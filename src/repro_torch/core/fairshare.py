"""Hierarchical fair-share accounting: HTCondor's accountant, simulated.

The OSG deployments the paper targets serve several communities, each
submitting through its own schedd into one shared pool; the negotiator
must arbitrate between them, not just drain one queue FIFO.  HTCondor
does this with two ledgers:

  * per-SUBMITTER usage with exponential decay (PRIORITY_HALFLIFE):
    a user's *real* priority tracks their recent resource consumption,
    and their *effective* priority is that times an operator-set
    priority factor — a factor-2 user is entitled to half the machines
    of a factor-1 user under contention;
  * per-GROUP (here: per-schedd) quotas that carve the pool between
    communities before users inside each community compete.

`UsageLedger` implements the decayed-usage integral exactly: between
observations a key accrues at its current running-core rate while the
whole ledger decays with half-life ``half_life_s``, so
``du/dt = rate − (ln2/hl)·u`` is integrated in closed form at every rate
change (claim / completion / release).  At a steady rate the usage
converges to ``rate·hl/ln2``; `effective_cores` divides that constant
back out, so "usage" reads in *cores currently deserved* — directly
comparable with the virtual cores the negotiator charges while handing
out slots inside one cycle.

`Accountant` wires a ledger pair to any number of `JobQueue`s via the
queue's claim/complete/release hooks and answers the two questions the
negotiation cycle (worker.py `run_cycle`) asks while
water-filling capacity:

  * ``effective_priority(user)`` — factor × (base + decayed cores +
    virtual cores charged so far this cycle); LOWEST goes first.
  * ``group_owed(schedd)`` — decayed group cores / quota; the schedd
    with the smallest usage-per-quota is most *owed* and negotiates
    first.

Serving the argmin and charging what it claimed equalizes
``factor × usage`` across users (and ``usage / quota`` across schedds),
which is exactly the inverse-factor / proportional-quota split HTCondor
documents — the fair-share convergence test pins the 2:1 case.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterable

from repro_torch.core.jobqueue import DEFAULT_USER, USER_ATTR, user_of  # noqa: F401
#   (re-exported: the accountant's callers key ledgers by user_of(job))

LN2 = math.log(2.0)


def job_cores(job) -> float:
    """Slot weight a job is charged at — HTCondor's default SlotWeight
    (cpus); GPUs are charged on top so a 1-cpu/1-gpu job outweighs a
    1-cpu scavenger."""
    cpus = job.ad.get("request_cpus", 1) or 1
    gpus = job.ad.get("request_gpus", 0) or 0
    return max(1.0, float(cpus)) + float(gpus)


class UsageLedger:
    """Per-key exponentially-decayed usage, integrated in closed form.

    Keys accrue at their current `rate` (running cores) while decaying
    with half-life `half_life_s`; both the accrual and the decay are
    settled lazily whenever a key is observed or its rate changes, so
    the ledger is exact at event granularity and O(1) per update.
    """

    def __init__(self, half_life_s: float = 86400.0):
        if not half_life_s > 0:
            raise ValueError(
                f"half_life_s must be positive, got {half_life_s}")
        self.half_life_s = half_life_s
        self.tau = half_life_s / LN2       # decay-equilibrium constant
        self._usage: dict[str, float] = {}   # core-seconds, decayed
        self._rate: dict[str, float] = {}    # running cores
        self._t: dict[str, float] = {}       # last settle time per key

    def _settle(self, key: str, now: float):
        t0 = self._t.get(key)
        if t0 is None:
            self._t[key] = now
            return
        dt = now - t0
        if dt <= 0:
            return
        d = 0.5 ** (dt / self.half_life_s)
        u = self._usage.get(key, 0.0)
        r = self._rate.get(key, 0.0)
        # closed form of du/dt = r - (ln2/hl) u over [t0, now]
        self._usage[key] = u * d + r * self.tau * (1.0 - d)
        self._t[key] = now

    def add_rate(self, key: str, delta_cores: float, now: float):
        """A job started (+cores) or stopped (-cores) at `now`."""
        self._settle(key, now)
        self._rate[key] = self._rate.get(key, 0.0) + delta_cores

    def charge(self, key: str, core_seconds: float, now: float):
        """One-shot usage charge (tests / imported accounting state)."""
        self._settle(key, now)
        self._usage[key] = self._usage.get(key, 0.0) + core_seconds

    def usage(self, key: str, now: float) -> float:
        """Decayed core-seconds of accumulated usage at `now`."""
        self._settle(key, now)
        return self._usage.get(key, 0.0)

    def effective_cores(self, key: str, now: float) -> float:
        """Usage normalized by the decay equilibrium: a key holding a
        steady `r` running cores converges to exactly `r` — the unit the
        negotiator's virtual within-cycle charges are denominated in."""
        return self.usage(key, now) / self.tau

    def rate(self, key: str) -> float:
        return self._rate.get(key, 0.0)

    def keys(self) -> list[str]:
        return sorted(set(self._usage) | set(self._rate))

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> dict[str, Any]:
        """Plain-dict persistable state (JSON-safe: str keys, floats).
        The raw (usage, rate, last-settle) triples reproduce the ledger
        EXACTLY — no settling happens, so a dump/load round-trip is
        bitwise-neutral at any later query time."""
        return {
            "half_life_s": self.half_life_s,
            "usage": dict(self._usage),
            "rate": dict(self._rate),
            "t": dict(self._t),
        }

    def load_state(self, state: dict[str, Any]):
        """Inverse of `state_dict` (e.g. after a json.loads round-trip);
        replaces all ledger contents."""
        hl = float(state.get("half_life_s", self.half_life_s))
        if not hl > 0:
            raise ValueError(f"half_life_s must be positive, got {hl}")
        self.half_life_s = hl
        self.tau = hl / LN2
        self._usage = {str(k): float(v)
                       for k, v in state.get("usage", {}).items()}
        self._rate = {str(k): float(v)
                      for k, v in state.get("rate", {}).items()}
        self._t = {str(k): float(v)
                   for k, v in state.get("t", {}).items()}


@dataclasses.dataclass
class ScheddSpec:
    """One submit host in a flocking federation: its name, its share
    quota (relative weight of the pool its community is entitled to),
    and per-user priority factors for its submitters (merged into the
    accountant; factors are pool-global in HTCondor and here)."""

    name: str
    quota: float = 1.0
    priority_factors: dict[str, float] = dataclasses.field(
        default_factory=dict)

    def __post_init__(self):
        if not self.quota > 0:
            raise ValueError(
                f"schedd {self.name!r}: quota must be positive, "
                f"got {self.quota}")


class Accountant:
    """The negotiator's usage/priority book-keeper (pool-level).

    Attach it to every schedd's queue (`attach_queue`); claim, complete,
    and release transitions then keep per-user and per-schedd running-
    core rates current, and the decayed ledgers answer priority queries
    at negotiation time.  Within one negotiation cycle the negotiator
    additionally charges *virtual* cores for the claims it just handed
    out (`charge_virtual`), so water-filling sees its own allocations
    before any sim time passes; `reset_cycle` drops them once real
    rates have taken over.
    """

    def __init__(self, *, half_life_s: float = 86400.0,
                 base_priority: float = 0.5,
                 default_factor: float = 1.0):
        if not base_priority > 0:
            raise ValueError(
                f"base_priority must be positive, got {base_priority}")
        self.users = UsageLedger(half_life_s)
        self.groups = UsageLedger(half_life_s)
        self.base_priority = base_priority
        self.default_factor = default_factor
        self.factors: dict[str, float] = {}
        self.quotas: dict[str, float] = {}
        # within-cycle virtual charges, in cores
        self._vuser: dict[str, float] = {}
        self._vgroup: dict[str, float] = {}

    # -- configuration -------------------------------------------------------
    def set_priority_factor(self, user: str, factor: float):
        if not factor > 0:
            raise ValueError(
                f"priority factor must be positive, got {factor}")
        self.factors[user] = factor

    def priority_factor(self, user: str) -> float:
        return self.factors.get(user, self.default_factor)

    def set_quota(self, schedd: str, quota: float):
        if not quota > 0:
            raise ValueError(f"quota must be positive, got {quota}")
        self.quotas[schedd] = quota

    def quota(self, schedd: str) -> float:
        return self.quotas.get(schedd, 1.0)

    # -- queue wiring --------------------------------------------------------
    def attach_queue(self, schedd: str, queue):
        """Subscribe to a schedd's job transitions so running-core rates
        stay exact: +cores at claim, −cores at completion/release."""

        def on_claim(job, now):
            cores = job_cores(job)
            self.users.add_rate(user_of(job), cores, now)
            self.groups.add_rate(schedd, cores, now)

        def on_stop(job, now):
            cores = job_cores(job)
            self.users.add_rate(user_of(job), -cores, now)
            self.groups.add_rate(schedd, -cores, now)

        queue.add_claim_hook(on_claim)
        queue.add_release_hook(on_stop)
        queue.add_complete_hook(lambda job: on_stop(job, job.completed_at))

    # -- negotiation-cycle queries -------------------------------------------
    def reset_cycle(self):
        """Drop the previous cycle's virtual charges (claims made then
        are now real running-core rates)."""
        self._vuser.clear()
        self._vgroup.clear()

    def charge_virtual(self, schedd: str, user: str, cores: float):
        self._vuser[user] = self._vuser.get(user, 0.0) + cores
        self._vgroup[schedd] = self._vgroup.get(schedd, 0.0) + cores

    def effective_priority(self, user: str, now: float) -> float:
        """HTCondor EUP: priority factor × (base + decayed usage), plus
        this cycle's virtual cores.  Lower is better."""
        cores = (self.users.effective_cores(user, now)
                 + self._vuser.get(user, 0.0))
        return self.priority_factor(user) * (self.base_priority + cores)

    def group_owed(self, schedd: str, now: float) -> float:
        """Usage-per-quota of a schedd (virtual charges included) — the
        water-filling key at the group level; lower means more owed."""
        cores = (self.groups.effective_cores(schedd, now)
                 + self._vgroup.get(schedd, 0.0))
        return cores / self.quota(schedd)

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> dict[str, Any]:
        """Everything needed to rebuild this accountant in a fresh
        process — plain dicts, JSON-safe.  Virtual within-cycle charges
        are deliberately NOT part of the state: they only exist inside
        one negotiation cycle and a restored accountant starts outside
        of any."""
        return {
            "base_priority": self.base_priority,
            "default_factor": self.default_factor,
            "factors": dict(self.factors),
            "quotas": dict(self.quotas),
            "users": self.users.state_dict(),
            "groups": self.groups.state_dict(),
        }

    def restore(self, state: dict[str, Any]):
        """Load a `state_dict()` — or a full `snapshot()` carrying one
        under its "state" key (snapshots stay directly restorable after
        a JSON round-trip).  Priority queries afterwards are identical
        to the source accountant's."""
        inner = state.get("state")
        if isinstance(inner, dict) and "users" in inner:
            state = inner
        self.base_priority = float(
            state.get("base_priority", self.base_priority))
        self.default_factor = float(
            state.get("default_factor", self.default_factor))
        self.factors = {str(k): float(v)
                        for k, v in state.get("factors", {}).items()}
        self.quotas = {str(k): float(v)
                       for k, v in state.get("quotas", {}).items()}
        self.users.load_state(state.get("users", {}))
        self.groups.load_state(state.get("groups", {}))
        self.reset_cycle()

    # -- introspection (metrics / tests) -------------------------------------
    def snapshot(self, now: float) -> dict[str, Any]:
        out = {
            "users": {
                u: {
                    "effective_cores": round(
                        self.users.effective_cores(u, now), 6),
                    "rate": self.users.rate(u),
                    "factor": self.priority_factor(u),
                    "effective_priority": round(
                        self.effective_priority(u, now), 6),
                }
                for u in self.users.keys()
            },
            "schedds": {
                s: {
                    "effective_cores": round(
                        self.groups.effective_cores(s, now), 6),
                    "rate": self.groups.rate(s),
                    "quota": self.quota(s),
                }
                for s in self.groups.keys()
            },
        }
        # the persistable half rides along so `json.dumps(snapshot)` is
        # both a metrics record AND a restore point (see `restore`)
        out["state"] = self.state_dict()
        return out


def make_schedd_specs(schedds: int | Iterable) -> list[ScheddSpec]:
    """Normalize the `Simulation(schedds=...)` argument: an int makes N
    equal-quota schedds named schedd00..; an iterable may mix names and
    ready-made `ScheddSpec`s."""
    if isinstance(schedds, int):
        if schedds < 1:
            raise ValueError(f"need at least one schedd, got {schedds}")
        return [ScheddSpec(name=f"schedd{i:02d}") for i in range(schedds)]
    specs: list[ScheddSpec] = []
    for s in schedds:
        if isinstance(s, ScheddSpec):
            specs.append(s)
        elif isinstance(s, str):
            specs.append(ScheddSpec(name=s))
        else:
            raise TypeError(f"schedd spec must be a name or ScheddSpec, "
                            f"got {s!r}")
    names = [s.name for s in specs]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate schedd names: {names}")
    if not specs:
        raise ValueError("need at least one schedd")
    return specs
