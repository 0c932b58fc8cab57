"""Pluggable scaling backends: one provisioner, many resource providers.

The paper runs identical provisioning logic against an on-prem Kubernetes
cluster (PRP/Nautilus, §2–§5) and a cloud deployment with node
auto-provisioning (GKE NAP, §6); its OSG follow-up generalizes this to
many heterogeneous providers feeding one HTCondor pool.  A
`ScalingBackend` is the seam that makes that federation possible: it
bundles a pod-placement surface (`KubeCluster`), an optional
`NodeAutoscaler`, a cost model, capacity limits, and a readiness view
behind a uniform interface —

    pending(label)     pods of a provisioning group still waiting
    submit(spec, now)  place a pod request on this provider
    tick(now, dt)      advance autoscaler / scheduler / cost accounting
    cost_rate()        current $/s burn
    headroom(request)  pods of this shape the provider can still absorb

The provisioner never talks to a cluster directly any more; it asks a
`RoutingPolicy` to split each group's deficit across an ordered list of
backends (fill-onprem-first, cheapest-first, weighted-spread,
spot-with-fallback) and attributes stats per backend.  A single
`KubeCluster` is adapted into a one-element backend list, so the paper's
single-provider deployment is just the degenerate case.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Protocol, runtime_checkable

from repro_torch.core.cluster import KubeCluster, Node, Pod, PodPhase
from repro_torch.core.config import BackendConfig, ProvisionerConfig
from repro_torch.core.nodescaler import NodeAutoscaler, NodeTemplate

OWNER = "prp-provisioner"


# ---------------------------------------------------------------------------
# Pod requests as data (what the provisioner hands a backend)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PodSpec:
    """Provider-independent pod request.  The backend applies its own
    priority class / tolerations / affinity on top before placement."""
    name: str
    request: dict[str, float]
    labels: dict[str, str] = dataclasses.field(default_factory=dict)
    priority_class: str = "default"
    tolerations: tuple[str, ...] = ()
    node_selector: dict[str, Any] = dataclasses.field(default_factory=dict)
    anti_affinity: dict[str, Any] = dataclasses.field(default_factory=dict)
    on_start: Callable[[Pod, float], None] | None = None
    on_stop: Callable[[Pod, float, str], None] | None = None


@dataclasses.dataclass
class BackendStats:
    pods_submitted: int = 0
    pods_reclaimed: int = 0
    cost_total: float = 0.0          # integrated $ spent


# ---------------------------------------------------------------------------
# The protocol
# ---------------------------------------------------------------------------

@runtime_checkable
class ScalingBackend(Protocol):
    """Anything that can turn pod requests into HTCondor execute capacity.

    The full surface the provisioner, routing policies, simulation, and
    metrics rely on — implement all of it (subclassing `KubeBackend` is
    the easy path; `autoscaler` may be None and `reclaim` may be a
    no-op for non-spot providers)."""
    name: str
    cluster: KubeCluster
    autoscaler: NodeAutoscaler | None
    stats: BackendStats
    spot: bool
    weight: float

    def pending(self, label: str | None = None) -> int: ...
    def submit(self, spec: PodSpec, now: float) -> str: ...
    def tick(self, now: float, dt: float) -> None: ...
    def cost_rate(self) -> float: ...
    def marginal_pod_cost(self, request: dict[str, float]) -> float: ...
    def headroom(self, request: dict[str, float]) -> int: ...
    def live_pods(self) -> int: ...
    def healthy(self) -> bool: ...
    def reclaim(self, frac: float, now: float, rng=None) -> int: ...


# ---------------------------------------------------------------------------
# The Kubernetes-backed implementation (covers static + autoscaled + spot)
# ---------------------------------------------------------------------------

class KubeBackend:
    """A Kubernetes resource provider: a static on-prem cluster when
    `autoscaler` is None, a NAP-style elastic pool when it is set, a spot
    pool when `spot` is additionally true (reclaims via `reclaim()`)."""

    def __init__(
        self,
        name: str,
        cluster: KubeCluster,
        autoscaler: NodeAutoscaler | None = None,
        *,
        max_pods: int = 1_000_000,
        priority_class: str = "",          # "" -> use the PodSpec's
        tolerations: tuple[str, ...] = (),
        node_affinity: dict[str, Any] | None = None,
        node_hourly_cost: float = 0.0,
        pod_hourly_cost: float = 0.0,
        spot: bool = False,
        weight: float = 1.0,
    ):
        self.name = name
        self.cluster = cluster
        self.autoscaler = autoscaler
        self.max_pods = max_pods
        self.priority_class = priority_class
        self.tolerations = tolerations
        self.node_affinity = dict(node_affinity or {})
        if autoscaler is not None and node_hourly_cost == 0.0:
            node_hourly_cost = autoscaler.template.hourly_cost
        self.node_hourly_cost = node_hourly_cost
        self.pod_hourly_cost = pod_hourly_cost
        self.spot = spot
        self.weight = weight
        self.stats = BackendStats()
        self._cost_t = 0.0            # cost accrued up to this sim time
        # a draining backend reports unhealthy (every routing policy
        # filters on healthy()), so no NEW pods route here; existing
        # claims run to completion, then the simulation detaches it
        # (Simulation.drain_backend)
        self.draining = False

    # -- ScalingBackend surface ---------------------------------------------
    def pending(self, label: str | None = None) -> int:
        def sel(p: Pod) -> bool:
            if p.labels.get("owner") != OWNER:
                return False
            return label is None or p.labels.get("provision-group") == label
        return len(self.cluster.pending_pods(sel))

    def live_pods(self) -> int:
        sel = (lambda p: p.labels.get("owner") == OWNER)
        return (len(self.cluster.pending_pods(sel))
                + len(self.cluster.running_pods(sel)))

    def submit(self, spec: PodSpec, now: float) -> str:
        selector = dict(spec.node_selector)
        anti = dict(spec.anti_affinity)
        for k, v in self.node_affinity.items():
            if k.startswith("^"):
                anti[k[1:]] = v
            else:
                selector[k] = v
        pod = Pod(
            name=spec.name,
            request=dict(spec.request),
            priority_class=self.priority_class or spec.priority_class,
            tolerations=self.tolerations or spec.tolerations,
            node_selector=selector,
            labels={
                **spec.labels,
                "backend": self.name,
                **({"anti-affinity": ",".join(anti)} if anti else {}),
            },
            on_start=spec.on_start,
            on_stop=spec.on_stop,
        )
        self.stats.pods_submitted += 1
        return self.cluster.create_pod(pod, now)

    def tick(self, now: float, dt: float) -> None:
        """Advance this provider by one interval ending at `now`: accrue
        cost at the pre-mutation rate, then node autoscaler, pod
        scheduler, and (lazy, exact-to-`now`) accounting.  Under the
        event engine this runs as a periodic event-loop callback
        (`schedule_backend_on`); the tick engine still polls it."""
        self.accrue_cost(now)         # BEFORE nodes change: a node added
        #                               at `now` is not billed for the past
        if self.autoscaler is not None:
            self.autoscaler.tick(now, dt)
        self.cluster.schedule(now)
        self.cluster.tick_accounting(dt, now)

    def accrue_cost(self, now: float):
        """Integrate $ burn continuously up to `now` at the current rate
        (rate changes between accrual points bill at the newer rate for
        the elapsed slice — bounded by the tick interval).  Idempotent at
        fixed `now`; the simulation flushes it before every summary so
        partial final intervals are charged."""
        if now > self._cost_t:
            self.stats.cost_total += self.cost_rate() * (now - self._cost_t)
            self._cost_t = now

    def rebase(self, now: float) -> None:
        """Align a backend constructed at t=0 with a pool already at
        `now` (runtime `Simulation.add_backend`): cost accrual and node
        alive-time integrals start at attach, not at the epoch — a
        static cluster added at t=5000 must not bill 5000s of history."""
        self._cost_t = now
        for n in self.cluster.nodes.values():
            n.created_at = now
        for name in list(self.cluster._acct_t):
            self.cluster._acct_t[name] = now

    def cost_rate(self) -> float:
        """Current burn in $/s: billed nodes plus per-pod surcharges."""
        if self.autoscaler is not None:
            n_nodes = self.autoscaler.live_nodes()
        else:
            n_nodes = len(self.cluster.nodes)
        n_pods = len(self.cluster.running_pods(
            lambda p: p.labels.get("owner") == OWNER))
        return (n_nodes * self.node_hourly_cost
                + n_pods * self.pod_hourly_cost) / 3600.0

    def headroom(self, request: dict[str, float]) -> int:
        """Pods of this shape the backend can still absorb: free capacity
        on live nodes (minus what pending pods will consume), plus — for
        elastic backends — capacity the autoscaler may still add."""
        fits = 0
        for name, node in self.cluster.nodes.items():
            free = node.allocatable((), used=self.cluster.node_used(name))
            fits += _pods_fit(free, request)
        fits -= self.pending(None)       # queued pods will eat capacity
        fits = max(0, fits)
        if self.autoscaler is not None:
            a = self.autoscaler
            room_nodes = max(
                0, a.max_nodes - a.live_nodes() - len(a._booting))
            fits += room_nodes * _pods_fit(a.template.capacity, request)
        return max(0, min(fits, self.max_pods - self.live_pods()))

    def healthy(self) -> bool:
        if self.draining:
            return False                      # stop routing; drain out
        if self.autoscaler is not None:
            return True                       # can always (try to) grow
        return bool(self.cluster.nodes)

    def health(self) -> dict[str, Any]:
        """Readiness view (what a /healthz of the provider would say)."""
        return {
            "healthy": self.healthy(),
            "draining": self.draining,
            "live_nodes": len(self.cluster.nodes),
            "booting_nodes": (len(self.autoscaler._booting)
                              if self.autoscaler else 0),
            "pending_pods": self.pending(None),
            "live_pods": self.live_pods(),
            "cost_rate_per_h": self.cost_rate() * 3600.0,
        }

    # -- cost model ----------------------------------------------------------
    def marginal_pod_cost(self, request: dict[str, float]) -> float:
        """$/h for one MORE pod of this shape.  Static nodes are sunk cost
        (marginal ≈ pod surcharge); elastic nodes amortize the node price
        over the pods that share it."""
        cost = self.pod_hourly_cost
        if self.autoscaler is not None:
            per_node = _pods_fit(self.autoscaler.template.capacity, request)
            if per_node > 0:
                cost += self.node_hourly_cost / per_node
            else:
                cost += self.node_hourly_cost
        return cost

    # -- persistence ----------------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-safe snapshot of the MUTABLE half: cluster, autoscaler,
        stats, cost accrual point, drain flag.  Configuration (costs,
        affinity, limits) is not serialized — restore targets a backend
        built from the same config."""
        out = {
            "name": self.name,
            "draining": self.draining,
            "cost_t": self._cost_t,
            "stats": dataclasses.asdict(self.stats),
            "cluster": self.cluster.state_dict(),
        }
        if self.autoscaler is not None:
            out["autoscaler"] = self.autoscaler.state_dict()
        return out

    def load_state(self, state: dict) -> None:
        if state.get("name") != self.name:
            raise ValueError(
                f"backend snapshot is for {state.get('name')!r}, "
                f"not {self.name!r}")
        self.draining = bool(state.get("draining", False))
        self._cost_t = float(state.get("cost_t", 0.0))
        self.stats = BackendStats(**state.get("stats", {}))
        self.cluster.load_state(state["cluster"])
        if self.autoscaler is not None and "autoscaler" in state:
            self.autoscaler.load_state(state["autoscaler"])

    # -- spot dynamics -------------------------------------------------------
    def reclaim(self, frac: float, now: float, rng=None) -> int:
        """Spot-style reclaim of a fraction of running provisioner pods
        on THIS backend (§5: preemption is routine, not exceptional)."""
        pods = self.cluster.running_pods(
            lambda p: p.labels.get("owner") == OWNER)
        if not pods:
            return 0
        k = max(1, int(len(pods) * frac))
        if rng is not None:
            idx = list(rng.permutation(len(pods))[:k])
        else:
            idx = list(range(k))
        for i in idx:
            self.cluster.delete_pod(pods[i].name, now, "preempted")
        self.stats.pods_reclaimed += len(idx)
        return len(idx)


def schedule_backend_on(backend, loop, interval_s: float, *,
                        priority: int = 0):
    """Drive any ScalingBackend from a discrete-event loop: periodic
    `tick`s at exact cadence (the k-th fires at now + k*interval and
    accounts the interval ENDING at its firing), preceded by a zero-dt
    priming pass at t=now so pods submitted by the first reconcile place
    immediately, like the seed's first tick did.  Works for backends that
    only implement the Protocol (no event-loop awareness required)."""
    loop.schedule(loop.now, lambda now: backend.tick(now, 0.0),
                  name=f"backend:{backend.name}:prime", priority=priority)
    return loop.every(interval_s,
                      lambda now: backend.tick(now, interval_s),
                      first=loop.now + interval_s,
                      name=f"backend:{backend.name}", priority=priority)


def _pods_fit(free: dict[str, float], request: dict[str, float]) -> int:
    n = float("inf")
    for k, v in request.items():
        if v > 0:
            n = min(n, free.get(k, 0) // v)
    return int(n) if n != float("inf") else 0


# ---------------------------------------------------------------------------
# Routing policies: how a group's deficit is split across backends
# ---------------------------------------------------------------------------

class RoutingPolicy:
    """Base policy: fill backends in declaration order (on-prem first is
    just 'declare on-prem first').  Demand beyond every backend's headroom
    queues as pending pods on the overflow target — pending pods are free
    and HTCondor demand is bursty (same rationale as the provisioner's
    no-delete default)."""

    name = "fill-first"

    def order(self, backends: list, request: dict[str, float]) -> list:
        return [b for b in backends if b.healthy()] or list(backends)

    def overflow_target(self, order: list):
        return order[0] if order else None

    def split(self, n: int, request: dict[str, float], backends: list,
              now: float) -> list[tuple[Any, int]]:
        order = self.order(list(backends), request)
        alloc: dict[str, int] = {}
        by_name = {b.name: b for b in order}
        left = n
        for b in order:
            if left <= 0:
                break
            k = min(left, b.headroom(request))
            if k > 0:
                alloc[b.name] = alloc.get(b.name, 0) + k
                left -= k
        if left > 0:
            tgt = self.overflow_target(order)
            if tgt is not None:
                alloc[tgt.name] = alloc.get(tgt.name, 0) + left
        return [(by_name[name], k) for name, k in alloc.items() if k > 0]


class FillFirstRouting(RoutingPolicy):
    name = "fill-first"


class CheapestFirstRouting(RoutingPolicy):
    """Order by marginal $/h for one more pod of the group's shape; ties
    break by declaration order (so on-prem beats equally-free spot)."""

    name = "cheapest-first"

    def order(self, backends, request):
        healthy = super().order(backends, request)
        idx = {b.name: i for i, b in enumerate(backends)}
        return sorted(
            healthy,
            key=lambda b: (b.marginal_pod_cost(request), idx[b.name]),
        )


class WeightedSpreadRouting(RoutingPolicy):
    """Split proportionally to backend weights (clamped to headroom);
    the remainder falls through fill-first over the same order."""

    name = "weighted-spread"

    def split(self, n, request, backends, now):
        order = self.order(list(backends), request)
        if not order:
            return []
        total_w = sum(max(b.weight, 0.0) for b in order) or 1.0
        alloc: dict[str, int] = {}
        head = {b.name: b.headroom(request) for b in order}
        left = n
        for b in order:
            want = int(n * max(b.weight, 0.0) / total_w)
            k = min(want, head[b.name], left)
            if k > 0:
                alloc[b.name] = k
                head[b.name] -= k
                left -= k
        for b in order:                      # fill-first the remainder
            if left <= 0:
                break
            k = min(left, head[b.name])
            if k > 0:
                alloc[b.name] = alloc.get(b.name, 0) + k
                left -= k
        if left > 0:
            tgt = self.overflow_target(order)
            if tgt is not None:
                alloc[tgt.name] = alloc.get(tgt.name, 0) + left
        by_name = {b.name: b for b in order}
        return [(by_name[name], k) for name, k in alloc.items() if k > 0]


class SpotWithFallbackRouting(RoutingPolicy):
    """Prefer spot capacity (cheap, reclaimable); fall back to on-demand
    when spot headroom is exhausted.  Overflow queues on the FALLBACK,
    not on spot — a pod stuck pending on a reclaimable pool is the worst
    of both worlds."""

    name = "spot-with-fallback"

    def order(self, backends, request):
        healthy = super().order(backends, request)
        idx = {b.name: i for i, b in enumerate(backends)}
        return sorted(healthy, key=lambda b: (not b.spot, idx[b.name]))

    def overflow_target(self, order):
        for b in order:
            if not b.spot:
                return b
        return order[0] if order else None


ROUTING_POLICIES: dict[str, type[RoutingPolicy]] = {
    p.name: p for p in (
        FillFirstRouting, CheapestFirstRouting, WeightedSpreadRouting,
        SpotWithFallbackRouting,
    )
}


def make_routing_policy(name: str) -> RoutingPolicy:
    try:
        return ROUTING_POLICIES[name]()
    except KeyError:
        raise ValueError(
            f"unknown routing policy {name!r}; "
            f"known: {sorted(ROUTING_POLICIES)}") from None


# ---------------------------------------------------------------------------
# Builders / adapters
# ---------------------------------------------------------------------------

def adapt_single_cluster(cluster: KubeCluster,
                         autoscaler: NodeAutoscaler | None = None,
                         name: str = "default") -> KubeBackend:
    """The compatibility adapter: one bare KubeCluster (+ optional
    autoscaler) becomes a one-element backend list — the paper's original
    single-provider deployment."""
    return KubeBackend(name, cluster, autoscaler)


def backend_from_config(bc: BackendConfig) -> KubeBackend:
    """Materialize one `[backend:<name>]` INI section."""
    if bc.kind not in ("static", "autoscale"):
        raise ValueError(
            f"[backend:{bc.name}] unknown kind {bc.kind!r}; "
            "expected 'static' or 'autoscale'")
    cluster = KubeCluster([], name=bc.name)
    autoscaler = None
    if bc.kind == "autoscale":
        tmpl = NodeTemplate(
            capacity=dict(bc.capacity),
            labels=dict(bc.node_labels),
            taints=bc.taints,
            provision_delay_s=bc.provision_delay_s,
            scale_down_delay_s=bc.scale_down_delay_s,
            hourly_cost=bc.node_hourly_cost,
        )
        autoscaler = NodeAutoscaler(cluster, tmpl, max_nodes=bc.max_nodes,
                                    prefix=f"{bc.name}-np")
    else:
        for i in range(bc.nodes):
            cluster.add_node(
                Node(name=f"{bc.name}-{i}", capacity=dict(bc.capacity),
                     labels=dict(bc.node_labels), taints=bc.taints),
                now=0.0,
            )
    return KubeBackend(
        bc.name, cluster, autoscaler,
        max_pods=bc.max_pods,
        priority_class=bc.priority_class,
        tolerations=bc.tolerations,
        node_affinity=bc.node_affinity,
        node_hourly_cost=bc.node_hourly_cost,
        pod_hourly_cost=bc.pod_hourly_cost,
        spot=bc.spot,
        weight=bc.weight,
    )


def build_backends(cfg: ProvisionerConfig) -> list[KubeBackend]:
    """All `[backend:*]` sections of a config, in declaration order."""
    return [backend_from_config(bc) for bc in cfg.backends]


class FederatedClusterView:
    """Read/terminate view over every backend's cluster, for components
    (advance_workers) that held a single-cluster handle.  Pod names are
    globally unique (one provisioner counter), so dispatch is a scan."""

    def __init__(self, backends: Iterable):
        self.backends = list(backends)

    def _owning(self, pod_name: str) -> KubeCluster | None:
        for b in self.backends:
            if pod_name in b.cluster.pods:
                return b.cluster
        return None

    def succeed_pod(self, name: str, now: float):
        c = self._owning(name)
        if c is not None:
            c.succeed_pod(name, now)

    def delete_pod(self, name: str, now: float, reason: str = "deleted"):
        c = self._owning(name)
        if c is not None:
            c.delete_pod(name, now, reason)

    @property
    def pods(self) -> dict[str, Pod]:
        out: dict[str, Pod] = {}
        for b in self.backends:
            out.update(b.cluster.pods)
        return out

    def pending_pods(self, selector=None) -> list[Pod]:
        out: list[Pod] = []
        for b in self.backends:
            out.extend(b.cluster.pending_pods(selector))
        return out

    def running_pods(self, selector=None) -> list[Pod]:
        out: list[Pod] = []
        for b in self.backends:
            out.extend(b.cluster.running_pods(selector))
        return out
