"""Negotiation-cycle profiler.

Attributes wall-clock per negotiation cycle to problem-build /
matchmaker `match` / plan-apply, and per provisioner reconcile to
collector-preview vs the rest — the phase split the million-job
roadmap item needs to know where a drain actually spends its time.

The collector/provisioner hot paths guard every timing site with a
single `if prof is not None:` check, so a simulation built without
telemetry pays one attribute load per cycle and nothing else.

Matchmaker-backend detail rides along: the jax backend reports, per
call, its padding bucket and whether that bucket was seen before
(first sight == XLA trace+compile, repeats == cached executable), and
`flush_staged` reports fused-batch size or the fallback reason.

Wall times land in registry histograms (scrapeable) and in bounded
per-cycle deques whose offsets are relative to profiler creation —
those deques feed the Chrome-trace exporter and are deliberately
*excluded* from snapshots: wall-clock measurements of a dead process
are not worth resuming, so a restore starts the profiler log empty
while the cumulative histograms carry over.
"""
from __future__ import annotations

import time
from collections import deque

from .registry import MetricRegistry, WALL_SECONDS_BUCKETS


class CycleProfiler:
    def __init__(self, registry: MetricRegistry, *,
                 cycle_log_max: int = 4096):
        self.phase_h = registry.histogram(
            "repro_cycle_phase_seconds",
            "Wall seconds per negotiation-cycle phase",
            ("phase",), WALL_SECONDS_BUCKETS)
        self.cycles_c = registry.counter(
            "repro_cycles_total", "Negotiation cycles by kind", ("kind",))
        # labelled by entry path: "cycle" covers match/match_cycles
        # dispatches from negotiation, "preview" the provisioner dry-run
        # dispatches.  The split exists because the preview path owns
        # its own jit (vmapped, guard-free) AND warms padding buckets
        # before the first recorded cycle — an unlabelled counter
        # under-reported vs `repro_matchmaker_seen_buckets` (measured
        # jit_compiles=0 on the 2k replay while buckets grew).
        self.jit_compiles = registry.counter(
            "repro_matchmaker_jit_compiles_total",
            "Matchmaker calls that hit a fresh padding bucket (XLA "
            "trace), by entry path", ("path",))
        self.reconcile_h = registry.histogram(
            "repro_reconcile_seconds",
            "Wall seconds per provisioner reconcile",
            (), WALL_SECONDS_BUCKETS)
        self.preview_h = registry.histogram(
            "repro_reconcile_preview_seconds",
            "Wall seconds spent in collector.preview per reconcile",
            (), WALL_SECONDS_BUCKETS)
        self.cycle_log_max = int(cycle_log_max)
        self.cycles: deque = deque(maxlen=self.cycle_log_max)
        self.reconciles: deque = deque(maxlen=self.cycle_log_max)
        self._t0 = time.perf_counter()

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def record_cycle(self, *, t: float, kind: str, w_start: float,
                     build_s: float, match_s: float, apply_s: float,
                     claims: int = 0, backend: str = "",
                     compiled: bool | None = None,
                     fused_k: int | None = None,
                     fallback: str | None = None):
        """One negotiation cycle.  `w_start` is the absolute
        perf_counter at cycle start; durations are wall seconds."""
        self.phase_h.labels("build").observe(build_s)
        self.phase_h.labels("match").observe(match_s)
        self.phase_h.labels("apply").observe(apply_s)
        self.cycles_c.labels(kind).value += 1
        if compiled:
            self.jit_compiles.labels("cycle").value += 1
        rec = {"t": t, "kind": kind, "w0": w_start - self._t0,
               "build_s": build_s, "match_s": match_s, "apply_s": apply_s,
               "claims": claims, "backend": backend}
        if compiled is not None:
            rec["compiled"] = compiled
        if fused_k is not None:
            rec["fused_k"] = fused_k
        if fallback is not None:
            rec["fallback"] = fallback
        self.cycles.append(rec)

    def note_compile(self, path: str):
        """Attribute one fresh-bucket XLA trace to an entry path
        ("preview" from the collector dry run; record_cycle attributes
        the "cycle" path itself)."""
        self.jit_compiles.labels(path).value += 1

    def record_reconcile(self, *, t: float, w_start: float, wall_s: float,
                         preview_s: float, submitted: int = 0):
        self.reconcile_h.observe(wall_s)
        self.preview_h.observe(preview_s)
        self.reconciles.append(
            {"t": t, "w0": w_start - self._t0, "wall_s": wall_s,
             "preview_s": preview_s, "submitted": submitted})

    # -- aggregate view (compare.py phase-attribution columns) ---------------
    def phase_totals(self) -> dict:
        out = {}
        for phase in ("build", "match", "apply"):
            h = self.phase_h.labels(phase)
            out[phase + "_s"] = h.sum
        out["reconcile_s"] = self.reconcile_h.sum
        out["preview_s"] = self.preview_h.sum
        out["cycles"] = {k[0]: int(c.value)
                         for k, c in self.cycles_c.children.items()}
        by_path = {k[0]: int(c.value)
                   for k, c in self.jit_compiles.children.items()}
        # "jit_compiles" stays the all-paths total (pre-label surface)
        out["jit_compiles"] = sum(by_path.values())
        out["jit_compiles_by_path"] = by_path
        return out

    # -- Chrome-trace rows (wall offsets -> microseconds) --------------------
    def chrome_events(self, pid: int = 2) -> list:
        out = [{"ph": "M", "pid": pid, "name": "process_name",
                "args": {"name": "negotiation wall clock"}}]
        for rec in self.cycles:
            w = rec["w0"] * 1e6
            args = {"sim_t": rec["t"], "kind": rec["kind"],
                    "backend": rec["backend"], "claims": rec["claims"]}
            for key in ("compiled", "fused_k", "fallback"):
                if key in rec:
                    args[key] = rec[key]
            for phase in ("build", "match", "apply"):
                dur = rec[phase + "_s"] * 1e6
                out.append({"ph": "X", "pid": pid, "tid": 1,
                            "name": phase, "cat": "negotiation",
                            "ts": w, "dur": dur, "args": args})
                w += dur
        for rec in self.reconciles:
            w = rec["w0"] * 1e6
            out.append({"ph": "X", "pid": pid, "tid": 2,
                        "name": "reconcile", "cat": "provisioner",
                        "ts": w, "dur": rec["wall_s"] * 1e6,
                        "args": {"sim_t": rec["t"],
                                 "preview_s": rec["preview_s"],
                                 "submitted": rec["submitted"]}})
        return out
