"""Streaming trace replay: arrivals become scheduled events, lazily.

The PR 3 event engine makes 100k-job campaigns cheap to SIMULATE; this
module makes them cheap to FEED.  A `TraceReplayer` walks an
arrival-ordered record stream (a `Trace`, a generator, or a JSONL file
reader) and schedules ONE pending feeder event at a time on the
simulation's event loop: when it fires, every record due by `now` is
converted to a `Job` and submitted, and the feeder re-arms itself at the
next record's warped arrival time.  At no point does the replayer hold
more than one read-ahead record — `Job` objects exist only from their
arrival to their completion, and with `compact_completed=True` not even
completed jobs accumulate (the queue streams them into a
`CompletedStats` aggregator instead of `completed_log`).

Knobs:
  * `speed`       — time-warp: arrivals are compressed N× (runtimes are
                    untouched; warping demand, not service, is what a
                    what-if "same day, twice the submission rate" means)
  * `start_s` / `until_s` — truncation window in TRACE time; replay
                    re-zeroes the window start onto `at` in sim time
  * `coalesce_s`  — batch arrivals within this sim-time span into one
                    event (arrivals land up to coalesce_s LATE, never
                    early).  0 replays every arrival at its exact
                    timestamp; coarser values trade timing fidelity for
                    fewer continuous-state integrations at 100k scale.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator

from repro_torch.core.jobqueue import Job
from repro_torch.core.metrics import CompletedStats
from repro_torch.workload.trace import Trace, TraceError, TraceRecord


@dataclasses.dataclass
class ReplayStats:
    submitted: int = 0
    truncated: int = 0            # records dropped by the window
    batches: int = 0              # feeder firings
    max_batch: int = 0            # largest single-event submission
    first_arrival_s: float = -1.0  # sim-time of the first submission
    last_arrival_s: float = -1.0
    completed: CompletedStats | None = None


class TraceReplayer:
    """Feeds one trace into one simulation.  Single-use: the underlying
    record stream is consumed as the simulation advances."""

    def __init__(
        self,
        sim,
        records: Trace | Iterable[TraceRecord],
        *,
        speed: float = 1.0,
        start_s: float = 0.0,
        until_s: float | None = None,
        coalesce_s: float = 0.0,
        at: float | None = None,
        max_batch: int = 50_000,
        job_factory: Callable[[TraceRecord], Job] | None = None,
        compact_completed: bool = False,
        queue=None,
    ):
        if speed <= 0:
            raise ValueError(f"speed must be positive, got {speed}")
        if coalesce_s < 0:
            raise ValueError(f"coalesce_s must be >= 0, got {coalesce_s}")
        if until_s is not None and until_s <= start_s:
            raise ValueError(
                f"empty window: until_s={until_s} <= start_s={start_s}")
        self.sim = sim
        self.speed = speed
        self.start_s = start_s
        self.until_s = until_s
        self.coalesce_s = coalesce_s
        self.at = sim.now if at is None else at
        self.max_batch = max_batch
        self.job_factory = job_factory or TraceRecord.to_job
        # target schedd: under flocking each replayer feeds ITS queue —
        # several replayers share one event loop, one per submit host
        self.queue = queue if queue is not None else sim.queue
        self.stats = ReplayStats()
        if compact_completed:
            self.stats.completed = CompletedStats()
            self.queue.keep_completed = False
            self.queue.add_complete_hook(self.stats.completed.observe)
        self._records = self._windowed(
            iter(records.records) if isinstance(records, Trace)
            else iter(records))
        self._pushback: TraceRecord | None = None
        self._exhausted = False
        self._arm()

    # -- time mapping --------------------------------------------------------
    def _sim_time(self, rec: TraceRecord) -> float:
        return self.at + (rec.arrival_s - self.start_s) / self.speed

    def _windowed(self, it: Iterator[TraceRecord]
                  ) -> Iterator[TraceRecord]:
        for rec in it:
            if rec.arrival_s < self.start_s:
                self.stats.truncated += 1
                continue
            if self.until_s is not None and rec.arrival_s >= self.until_s:
                # arrival-ordered: everything left is outside the window;
                # drain (without keeping) so `truncated` counts exactly
                self.stats.truncated += 1 + sum(1 for _ in it)
                break
            yield rec

    def _next_record(self) -> TraceRecord | None:
        if self._pushback is not None:
            rec, self._pushback = self._pushback, None
            return rec
        return next(self._records, None)

    # -- the feeder chain ----------------------------------------------------
    def _arm(self):
        """Schedule the next feeder at the (coalesce-quantized) sim time
        of the next record.  Exactly one feeder is pending at any time,
        so `run_until_drained`'s external-event accounting sees the
        replay as live until the stream is exhausted."""
        rec = self._next_record()
        if rec is None:
            self._exhausted = True
            return
        self._pushback = rec
        t = self._sim_time(rec) + self.coalesce_s
        self.sim.at(t, self._feed, name="trace-replay")

    def _feed(self, sim, now: float):
        batch = 0
        while batch < self.max_batch:
            rec = self._next_record()
            if rec is None:
                self._exhausted = True
                break
            if self._sim_time(rec) > now + 1e-9:
                self._pushback = rec
                break
            job = self.job_factory(rec)
            self.queue.submit(job, now)
            if self.stats.first_arrival_s < 0:
                self.stats.first_arrival_s = now
            self.stats.last_arrival_s = now
            self.stats.submitted += 1
            batch += 1
        self.stats.batches += 1
        self.stats.max_batch = max(self.stats.max_batch, batch)
        if self._pushback is not None or not self._exhausted:
            self._arm()

    @property
    def exhausted(self) -> bool:
        return self._exhausted and self._pushback is None


def replay_trace(sim, records, **kw) -> TraceReplayer:
    """Install a streaming replay on `sim`; returns the replayer whose
    `.stats` fill in as the simulation runs.  Drive the simulation with
    `sim.run_until_drained(...)` as usual."""
    return TraceReplayer(sim, records, **kw)


def replay_flock(sim, traces: dict, **kw) -> dict[str, TraceReplayer]:
    """Install one streaming replayer PER SCHEDD on a multi-queue
    simulation: `traces` maps schedd name -> trace (what `split_trace`
    returns, keyed to the sim's `schedds=` names).  Every replayer
    self-arms on the one shared event loop, so the traces stream
    concurrently — each feeding its own queue — and `run_until_drained`
    sees the union as live until every stream is exhausted.  Extra
    keyword arguments (speed, coalesce_s, compact_completed, ...) apply
    to every replayer.  Returns {schedd name: replayer}; empty traces
    still get a (trivially-exhausted) replayer so the result is
    keyed like the input."""
    out: dict[str, TraceReplayer] = {}
    for name, trace in traces.items():
        out[name] = TraceReplayer(sim, trace, queue=sim.queue_named(name),
                                  **kw)
    return out


def submit_trace_upfront(sim, trace: Trace | Iterable[TraceRecord], *,
                         speed: float = 1.0) -> int:
    """Non-streaming oracle: materialize every job and schedule each
    arrival individually (exact times, O(n) memory).  Differential tests
    compare this against the streaming replayer."""
    n = 0
    records = trace.records if isinstance(trace, Trace) else list(trace)
    for rec in records:
        if rec.runtime_s <= 0:
            raise TraceError(f"bad record {rec!r}")
        sim.submit_jobs(rec.arrival_s / speed, [rec.to_job()])
        n += 1
    return n
