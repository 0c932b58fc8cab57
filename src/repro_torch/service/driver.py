"""Wall-clock driver: paces a discrete-event Simulation in real time.

The event loop is a pure function of its heap — it has no clock of its
own.  This driver maps simulation time onto monotonic wall time
(`speed=N` runs N simulated seconds per real second; `speed=None` runs
as fast as possible) and fires events when their wall deadline arrives.

Concurrency model — single-writer, quiescent injection points:

  * ONE background thread owns the simulation.  Every outside operation
    (submit, status, snapshot, drain) is a closure handed to `call()`,
    which enqueues it and wakes the thread; the caller blocks until the
    thread has run it and returns (or re-raises) the result.
  * Injections run only BETWEEN timestamp groups: the thread fires every
    event sharing the current timestamp before servicing the queue, so
    an injected `Simulation.state_dict()` always sees a quiescent
    instant — the invariant its snapshot gate checks.
  * When the thread is not running, `call()` executes inline (after the
    same settle step), so tests and the as-fast batch path share one
    code path with the live service.

Pacing detail: the deadline for simulated time t is
``wall0 + (t - sim0)/speed``.  A late deadline (slow host, long
injection) fires immediately — the driver catches up rather than
stretching simulated cadences.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable


class _Injection:
    """One queued closure plus its completion signal."""

    __slots__ = ("fn", "done", "result", "error")

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn
        self.done = threading.Event()
        self.result: Any = None
        self.error: BaseException | None = None


class WallClockDriver:
    def __init__(self, sim, *, speed: float | None = 1.0,
                 idle_poll_s: float = 0.05):
        if speed is not None and speed <= 0:
            raise ValueError(f"speed must be positive or None, got {speed}")
        self.sim = sim
        self.speed = speed
        self.idle_poll_s = idle_poll_s
        self._cond = threading.Condition()
        self._queue: list[_Injection] = []
        self._thread: threading.Thread | None = None
        self._stop = False

    # -- lifecycle -----------------------------------------------------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self):
        if self.running:
            raise RuntimeError("driver already running")
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name="pool-driver", daemon=True)
        self._thread.start()

    def stop(self, timeout: float | None = 30.0):
        """Graceful stop: the thread finishes the current timestamp group
        and drains queued injections before exiting, so the simulation is
        left quiescent (snapshot-safe)."""
        t = self._thread
        if t is None:
            return
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        t.join(timeout)
        if t.is_alive():
            raise RuntimeError("driver thread failed to stop in time")
        self._thread = None

    # -- injection -----------------------------------------------------------
    def call(self, fn: Callable[[Any], Any]) -> Any:
        """Run `fn(sim)` at the next quiescent instant and return its
        result (exceptions propagate to the caller).  Inline when the
        thread is not running."""
        if not self.running:
            self._settle()
            return fn(self.sim)
        inj = _Injection(fn)
        with self._cond:
            if self._stop:
                raise RuntimeError("driver is stopping")
            self._queue.append(inj)
            self._cond.notify_all()
        inj.done.wait()
        if inj.error is not None:
            raise inj.error
        return inj.result

    # -- event-loop mechanics ------------------------------------------------
    def _settle(self):
        """Fire every event due at or before the current simulated time —
        afterwards `loop.next_at() > sim.now` (or the heap is empty), the
        quiescence `state_dict()` requires.  A fresh simulation settles
        through its whole t=0 group here."""
        sim = self.sim
        while True:
            t = sim.loop.next_at()
            if t is None or t > sim.now:
                break
            self._fire_group(t)
        # injections may read pool state or schedule events inside a
        # deferred-negotiation window; flush any staged cycles so they
        # observe (and mutate) fully-applied claim state
        quiesce = getattr(sim, "quiesce_negotiation", None)
        if quiesce is not None:
            quiesce()

    def _fire_group(self, t: float):
        """Fire ALL events sharing timestamp `t` — injections never see a
        half-fired instant."""
        sim = self.sim
        while True:
            sim._advance_to(t)
            sim.loop.fire_next()
            nxt = sim.loop.next_at()
            if nxt is None or nxt > t:
                break
        sim.now = sim.loop.now

    def _drain_injections(self) -> bool:
        with self._cond:
            pending, self._queue = self._queue, []
        if not pending:
            return False
        self._settle()
        for inj in pending:
            try:
                inj.result = inj.fn(self.sim)
            except BaseException as e:  # propagate to the caller, not us
                inj.error = e
            finally:
                inj.done.set()
        return True

    def _idle(self) -> bool:
        """Nothing left that time itself will change: every queue drained
        and no external events pending.  Periodic timers alone don't
        count — in as-fast mode they would otherwise spin the simulated
        clock toward infinity between submissions."""
        sim = self.sim
        return sim.pool_queue.drained() and sim._external_pending == 0

    def _run(self):
        wall0 = time.monotonic()
        sim0 = self.sim.now
        while True:
            had_work = self._drain_injections()
            with self._cond:
                if self._stop and not self._queue:
                    break
            if had_work:
                continue
            t = self.sim.loop.next_at()
            if t is None or (self.speed is None and self._idle()):
                with self._cond:
                    if not self._queue and not self._stop:
                        self._cond.wait(self.idle_poll_s)
                continue
            if self.speed is not None:
                deadline = wall0 + (t - sim0) / self.speed
                late = time.monotonic() >= deadline
                if not late:
                    with self._cond:
                        if not self._queue and not self._stop:
                            self._cond.wait(min(
                                max(deadline - time.monotonic(), 0.0),
                                0.25))
                    continue   # re-check injections/stop before firing
            self._fire_group(t)
        # leave quiescent: finish the instant we stopped inside of
        self._settle()
        self._drain_injections()
