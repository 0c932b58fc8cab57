"""Discrete-event scheduler: the heap at the heart of the simulation.

The seed harness advanced in fixed ticks and rescanned a flat event list
every tick (O(events) per tick, and anything scheduled between ticks fired
up to ``tick_s`` late).  This module replaces that with a classic
discrete-event loop:

  * `schedule(at, fn)` pushes a one-shot event onto a heapq; events fire
    at their EXACT timestamp, in (time, priority, insertion) order
  * `every(interval, fn)` installs a periodic callback whose k-th firing
    is at ``first + k*interval`` — computed by multiplication, not by
    repeated addition, so neither tick quantization nor float
    accumulation can drift the cadence (the seed's
    ``_last_negotiate = now`` bug)
  * `fire_next()` pops exactly one event so the driver (simulation.py)
    can advance continuous processes — running jobs, accounting — up to
    the event's timestamp before it observes the world

Priorities order same-timestamp events deterministically; the simulation
uses them to reproduce the seed's intra-tick sequence (external events ->
reconcile -> backend ticks -> negotiate -> stragglers -> metrics).
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable

EventFn = Callable[[float], None]


class EventHandle:
    """Cancellation token for a scheduled one-shot event."""

    __slots__ = ("at", "name", "cancelled")

    def __init__(self, at: float, name: str = ""):
        self.at = at
        self.name = name
        self.cancelled = False

    def cancel(self):
        self.cancelled = True

    def __repr__(self):
        flag = " cancelled" if self.cancelled else ""
        return f"EventHandle({self.name!r}@{self.at}{flag})"


class PeriodicHandle:
    """A repeating event; firing k lands exactly at ``first + k*interval``."""

    def __init__(self, loop: "EventLoop", interval: float, fn: EventFn, *,
                 first: float = 0.0, name: str = "", priority: int = 0):
        if interval <= 0:
            raise ValueError(f"interval must be positive, got {interval}")
        self.loop = loop
        self.interval = interval
        self.fn = fn
        self.first = first
        self.name = name
        self.priority = priority
        self.k = 0
        self.cancelled = False
        self._handle: EventHandle | None = None
        self._arm()

    @property
    def next_at(self) -> float:
        return self.first + self.k * self.interval

    def _arm(self):
        self._handle = self.loop.schedule(
            self.next_at, self._fire, name=self.name,
            priority=self.priority)

    def _fire(self, now: float):
        if self.cancelled:
            return
        self.fn(now)
        if self.cancelled:      # fn cancelled its own handle: don't re-arm
            return
        self.k += 1
        self._arm()

    def cancel(self):
        self.cancelled = True
        if self._handle is not None:
            self._handle.cancel()


class EventLoop:
    """heapq-based scheduler; the simulation drives it one event at a time."""

    def __init__(self, t0: float = 0.0):
        self.now = t0
        self.fired = 0
        self._heap: list[tuple[float, int, int, EventHandle, EventFn]] = []
        self._seq = itertools.count()

    # -- scheduling ----------------------------------------------------------
    def schedule(self, at: float, fn: EventFn, *, name: str = "",
                 priority: int = 0) -> EventHandle:
        if at < self.now - 1e-9:
            raise ValueError(
                f"cannot schedule {name!r} at {at} in the past "
                f"(now={self.now})")
        handle = EventHandle(at, name)
        heapq.heappush(self._heap, (at, priority, next(self._seq),
                                    handle, fn))
        return handle

    def every(self, interval: float, fn: EventFn, *, first: float = 0.0,
              name: str = "", priority: int = 0) -> PeriodicHandle:
        return PeriodicHandle(self, interval, fn, first=first, name=name,
                              priority=priority)

    def cancel(self, handle: "EventHandle | PeriodicHandle") -> None:
        """Cancel a scheduled one-shot or periodic callback by its
        handle.  The heap entry is dropped lazily (`_skim`), so
        cancellation is O(1); a cancelled periodic never re-arms.  This
        is how a drained backend's poll timers are retired — the
        simulation retains every periodic handle it installs exactly so
        they can be cancelled here (simulation.py `_backend_timers`)."""
        handle.cancel()

    # -- draining ------------------------------------------------------------
    def _skim(self):
        """Drop cancelled events from the top of the heap."""
        while self._heap and self._heap[0][3].cancelled:
            heapq.heappop(self._heap)

    def next_at(self) -> float | None:
        """Timestamp of the earliest live event, or None."""
        self._skim()
        return self._heap[0][0] if self._heap else None

    def has_event_before(self, at: float, priority: int) -> bool:
        """True when any LIVE event would fire strictly before the slot
        ``(at, priority)`` — i.e. its key is lexicographically smaller,
        with a 1e-9 time tolerance so float jitter on equal grids counts
        as "before".  O(heap) scan, no mutation: the negotiation-
        deferral arming check (simulation.py) asks this once per
        candidate window, and ANY intervening event — an external
        submit/failure injection, a reconcile, a backend timer, even a
        same-instant lower-priority follower — vetoes deferring past
        it."""
        for t, prio, _seq, handle, _fn in self._heap:
            if handle.cancelled:
                continue
            if t < at - 1e-9 or (t <= at + 1e-9 and prio < priority):
                return True
        return False

    def fire_next(self) -> float | None:
        """Fire exactly one event at its exact timestamp; returns the
        timestamp, or None when the heap is empty."""
        self._skim()
        if not self._heap:
            return None
        at, _prio, _seq, _handle, fn = heapq.heappop(self._heap)
        self.now = max(self.now, at)
        self.fired += 1
        fn(at)
        return at

    def run_until(self, t_end: float,
                  pre: Callable[[float], None] | None = None) -> int:
        """Fire every event with ``at <= t_end`` in order; `pre(t)` runs
        before each event so continuous state can be integrated up to the
        event's timestamp.  Returns the number of events fired."""
        n = 0
        while True:
            t = self.next_at()
            if t is None or t > t_end:
                break
            if pre is not None:
                pre(t)
            self.fire_next()
            n += 1
        if t_end > self.now:
            self.now = t_end
        return n

    def __len__(self):
        return sum(1 for e in self._heap if not e[3].cancelled)
