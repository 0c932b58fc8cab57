"""The training step's program spans and its phase timer.

`span(name)` labels a stretch of the program for `torch.profiler`.
While a profiler collects it enters `torch.profiler.record_function`
under ``name``; otherwise it returns one shared no-op context, so a step
run without a profiler pays one call and one test a span.  The spans of
a training step, each with the span it lies in (`SPANS`):

  forward            the loss's forward (`train.train_step`)
    embed            the input embedding (`models.model._input_embeds`)
    block.norm       a block's norms (`models.transformer`)
    mixer.in_proj    the SSD mixer's input projection and its split
    mixer.conv       the causal depthwise conv and its SiLU
    mixer.dt         softplus of dt, -exp(A_log)
    mixer.ssd        the scan (`kernels.ssd.ssd`)
    mixer.gate_norm  the gated RMS norm
    mixer.out_proj   the output projection
    attn, mlp, moe   an attention, MLP or MoE sublayer, whole
    final_norm       the final norm (`models.model._forward`)
    loss             the unembedding, log-sum-exp, CE and z-loss
  backward           `torch.autograd.grad`: the main thread waits in it
                     while autograd's device thread launches the kernels
  optimizer          `adamw_update`
    optimizer.norm   the gradients' global norm and the clip factor

What the forward computes outside a sublayer span (the residual adds,
the stacked layers' unbind) stays with ``forward``.  A backward kernel
is charged to the forward span whose op made its autograd node through
the profiler's sequence numbers (`perfbench/spans.py`).

`StepTimer` times the phases of steps run without a profiler: at each
boundary the step marks it with one CUDA event on the current stream
and one host stamp on the clock the profiler stamps its events with
(`time.time_ns`: Unix-epoch nanoseconds), and nothing is read until
`StepTimer.summary` or `StepTimer.intervals`.
"""
from __future__ import annotations

import contextlib
import statistics
import time

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

#: every span of a training step, and the span it lies in
SPANS = {
    "forward": None, "backward": None, "optimizer": None,
    "embed": "forward", "block.norm": "forward",
    "mixer.in_proj": "forward", "mixer.conv": "forward",
    "mixer.dt": "forward", "mixer.ssd": "forward",
    "mixer.gate_norm": "forward", "mixer.out_proj": "forward",
    "attn": "forward", "mlp": "forward", "moe": "forward",
    "final_norm": "forward", "loss": "forward",
    "optimizer.norm": "optimizer",
}

_OFF = contextlib.nullcontext()


def span(name: str):
    """``record_function(name)`` while a profiler collects, else a shared
    no-op context."""
    if _profiler_enabled():
        return record_function(name)
    return _OFF


#: the phase each boundary opens; "end" opens the gap to the next step
PHASE_OF = {"entry": "prepare", "forward": "forward",
            "backward": "backward", "optimizer": "optimizer",
            "end": "gap"}
PHASES = ("gap", "prepare", "forward", "backward", "optimizer")


def _quartiles(values: list) -> dict | None:
    if not values:
        return None
    if len(values) == 1:
        return {"median": values[0], "q1": values[0], "q3": values[0]}
    q1, med, q3 = statistics.quantiles(values, n=4, method="inclusive")
    return {"median": med, "q1": q1, "q3": q3}


class StepTimer:
    """Phase boundaries of training steps (`make_train_step`'s
    ``timer``).  A step marks "entry", then "forward" and "backward" for
    each microbatch, "optimizer" and "end"; the interval from a boundary
    to the next belongs to the phase it opens (`PHASE_OF`): prepare
    (the batch moved to the device), forward, backward (the gradients,
    their accumulation over microbatches, and the learning rate's scalar
    kernels), optimizer, and the gap from one step's end to the next
    step's entry.  On CPU tensors no event is recorded and the device
    fields are None."""

    def __init__(self):
        self.steps: list[list[tuple[str, int, torch.cuda.Event | None]]] = []

    def mark(self, boundary: str, device: torch.device) -> None:
        if boundary == "entry":
            self.steps.append([])
        stamp = time.time_ns()
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event(enable_timing=True)
            event.record(torch.cuda.current_stream(device))
        self.steps[-1].append((boundary, stamp, event))

    def intervals(self, first: int = 0, last: int | None = None) -> list:
        """(step, phase, host start ns, host end ns, device ms or None) of
        steps ``first`` to ``last``; a step's gap is the one before it,
        left out for the first step of the stretch.  Waits for the
        device."""
        steps = self.steps[first:last]
        if any(e is not None for s in steps for _, _, e in s):
            torch.cuda.synchronize()
        out = []
        for i, marks in enumerate(steps):
            if i:
                marks = [self.steps[first + i - 1][-1], *marks]
            for (b, t0, e0), (_, t1, e1) in zip(marks, marks[1:]):
                ms = e0.elapsed_time(e1) if e0 is not None else None
                out.append((first + i, PHASE_OF[b], t0, t1, ms))
        return out

    def summary(self, first: int = 0, last: int | None = None) -> dict:
        """Per phase, over steps ``first`` to ``last``: the median and
        quartiles of its device ms (from the events) and host ms (from
        the stamps), a step's microbatches summed; also ``step`` (entry
        to end) and ``between`` (gap and prepare: one step's end to the
        next step's forward)."""
        per: dict[int, dict[str, list]] = {}
        for step, phase, t0, t1, ms in self.intervals(first, last):
            got = per.setdefault(step, {}).setdefault(phase, [0.0, 0.0])
            got[0] += (t1 - t0) * 1e-6
            got[1] = None if ms is None or got[1] is None else got[1] + ms
        for phases in per.values():
            phases["step"] = _total(phases, ("prepare", "forward",
                                             "backward", "optimizer"))
            if "gap" in phases:
                phases["between"] = _total(phases, ("gap", "prepare"))
        out = {}
        for name in (*PHASES, "step", "between"):
            rows = [p[name] for p in per.values() if name in p]
            device = [d for _, d in rows if d is not None]
            out[name] = {"host_ms": _quartiles([h for h, _ in rows]),
                         "device_ms": _quartiles(device)
                         if len(device) == len(rows) else None,
                         "steps": len(rows)}
        return out


def _total(phases: dict, names: tuple) -> list:
    rows = [phases[n] for n in names if n in phases]
    device = [d for _, d in rows]
    return [sum(h for h, _ in rows),
            None if None in device else sum(device)]


__all__ = ["SPANS", "span", "StepTimer", "PHASES", "PHASE_OF"]
