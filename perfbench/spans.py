"""The training step's device time and idle gaps charged to the program's
spans: a reduction of the same `torch.profiler` object that
`harness.trace_summary` reads, beside it.

The program labels its step with spans (`SPANS`: `repro_torch.
observability.steps`, which this file does not import, so that it reads
a program that has fewer).  `reduce` charges each kernel by its launch
(the runtime call of the same correlation id):

  * launched inside an ``autograd::engine::evaluate_function: ...``
    event (autograd's device thread, in the backward), to the forward
    span that was innermost when autograd recorded the node's forward
    op, found through the op's sequence number and forward thread
    (``sequence_nr()``, ``fwd_thread_id()``): the span's backward side;
  * otherwise to the innermost program span at the launch, on the
    launching thread where it holds one (else on any thread: the main
    thread waits in ``backward`` while autograd's thread launches): its
    forward side (its own launches; for ``backward``, those autograd
    could not charge to a forward span);
  * with no span at the launch, to ``outside``.

The phase of a kernel is the outermost of ``forward``, ``backward`` and
``optimizer`` at its launch.  Each idle gap between kernels goes to the
innermost program span the host was in at the gap's middle, on any
thread, else to the step timer's ``gap`` or ``prepare`` interval
(`StepTimer.intervals`, on the profiler's clock) that holds it, else to
``outside``.
"""
from __future__ import annotations

from bisect import bisect_right

from perfbench.harness import _annotation

#: the program's spans (`repro_torch.observability.steps.SPANS`)
SPANS = ("forward", "backward", "optimizer", "embed", "block.norm",
         "mixer.in_proj", "mixer.conv", "mixer.dt", "mixer.ssd",
         "mixer.gate_norm", "mixer.out_proj", "attn", "mlp", "moe",
         "final_norm", "loss", "optimizer.norm")
PHASES = ("forward", "backward", "optimizer")
EVALUATE = "autograd::engine::evaluate_function: "
#: the spans of the norms and of the loss (`readings`)
NORMS = ("block.norm", "mixer.gate_norm", "final_norm")
#: the names of elementwise and reduction kernels
ELEMENTWISE = ("elementwise_kernel", "reduce_kernel")


class _Nest:
    """Nested intervals ``(start, end, payload)`` of one thread: the
    stack of those holding a time, outermost first.  A child that
    outlasts its parent is cut at the parent's end."""

    def __init__(self, intervals):
        self.times, self.stacks, stack = [], [], []
        for s, e, p in sorted(intervals, key=lambda x: (x[0], -x[1])):
            while stack and stack[-1][1] <= s:
                self._pop(stack)
            if stack:
                e = min(e, stack[-1][1])
            stack.append((s, e, p))
            self._point(s, stack)
        while stack:
            self._pop(stack)

    def _pop(self, stack):
        end = stack.pop()[1]
        self._point(end, stack)

    def _point(self, t, stack):
        self.times.append(t)
        self.stacks.append(tuple(stack))

    def at(self, t) -> tuple:
        i = bisect_right(self.times, t) - 1
        return self.stacks[i] if i >= 0 else ()


class _Threads:
    """`_Nest` per thread: the innermost interval holding a time on any
    thread, and every interval holding it."""

    def __init__(self, by_thread: dict):
        self.nests = {tid: _Nest(v) for tid, v in by_thread.items()}

    def holding(self, t) -> list:
        return [x for n in self.nests.values() for x in n.at(t)]

    def innermost(self, t, tid=None):
        """On thread ``tid`` where it holds one, else on any thread."""
        held = self.nests[tid].at(t) if tid in self.nests else ()
        held = held or self.holding(t)
        return min(held, key=lambda x: x[1] - x[0]) if held else None


def _ns(e) -> tuple[int, int]:
    start = e.start_ns()
    return start, start + e.duration_ns()


def reduce(prof, intervals=(), steps: int = 1) -> dict:
    """The profiled steps' kernels and idle gaps by program span (see the
    module docstring).  ``intervals`` are the step timer's over the same
    steps (`StepTimer.intervals`).  Per span: ``forward_s`` and
    ``backward_s`` (device seconds of the kernels charged to its two
    sides), ``kernels``, ``idle_s`` and ``elementwise_s`` (the part of
    its two sides in elementwise and reduction kernels); per phase the
    device seconds launched under it; the idle gaps by owner; and how
    the backward's ``evaluate_function`` events resolved."""
    from torch.autograd import DeviceType

    kernels, launches, ops = [], {}, {}
    spans, evaluates = {}, {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name not in SPANS and not _annotation(e):
                kernels.append((*_ns(e), name, e.correlation_id()))
            continue
        tid = e.start_thread_id()
        if name in SPANS:
            spans.setdefault(tid, []).append((*_ns(e), name))
        elif name.startswith(EVALUATE):
            evaluates.setdefault(tid, []).append(
                (*_ns(e), (name[len(EVALUATE):], e.sequence_nr(),
                           e.fwd_thread_id())))
        elif name.startswith("cu"):          # the runtime's calls
            launches[e.correlation_id()] = (e.start_ns(), tid)
        elif e.sequence_nr() >= 0:
            ops.setdefault(tid, []).append((e.sequence_nr(), e.start_ns()))
    program = _Threads(spans)
    in_evaluate = _Threads(evaluates).nests
    for tid, seqs in ops.items():
        nest = in_evaluate.get(tid)
        seqs[:] = sorted(x for x in seqs if nest is None or not nest.at(x[1]))

    def forward_span(seq, fwd_tid, before):
        """The innermost span on the forward thread at the node's forward
        op: the last op before ``before`` that no ``evaluate_function``
        event holds, of the node's sequence number or, for a node no op
        records (an in-place op's ``CopySlices``), of the largest below
        it."""
        seqs = ops.get(fwd_tid, [])
        i = bisect_right(seqs, (seq, before - 1))
        nest = program.nests.get(fwd_tid)
        held = nest.at(seqs[i - 1][1]) if i and nest is not None else ()
        return held[-1][2] if held else None

    nodes = {"events": 0, "resolved": 0, "unsequenced": 0}
    by_node: dict[str, dict[str, int]] = {}
    resolved: dict = {}
    for tid, evs in evaluates.items():
        for s, u, (node, seq, fwd_tid) in evs:
            nodes["events"] += 1
            owner = None
            if seq < 0:
                nodes["unsequenced"] += 1
            else:
                owner = forward_span(seq, fwd_tid, s)
                nodes["resolved"] += owner is not None
            resolved.setdefault(tid, []).append((s, u, (node, owner)))
            got = by_node.setdefault(node, {})
            key = owner or "unresolved"
            got[key] = got.get(key, 0) + 1
    backward = _Threads(resolved)

    table: dict[str, dict] = {}

    def row(name):
        return table.setdefault(name, {"forward_s": 0.0, "backward_s": 0.0,
                                       "kernels": 0, "idle_s": 0.0,
                                       "elementwise_s": 0.0})

    for evs in spans.values():
        for _, _, name in evs:
            row(name)
    phases = {p: 0.0 for p in (*PHASES, "outside")}
    kernels.sort()
    busy, gaps, reach = 0, [], None
    for s, u, name, corr in kernels:
        dur = (u - s) * 1e-9
        at, tid = launches.get(corr, (None, None))
        owner, side, phase = "outside", "forward_s", "outside"
        if at is not None:
            prog = program.innermost(at, tid)
            ev = backward.innermost(at, tid)
            phase = next((x[2] for x in program.holding(at)
                          if x[2] in PHASES), "outside")
            if ev is not None and ev[2][1] is not None and (
                    prog is None or ev[1] - ev[0] < prog[1] - prog[0]):
                owner, side = ev[2][1], "backward_s"
            elif prog is not None:
                owner = prog[2]
        r = row(owner)
        r[side] += dur
        r["kernels"] += 1
        if any(k in name for k in ELEMENTWISE):
            r["elementwise_s"] += dur
        phases[phase] += dur
        if reach is None or s > reach:
            if reach is not None:
                gaps.append((reach, s))
            busy += u - s
            reach = u
        elif u > reach:
            busy += u - reach
            reach = u

    timer = _Threads({"timer": [(t0, t1, phase) for _, phase, t0, t1, _
                                in intervals
                                if phase in ("gap", "prepare")]})
    idle = {"spans": 0.0, "gap": 0.0, "prepare": 0.0, "outside": 0.0}
    for a, b in gaps:
        mid, dur = (a + b) // 2, (b - a) * 1e-9
        prog = program.innermost(mid)
        if prog is not None:
            row(prog[2])["idle_s"] += dur
            idle["spans"] += dur
            continue
        between = timer.innermost(mid)
        idle[between[2] if between is not None else "outside"] += dur
    return {"steps": steps, "busy_s": busy * 1e-9, "kernels": len(kernels),
            "spans": table, "phases": phases, "idle": idle,
            "evaluate": {**nodes, "by_node": by_node}}


def readings(spans: dict | None, step_timer: dict | None) -> dict:
    """The per-layer readings of a traced run from its span reduction
    (`reduce`) and its window's timer summary (`StepTimer.summary`), in
    ms a step; each None where its data is absent."""
    out = dict.fromkeys(("forward_ms", "backward_ms", "conv_ms",
                         "norms_ms", "loss_ms", "step_gap_ms"))
    if spans and spans["kernels"]:
        per = 1e3 / spans["steps"]
        table = spans["spans"]

        def both(*names):
            got = [table[n] for n in names if n in table]
            if not got:
                return None
            return per * sum(r["forward_s"] + r["backward_s"] for r in got)
        if "forward" in table:
            out["forward_ms"] = per * spans["phases"]["forward"]
        if "backward" in table:
            out["backward_ms"] = per * spans["phases"]["backward"]
        out.update(conv_ms=both("mixer.conv"), norms_ms=both(*NORMS),
                   loss_ms=both("loss"))
    between = (step_timer or {}).get("between") or {}
    if between.get("device_ms"):
        out["step_gap_ms"] = between["device_ms"]["median"]
    return out
