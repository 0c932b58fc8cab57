"""A traced run of a training cell with the program's step timer and
its span reduction: what the cell's traced run records once its driver
passes the timer itself.

  python3 perfbench/trace_spans.py --workload <name> --seed <n> \\
      --seconds <s> [--out FILE]

Runs the cell's driver as ``run.py --trace 1`` does, with two changes
made from outside it: the program's step is built with an
`observability.steps.StepTimer` (so the check steps, the window and the
profiled steps all mark their phases), and the profiler object is also
reduced by `perfbench.spans.reduce` over the profiled steps' timer
intervals.  Prints one JSON line (and writes it to ``--out``): the
readings (`spans.readings`), the coverage of the profiled steps by the
program's spans (`coverage`), the span table, the timer's summaries of
the window and of the profiled steps, the device's idle in each phase
(`idle_by_phase`), the window's tokens per second with the timer on,
the profiled stretch's busy and window seconds, the cell's own per-layer
metrics and its checks.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from unittest import mock  # noqa: E402

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from perfbench import harness, spans  # noqa: E402
from perfbench.run import result_line  # noqa: E402

#: spans that are not a sublayer of the forward
PHASE_SPANS = ("forward", "backward", "optimizer", "optimizer.norm")


def traced(args, config: dict, traffic: dict, t_process: float,
           device: str = "cuda") -> tuple[dict, dict]:
    """(the driver's record, what the timer and the span reduction add)
    of one traced run of the cell ``config`` x ``traffic``."""
    from repro_torch.observability.steps import StepTimer
    from repro_torch.train import train_step

    timer, added = StepTimer(), {}
    make, summarise = train_step.make_train_step, harness.trace_summary

    def with_timer(*a, **kw):
        return make(*a, timer=timer, **kw)

    def also_reduce(prof, labels, window_s):
        n = traffic["profile_steps"]
        first = len(timer.steps) - n
        added["spans"] = spans.reduce(prof, timer.intervals(first), steps=n)
        added["step_timer"] = {
            "window": timer.summary(traffic["check_steps"], first),
            "profiled": timer.summary(first)}
        return summarise(prof, labels, window_s)

    driver = harness.load_module("drivers", traffic["driver"])
    with mock.patch.object(train_step, "make_train_step", with_timer), \
            mock.patch.object(harness, "trace_summary", also_reduce):
        record = driver.run(args=args, config=config, traffic=traffic,
                            t_process=t_process, device=device)
    return record, added


def coverage(red: dict) -> dict:
    """Shares of the profiled steps' device and idle time by owner."""
    phases, table = red["phases"], red["spans"]
    total = sum(phases.values())
    idle = sum(red["idle"].values())
    sub = sum(r["forward_s"] + r["backward_s"] for n, r in table.items()
              if n in spans.SPANS and n not in PHASE_SPANS)
    named = sum(r["elementwise_s"] for n, r in table.items()
                if n in spans.SPANS and n not in ("forward", "backward"))
    elementwise = sum(r["elementwise_s"] for r in table.values())

    def share(a, b):
        return a / b if b else None
    return {
        "phases_of_kernel_time": share(total - phases["outside"], total),
        "outside_of_kernel_time": share(phases["outside"], total),
        "sublayers_of_forward_backward": share(
            sub, phases["forward"] + phases["backward"]),
        "elementwise_named": share(named, elementwise),
        "idle_outside": share(red["idle"]["outside"], idle),
        "kernel_s_over_busy_s": share(total, red["busy_s"]),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    args.trace = 1
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    record, added = traced(args, config, traffic, T_PROCESS)
    out = summary_line(bench, args.workload, record, added)
    import torch
    out["device"]["kind"] = torch.cuda.get_device_name(0)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0


def idle_by_phase(red: dict, window: dict) -> dict:
    """Per phase, ms a step: the window's device time by the timer's
    events less the profiled steps' kernel time launched under it (the
    device's idle in the phase, without the profiler's stretch)."""
    out = {}
    for phase in spans.PHASES:
        got = window[phase]["device_ms"]
        if got is not None:
            out[phase] = got["median"] - 1e3 * red["phases"][phase] / red[
                "steps"]
    return out


def summary_line(bench: dict, workload: str, record: dict,
                 added: dict) -> dict:
    line = result_line(bench, workload, 1, record)
    red = added.get("spans")
    window = added.get("step_timer", {}).get("window")
    kernels = bool(red and red["kernels"])
    return {
        "readings": spans.readings(red, window),
        "coverage": coverage(red) if kernels else None,
        "idle_by_phase_ms": idle_by_phase(red, window) if kernels else None,
        "window_tokens_per_s": record["steps"] * record["tokens_per_step"]
        / record["window_s"],
        "window_steps": record["steps"],
        "correct": line["correct"], "metrics": line["metrics"],
        "device": line["device"], "checks": line["checks"],
        **added}


if __name__ == "__main__":
    sys.exit(main())
