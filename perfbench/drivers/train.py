"""Training driver: the program's train step (`make_train_step`, AdamW)
back to back on batches made from the seed, closed loop.

Set-up makes the weights on the device from the seed, builds the train
state and the step once, and drives that same step through its first
``check_steps`` steps, on batches whose rows all differ; those steps
warm every kernel, and the program's readings for ``correct`` are taken
from them (each step's loss, the first moment after one step, the
parameters' change).  The window then runs the same step on, each step
ending in a synchronise, and closes at the end of the first step that
ends ``--seconds`` after it opened.  With ``--trace 1`` ``profile_steps``
more steps run under `torch.profiler` after the window.

``correct``: `perfbench.reference.train_check` runs the same steps from
the same weights and batches, after the program's state is freed.  With
``args.control`` set, the reference's own steps in float8
(`perfbench.control`) take the program's place in the comparison.
"""
from __future__ import annotations

import gc
import time

import torch

from perfbench import harness, weights
from perfbench.reference import train_check

LABELS = ("train.step", "forward", "optimizer")


def batches(traffic: dict, seed: int, vocab: int, device) -> list:
    """``pool`` batches of (tokens, labels), uniform ids from the seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(weights.leaf_seed(seed, "batches", 0))
    B, S = traffic["batch"], traffic["seq"]
    ids = torch.randint(0, vocab, (traffic["pool"], B, S + 1),
                        generator=gen, device=device, dtype=torch.int64)
    return [{"tokens": t[:, :-1].to(torch.int32),
             "labels": t[:, 1:].to(torch.int32)} for t in ids]


def _leaf_items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaf_items(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _by_leaf(tree, fn) -> dict:
    """``fn`` of every layer slice (``path[i]``) of a stacked tree."""
    out = {}
    for path, t in _leaf_items(tree):
        if path.startswith("stack."):
            for i in range(t.shape[0]):
                out[f"{path}[{i}]"] = fn(path, i, t[i])
        else:
            out[path] = fn(path, -1, t)
    return out


def run(*, args, config, traffic, t_process, device="cuda") -> dict:
    from repro_torch.models import model as model_lib
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (
        init_train_state, make_train_step,
    )

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = harness.program_config(config)
    params = weights.program_tree(model_lib.leaf_tree(cfg), args.seed, dev)
    opt_cfg = OptimizerConfig(**traffic["optimizer"])
    state = init_train_state(params, opt_cfg)
    del params
    step_fn = make_train_step(cfg, opt_cfg, remat=traffic["remat"],
                              lr_kwargs=traffic["lr"], device=dev)
    pool = batches(traffic, args.seed, cfg.vocab_size, dev)

    # the first steps: warm-up, and the program's readings
    losses, grad_norms = [], None
    b1 = opt_cfg.b1
    fault = getattr(args, "fault", None)
    for i in range(traffic["check_steps"]):
        if fault == "half":        # the check's own test: rows left out
            half = traffic["batch"] // 2
            state, m = step_fn(state, {k: v[:half]
                                       for k, v in pool[i].items()})
        elif fault == "unchanged":  # a step that returns its state
            copy = init_train_state(_clone(state.params), opt_cfg)
            m = step_fn(copy, pool[i])[1]
            del copy
        else:
            state, m = step_fn(state, pool[i])
        losses.append(float(m["loss"]))
        if i == 0:
            grad_norms = _by_leaf(state.opt["mu"], lambda p, j, t: float(
                t.float().norm()) / (1 - b1))
    changes = _by_leaf(state.params, lambda p, j, t: float(
        (t.float() - weights.draw(args.seed, p, j, t.shape, t.dtype,
                                  dev).float()).norm()))
    sync()
    t_open = time.perf_counter()
    setup_s = t_open - t_process
    ends, i = [], traffic["check_steps"]
    while True:
        state, _ = step_fn(state, pool[i % len(pool)])
        sync()
        ends.append(time.perf_counter() - t_open)
        i += 1
        if ends[-1] >= args.seconds:
            break
    record = {"setup_s": setup_s, "window_s": ends[-1],
              "steps": len(ends), "step_ends": ends,
              "tokens_per_step": traffic["batch"] * traffic["seq"],
              "config": config, "traffic": traffic,
              "attempted": len(ends), "failed": 0, "device": {}}
    if args.trace:
        prof = torch.profiler.profile(activities=harness.activities(cuda))
        prof.start()
        p0 = time.perf_counter()
        for _ in range(traffic["profile_steps"]):
            with torch.profiler.record_function("train.step"):
                state, _ = step_fn(state, pool[i % len(pool)])
                sync()
            i += 1
        p1 = time.perf_counter()
        prof.stop()
        summary = harness.trace_summary(prof, LABELS, p1 - p0)
        del prof
        record["profile"] = summary
        record["profile_steps"] = traffic["profile_steps"]
        record["device"].update(busy_s=summary["busy_s"],
                                window_s=summary["window_s"])
        record["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    sync()
    record["device"]["memory_peak_bytes"] = int(
        torch.cuda.max_memory_allocated(dev) if cuda else 0)

    # -- correct: the reference's three steps ------------------------------
    del state, step_fn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    feed = [(b["tokens"], b["labels"])
            for b in pool[:traffic["check_steps"]]]
    ref = train_check.readings(config, traffic, args.seed, feed, dev)
    gaps = train_check.compare({"losses": losses, "grad_norms": grad_norms,
                                "changes": changes}, ref)
    limits = config["limits"]["train"]
    record["gaps"] = gaps
    if getattr(args, "control", False):
        # the reference in a lower precision in the program's place:
        # its readings, not the program's, are the ones compared
        low = train_check.readings(config, traffic, args.seed, feed, dev,
                                   prec="fp8")
        record["program_gaps"] = gaps
        record["gaps"] = gaps = train_check.compare(low, ref)
    record["checks"] = [harness.Check(k, gaps[k], limits[k])
                        for k in ("grad_gap", "change_gap")]
    record["correct"] = True
    return record
