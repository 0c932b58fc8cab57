"""The training step's program spans and phase timer
(`repro_torch.observability.steps`).  Imports nothing of JAX, so the card
test runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_steps.py

On the CPU: a tiny step under `torch.profiler` shows every span of the
step, each inside the span `SPANS` names (an SSD stack, and jamba for the
attention, MLP and MoE sublayers); without a profiler `span` enters no
``record_function``; `StepTimer` marks every phase of every step (the
microbatches' forward and backward under accumulation) with host stamps
and no device fields; a step with a timer leaves the same bits as one
without.  On the card: the timer's host stamps of profiled steps against
the profiler's own stamps of the program spans that open at the same
boundaries, and the events' phase sum against the host's step time.
"""
import statistics
import time

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.models import model as model_lib
from repro_torch.models.param import tree_leaves
from repro_torch.observability import steps
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import init_train_state, make_train_step

BOUNDARIES = ["entry", "forward", "backward", "optimizer", "end"]


def _setup(arch, device="cpu", *, timer=None, accum_steps=1, cfg=None,
           batch=2, seq=32, seed=0):
    cfg = cfg or reduced_config(arch)
    params = model_lib.init_model(cfg, seed=seed, device=device)
    state = init_train_state(params, OptimizerConfig())
    step = make_train_step(cfg, OptimizerConfig(), remat="none",
                           accum_steps=accum_steps, device=device,
                           timer=timer)
    gen = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=gen,
                        dtype=torch.int32)
    return state, step, {"tokens": ids[:, :-1].to(device),
                         "labels": ids[:, 1:].to(device)}


def _span_events(prof) -> list:
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
             e.start_thread_id())
            for e in prof.profiler.kineto_results.events()
            if e.name() in steps.SPANS
            and e.device_type() == torch.autograd.DeviceType.CPU]


def _parent(ev, events):
    s, u, _, tid = ev
    holding = [x for x in events if x is not ev and x[3] == tid
               and x[0] <= s and u <= x[1]]
    return min(holding, key=lambda x: x[1] - x[0])[2] if holding else None


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,extra", [
    ("mamba2-1.3b", ()),
    ("jamba-v0.1-52b", ("attn", "mlp", "moe")),
])
def test_a_profiled_step_shows_every_span_nested_as_the_table_says(
        arch, extra):
    state, step, batch = _setup(arch)
    state, _ = step(state, batch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    events = _span_events(prof)
    want = {n for n, parent in steps.SPANS.items()
            if n not in ("attn", "mlp", "moe")} | set(extra)
    assert {name for _, _, name, _ in events} == want
    for ev in events:
        assert _parent(ev, events) == steps.SPANS[ev[2]], ev[2]
    count = {n: sum(e[2] == n for e in events) for n in want}
    assert count["forward"] == count["backward"] == count["optimizer"] == 1
    assert count["loss"] == 2                   # the unembedding, the CE
    cfg = reduced_config(arch)
    ssd_layers = sum(cfg.mixer_kind(i % cfg.period) == "ssm"
                     for i in range(cfg.n_layers))
    assert count["mixer.conv"] == count["mixer.ssd"] == ssd_layers


def test_span_enters_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    monkeypatch.setattr(steps, "record_function",
                        lambda name: entered.append(name) or steps._OFF)
    assert steps.span("forward") is steps._OFF
    with steps.span("forward"):
        pass
    assert entered == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with steps.span("forward"):
            pass
    assert entered == ["forward"]


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_step_timer_on_cpu_marks_every_phase_of_every_step(accum_steps):
    timer = steps.StepTimer()
    state, step, batch = _setup("mamba2-1.3b", timer=timer,
                                accum_steps=accum_steps)
    for _ in range(3):
        state, _ = step(state, batch)
    micro = ["forward", "backward"] * accum_steps
    want = ["entry", *micro, "optimizer", "end"]
    assert [[b for b, _, _ in s] for s in timer.steps] == [want] * 3
    stamps = [t for s in timer.steps for _, t, _ in s]
    assert stamps == sorted(stamps)
    assert all(e is None for s in timer.steps for _, _, e in s)
    intervals = timer.intervals()
    assert all(ms is None for *_, ms in intervals)
    assert [p for i, p, *_ in intervals if i == 1] == [
        "gap", "prepare", *micro, "optimizer"]
    summary = timer.summary()
    for phase in (*steps.PHASES, "step", "between"):
        assert summary[phase]["host_ms"]["median"] >= 0
        assert summary[phase]["device_ms"] is None
        assert summary[phase]["steps"] == (2 if phase in ("gap", "between")
                                           else 3)
    # a step's microbatches are summed into its phases
    host = {p: sum((t1 - t0) * 1e-6 for i, q, t0, t1, _ in intervals
                   if i == 0 and q == p) for p in ("forward", "backward")}
    one = timer.summary(0, 1)
    for p in ("forward", "backward"):
        assert one[p]["host_ms"]["median"] == pytest.approx(host[p])
    assert timer.summary(1)["gap"]["steps"] == 1


def test_a_timer_leaves_the_state_bitwise_the_same():
    states = []
    for timer in (None, steps.StepTimer()):
        state, step, batch = _setup("mamba2-1.3b", timer=timer)
        for _ in range(2):
            state, _ = step(state, batch)
        states.append(state)
    plain, timed = states
    for a, b in zip(tree_leaves({"p": plain.params, "o": plain.opt}),
                    tree_leaves({"p": timed.params, "o": timed.opt})):
        assert torch.equal(a, b)
    assert torch.equal(plain.step, timed.step)


@pytest.mark.cuda
def test_timer_stamps_on_the_profilers_clock_on_the_card():
    """A mamba2 step at full width with 4 layers, bf16, 8 x 512: the host
    stamps of 3 profiled steps within 0.1 ms (median) of the profiler's
    stamps of the spans that open or close at the same boundary (entry:
    the test's own label around the call), and the device phases of 5
    unprofiled steps, each ending in a synchronise, within 1 % of the
    host's step time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config("mamba2-1.3b"), n_layers=4)
    timer = steps.StepTimer()
    state, step, batch = _setup(None, "cuda", timer=timer, cfg=cfg,
                                batch=8, seq=512)
    for _ in range(3):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    device = [ms for _, ms in _step_device_ms(timer, len(timer.steps) - 5)]
    gaps = [abs(d - h) / h for d, h in zip(device, host)]
    first = len(timer.steps)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            with torch.profiler.record_function("test.step"):
                state, _ = step(state, batch)
            torch.cuda.synchronize()
    mirrors = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU and e.name() in (
                "test.step", "forward", "backward", "optimizer"):
            mirrors.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    at = {"entry": ("test.step", 0), "forward": ("forward", 0),
          "backward": ("backward", 0), "optimizer": ("optimizer", 0),
          "end": ("optimizer", 1)}
    diffs = []
    for k, marks in enumerate(timer.steps[first:]):
        for boundary, stamp, _ in marks:
            name, side = at[boundary]
            diffs.append(abs(stamp - sorted(mirrors[name])[k][side]) * 1e-6)
    print(f"stamps against the profiler's: median {statistics.median(diffs)}"
          f" ms, largest {max(diffs)} ms; phase sums against the host's "
          f"step: {gaps}")
    assert statistics.median(diffs) <= 0.1
    assert max(gaps) <= 0.01


def _step_device_ms(timer, first):
    """(step, device ms from entry to end) of steps from ``first``."""
    per = {}
    for i, phase, _, _, ms in timer.intervals(first):
        if phase != "gap":
            per[i] = per.get(i, 0.0) + ms
    return sorted(per.items())
