"""`perfbench/spans.py` and `perfbench/trace_spans.py` on the CPU.

A tiny step under `torch.profiler`: every ``evaluate_function`` event
with a sequence number resolves to a forward span (the conv's backward
to ``mixer.conv``, the tied unembedding's to ``loss``, the SSD
function's to ``mixer.ssd``, the stacked layers' unbind to ``forward``).
A trace made by hand, since the CPU launches no kernel: each kernel
charged by its launch, each idle gap by its middle.  The study rehearsed
at the tiny size."""
import argparse
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import harness, rehearsal, spans, trace_spans


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_spans_are_the_programs():
    from repro_torch.observability.steps import SPANS
    assert set(spans.SPANS) == set(SPANS)
    assert set(spans.NORMS) <= set(SPANS)


def _profiled_step(arch, monkeypatch):
    from repro_torch.configs import reduced_config
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import model as model_lib
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (
        init_train_state, make_train_step,
    )

    def through_fn(x, dt, A, Bm, Cm, D, *, chunk=256, initial_state=None):
        return ssd_ops.SSDFn.apply(x, dt, A, Bm, Cm, D, initial_state, chunk)
    monkeypatch.setattr(ssm_mod, "ssd", through_fn)
    cfg = reduced_config(arch)
    state = init_train_state(model_lib.init_model(cfg, device="cpu"),
                             OptimizerConfig())
    step = make_train_step(cfg, OptimizerConfig(), remat="none",
                           device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 33),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.int32)
    batch = {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
    state, _ = step(state, batch)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    return prof


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-v0.1-52b"])
def test_every_backward_node_resolves_to_a_forward_span(arch, monkeypatch):
    red = spans.reduce(_profiled_step(arch, monkeypatch))
    ev = red["evaluate"]
    assert ev["events"] > 0
    assert ev["resolved"] + ev["unsequenced"] == ev["events"]
    by_node = ev["by_node"]
    # gradients captured for torch.autograd.grad: no sequence number
    assert by_node.pop("torch::autograd::AccumulateGrad") == {
        "unresolved": ev["unsequenced"]}
    assert all(set(owners) <= set(spans.SPANS)
               for owners in by_node.values())
    assert by_node["ConstantPadNdBackward0"] == {"mixer.conv": by_node[
        "ConstantPadNdBackward0"]["mixer.conv"]}
    assert "mixer.conv" in by_node["SiluBackward0"]
    assert set(by_node["SSDFnBackward"]) == {"mixer.ssd"}
    assert set(by_node["SoftplusBackward0"]) == {"mixer.dt"}
    assert set(by_node["LogsumexpBackward0"]) == {"loss"}
    assert set(by_node["GatherBackward0"]) == {"loss"}
    assert set(by_node["UnbindBackward0"]) == {"forward"}
    assert by_node["IndexBackward0"]["embed"] == 1
    if arch == "mamba2-1.3b":
        # the tied table's transpose in the unembedding: its only permute
        assert by_node["PermuteBackward0"] == {"loss": 1}
        assert set(by_node["MmBackward0"]) == {
            "loss", "mixer.in_proj", "mixer.out_proj"}
    else:
        # an in-place op's CopySlices, which no forward op records
        assert set(by_node["torch::autograd::CopySlices"]) == {"moe"}


class _Event(SimpleNamespace):
    """A kineto event as `spans.reduce` reads it."""

    def __getattr__(self, name):
        raise AttributeError(name)

    def name(self):
        return self.n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA
                if self.kind in ("kernel", "gpu_user_annotation")
                else torch.autograd.DeviceType.CPU)

    def activity_type(self):
        return self.kind

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.corr

    def start_thread_id(self):
        return self.tid

    def sequence_nr(self):
        return self.seq

    def fwd_thread_id(self):
        return self.fwd


def _ev(n, s, d, *, kind="cpu_op", tid=1, seq=-1, fwd=0, corr=0):
    return _Event(n=n, s=s, d=d, kind=kind, tid=tid, seq=seq, fwd=fwd,
                  corr=corr)


def _launch(corr, at, kernel_at, dur, name="vectorized_elementwise_kernel"):
    return [_ev("cudaLaunchKernel", at, 1, kind="cuda_runtime", tid=9,
                corr=corr),
            _ev(name, kernel_at, dur, kind="kernel", corr=corr)]


def test_kernels_and_idle_gaps_charged_by_launch_and_middle():
    """Main thread 1: forward with mixer.conv (op of sequence 5 inside),
    backward, optimizer, then the next step's forward; autograd's thread
    2 evaluates node 5 and an AccumulateGrad; the timer's gap and prepare
    lie between the steps."""
    events = [
        _ev("forward", 0, 100), _ev("mixer.conv", 10, 20),
        _ev("aten::mul", 12, 3, seq=5), *_launch(1, 15, 20, 20),
        _ev("backward", 200, 200),
        _ev("autograd::engine::evaluate_function: MulBackward0", 250, 10,
            tid=2, seq=5, fwd=1),
        _ev("MulBackward0", 251, 8, tid=2, seq=5, fwd=1),
        *_launch(2, 255, 260, 20, "void at::native::reduce_kernel<>"),
        _ev("autograd::engine::evaluate_function: "
            "torch::autograd::AccumulateGrad", 300, 5, tid=2),
        *_launch(3, 301, 302, 10, "Memcpy DtoD"),
        _ev("optimizer", 450, 50), _ev("optimizer.norm", 455, 10),
        *_launch(4, 460, 470, 50),
        _ev("forward", 655, 45), *_launch(5, 660, 670, 20, "nvjet_gemm"),
        _ev("forward", 0, 100, kind="gpu_user_annotation"),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    intervals = [(1, "gap", 520, 600, 0.08), (1, "prepare", 600, 650, 0.05)]
    red = spans.reduce(prof, intervals, steps=1)
    table = red["spans"]
    assert table["mixer.conv"]["forward_s"] == pytest.approx(20e-9)
    assert table["mixer.conv"]["backward_s"] == pytest.approx(20e-9)
    assert table["mixer.conv"]["kernels"] == 2
    assert table["mixer.conv"]["elementwise_s"] == pytest.approx(40e-9)
    assert table["backward"]["forward_s"] == pytest.approx(10e-9)
    assert table["optimizer.norm"]["forward_s"] == pytest.approx(50e-9)
    assert table["forward"]["forward_s"] == pytest.approx(20e-9)
    assert red["phases"] == pytest.approx({
        "forward": 40e-9, "backward": 30e-9, "optimizer": 50e-9,
        "outside": 0.0})
    assert red["kernels"] == 5 and red["busy_s"] == pytest.approx(120e-9)
    # gaps: 40-260 (middle 150: no span), 280-302 (291: backward),
    # 312-470 (391: backward), 520-670 (595: the timer's gap)
    assert red["idle"] == pytest.approx({
        "spans": 180e-9, "gap": 150e-9, "prepare": 0.0,
        "outside": 220e-9})
    assert table["backward"]["idle_s"] == pytest.approx(180e-9)
    assert red["evaluate"]["by_node"] == {
        "MulBackward0": {"mixer.conv": 1},
        "torch::autograd::AccumulateGrad": {"unresolved": 1}}
    got = spans.readings(red, {"between": {"device_ms": {"median": 0.13}}})
    assert got == pytest.approx({
        "forward_ms": 40e-6, "backward_ms": 30e-6, "conv_ms": 40e-6,
        "norms_ms": None, "loss_ms": None, "step_gap_ms": 0.13})


def test_readings_are_none_without_data():
    assert set(spans.readings(None, None).values()) == {None}
    assert set(spans.readings({"kernels": 0}, {}).values()) == {None}


def test_the_study_rehearsed_on_the_cpu():
    config, traffic = rehearsal.tiny("mamba2-train")
    args = argparse.Namespace(seed=2 ** 31 + 5, seconds=0.3, trace=1)
    from repro_torch.train import train_step
    make, summarise = train_step.make_train_step, harness.trace_summary
    record, added = trace_spans.traced(args, config, traffic,
                                       time.perf_counter(), device="cpu")
    assert (train_step.make_train_step, harness.trace_summary) == (
        make, summarise)
    line = trace_spans.summary_line(harness.benchmark(), "mamba2-train",
                                    record, added)
    assert line["correct"], line["checks"]
    assert set(line["readings"]) == {
        "forward_ms", "backward_ms", "conv_ms", "norms_ms", "loss_ms",
        "step_gap_ms"}
    # no kernels and no events on the CPU: nothing to read
    assert set(line["readings"].values()) == {None}
    assert line["coverage"] is None and line["idle_by_phase_ms"] is None
    ev = line["spans"]["evaluate"]
    assert ev["resolved"] + ev["unsequenced"] == ev["events"] > 0
    window = line["step_timer"]["window"]
    assert window["step"]["steps"] == record["steps"]
    assert window["between"]["host_ms"]["median"] > 0
    assert window["between"]["device_ms"] is None
    profiled = line["step_timer"]["profiled"]
    assert profiled["step"]["steps"] == traffic["profile_steps"]
    assert line["window_tokens_per_s"] > 0
