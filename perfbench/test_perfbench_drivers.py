"""The training driver rehearsed at a tiny size on the CPU: a well-formed
result line, and ``correct`` false when the timed path is broken
underneath (the faults the cell can have) or the float8 control takes
its place.  The control at the cell's own size runs on the card only."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench import harness, rehearsal

BENCH = harness.benchmark()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _well_formed(line: dict, workload: str, trace: int):
    json.dumps(line)
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert list(line)[-1] == "checks" and line["checks"]
    kind = "per_layer" if trace else "end_to_end"
    names = {m["name"] for m in harness.metrics_for(BENCH, workload, kind)}
    assert set(line["metrics"]) <= names
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert "memory_peak_bytes" in line["device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", ["mamba2-train"])
def test_rehearsal_prints_a_well_formed_line(workload, trace):
    record, line = rehearsal.rehearse(workload, trace=trace)
    _well_formed(line, workload, trace)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    if not trace:
        assert {"setup_s"} < set(line["metrics"])


@pytest.mark.parametrize("workload,fault", [
    ("mamba2-train", "half"),         # half the batch left out
    ("mamba2-train", "unchanged"),    # a step that returns its state
])
def test_a_broken_timed_path_is_not_correct(workload, fault):
    record, line = rehearsal.rehearse(workload, fault=fault)
    assert not line["correct"], line["checks"]


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload",
         "mamba2-train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 32 + 17, 7])
def test_the_control_in_the_programs_place_is_not_correct(seed):
    """The float8 reference's readings go through the run's own checks
    and result line, and fail one of the limits."""
    record, line = rehearsal.rehearse("mamba2-train", seed=seed,
                                      control=True)
    _well_formed(line, "mamba2-train", 0)
    assert not line["correct"], line["checks"]
    limits = record["config"]["limits"]["train"]
    assert all(record["program_gaps"][k] <= v for k, v in limits.items())


def test_idle_share_divides_by_the_untraced_step():
    reader = harness.load_module("metrics", "idle_share.train")
    record = {"profile": {"busy_s": 1.152, "kernels": 10},
              "profile_steps": 3, "window_s": 51.3, "steps": 128}
    step = 51.3 / 128
    assert reader.read(record) == pytest.approx(100 * (1 - 0.384 / step))
    assert reader.read({"profile": None}) is None


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mamba2-train"])
def test_the_control_fails_a_limit_at_the_cells_size(workload):
    """At the cell's own size, on three seeds: the float8 control in the
    program's place reads ``correct`` false through the run's checks and
    result line, while the program's own readings pass every limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    seeds = ["2718281897", "2718281898", "2718281899"]
    proc = subprocess.run(
        [sys.executable, str(harness.BENCH / "control.py"), "--workload",
         workload, "--seeds", *seeds, "--seconds", "1"],
        capture_output=True, text=True, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(x) for x in proc.stdout.strip().splitlines()]
    assert len(lines) == len(seeds)
    for line in lines:
        _well_formed(line, workload, 0)
        assert not line["correct"], line["checks"]
    config = harness.load_json("configs", harness.cell(
        BENCH, workload)["config"])
    limits = config["limits"]["train"]
    programs = [json.loads(x.split(" program ", 1)[1])
                for x in proc.stderr.splitlines() if " program " in x]
    assert len(programs) == len(seeds)
    assert all(p[k] <= v for p in programs for k, v in limits.items())
