"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import ast
import json
import re
from pathlib import Path

import pytest

from perfbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    n = len(BENCH["workloads"])
    # the check's cost with 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= n <= 24 and len(json.dumps(BENCH)) < 64 * 1024
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, n // 4)


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + METRICS, ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in entry.get("reduced", []):
        assert NAME.match(k)
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in (
            "lower", "higher")
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k] \
                and "\t" not in entry[k]


def test_unique_names():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert entry["file"] == f"perfbench/configs/{cell['config']}.json"
    assert config["name"] == cell["config"]
    assert set(entry["reduced"]) == set(config["reduced"])
    assert config["source"] and config["assumed"] is not None
    assert (harness.BENCH / "drivers" / f"{traffic['driver']}.py").exists()
    e2e = [m["name"] for m in harness.metrics_for(BENCH, cell["name"],
                                                  "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_for(BENCH, cell["name"], "per_layer")
    for m in e2e:
        assert hasattr(harness.load_module("end_to_end", m), "read")


@pytest.mark.parametrize("metric", BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_per_layer_metric_file_and_its_cells(metric):
    mod = harness.load_module("metrics", metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES, mod.WORKLOADS) == (
        metric["layer"], metric["unit"], metric["source"], metric["moves"],
        metric["workloads"])
    for w in metric["workloads"]:
        reports = [m["name"] for m in harness.metrics_for(BENCH, w,
                                                          "end_to_end")]
        assert metric["moves"] in reports


def test_one_layer_name_a_layer():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(harness.BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(harness.BENCH)))
def test_no_jax_and_a_reference_of_its_own(path):
    tops = {m.split(".", 1)[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    assert "benchmarks" not in tops
    if path.parent.name in ("reference", "work"):
        assert "repro_torch" not in tops


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.models", "jaxtyping", "torch"]) == []
    assert harness.forbidden_modules(
        ["repro_torch", "repro.core", "jax.numpy", "flax"]) == [
        "flax", "jax", "repro"]
