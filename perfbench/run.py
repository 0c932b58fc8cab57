"""Runs one cell of BENCHMARK.json once and prints its result line.

  python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
      --trace <0|1>

The cell names a configuration (perfbench/configs/<config>.json) and a
traffic mix (perfbench/traffic/<traffic>.json); the traffic names its
driver (perfbench/drivers/<driver>.py), which sets the program up,
measures the window and decides ``correct`` against the plain reference.
With ``--trace 0`` the line holds the cell's end-to-end metrics, each
read from the run's record by perfbench/end_to_end/<name>.py; with
``--trace 1`` its per-layer metrics, each read by
perfbench/metrics/<name>.py.  The last line of standard output is the
JSON result; the numbers compared for ``correct`` end standard error.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")
# kernel caches at fixed places inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])

    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {cell['chips']} devices needed, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    driver = harness.load_module("drivers", traffic["driver"])
    record = driver.run(args=args, config=config, traffic=traffic,
                        t_process=T_PROCESS)

    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}", file=sys.stderr)
        return 3
    line = result_line(bench, args.workload, args.trace, record)
    line["device"] = {"platform": "gpu",
                      "kind": torch.cuda.get_device_name(0),
                      "count": cell["chips"], **line["device"]}
    print_line(line)
    return 0


def print_line(line: dict) -> None:
    """The numbers compared, each beside its limit, as the last lines of
    standard error; the result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def result_line(bench: dict, workload: str, trace: int, record: dict
                ) -> dict:
    """The result's JSON object from a driver's record: the cell's
    end-to-end metrics (``trace`` 0) or per-layer metrics (1), each read
    by its own file, a metric with nothing to read left out; the
    numbers compared for ``correct`` last."""
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in harness.metrics_for(bench, workload, kind):
        reader = harness.load_module(
            "metrics" if trace else "end_to_end", m["name"])
        value = reader.read(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = record["checks"]
    line = {"correct": bool(checks) and all(c.ok for c in checks)
            and record["correct"],
            "attempted": record["attempted"], "failed": record["failed"],
            "metrics": metrics, "device": dict(record["device"])}
    if trace and record.get("breakdown"):
        line["breakdown"] = record["breakdown"]
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                      for c in checks}
    return line


if __name__ == "__main__":
    sys.exit(main())
