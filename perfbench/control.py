"""The control runs of a cell: the run's whole check, with the plain
reference computed in float8 put in the program's place, on several
seeds in one process.  Each seed's result line (built as a run's is)
has to read ``correct`` false.

  python3 perfbench/control.py --workload <name> --seeds 11 12 13 \\
      --seconds <s>

Prints one result line per seed; the program's own readings on the same
seed go to standard error.  The benchmark's own runs never run this.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402
from perfbench.run import print_line, result_line  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("perfbench: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark()
    cell = harness.cell(bench, args.workload)
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    driver = harness.load_module("drivers", traffic["driver"])
    t = T_PROCESS
    for seed in args.seeds:
        run_args = argparse.Namespace(seed=seed, seconds=args.seconds,
                                      trace=0, control=True)
        rec = driver.run(args=run_args, config=config, traffic=traffic,
                         t_process=t)
        print(f"seed {seed} program {json.dumps(rec.get('program_gaps'))}",
              file=sys.stderr)
        print_line(result_line(bench, args.workload, 0, rec))
        del rec
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
