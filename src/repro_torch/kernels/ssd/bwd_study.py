"""Times the SSD backward kernel of one tree of this repository by kernel,
so that two commits can be compared on one card.

Run it once for each tree, each in a process of its own, in turns (A, B,
B, A)::

    python3 src/repro_torch/kernels/ssd/bwd_study.py --root OTHER_TREE
    python3 src/repro_torch/kernels/ssd/bwd_study.py

``--root`` names the checkout whose ``chip_smoke.py`` and
``src/repro_torch`` are imported (default: this one); it prints one JSON
line per shape of that tree's ``chip_smoke.SSD_BWD_TIMED``, from that
tree's ``time_ssd_bwd`` (the routed instance checked against the plain
backward, then device time in all and by kernel), then the card's name
and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[4]))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bwd_study: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels.ssd import ops as so
    so.build_backward()
    device = torch.device("cuda", 0)
    for shape in cs.SSD_BWD_TIMED:
        row = cs.time_ssd_bwd(so, *shape, device)
        print(json.dumps({"root": str(root), "study_row": row["ssd_bwd_case"],
                          "device_ms": row["device_ms"],
                          "kernels_device_ms": row["kernels_device_ms"]}),
              flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
