"""Why `torch.profiler` read no device events in the flash phase of
`chip_smoke.py` runs that had run the water-fill phase first, in the
same process.  Run on the card from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.waterfill.study [NAME ...]

Each study (all of them, or those named) runs in a process of its own;
one JSON line per row, then the card's name and power limit.  The port
never imports this module.

* ``sessions``: SESSIONS profiler sessions one after another, each
  around one matmul and one water-fill launch: the CUDA events each
  session reads, and the first session that reads none (a cap on
  sessions a process can open would show here).
* ``phase``: `chip_smoke.py`'s water-fill phase as the smoke runs it
  (its cases on both instances, cycles and candidates, the four days,
  the breakdown), with a probe session around one matmul before it and
  after each piece: the first piece after which the probe reads no
  device event.
* ``launches``: a probe, then STEP launches of a one-element add between
  probes, up to TOTAL: whether many kernel launches in one process, with
  sessions between them, stop the probe reading events.
* ``stretch``: a probe, then stretches of 100k, 200k, 400k and 800k
  launches with a probe after each: whether a long stretch without a
  session does.
* ``unarmed``: the same stretches in a process that opens no session
  before the first: whether the session before them is what arms it.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[4]
SESSIONS = 200
STEP, TOTAL = 25_000, 1_000_000
STRETCHES = (100_000, 200_000, 400_000, 800_000)


def _events(prof) -> tuple[int, float]:
    """(CUDA events, their device time in ms) of a finished session."""
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.count for e in ev),
            sum(e.self_device_time_total for e in ev) / 1e3)


def _probe(x: torch.Tensor) -> tuple[int, float]:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        x @ x
        torch.cuda.synchronize()
    return _events(prof)


def sessions() -> None:
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.matchmaker import MatchProblem, TorchMatchmaker
    from repro_torch.kernels.waterfill import ops

    rng = np.random.default_rng(0)
    C, W, R = 512, 128, 6
    req = np.zeros((C, R))
    req[:, 0] = rng.integers(1, 5, C)
    free = np.zeros((W, R))
    free[:, 0] = rng.integers(8, 65, W)
    p = MatchProblem(keys=[(0, c) for c in range(C)], requests=req,
                     demand=rng.integers(1, 40, C).astype(np.int64),
                     order=rng.permutation(C).astype(np.int64), free=free,
                     capacity=free.copy(), compat=rng.random((C, W)) < 0.9)
    args, _ = TorchMatchmaker().kernel_inputs(p)
    x = torch.randn(256, 256, device="cuda")
    ops.waterfill_solve(**args)
    counts, first_empty = [], None
    for i in range(SESSIONS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            x @ x
            ops.waterfill_solve(**args)
            torch.cuda.synchronize()
        n, _ms = _events(prof)
        counts.append(n)
        if n == 0 and first_empty is None:
            first_empty = i + 1
    print(json.dumps({"study": "sessions", "sessions": SESSIONS,
                      "first_empty_session": first_empty,
                      "empty_sessions": counts.count(0),
                      "events_per_session": sorted(set(counts))}),
          flush=True)


def phase() -> None:
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    x = torch.randn(256, 256, device="cuda")
    pieces = []

    def after(row: dict) -> None:
        label = next((f"{k}={row[k]}" for k in (
            "case", "cycles_case", "preview_case", "e2e") if k in row),
            "match_breakdown")
        for k in ("K", "N", "demands"):
            if k in row:
                label += f" {k}={row[k]}"
        n, ms = _probe(x)
        pieces.append(n)
        print(json.dumps({"study": "phase", "after": label,
                          "probe_events": n, "probe_device_ms": ms}),
              flush=True)

    n, ms = _probe(x)
    print(json.dumps({"study": "phase", "after": "nothing",
                      "probe_events": n, "probe_device_ms": ms}), flush=True)
    chip_smoke.run_waterfill_phase(after)
    print(json.dumps({"study": "phase", "pieces": len(pieces),
                      "pieces_with_no_probe_event": pieces.count(0)}),
          flush=True)


def _launch(y: torch.Tensor, n: int) -> None:
    for _ in range(n):
        y.add_(1)
    torch.cuda.synchronize()


def launches() -> None:
    x = torch.randn(256, 256, device="cuda")
    y = torch.zeros(1, device="cuda")
    probes = [_probe(x)[0]]
    for _ in range(TOTAL // STEP):
        _launch(y, STEP)
        probes.append(_probe(x)[0])
    empty = [i * STEP for i, n in enumerate(probes) if n == 0]
    print(json.dumps({"study": "launches", "step": STEP, "total": TOTAL,
                      "probes": len(probes),
                      "first_empty_after": empty[0] if empty else None,
                      "empty_probes": len(empty)}), flush=True)


def _stretches(study: str, armed: bool) -> None:
    x = torch.randn(256, 256, device="cuda")
    y = torch.zeros(1, device="cuda")
    if armed:
        print(json.dumps({"study": study, "after_launches": 0,
                          "probe_events": _probe(x)[0]}), flush=True)
    for n in STRETCHES:
        _launch(y, n)
        print(json.dumps({"study": study, "after_launches": n,
                          "probe_events": _probe(x)[0]}), flush=True)


def stretch() -> None:
    _stretches("stretch", True)


def unarmed() -> None:
    _stretches("unarmed", False)


STUDIES = {"sessions": sessions, "phase": phase, "launches": launches,
           "stretch": stretch, "unarmed": unarmed}


def main() -> int:
    names = sys.argv[1:]
    if names[:1] == ["--in-process"]:
        STUDIES[names[1]]()
        return 0
    if not torch.cuda.is_available():
        print("study: no CUDA device", file=sys.stderr)
        return 1
    for name in names or STUDIES:
        done = subprocess.run([sys.executable, "-m", __spec__.name,
                               "--in-process", name], cwd=ROOT, timeout=1800)
        if done.returncode != 0:
            return done.returncode
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
