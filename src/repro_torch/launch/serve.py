"""Serving launcher: the continuous-batching engine on one device.

Runs `ServeEngine` over randomly initialised weights (drawn from a
seeded ``torch.Generator``) and prints tokens/s and latency.  The model
runs on cuda unless ``--device cpu`` is given; ``--reduced`` takes the
arch's tiny CPU-test config.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --reduced --device cpu --requests 12
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch jamba-v0.1-52b --reduced --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import model as model_lib
from repro_torch.serve.engine import Request, ServeEngine


def run_serve(cfg, *, n_requests: int, slots: int = 4, max_seq: int = 128,
              max_new: int = 8, seed: int = 0, device=None):
    rng = np.random.default_rng(seed)
    params = model_lib.init_model(cfg, seed=seed, device=device)
    engine = ServeEngine(cfg, params, batch_slots=slots, max_seq=max_seq)

    t0 = time.time()
    for i in range(n_requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=rng.integers(4, max_seq // 4))
        engine.submit(Request(rid=i, prompt=prompt.astype(np.int32),
                              max_new_tokens=max_new))
    ticks = engine.run_until_drained()
    dt = time.time() - t0

    done = engine.done
    toks = sum(len(r.output or []) for r in done.values())
    print(f"[serve] {len(done)}/{n_requests} requests, {toks} tokens, "
          f"{ticks} ticks, {dt:.1f}s ({toks/dt:.1f} tok/s) on "
          f"{engine.device}")
    lat = [r.finished_at - r.submitted_at for r in done.values()]
    print(f"[serve] latency mean={np.mean(lat):.2f}s p95="
          f"{np.percentile(lat, 95):.2f}s")
    return engine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    run_serve(cfg, n_requests=args.requests, slots=args.slots,
              max_seq=args.max_seq, max_new=args.max_new, device=args.device)


if __name__ == "__main__":
    main()
