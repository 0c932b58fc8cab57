"""Workload CLI: generate traces, replay them, compare policies.

    # 10k-job OSG-shaped day -> JSONL (CSV by extension)
    python -m repro_torch.workload generate --preset diurnal --jobs 10000 \
        --seed 7 --out day.jsonl

    # stream it through one policy's federation, print the summary JSON
    python -m repro_torch.workload replay day.jsonl --policy cheapest-first

    # same trace, several policies + NAP headrooms, Fig 2/3-style JSON
    python -m repro_torch.workload compare day.jsonl \
        --policies fill-first,cheapest-first --out cmp.json

    # one-shot: generate in-memory and compare (the acceptance path)
    python -m repro_torch.workload compare --generate diurnal --jobs 10000 \
        --seed 7 --policies fill-first,cheapest-first --budget-s 60

    # multi-schedd flocking: `compare --schedds N` splits ONE trace
    # internally (3 schedds, fair-share negotiation) ...
    python -m repro_torch.workload compare day.jsonl --schedds 3 --fairshare \
        --policies fill-first,cheapest-first --out cmp.json

    # ... while `generate --split-by` writes per-schedd trace FILES
    # (day.schedd00.jsonl ...) for external consumers
    python -m repro_torch.workload generate --jobs 10000 --split-by group \
        --schedds 3 --out day.jsonl

Exit codes: 0 ok; 1 bad usage/trace; 2 budget exceeded or conservation
check failed (CI treats both as regressions).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.workload.compare import (
    compare, comparison_table, run_policy, standard_policies,
    standard_policy,
)
from repro_torch.workload.generators import DAY_S, generate_preset
from repro_torch.workload.replay import replay_trace
from repro_torch.workload.trace import Trace, TraceError, split_trace


def _split_out_path(base: str, name: str) -> str:
    root, dot, ext = base.rpartition(".")
    return f"{root}.{name}.{ext}" if dot else f"{base}.{name}"


def _cmd_generate(args) -> int:
    trace = generate_preset(args.preset, args.jobs, seed=args.seed,
                            duration_s=args.duration_s)
    if args.split_by:
        # per-schedd traces straight from the generator: one file per
        # label (or per schedd bucket with --schedds N)
        if not args.out:
            print("generate: --split-by needs --out (one file per "
                  "schedd)", file=sys.stderr)
            return 1
        parts = split_trace(trace, by=args.split_by,
                            n_schedds=args.schedds)
        for name, part in parts.items():
            path = _split_out_path(args.out, name)
            part.save(path)
            print(f"wrote {len(part)} records to {path}")
        return 0
    if args.out:
        trace.save(args.out)
        print(f"wrote {len(trace)} records to {args.out} "
              f"({json.dumps(trace.stats())})")
    else:
        sys.stdout.write(trace.to_jsonl())
    return 0


def _cmd_replay(args) -> int:
    if len(args.headroom) != 1:
        print("replay: takes exactly one --headroom (compare sweeps "
              "several)", file=sys.stderr)
        return 1
    trace = Trace.load(args.trace)
    spec = standard_policy(args.policy, headroom=args.headroom[0])
    if args.schedds > 1 or args.fairshare:
        # multi-schedd flocking replay: run_policy handles the split,
        # the concurrent per-queue streams, and the per-schedd block
        doc = run_policy(
            trace, spec, speed=args.speed, coalesce_s=args.coalesce_s,
            start_s=args.start_s, until_s=args.until_s,
            max_t=args.max_t, schedds=args.schedds,
            split_by=args.split_by or "group",
            fairshare=args.fairshare)
        doc.pop("_core_seconds", None)
        doc.pop("_gpu_seconds", None)
        doc = {"trace": {**trace.meta, **trace.stats()}, **doc}
        out = json.dumps(doc, indent=1)
        if args.out:
            with open(args.out, "w") as f:
                f.write(out + "\n")
        print(out)
        return 0
    sim = spec.build()
    replayer = replay_trace(
        sim, trace, speed=args.speed, coalesce_s=args.coalesce_s,
        start_s=args.start_s, until_s=args.until_s,
        compact_completed=True)
    t0 = time.time()
    sim.run_until_drained(max_t=args.max_t)
    if not sim.queue.drained():
        print(f"FAIL: not drained by --max-t {args.max_t} "
              f"({sim.queue.n_idle()} idle, {sim.queue.n_running()} "
              f"running)", file=sys.stderr)
        return 2
    doc = {
        "trace": {**trace.meta, **trace.stats()},
        "policy": spec.name,
        "wall_s": round(time.time() - t0, 3),
        "makespan_s": round(sim.now, 3),
        "jobs": replayer.stats.completed.summary(),
        "replay": {"submitted": replayer.stats.submitted,
                   "truncated": replayer.stats.truncated,
                   "batches": replayer.stats.batches},
        "cost_total": round(sim.summary()["cost_total"], 4),
    }
    out = json.dumps(doc, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)
    return 0


def _cmd_compare(args) -> int:
    if args.generate and args.trace:
        print("compare: TRACE file and --generate are mutually exclusive",
              file=sys.stderr)
        return 1
    if args.generate:
        trace = generate_preset(args.generate, args.jobs, seed=args.seed,
                                duration_s=args.duration_s)
    elif args.trace:
        trace = Trace.load(args.trace)
    else:
        print("compare: need a TRACE file or --generate PRESET",
              file=sys.stderr)
        return 1
    routings = [p.strip() for p in args.policies.split(",") if p.strip()]
    policies = standard_policies(routings, headrooms=args.headroom)
    t0 = time.time()
    doc = compare(trace, policies, speed=args.speed,
                  coalesce_s=args.coalesce_s, start_s=args.start_s,
                  until_s=args.until_s, max_t=args.max_t,
                  schedds=args.schedds,
                  split_by=args.split_by or "group",
                  fairshare=args.fairshare)
    wall = time.time() - t0
    doc["wall_s_total"] = round(wall, 3)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"wrote comparison to {args.out}")
    print(comparison_table(doc))
    print(f"total wall {wall:.1f}s")
    if not doc["conservation"]["ok"]:
        print("FAIL: conservation check failed", file=sys.stderr)
        return 2
    if args.budget_s is not None and wall > args.budget_s:
        print(f"FAIL: {wall:.1f}s > budget {args.budget_s}s",
              file=sys.stderr)
        return 2
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.workload",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("generate", help="synthesize a trace")
    g.add_argument("--preset", default="diurnal",
                   choices=("diurnal", "poisson", "uniform-burst"))
    g.add_argument("--jobs", type=int, default=10_000)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--duration-s", type=float, default=DAY_S)
    g.add_argument("--out", default=None,
                   help=".jsonl or .csv (stdout JSONL when omitted)")
    g.add_argument("--split-by", default=None, choices=("group", "user"),
                   help="write per-schedd traces (one file per label, "
                        "or per bucket with --schedds N)")
    g.add_argument("--schedds", type=int, default=None,
                   help="with --split-by: pack labels onto N schedds")
    g.set_defaults(fn=_cmd_generate)

    def _replay_opts(p):
        p.add_argument("--speed", type=float, default=1.0,
                       help="time-warp: compress arrivals N x")
        p.add_argument("--coalesce-s", type=float, default=10.0,
                       help="batch arrivals within this sim-time span")
        p.add_argument("--start-s", type=float, default=0.0)
        p.add_argument("--until-s", type=float, default=None)
        p.add_argument("--max-t", type=float, default=5e6)
        p.add_argument("--headroom", type=int, default=24, nargs="*",
                       help="elastic backends' max_nodes (NAP headroom)")
        p.add_argument("--schedds", type=int, default=1,
                       help="flocking: split the trace per schedd and "
                            "replay concurrently into one pool")
        p.add_argument("--split-by", default=None,
                       choices=("group", "user"),
                       help="per-schedd split label (default group)")
        p.add_argument("--fairshare", action="store_true",
                       help="hierarchical fair-share negotiation "
                            "(per-schedd quotas, per-user priority)")
        p.add_argument("--out", default=None)

    r = sub.add_parser("replay", help="stream a trace through one policy")
    r.add_argument("trace")
    r.add_argument("--policy", default="cheapest-first")
    _replay_opts(r)
    r.set_defaults(fn=_cmd_replay)

    c = sub.add_parser("compare",
                       help="one trace across several policies")
    c.add_argument("trace", nargs="?", default=None)
    c.add_argument("--generate", default=None, metavar="PRESET",
                   choices=("diurnal", "poisson", "uniform-burst"),
                   help="synthesize instead of reading a file")
    c.add_argument("--jobs", type=int, default=10_000)
    c.add_argument("--seed", type=int, default=0)
    c.add_argument("--duration-s", type=float, default=DAY_S)
    c.add_argument("--policies", default="fill-first,cheapest-first")
    c.add_argument("--budget-s", type=float, default=None,
                   help="fail (exit 2) if total wall time exceeds this")
    _replay_opts(c)
    c.set_defaults(fn=_cmd_compare)

    args = ap.parse_args(argv)
    if isinstance(getattr(args, "headroom", None), int):
        args.headroom = [args.headroom]
    elif getattr(args, "headroom", None) in (None, []):
        args.headroom = [24]
    try:
        return args.fn(args)
    except TraceError as e:
        print(f"trace error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
