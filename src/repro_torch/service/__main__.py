"""Pool-service CLI: serve a live pool, talk to one, or run the smoke.

    # serve the standard 3-provider federation at 60x real time
    python -m repro_torch.service serve --standard --speed 60 --port 8080 --start

    # stream a generated day of demand into it at trace times
    python -m repro_torch.service submit --url http://127.0.0.1:8080 \
        --preset diurnal --jobs 1000 --at-trace-times

    # watch it
    python -m repro_torch.service status --url http://127.0.0.1:8080
    python -m repro_torch.service metrics --url http://127.0.0.1:8080

    # telemetry: Prometheus scrape / Chrome trace (open in Perfetto)
    curl http://127.0.0.1:8080/metrics.prom
    python -m repro_torch.service trace --url http://127.0.0.1:8080 \
        --path trace.json

    # full-state snapshot to disk; later: serve --resume pool.json
    python -m repro_torch.service snapshot --url http://127.0.0.1:8080 \
        --path pool.json

    # retire a provider without restarting
    python -m repro_torch.service drain-backend --url http://127.0.0.1:8080 \
        --name spot

    # end-to-end acceptance smoke (submit -> snapshot/kill/resume ->
    # runtime drain -> drained; equality vs the uninterrupted run)
    python -m repro_torch.service smoke --jobs 10000 --budget-s 600

Exit codes: 0 ok; 1 bad usage; 2 smoke failure or budget exceeded.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.service.http import serve, serve_in_thread
from repro_torch.service.pool import PoolClient, PoolService, RemoteClient
from repro_torch.workload.compare import FEDERATION_INI
from repro_torch.workload.generators import DAY_S, generate_preset
from repro_torch.workload.trace import Trace

STANDARD_INI = FEDERATION_INI.format(routing="cheapest-first",
                                     onprem_nodes=4, cloud_max_nodes=24,
                                     spot_max_nodes=24)


def _print(doc) -> int:
    print(json.dumps(doc, indent=1))
    return 0


def _speed(args) -> float | None:
    return None if args.as_fast else args.speed


# -- serve --------------------------------------------------------------------
def _cmd_serve(args) -> int:
    if args.resume:
        svc = PoolService.resume(args.resume, speed=_speed(args))
        print(f"resumed from {args.resume} at t={svc.sim.now}")
    else:
        ini = STANDARD_INI if args.standard else None
        if args.ini:
            with open(args.ini) as f:
                ini = f.read()
        if ini is None:
            print("serve: need --ini FILE, --standard, or --resume SNAP",
                  file=sys.stderr)
            return 1
        schedds = args.schedds if args.schedds else None
        svc = PoolService(ini, schedds=schedds, fairshare=args.fairshare,
                          tick_s=args.tick_s,
                          negotiate_interval_s=args.negotiate_interval_s,
                          metrics_interval_s=args.metrics_interval_s,
                          seed=args.seed, speed=_speed(args))
    server = serve(svc, args.host, args.port)
    addr, port = server.server_address[:2]
    if args.start:
        svc.start()
    print(f"pool service on http://{addr}:{port} "
          f"(speed={svc.driver.speed}, driver "
          f"{'running' if svc.driver.running else 'held — POST /start'})")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        svc.stop()
    return 0


# -- client verbs -------------------------------------------------------------
def _records_from_args(args):
    if args.trace:
        return [r.to_obj() for r in Trace.load(args.trace).records]
    return [r.to_obj()
            for r in generate_preset(args.preset, args.jobs,
                                     seed=args.seed,
                                     duration_s=args.duration_s).records]


def _cmd_submit(args) -> int:
    rc = RemoteClient(args.url)
    return _print(rc.submit(_records_from_args(args), schedd=args.schedd,
                            at_trace_times=args.at_trace_times,
                            at=args.at))


def _cmd_client(args) -> int:
    rc = RemoteClient(args.url)
    verb = args.cmd
    if verb == "status":
        return _print(rc.status())
    if verb == "metrics":
        return _print(rc.metrics())
    if verb == "metrics-prom":
        print(rc.metrics_prom(), end="")
        return 0
    if verb == "trace":
        doc = rc.trace()
        if args.path:
            with open(args.path, "w") as f:
                json.dump(doc, f)
            print(f"{len(doc['traceEvents'])} events -> {args.path}")
            return 0
        return _print(doc)
    if verb == "job":
        return _print(rc.job_status(args.jid))
    if verb == "rm":
        return _print(rc.rm(args.jid))
    if verb == "snapshot":
        return _print(rc.snapshot(args.path))
    if verb == "drain-backend":
        return _print(rc.drain_backend(args.name, at=args.at))
    if verb == "add-backend":
        with open(args.ini) as f:
            return _print(rc.add_backend(f.read()))
    if verb == "add-schedd":
        return _print(rc.add_schedd(args.name, quota=args.quota))
    if verb == "drain-schedd":
        return _print(rc.drain_schedd(args.name, at=args.at))
    if verb == "start":
        return _print(rc.start(None if args.as_fast else args.speed))
    if verb == "shutdown":
        return _print(rc.shutdown())
    raise AssertionError(verb)


# -- the acceptance smoke -----------------------------------------------------
SMOKE_KW = dict(tick_s=30.0, negotiate_interval_s=60.0,
                metrics_interval_s=300.0, seed=0, speed=None)


def _smoke_reference(ini, trace, t_drain, max_t):
    """The uninterrupted oracle: same trace at trace times, same runtime
    drain, batch-driven as fast as possible."""
    svc = PoolService(ini, **SMOKE_KW)
    client = PoolClient(svc)
    client.submit(trace.records, at_trace_times=True, at=0.0)
    client.drain_backend("spot", at=t_drain)
    svc.run_until_drained(max_t)
    return svc


def _cmd_smoke(args) -> int:
    t0 = time.time()
    trace = generate_preset("diurnal", args.jobs, seed=args.seed)
    ini = STANDARD_INI
    t_drain, max_t = 30_000.0, 5e6
    fail = lambda msg: (print(f"SMOKE FAIL: {msg}", file=sys.stderr), 2)[1]

    # 1. uninterrupted reference run
    ref = _smoke_reference(ini, trace, t_drain, max_t)
    ref_jobs = ref.completed_stats().state_dict()
    ref_summary = ref.summary()
    wall_ref = time.time() - t0
    print(f"reference drained at t={ref.sim.now:.0f} "
          f"({ref_jobs['n']} jobs, wall {wall_ref:.1f}s)")

    # 2. live service over HTTP: submit, run, snapshot mid-run, kill
    svc = PoolService(ini, **SMOKE_KW)
    server, url = serve_in_thread(svc)
    rc = RemoteClient(url, timeout=120.0)
    if not rc.healthz().get("ok"):
        return fail("healthz not ok")
    r = rc.submit([rec.to_obj() for rec in trace.records],
                  at_trace_times=True, at=0.0)
    if r.get("scheduled") != len(trace.records):
        return fail(f"submit scheduled {r} != {len(trace.records)}")
    rc.drain_backend("spot", at=t_drain)
    rc.start(None)                      # as fast as possible
    t_snap = 10_000.0
    while True:
        st = rc.status()
        if st["t"] >= t_snap or st["drained"]:
            break
        time.sleep(0.02)
    snap_path = args.snapshot_path
    saved = rc.snapshot(snap_path)
    print(f"snapshot at t={saved['t']:.0f} -> {saved['path']}")
    rc.shutdown()                       # kill the first service
    server.server_close()

    # 3. resume from disk and drain the rest
    svc2 = PoolService.resume(snap_path, speed=None)
    server2, url2 = serve_in_thread(svc2)
    rc2 = RemoteClient(url2, timeout=120.0)
    rc2.start(None)
    deadline = time.time() + (args.budget_s or 3600.0)
    while True:
        st = rc2.status()
        if st["drained"]:
            break
        if time.time() > deadline:
            return fail(f"resumed run not drained in budget (t={st['t']})")
        time.sleep(0.02)
    svc2.stop()

    # 4. /metrics JSON is well-formed and carries the Fig 2/3 series
    m = rc2.metrics()
    for key in ("gauges", "backends", "series"):
        if key not in m:
            return fail(f"/metrics missing {key!r}")
    for key in ("idle_jobs", "running_jobs", "provisioned_cores",
                "cost_rate"):
        if key not in m["series"]:
            return fail(f"/metrics series missing {key!r}")
        if key not in m["gauges"]:
            return fail(f"/metrics gauges missing {key!r}")

    # 4b. telemetry surfaces: Prometheus text + Chrome trace over HTTP
    prom = rc2.metrics_prom()
    for needle in ("# TYPE repro_pool_idle_jobs gauge",
                   "# TYPE repro_job_wait_seconds histogram",
                   "# TYPE repro_cycle_phase_seconds histogram",
                   "repro_job_spans_total"):
        if needle not in prom:
            return fail(f"/metrics.prom missing {needle!r}")
    tr = rc2.trace()
    evs = tr.get("traceEvents")
    if not isinstance(evs, list) or not evs:
        return fail("/trace has no traceEvents")
    if any(not {"name", "ph", "pid"} <= set(e)
           or (e["ph"] != "M" and "ts" not in e) for e in evs):
        return fail("/trace events missing required keys")
    if not any(e.get("ph") == "X" and e.get("cat") == "job,run"
               for e in evs):
        return fail("/trace has no job run spans")
    print(f"telemetry: {len(prom.splitlines())} prom lines, "
          f"{len(evs)} trace events")
    rc2.shutdown()
    server2.server_close()

    # 5. equality with the uninterrupted run + conservation vs the trace
    got_jobs = svc2.completed_stats().state_dict()
    got_summary = svc2.summary()
    if st["detached_backends"] != ["spot"]:
        return fail(f"spot not detached: {st['detached_backends']}")
    if got_jobs != ref_jobs:
        return fail(f"completed stats diverge:\n ref {ref_jobs}\n "
                    f"got {got_jobs}")
    a = json.dumps(ref_summary, sort_keys=True, default=str)
    b = json.dumps(got_summary, sort_keys=True, default=str)
    if a != b:
        return fail("summary() diverges between uninterrupted and "
                    "snapshot/resume runs")
    stats = trace.stats()
    close = (lambda x, y:
             abs(x - y) <= 1e-6 * max(1.0, abs(x), abs(y)))
    if got_jobs["n"] != stats["n"]:
        return fail(f"completed {got_jobs['n']} != trace {stats['n']}")
    if not close(got_jobs["core_seconds"], stats["core_seconds"]):
        return fail("core-seconds conservation violated")
    if not close(got_jobs["gpu_seconds"], stats["gpu_seconds"]):
        return fail("gpu-seconds conservation violated")

    wall = time.time() - t0
    print(f"SMOKE OK: {got_jobs['n']} jobs streamed over HTTP, snapshot/"
          f"kill/resume at t={saved['t']:.0f}, spot drained at "
          f"t={t_drain:.0f}, equality + conservation hold "
          f"(wall {wall:.1f}s)")
    if args.budget_s is not None and wall > args.budget_s:
        print(f"FAIL: {wall:.1f}s > budget {args.budget_s}s",
              file=sys.stderr)
        return 2
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.service",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("serve", help="run a pool service")
    s.add_argument("--ini", default=None, help="federation INI file")
    s.add_argument("--standard", action="store_true",
                   help="use the standard 3-provider federation")
    s.add_argument("--resume", default=None, metavar="SNAPSHOT",
                   help="resume from a snapshot file")
    s.add_argument("--schedds", type=int, default=0,
                   help="flocking: N submit hosts (0 = single schedd)")
    s.add_argument("--fairshare", action="store_true")
    s.add_argument("--tick-s", type=float, default=30.0)
    s.add_argument("--negotiate-interval-s", type=float, default=60.0)
    s.add_argument("--metrics-interval-s", type=float, default=300.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--speed", type=float, default=1.0,
                   help="simulated seconds per wall second")
    s.add_argument("--as-fast", action="store_true",
                   help="no pacing (idle between submissions)")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=8080)
    s.add_argument("--start", action="store_true",
                   help="start the clock immediately")
    s.set_defaults(fn=_cmd_serve)

    def _url(p):
        p.add_argument("--url", required=True)

    sm = sub.add_parser("submit", help="submit jobs to a served pool")
    _url(sm)
    sm.add_argument("--trace", default=None, help="JSONL/CSV trace file")
    sm.add_argument("--preset", default="diurnal",
                    choices=("diurnal", "poisson", "uniform-burst"))
    sm.add_argument("--jobs", type=int, default=100)
    sm.add_argument("--seed", type=int, default=0)
    sm.add_argument("--duration-s", type=float, default=DAY_S)
    sm.add_argument("--schedd", default=None)
    sm.add_argument("--at-trace-times", action="store_true",
                    help="schedule each record at base+arrival_s "
                         "instead of submitting everything now")
    sm.add_argument("--at", type=float, default=None)
    sm.set_defaults(fn=_cmd_submit)

    for verb, opts in (
        ("status", ()), ("metrics", ()), ("metrics-prom", ()),
        ("shutdown", ()),
        ("job", ("jid",)), ("rm", ("jid",)),
        ("snapshot", ("path",)),
        ("trace", ("tracepath",)),
        ("drain-backend", ("name", "at")),
        ("add-backend", ("bini",)),
        ("add-schedd", ("name", "quota")),
        ("drain-schedd", ("name", "at")),
        ("start", ("speed2",)),
    ):
        p = sub.add_parser(verb)
        _url(p)
        if "jid" in opts:
            p.add_argument("--jid", type=int, required=True)
        if "path" in opts:
            p.add_argument("--path", default=None,
                           help="save to this file on the SERVER "
                                "(inline JSON when omitted)")
        if "tracepath" in opts:
            p.add_argument("--path", default=None,
                           help="write Chrome trace JSON to this local "
                                "file (print inline when omitted)")
        if "name" in opts:
            p.add_argument("--name", required=True)
        if "at" in opts:
            p.add_argument("--at", type=float, default=None,
                           help="sim time to apply at (default: now)")
        if "bini" in opts:
            p.add_argument("--ini", required=True,
                           help="INI file with [backend:<name>] sections")
        if "quota" in opts:
            p.add_argument("--quota", type=float, default=1.0)
        if "speed2" in opts:
            p.add_argument("--speed", type=float, default=1.0)
            p.add_argument("--as-fast", action="store_true")
        p.set_defaults(fn=_cmd_client)

    k = sub.add_parser("smoke",
                       help="end-to-end acceptance: HTTP stream + "
                            "snapshot/kill/resume + runtime drain")
    k.add_argument("--jobs", type=int, default=10_000)
    k.add_argument("--seed", type=int, default=7)
    k.add_argument("--budget-s", type=float, default=None)
    k.add_argument("--snapshot-path", default="/tmp/pool_smoke_snap.json")
    k.set_defaults(fn=_cmd_smoke)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
