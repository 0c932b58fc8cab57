"""The port's pool service and workload command lines against the JAX
package's, on the CPU, and the twin of examples/quickstart.py.

- The service smoke's sequence (`chip_smoke.service_sequence`: a day
  submitted at trace times over HTTP, a spot drain, a snapshot mid-day,
  the service shut down, a new one resumed from the snapshot and run
  until drained) on the port's `PoolService` with the torch backend (its
  plain versions: a test-only ``torch-cpu`` factory, `TorchMatchmaker(
  device="cpu")`, registered for the test and removed after it) and on
  the JAX package's `repro.service.PoolService` with NumPy: completed
  stats, summary and the Fig 2/3 series equal, jobs and core- and
  GPU-seconds conserved, and every matchmaker call counted.
- The HTTP surface: `serve_in_thread` with `RemoteClient`'s `healthz`,
  `submit`, `status` and `snapshot`, against the reference's replies.
- `python -m repro_torch.workload generate|replay|compare` against
  `python -m repro.workload` on a 2,000-job diurnal day (each pair run
  side by side in subprocesses): the same trace file, the same documents
  but for their wall-clock fields, the same exit codes.
- The quickstart's twin: its provisioning demo on the port's copies, and
  30 steps of reduced granite-8b through the port's `run_fixed` at batch
  8 with the loss falling.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from repro.service import PoolService as RefPoolService
from repro.service.__main__ import STANDARD_INI as REF_STANDARD_INI
from repro.service.http import serve_in_thread as ref_serve_in_thread
from repro.service.pool import RemoteClient as RefRemoteClient
from repro_torch.core.matchmaker import TorchMatchmaker, base
from repro_torch.service import PoolService, RemoteClient
from repro_torch.service.__main__ import SMOKE_KW, STANDARD_INI
from repro_torch.service.http import serve_in_thread
from repro_torch.workload.generators import generate_preset
from test_torch_matchmaker import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (  # noqa: E402
    SERVICE_DAY, check_service_equal, counted_calls, service_ini,
    service_sequence,
)

JOBS = 1_000


@pytest.fixture
def torch_cpu():
    """``matchmaker = torch-cpu``: the torch backend on CPU tensors (its
    plain versions), registered for one test only."""
    base.register_matchmaker(
        "torch-cpu", lambda **kw: TorchMatchmaker(device="cpu", **kw))
    yield "torch-cpu"
    del base._REGISTRY["torch-cpu"]


def test_service_ini_names_the_backend():
    assert service_ini() == STANDARD_INI
    assert STANDARD_INI == REF_STANDARD_INI
    ini = service_ini("torch")
    assert ini.startswith("[provision]\nmatchmaker = torch\n")
    assert ini.replace("matchmaker = torch\n", "") == STANDARD_INI


def test_service_on_torch_equals_reference_service_on_numpy(torch_cpu,
                                                            tmp_path):
    trace = generate_preset("diurnal", JOBS, seed=SERVICE_DAY["seed"])
    kw = dict(t_drain=SERVICE_DAY["t_drain"], t_snap=SERVICE_DAY["t_snap"],
              kw=SMOKE_KW)
    with counted_calls(TorchMatchmaker) as calls:
        svc, saved, st = service_sequence(
            (PoolService, serve_in_thread, RemoteClient),
            service_ini(torch_cpu), trace, tmp_path / "port.json", **kw)
    ref, ref_saved, _ = service_sequence(
        (RefPoolService, ref_serve_in_thread, RefRemoteClient),
        REF_STANDARD_INI, trace, tmp_path / "ref.json", **kw)
    assert not isinstance(svc.sim.collector.matchmaker,
                          type(ref.sim.collector.matchmaker))
    assert type(svc.sim.collector.matchmaker) is TorchMatchmaker
    assert calls["match"] > 0 and calls["preview_many"] > 0
    # the snapshot's time is where the wall-clock poll caught each clock
    assert min(saved["t"], ref_saved["t"]) >= SERVICE_DAY["t_snap"]
    assert st["drained"] and st["completed"] == JOBS
    check_service_equal(svc, ref, trace)


def test_counted_calls_restores_the_methods():
    names = ("match", "match_cycles", "preview_many")
    before = {n: TorchMatchmaker.__dict__[n] for n in names}
    with counted_calls(TorchMatchmaker) as calls:
        assert all(TorchMatchmaker.__dict__[n] is not before[n]
                   for n in names)
    assert calls == dict.fromkeys(names, 0)
    assert {n: TorchMatchmaker.__dict__[n] for n in names} == before


def test_http_round_trip_matches_reference(torch_cpu, tmp_path):
    """healthz, submit at trace times, status until drained and a
    snapshot on disk, over HTTP on both packages' services."""
    trace = generate_preset("diurnal", 200, seed=3)
    records = [r.to_obj() for r in trace.records]
    replies = []
    for svc, serve_fn, client, name in (
            (PoolService(service_ini(torch_cpu), **SMOKE_KW),
             serve_in_thread, RemoteClient, "port"),
            (RefPoolService(REF_STANDARD_INI, **SMOKE_KW),
             ref_serve_in_thread, RefRemoteClient, "ref")):
        server, url = serve_fn(svc)
        rc = client(url, timeout=60.0)
        try:
            assert rc.healthz()["ok"]
            sub = rc.submit(records, at_trace_times=True, at=0.0)
            assert sub["scheduled"] == len(records)
            rc.start(None)
            st = rc.status()
            while not st["drained"]:
                time.sleep(0.01)
                st = rc.status()
            snap = rc.snapshot(str(tmp_path / f"{name}.json"))
            assert Path(snap["path"]).exists()
            replies.append((sub, {k: st[k] for k in (
                "t", "completed", "schedds", "detached_backends")},
                snap["t"]))
        finally:
            rc.shutdown()
            server.server_close()
    assert replies[0] == replies[1]
    assert replies[0][1]["completed"] == len(records)


def run_both(*commands, cwd, timeout=300):
    """Each of ``commands`` (argument lists; ``{pkg}`` is ``port`` or
    ``ref``) through `python -m repro_torch.workload` and `python -m
    repro.workload`, all side by side; returns a (port, ref) pair of
    completed processes per command."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + ([os.environ["PYTHONPATH"]]
                               if os.environ.get("PYTHONPATH") else [])),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [[subprocess.Popen(
        [sys.executable, "-m", module, *[a.format(pkg=pkg) for a in args]],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for module, pkg in (("repro_torch.workload", "port"),
                                       ("repro.workload", "ref"))]
        for args in commands]
    done = []
    for pair in procs:
        done.append([])
        for p in pair:
            stdout, stderr = p.communicate(timeout=timeout)
            done[-1].append(subprocess.CompletedProcess(
                p.args, p.returncode, stdout, stderr))
    return done


def without_walls(doc):
    """A document without its host wall-clock fields."""
    if isinstance(doc, dict):
        return {k: without_walls(v) for k, v in doc.items()
                if k not in ("wall_s", "wall_s_total", "phases")}
    if isinstance(doc, list):
        return [without_walls(v) for v in doc]
    return doc


def test_workload_cli_matches_reference(tmp_path):
    """generate, replay and compare on a 2,000-job diurnal day, and a
    usage error and a missed budget: the same files, documents and exit
    codes from both packages' command lines."""
    [(port, ref)] = run_both(["generate", "--preset", "diurnal", "--jobs",
                              "2000", "--seed", "7", "--out", "{pkg}.jsonl"],
                             cwd=tmp_path)
    assert port.returncode == ref.returncode == 0, port.stderr + ref.stderr
    assert port.stdout.replace("port.jsonl", "ref.jsonl") == ref.stdout
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()

    runs = {"replay": ["--policy", "cheapest-first"],
            "compare": ["--policies", "fill-first,cheapest-first"]}
    # both a TRACE and --generate: a usage error (1); a budget of 0 s: 2
    failing = {1: ["compare", "{pkg}.jsonl", "--generate", "diurnal"],
               2: ["compare", "--generate", "diurnal", "--jobs", "50",
                   "--policies", "fill-first", "--budget-s", "0"]}
    done = run_both(*([verb, "{pkg}.jsonl", *extra, "--out",
                       "{pkg}." + verb + ".json"]
                      for verb, extra in runs.items()),
                    *failing.values(), cwd=tmp_path)
    for verb, (port, ref) in zip(runs, done):
        assert port.returncode == ref.returncode == 0, \
            port.stderr + ref.stderr
        docs = [json.loads((tmp_path / f"{p}.{verb}.json").read_text())
                for p in ("port", "ref")]
        assert without_walls(docs[0]) == without_walls(docs[1])
        assert docs[0]["trace"]["n"] == 2000
    for code, (port, ref) in zip(failing, done[len(runs):]):
        assert port.returncode == ref.returncode == code
        assert port.stderr.splitlines()[-1].split(":")[0] == \
            ref.stderr.splitlines()[-1].split(":")[0]


def test_quickstart_provisioning_twin():
    """examples/quickstart.py's provisioning demo on the port's copies:
    the same marks, summary and a drained pool as the reference's."""
    def demo(core):
        cfg = core.load_ini(core.PAPER_EXAMPLE_INI)
        cfg.submit_interval_s, cfg.idle_timeout_s = 30, 180
        cfg.startup_delay_s = 30
        nodes = core.onprem_nodes(4, gpus=8, labels={
            "gpu-type": "A100", "nautilus.io/low-power": "false"})
        sim = core.Simulation(cfg, nodes=nodes, tick_s=5)
        sim.submit_jobs(0, [core.gpu_job(600, gpus=1) for _ in range(12)]
                        + [core.gpu_job(600, gpus=4) for _ in range(3)])
        sim.submit_jobs(3000, [core.gpu_job(300, gpus=1) for _ in range(6)])
        marks = []
        for t in (600, 1200, 3600, 6000):
            sim.run(t)
            marks.append([sim.recorder.last(k) for k in (
                "idle_jobs", "running_pods", "busy_workers")])
        sim.run_until_drained(max_t=20000)
        assert sim.queue.drained() and not sim.collector.workers
        return marks, json.dumps(sim.summary(), sort_keys=True, default=str)

    import repro.core as ref_core
    import repro_torch.core as port_core
    port = demo(port_core)
    assert port == demo(ref_core)
    assert json.loads(port[1])["jobs"]["n"] == 21


def test_quickstart_training_twin(tmp_path):
    """examples/quickstart.py's training demo: 30 steps of the reduced
    granite-8b through the port's run_fixed at batch 8, sequence 64, the
    loss falling."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch.train import run_fixed
    losses = run_fixed(reduced_config("granite-8b"), steps=30, batch=8,
                       seq=64, ckpt_dir=str(tmp_path / "ckpt"), log_every=10,
                       device="cpu")
    assert len(losses) >= 3
    assert all(torch.isfinite(torch.tensor(losses)))
    assert losses[-1] < losses[0]
