"""The slice as a whole: the port's provisioning loop against the JAX
package's, on the CPU.

  * `run_policy` over a diurnal day on the standard 3-provider
    federation, the port with `TorchMatchmaker(device="cpu")` and the
    reference with its JAX matchmaker: equal result blocks (jobs, pods,
    cost, Fig 2/3 series, per-backend split), host wall-clock fields
    aside;
  * the same on a 3-schedd fair-share federation;
  * state carried across: a reference Simulation snapshotted mid-run is
    restored into the port's identically configured Simulation, and both
    drain to the same summary and series.
"""
import dataclasses
import json

import numpy as np

import repro.core as ref_core
import repro.workload as ref_workload
from repro_torch import core as port_core
from repro_torch import workload as port_workload
from repro_torch.core.matchmaker import TorchMatchmaker
from test_torch_matchmaker import (  # noqa: F401  (fixtures)
    jax_backend, one_torch_thread,
)


def with_matchmaker(spec, matchmaker):
    """`spec` whose Simulation is built with ``matchmaker`` (a name or an
    instance, as `Simulation(matchmaker=...)` takes it)."""
    class Spec(type(spec)):
        def build(self, **kw):
            return super().build(matchmaker=matchmaker, **kw)

    return Spec(**{f.name: getattr(spec, f.name)
                   for f in dataclasses.fields(spec)})


def comparable(block):
    """A run_policy block without its host wall-clock fields."""
    return {k: v for k, v in block.items() if k not in ("wall_s", "phases")}


def run_both(n_jobs, seed, **kw):
    ref_spec = with_matchmaker(
        ref_workload.standard_policy("fill-first"), "jax")
    port_spec = with_matchmaker(
        port_workload.standard_policy("fill-first"),
        TorchMatchmaker(device="cpu"))
    ref = ref_workload.run_policy(
        ref_workload.diurnal_day(n_jobs, seed=seed), ref_spec, **kw)
    port = port_workload.run_policy(
        port_workload.diurnal_day(n_jobs, seed=seed), port_spec, **kw)
    return ref, port


def test_diurnal_day_equals_reference(jax_backend):  # noqa: F811
    ref, port = run_both(300, 7)
    assert port["jobs"]["n"] == 300
    for key in ("jobs", "pods_submitted", "cost_total", "series",
                "backends"):
        assert port[key] == ref[key], key
    assert comparable(port) == comparable(ref)


def test_fairshare_federation_equals_reference(jax_backend):  # noqa: F811
    ref, port = run_both(200, 11, schedds=3, fairshare=True)
    assert port["jobs"]["n"] == 200
    assert set(port["schedds"]) == set(ref["schedds"])
    assert port["fairshare"] == ref["fairshare"]
    assert comparable(port) == comparable(ref)


CAP = {"cpu": 16, "gpu": 4, "memory": 64, "disk": 256}


def build_sim(core, matchmaker, seed=3):
    """Flocking + fair-share + autoscaling: every serialized subsystem."""
    cfg = core.ProvisionerConfig(submit_interval_s=30, idle_timeout_s=120,
                                 startup_delay_s=30)
    return core.Simulation(
        cfg, nodes=core.onprem_nodes(2, gpus=4, cpus=16),
        node_template=core.NodeTemplate(capacity=dict(CAP)), max_nodes=8,
        schedds=2, fairshare=True, tick_s=5.0, negotiate_interval_s=15.0,
        seed=seed, matchmaker=matchmaker)


def submit_jobs(core, sim):
    rng = np.random.default_rng(5)
    for i in range(40):
        sim.submit_jobs(10.0 * i,
                        [core.gpu_job(300.0 + 20.0 * (i % 7),
                                      gpus=1 + (i % 2),
                                      cpus=int(rng.integers(1, 4)))],
                        schedd=i % 2)


def canon(obj) -> str:
    return json.dumps(obj, sort_keys=True, default=str)


def test_reference_snapshot_restores_into_port(jax_backend):  # noqa: F811
    ref = build_sim(ref_core, "jax")
    submit_jobs(ref_core, ref)
    ref.run(400.0)                    # every submission has fired
    state = json.loads(json.dumps(ref.state_dict()))

    port = build_sim(port_core, TorchMatchmaker(device="cpu"))
    port.restore(state)
    assert canon(json.loads(json.dumps(port.state_dict()))) == canon(state)

    ref.run_until_drained(20000.0)
    port.run_until_drained(20000.0)
    assert canon(port.summary()) == canon(ref.summary())
    assert port.recorder.series == ref.recorder.series
    assert port.now == ref.now
