"""Port twins of the reference's fused-negotiation, live-fusion and
preview suites, on `TorchMatchmaker(device="cpu")`.

The port's matchmaker now runs `match_cycles` (K staged cycles) and
`preview_many` (N candidate pools) each as one call of its water-fill
entry points -- one kernel launch on the card; here, on the CPU, their
plain versions.  These tests hold the control plane around them to the
same pins the reference holds its JAX backend to, with the NumPy backend
as the oracle wherever the reference used the JAX backend for both
sides:

  * tests/test_fused_negotiation.py: a staged K-cycle batch (K in
    {1, 2, 8}) claims exactly what cycle-by-cycle negotiation claims,
    timestamps included, through fused batches and every fallback
    (mid-batch quiesce, worker churn, the reseed hazard), and a
    Simulation's claim map does not depend on negotiation_batch;
  * tests/test_live_fusion.py: the 150-job streaming diurnal replay is
    bit-identical across negotiation_batch in {1, 2, 8}, and live fusion
    really fuses (fused_batches > 0);
  * tests/test_preview_many.py and tests/test_preview_counters.py: the
    batched preview against the sequential NumPy loop, per-candidate
    demands, the session under a stable token and a changed order,
    padding edges, the call telemetry, the path-labelled compile
    counter and the legacy-walk counter.
"""
import numpy as np
import pytest

from repro_torch.core import ProvisionerConfig, Simulation, gpu_job, onprem_nodes
from repro_torch.core.classad import ClassAdExpr
from repro_torch.core.jobqueue import Job, JobQueue
from repro_torch.core.matchmaker import (
    NumpyMatchmaker, TorchMatchmaker, problem_from_reference,
)
from repro_torch.core.matchmaker.base import (
    match_cycles, preview_many, sequential_match_cycles,
    sequential_preview_many,
)
from repro_torch.core.worker import Collector, Worker
from repro_torch.workload.generators import diurnal_day
from repro_torch.workload.replay import replay_trace
from test_fused_negotiation import random_deltas
from test_matchmaker_differential import random_problem
from test_preview_many import assert_batches_equal, random_frees
from test_torch_matchmaker import one_torch_thread  # noqa: F401


def port_mm():
    return TorchMatchmaker(device="cpu")


# -- backend: the fused K-cycle call against the K-loop reference ------------

@pytest.mark.parametrize("K", [1, 2, 8])
def test_match_cycles_bit_identical_to_sequential(K):
    rng = np.random.default_rng(100 + K)
    for trial in range(4):
        p = problem_from_reference(random_problem(rng, fractional=trial % 2))
        p.demand = np.zeros_like(p.demand)
        deltas = random_deltas(rng, p, K)
        fused = match_cycles(port_mm(), p, deltas)      # the fused path
        seq = sequential_match_cycles(NumpyMatchmaker(), p, deltas)
        assert len(fused) == len(seq) == K
        for k in range(K):
            label = f"K={K} trial={trial} cycle={k}"
            np.testing.assert_array_equal(fused[k].takes, seq[k].takes,
                                          err_msg=label)
            np.testing.assert_array_equal(fused[k].free_after,
                                          seq[k].free_after, err_msg=label)


# -- collector: staged batches against interleaved sequential cycles ---------

def mk_pool(batch, n_workers=10, cpus=8, matchmaker=None):
    col = Collector(matchmaker=port_mm() if matchmaker is None
                    else matchmaker, negotiation_batch=batch)
    for i in range(n_workers):
        w = Worker(name=f"w{i}", ad={"cpus": cpus, "memory": 64},
                   start_expr=ClassAdExpr("True"))
        w.booted_at = 0.0
        col.advertise(w)
    return col, JobQueue()


def submit_wave(q, t, n, cpus=1, mem=4, user="alice"):
    for _ in range(n):
        q.submit(Job(ad={"request_cpus": cpus, "request_memory": mem,
                         "owner": user, "runtime_s": 1e5}), now=t)


def full_claim_map(q):
    return sorted((j.jid, j.claimed_by, j.attempt_started_at)
                  for j in q.jobs() if j.claimed_by is not None)


@pytest.mark.parametrize("K", [1, 2, 8])
def test_staged_flush_identical_to_sequential(K):
    """Random interleaved waves: whatever mix of fused batches and
    fallbacks the guards pick, the claim map (per-claim timestamps
    included) equals the cycle-by-cycle NumPy reference."""
    rng = np.random.default_rng(7 + K)
    for trial in range(6):
        col_s, q_s = mk_pool(batch=K)
        col_r, q_r = mk_pool(batch=1, matchmaker="numpy")
        times = [10.0 * (k + 1) for k in range(K)]
        waves = [(int(rng.integers(0, 20)), int(rng.integers(1, 4)),
                  ["alice", "bob"][int(rng.integers(0, 2))])
                 for _ in times]
        claims_s = 0
        for t, (n, c, u) in zip(times, waves):
            submit_wave(q_s, t - 1, n, cpus=c, user=u)
            claims_s += col_s.stage_cycle(q_s, t)
        claims_s += col_s.quiesce()
        claims_r = 0
        for t, (n, c, u) in zip(times, waves):
            submit_wave(q_r, t - 1, n, cpus=c, user=u)
            claims_r += col_r.run_cycle(q_r, t)
        assert claims_s == claims_r, f"K={K} trial={trial}"
        assert full_claim_map(q_s) == full_claim_map(q_r), \
            f"K={K} trial={trial}"


def test_staged_batch_takes_fused_path_on_disjoint_waves():
    K = 4
    col_s, q_s = mk_pool(batch=K, n_workers=4, cpus=4)
    col_r, q_r = mk_pool(batch=1, n_workers=4, cpus=4, matchmaker="numpy")
    times = [10.0 * (k + 1) for k in range(K)]
    for q, col, stage in ((q_s, col_s, True), (q_r, col_r, False)):
        for k, t in enumerate(times):
            submit_wave(q, t - 1, 8, cpus=2, mem=4 + 8 * k)
            if stage:
                col.stage_cycle(q, t)
            else:
                col.run_cycle(q, t)
    col_s.quiesce()
    assert col_s.fused_batches == 1 and col_s.staged_fallbacks == 0
    assert col_s.fused_cycles == K
    assert col_s.matchmaker.last_call["kind"] == "match_cycles"
    assert full_claim_map(q_s) == full_claim_map(q_r)


def test_mid_batch_quiesce_flushes_and_matches():
    col_s, q_s = mk_pool(batch=8, n_workers=4, cpus=4)
    col_r, q_r = mk_pool(batch=1, n_workers=4, cpus=4, matchmaker="numpy")
    times = [10.0 * (k + 1) for k in range(5)]
    for k, t in enumerate(times[:3]):
        submit_wave(q_s, t - 1, 5, cpus=2, mem=4 + 8 * k)
        col_s.stage_cycle(q_s, t)
    col_s.quiesce()
    assert not col_s._staged_times
    for k, t in enumerate(times[3:], start=3):
        submit_wave(q_s, t - 1, 5, cpus=2, mem=4 + 8 * k)
        col_s.stage_cycle(q_s, t)
    col_s.quiesce()
    for k, t in enumerate(times):
        submit_wave(q_r, t - 1, 5, cpus=2, mem=4 + 8 * k)
        col_r.run_cycle(q_r, t)
    assert full_claim_map(q_s) == full_claim_map(q_r)


def test_worker_churn_mid_batch_forces_fallback():
    col_s, q_s = mk_pool(batch=4, n_workers=2, cpus=4)
    col_r, q_r = mk_pool(batch=1, n_workers=2, cpus=4, matchmaker="numpy")
    times = [10.0, 20.0, 30.0, 40.0]

    def boot_extra(col):
        w = Worker(name="late", ad={"cpus": 4, "memory": 64},
                   start_expr=ClassAdExpr("True"))
        w.booted_at = 15.0
        col.advertise(w)

    for k, t in enumerate(times):
        submit_wave(q_s, t - 1, 6, cpus=2, mem=4 + 8 * k)
        col_s.stage_cycle(q_s, t)
        if t == 10.0:
            boot_extra(col_s)
    col_s.quiesce()
    for k, t in enumerate(times):
        submit_wave(q_r, t - 1, 6, cpus=2, mem=4 + 8 * k)
        col_r.run_cycle(q_r, t)
        if t == 10.0:
            boot_extra(col_r)
    assert col_s.staged_fallbacks == 1 and col_s.fused_batches == 0
    assert full_claim_map(q_s) == full_claim_map(q_r)


def test_reseed_hazard_forces_fallback():
    col_s, q_s = mk_pool(batch=3, n_workers=10, cpus=8)
    col_r, q_r = mk_pool(batch=1, n_workers=10, cpus=8, matchmaker="numpy")
    times = [10.0, 20.0, 30.0]
    waves = [(4, 3, "alice"), (1, 1, "bob"), (13, 3, "alice")]
    for (t, (n, c, u)) in zip(times, waves):
        submit_wave(q_s, t - 1, n, cpus=c, user=u)
        col_s.stage_cycle(q_s, t)
    col_s.quiesce()
    for (t, (n, c, u)) in zip(times, waves):
        submit_wave(q_r, t - 1, n, cpus=c, user=u)
        col_r.run_cycle(q_r, t)
    assert col_s.staged_fallbacks == 1
    assert full_claim_map(q_s) == full_claim_map(q_r)


def test_simulation_batch_knob_preserves_claim_map():
    def drive(batch, matchmaker):
        cfg = ProvisionerConfig(submit_interval_s=30, idle_timeout_s=120,
                                startup_delay_s=30, negotiation_batch=batch)
        sim = Simulation(cfg, nodes=onprem_nodes(4, gpus=8), tick_s=5,
                         matchmaker=matchmaker)
        sim.submit_jobs(0, [gpu_job(300) for _ in range(12)])
        sim.run(3000)
        return sim, full_claim_map(sim.queue)

    sim1, cm1 = drive(1, "numpy")
    sim4, cm4 = drive(4, port_mm())
    assert sim1.queue.drained() and sim4.queue.drained()
    assert cm1 == cm4


# -- live fusion: the streaming diurnal replay across K ----------------------

def fallback_counts(sim):
    fam = sim.collector._c_fallbacks
    return {k[0]: int(c.value) for k, c in fam.children.items()}


def completion_signature(sim):
    return sorted((j.jid, j.submitted_at, j.runtime_s, j.completed_at)
                  for j in sim.queue.completed_log)


def replay(batch, matchmaker):
    trace = diurnal_day(150, seed=3, duration_s=3600.0)
    cfg = ProvisionerConfig(submit_interval_s=60, idle_timeout_s=300,
                            startup_delay_s=30, negotiation_batch=batch)
    sim = Simulation(cfg, nodes=onprem_nodes(2, gpus=8), tick_s=60,
                     negotiate_interval_s=20, metrics_interval_s=60,
                     matchmaker=matchmaker)
    replay_trace(sim, trace, coalesce_s=0.0)
    sim.run_until_drained(max_t=1e6)
    return sim


def test_diurnal_replay_bit_identical_across_batch():
    """negotiation_batch=1 on the NumPy backend against 2 and 8 on the
    port: the same completions and the same Fig 2-3 series, with real
    fused batches through `match_cycles`."""
    ref = replay(1, "numpy")
    ref_sig = completion_signature(ref)
    assert ref_sig, "trace must complete jobs"
    for K in (2, 8):
        sim = replay(K, port_mm())
        col = sim.collector
        assert completion_signature(sim) == ref_sig, f"K={K}"
        assert sim.recorder.series == ref.recorder.series, f"K={K}"
        assert not col._staged_times
        assert col.fused_batches > 0, fallback_counts(sim)
        flushes = col.fused_batches + col.staged_fallbacks
        assert fallback_counts(sim).get("single_cycle", 0) < flushes


# -- batched preview ----------------------------------------------------------

@pytest.mark.parametrize("fractional", [False, True])
def test_preview_many_matches_sequential_numpy(fractional):
    mm, ref = port_mm(), NumpyMatchmaker()
    rng = np.random.default_rng(101 + fractional)
    for trial in range(8):
        p = problem_from_reference(random_problem(rng, fractional=fractional))
        for n in (1, 2, 8):
            frees = random_frees(rng, p, n)
            assert_batches_equal(
                mm.preview_many(p, frees),
                sequential_preview_many(ref, p, frees),
                f"trial={trial} n={n} fractional={fractional}")


def test_preview_many_per_candidate_demands():
    mm, ref = port_mm(), NumpyMatchmaker()
    rng = np.random.default_rng(113)
    for trial in range(6):
        p = problem_from_reference(random_problem(rng))
        n = int(rng.integers(1, 9))
        frees = random_frees(rng, p, n)
        demands = [rng.integers(0, 40, size=p.n_cohorts).astype(np.int64)
                   for _ in range(n)]
        assert_batches_equal(mm.preview_many(p, frees, demands),
                             sequential_preview_many(ref, p, frees, demands),
                             f"trial={trial} n={n}")


def test_preview_many_session_reuse_and_order_invalidation():
    mm, ref = port_mm(), NumpyMatchmaker()
    rng = np.random.default_rng(127)
    p = problem_from_reference(random_problem(rng, C=37, W=21))
    token = ("pool", "fingerprint")
    for call in range(4):
        frees = random_frees(rng, p, 3)
        assert_batches_equal(mm.preview_many(p, frees, session=token),
                             sequential_preview_many(ref, p, frees),
                             f"session call={call}")
    p2 = problem_from_reference(random_problem(rng, C=37, W=21))
    p2.order = np.roll(p.order, 5)
    p2.requests, p2.demand = p.requests, p.demand
    p2.free, p2.compat = p.free, p.compat
    frees = random_frees(rng, p2, 2)
    assert_batches_equal(mm.preview_many(p2, frees, session=token),
                         sequential_preview_many(ref, p2, frees),
                         "order change under stable token")


def test_preview_many_padding_boundaries():
    mm, ref = port_mm(), NumpyMatchmaker()
    rng = np.random.default_rng(131)
    for C in (1, 63, 64, 65):
        for W in (1, 127, 128, 129):
            p = problem_from_reference(random_problem(rng, C=C, W=W))
            frees = random_frees(rng, p, 2)
            assert_batches_equal(mm.preview_many(p, frees),
                                 sequential_preview_many(ref, p, frees),
                                 f"C={C} W={W}")


def test_preview_many_marks_preview_call():
    mm = port_mm()
    p = problem_from_reference(random_problem(np.random.default_rng(137)))
    mm.preview_many(p, [p.free])
    assert mm.last_call["kind"] == "preview"
    assert mm.last_call["compiled"] is True


def test_dispatcher_routes_the_port_and_falls_back_sequential():
    rng = np.random.default_rng(139)
    p = problem_from_reference(random_problem(rng))
    frees = random_frees(rng, p, 4)
    ref = NumpyMatchmaker()
    want = sequential_preview_many(ref, p, frees)
    assert_batches_equal(preview_many(ref, p, frees), want, "numpy route")
    mm = port_mm()
    assert_batches_equal(preview_many(mm, p, frees), want, "port route")
    assert mm.last_call["kind"] == "preview"


# -- preview telemetry --------------------------------------------------------

def add_worker(col, name, ad, start="true", booted=0.0):
    w = Worker(name=name, ad=dict(ad), start_expr=ClassAdExpr(start),
               startup_delay=0.0)
    w.booted_at = booted
    col.advertise(w)
    return w


def test_compiles_labelled_by_entry_path():
    """The port has nothing to trace, but it flags a padding bucket's
    first call as `compiled`, so the profiler's path-labelled counter
    still says how many shapes each entry path met."""
    col = Collector(matchmaker=port_mm(), telemetry=True)
    prof = col.profiler
    for i in range(3):
        add_worker(col, f"w{i}", {"cpus": 8, "memory": 32})
    q = JobQueue()
    for i in range(20):
        q.submit(Job(ad={"request_cpus": 1 + i % 2, "request_memory": 2},
                     runtime_s=60), float(i))
    col.preview(q, 0.0)
    by_path = prof.phase_totals()["jit_compiles_by_path"]
    assert by_path.get("preview", 0) >= 1
    n_preview = by_path["preview"]
    col.preview(q, 0.0)                  # the same bucket
    assert prof.phase_totals()["jit_compiles_by_path"]["preview"] == n_preview
    col.run_cycle(q, 0.0)
    totals = prof.phase_totals()
    assert totals["jit_compiles_by_path"].get("cycle", 0) >= 1
    assert totals["jit_compiles"] == sum(
        totals["jit_compiles_by_path"].values())


def test_preview_legacy_counter_counts_quantity_forced_walks():
    col = Collector(matchmaker=port_mm())
    add_worker(col, "w0", {"cpus": 8, "memory": 32})
    q = JobQueue()
    q.submit(Job(ad={"request_cpus": 1}, runtime_s=60), 0.0)
    col.preview(q, 0.0)                  # quantity-blind: the fused path
    assert col.preview_legacy == 0
    assert col.matchmaker.last_call["kind"] == "preview"
    col2 = Collector(matchmaker=port_mm())
    add_worker(col2, "w0", {"cpus": 8, "memory": 32}, start="cpus >= 2")
    col2.preview(q, 0.0)                 # START reads offered cpus
    assert col2.preview_legacy == 1
    col2.preview_candidates(q, 0.0, frees=[np.array([[8., 0, 32, 0, 0, 0]]),
                                           np.array([[4., 0, 32, 0, 0, 0]])])
    assert col2.preview_legacy == 2
