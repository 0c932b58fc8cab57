"""The port's sharded training on gloo worlds on the CPU, held against
the JAX package's single-device outputs: the twins of
tests/test_multidevice.py's train-step, int8 and sequence-parallel tests
(which fail on this installation's JAX), and `run_fixed` in a world.

One world of 8 ranks (tests/torch_world.py: one process and one torch
thread a rank, rendezvous through a ``file://`` store in a temporary
directory, one timeout for the world) runs every case; meshes of
different shapes are made over the same ranks.  The reference runs in
this process, on a 1 x 1 mesh, while the world works; weights and
batches cross over as numpy."""
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_world
from repro.configs import reduced_config as ref_reduced_config
from repro.data.pipeline import SyntheticTokenPipeline
from repro.models import model as ref_model
from repro.models.param import materialize
from repro.parallel.sharding import rules_for as ref_rules_for
from repro.train import optimizer as ref_opt
from repro.train.train_step import init_train_state as ref_init_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import spawn_world

#: the reference's bars (tests/test_multidevice.py)
SP_LOSS_TOL = 1e-4
STEP_LOSS_TOL = 1e-4
STEP_PARAM_TOL = 2e-2
INT8_LOSS_TOL = 1e-5
INT8_PARAM_TOL = 5e-2
#: gradients, x max |g_ref| of each leaf (float32 on both sides)
GRAD_TOL = 1e-4
WORLD_TIMEOUT_S = 300.0
#: run_fixed in the world against one device: each logged loss
RUN_LOSS_TOL = 1e-4

STEP_CASES = [
    dict(arch="granite-8b", mesh={"data": 4, "model": 2}),          # zero3
    dict(arch="mamba2-1.3b", mesh={"data": 4, "model": 2}),         # base
    # expert parallelism's auxiliary loss is a mean of per-rank
    # estimates, not the one-device estimate (tests/test_torch_parallel.py
    # holds its value and gradient): weighted 0 here, the step is the
    # same function on both sides.  Top-2, so that the router has a
    # gradient: top-1 gates are 1 whatever the logits, and AdamW would
    # turn the two sides' rounding noise into different router updates
    dict(arch="llama4-scout-17b-a16e", mesh={"data": 4, "model": 2},
         n_experts=4, capacity_factor=8.0,
         moe=dict(aux_loss_weight=0.0, top_k=2)),                    # ep
]
RUN = dict(arch="qwen2-1.5b", steps=2, batch=8, seq=16)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def batches(cfg, n, S=32, B=8):
    pipe = SyntheticTokenPipeline(cfg.vocab_size, S, B, seed=1)
    return [pipe.batch_at(i) for i in range(n)]


def ref_config(case):
    cfg = ref_reduced_config(case["arch"])
    if case.get("n_experts"):
        cfg = torch_world.with_moe(cfg, case["n_experts"],
                                   case["capacity_factor"], **case["moe"])
    return cfg


def ref_grads(cfg, params, batch, rows):
    """The reference's one-device gradient of `loss_fn` on ``rows`` of
    the batch, as numpy leaves."""
    b = {k: jnp.asarray(v[rows]) for k, v in batch.items()}
    g = jax.jit(jax.grad(lambda p: ref_model.loss_fn(
        p, cfg, b, remat="none")[0]))(params)
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(g)]


def ref_steps(cfg, params, batch_list):
    """The reference's step on a 1 x 1 mesh: each step's metrics and
    parameters."""
    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    opt = ref_opt.OptimizerConfig(lr=1e-3)
    step = jax.jit(ref_make_train_step(
        cfg, opt, mesh1, ref_rules_for(cfg, "train"), remat="none",
        lr_kwargs=torch_world.LR_KWARGS))
    state = ref_init_state(params, opt, jax.random.PRNGKey(0))
    out = []
    with jax.set_mesh(mesh1):
        for b in batch_list:
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            out.append(({k: float(v) for k, v in m.items()},
                        [np.asarray(a, np.float32)
                         for a in jax.tree_util.tree_leaves(state.params)]))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    sp_cfg = dataclasses.replace(ref_reduced_config("granite-8b"),
                                 n_heads=6, n_kv_heads=2, d_head=16)
    sp_params = materialize(ref_model.init_model(sp_cfg),
                            jax.random.PRNGKey(0))
    sp_batch = batches(sp_cfg, 1)[0]
    steps = []
    for case in STEP_CASES:
        cfg = ref_config(case)
        params = materialize(ref_model.init_model(cfg), jax.random.PRNGKey(0))
        steps.append(dict(case, params=numpy_tree(params),
                          batches=batches(cfg, 3), ref_params=params))
    int8_cfg = ref_reduced_config("qwen2-1.5b")
    int8_params = materialize(ref_model.init_model(int8_cfg),
                              jax.random.PRNGKey(0))
    int8_batch = batches(int8_cfg, 1)[0]
    tmp = tmp_path_factory.mktemp("world")
    cases = {
        "sp": dict(params=numpy_tree(sp_params), batch=sp_batch),
        "steps": [{k: v for k, v in c.items() if k != "ref_params"}
                  for c in steps],
        "int8": dict(arch="qwen2-1.5b", params=numpy_tree(int8_params),
                     batch=int8_batch),
        "run_fixed": dict(RUN, ckpt_dir=str(tmp / "world_ckpt")),
    }
    # the world and the reference's compilations run side by side
    with ThreadPoolExecutor(1 + len(steps) + 1) as pool:
        running = pool.submit(spawn_world, torch_world.multidevice_world, 8,
                              backend="gloo", init_file=tmp / "store",
                              timeout_s=WORLD_TIMEOUT_S, args=(cases,))
        ref_runs = [pool.submit(ref_steps, ref_config(c), c["ref_params"],
                                c["batches"]) for c in steps]
        ref_int8 = pool.submit(ref_steps, int8_cfg, int8_params,
                               [int8_batch])
        # the int8 step's pods hold rows 0-3 and 4-7 (batch over ("pod",
        # "data")), each pod's loss a mean over its own rows
        half = len(int8_batch["tokens"]) // 2
        ref_int8_grads = [pool.submit(ref_grads, int8_cfg, int8_params,
                                      int8_batch, rows) for rows in
                          (slice(0, half), slice(half, None), slice(None))]
        batch_j = {k: jnp.asarray(v) for k, v in sp_batch.items()}
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: ref_model.loss_fn(p, sp_cfg, batch_j, remat="none"),
            has_aux=True))(sp_params)
        ref = {"sp": dict(loss=float(loss),
                          metrics={k: float(v) for k, v in metrics.items()},
                          grads=[np.asarray(g) for g in
                                 jax.tree_util.tree_leaves(grads)]),
               "steps": [r.result() for r in ref_runs],
               "int8": ref_int8.result(),
               "int8_grads": [r.result() for r in ref_int8_grads]}
        out = running.result()
    return out, ref, tmp


@pytest.mark.parametrize("preset", ["zero3", "base"])
def test_sequence_parallel_loss_matches_single_device(world, preset):
    """granite with 6 heads on (2, 4): attention is sequence-parallel
    (6 % 4 != 0).  Under zero3 each rank's rows reach their part of the
    sequence by an all-to-all over "model", under base by a slice.  The
    loss within 1e-4 of the reference's one-device loss_fn on every rank,
    its metrics, and the gradient (summed over the mesh) within 1e-4 of
    each leaf's max."""
    out, ref, _ = world
    for r in out:
        assert abs(r["sp"][preset]["loss"] - ref["sp"]["loss"]) < SP_LOSS_TOL
    m = out[0]["sp"][preset]["metrics"]
    for k in ("ce", "z_loss", "tokens"):
        assert abs(m[k] - ref["sp"]["metrics"][k]) <= \
            SP_LOSS_TOL * max(1.0, abs(ref["sp"]["metrics"][k])), k
    for got, want in zip(out[0]["sp"][preset]["grads"], ref["sp"]["grads"]):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max()


@pytest.mark.parametrize("i", range(len(STEP_CASES)),
                         ids=[c["arch"] for c in STEP_CASES])
def test_sharded_train_step_matches_single_device(world, i):
    """Three sharded steps on (4, 2) (granite under zero3, mamba2 under
    base through the SSD's plain version, a 4-expert llama4-scout under
    ep through the expert-parallel layer) against the reference's steps
    on a 1 x 1 mesh: the loss within 1e-4 and every parameter within
    2e-2 after each step (the reference's bars), the same loss on every
    rank."""
    out, ref, _ = world
    case = STEP_CASES[i]
    want_rules = {"granite-8b": "zero3", "mamba2-1.3b": "base",
                  "llama4-scout-17b-a16e": "ep"}[case["arch"]]
    assert out[0]["steps"][i]["rules"] == want_rules
    for step, (rm, rp) in enumerate(ref["steps"][i]):
        m = out[0]["steps"][i]["metrics"][step]
        assert {r["steps"][i]["metrics"][step]["loss"] for r in out} == \
            {m["loss"]}
        assert abs(m["loss"] - rm["loss"]) < STEP_LOSS_TOL, step
        got = out[0]["steps"][i]["params"][step]
        assert len(got) == len(rp)
        for a, b in zip(got, rp):
            assert np.abs(a - b).max() < STEP_PARAM_TOL, step


def test_int8_compressed_train_step_close_to_exact(world):
    """One step on (2, 2, 2) under base.  The gradient the int8 step
    reduced (read from AdamW's first moment) is the mean of the two
    pods' reference gradients within amax/127 (amax: the leaf's largest
    |g| over the pods; plus the float32 bar GRAD_TOL x amax), leaf by
    leaf, and its global norm that mean's within the bound's norm.  The
    bound is below half of each leaf's largest |g|, so a zero gradient,
    a flipped sign or a sum without the mean over the pods would fail.
    Beside it, the reference's bars: the loss (before the update) within
    1e-5 of the exact sharded step's and of the reference's one-device
    step's, the parameters within 5e-2 of both (AdamW's first step moves
    each by about lr, so these bars cannot see the gradient); and every
    rank of a "pod" group holds the same bits."""
    out, ref, _ = world
    r0 = out[0]["int8"]
    (rm, rp), = ref["int8"]
    pod0, pod1, _ = ref["int8_grads"]
    bound_sq = mean_sq = 0.0
    for got, a, b in zip(r0["int8"]["grads"], pod0, pod1):
        mean = (a + b) / 2
        amax = max(np.abs(a).max(), np.abs(b).max())
        bound = amax / 127 + GRAD_TOL * amax
        assert bound < 0.5 * np.abs(mean).max()
        assert np.abs(got - mean).max() <= bound
        bound_sq += mean.size * bound ** 2
        mean_sq += float(np.square(mean.astype(np.float64)).sum())
    assert abs(r0["int8"]["metrics"]["grad_norm"] - np.sqrt(mean_sq)) <= \
        np.sqrt(bound_sq)
    assert abs(r0["int8"]["metrics"]["loss"] -
               r0["exact"]["metrics"]["loss"]) < INT8_LOSS_TOL
    assert abs(r0["int8"]["metrics"]["loss"] - rm["loss"]) < INT8_LOSS_TOL
    for a, b, c in zip(r0["int8"]["params"], r0["exact"]["params"], rp):
        assert np.abs(a - b).max() < INT8_PARAM_TOL
        assert np.abs(a - c).max() < INT8_PARAM_TOL
    by_place = {}
    for r in out:
        c = r["int8"]["coord"]
        by_place.setdefault((c["data"], c["model"]), set()).add(
            r["int8"]["int8"]["digest"])
    assert len(by_place) == 4
    assert all(len(d) == 1 for d in by_place.values())


def test_compressed_step_differs_from_exact_only_by_rounding(world):
    """The compressed update is not the exact one (the int8 path ran);
    the exact sharded step's reduced gradient is the reference's
    one-device gradient of the whole batch within 1e-4 of each leaf's
    max, and its parameters the reference's within its bar."""
    out, ref, _ = world
    r0 = out[0]["int8"]
    (_, rp), = ref["int8"]
    assert any(not np.array_equal(a, b) for a, b in
               zip(r0["int8"]["params"], r0["exact"]["params"]))
    whole = ref["int8_grads"][2]
    for got, want in zip(r0["exact"]["grads"], whole):
        assert np.abs(got - want).max() <= GRAD_TOL * np.abs(want).max()
    for a, b in zip(r0["exact"]["params"], rp):
        assert np.abs(a - b).max() < STEP_PARAM_TOL


def test_run_fixed_with_model_parallel_in_a_world(world, tmp_path):
    """run_fixed with --model-parallel 2 in the world of 8 ((4, 2), zero3)
    logs the losses of a one-device run within 1e-4; rank 0's checkpoint
    is the one-device format, and a one-device run resumes it."""
    out, _, tmp = world
    cfg = reduced_config(RUN["arch"])
    one = launch_train.run_fixed(
        cfg, steps=RUN["steps"], batch=RUN["batch"], seq=RUN["seq"],
        ckpt_dir=str(tmp_path / "one"), device="cpu", log_every=1,
        ckpt_every=RUN["steps"])
    for r in out:
        got = r["run_fixed"]["losses"]
        assert len(got) == len(one)
        assert all(abs(a - b) < RUN_LOSS_TOL for a, b in zip(got, one))
    world_dir = tmp / "world_ckpt"
    assert CheckpointManager(str(world_dir)).all_steps() == [RUN["steps"]]
    with np.load(world_dir / f"step_{RUN['steps']:08d}" / "arrays.npz") \
            as a, np.load(tmp_path / "one" / f"step_{RUN['steps']:08d}" /
                          "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert np.abs(a[name].astype(np.float32) -
                          b[name].astype(np.float32)).max() < STEP_PARAM_TOL
    resumed = launch_train.run_fixed(
        cfg, steps=RUN["steps"] + 1, batch=RUN["batch"], seq=RUN["seq"],
        ckpt_dir=str(world_dir), device="cpu", log_every=1,
        resume_from=RUN["steps"])
    assert len(resumed) == 1 and np.isfinite(resumed[0])
