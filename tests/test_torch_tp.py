"""Activation tensor parallelism over "model" on a gloo world of 8 CPU
ranks, held against the JAX package.

Under the rules that cut activations over "model" (base, ep, decode) a
rank computes its part of the query heads, the MLP and expert FF columns,
the SSM heads and the vocabulary, from the "model" cut of the weights as
stored.  For reduced qwen2 (4 heads, 2 kv heads), mamba2 (8 SSM heads)
and jamba (4 experts, ``ep``), each on {"data": 4, "model": 2} and
{"data": 2, "model": 4}: the blocks against the reference's one-device
functions, the loss and its gradient against ``jax.value_and_grad``,
prefill and decode against the reference's, the shapes that reach the
kernels, and `ServeEngine` against the JAX package's engine on a
``jax.sharding.Mesh`` of the same shape (8 host devices in a
subprocess).  Then three train steps under base (mamba2) and ep (jamba)
against the reference's one-device step, and the three traps of the cut
planted, each read above its bar.

One world (tests/torch_world.py: one process and one torch thread a
rank) runs every case while the reference runs in this process and its
meshed engines in subprocesses; weights and inputs cross over as
numpy."""
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_world
from repro.configs import reduced_config as ref_reduced_config
from repro.data.pipeline import SyntheticTokenPipeline
from repro.models import attention as ref_attention
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models.param import materialize
from repro_torch.launch.mesh import spawn_world
from test_torch_matchmaker import one_torch_thread  # noqa: F401
from test_torch_multidevice import numpy_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD_TIMEOUT_S = 300.0
#: float32 on both sides, different summation orders: blocks, logits and
#: losses absolutely (their values are O(1)-O(100)), gradients x each
#: leaf's max |g|; the planted faults must read above them
TOL = 1e-4
GRAD_TOL = 1e-4
#: parameters after a step: the reference's bar (tests/test_multidevice.py)
STEP_PARAM_TOL = 2e-2

ARCHS = [
    dict(arch="qwen2-1.5b", rules="base", serve_rules="decode"),
    dict(arch="mamba2-1.3b", rules="base", serve_rules="decode"),
    # capacity that drops nothing on either side; the auxiliary loss,
    # under EP a mean of per-rank estimates, weighted 0
    dict(arch="jamba-v0.1-52b", rules="ep", serve_rules="ep",
         capacity_factor=8.0, moe=dict(aux_loss_weight=0.0)),
]
MESHES = [{"data": 4, "model": 2}, {"data": 2, "model": 4}]
SERVE = dict(slots=4, max_seq=32, new=4, decode_steps=2)
STEPS = [dict(ARCHS[1], mesh=MESHES[0]), dict(ARCHS[2], mesh=MESHES[0])]

#: the JAX package's engine on a jax.sharding.Mesh over 8 host devices
REF_ENGINE = """
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np, jax
from repro.configs import reduced_config
from repro.models import model
from repro.models.param import materialize
from repro.parallel.sharding import preset
from repro.serve.engine import Request, ServeEngine
run = json.loads(sys.argv[1])
case = run["case"]
cfg = reduced_config(case["arch"])
if case.get("capacity_factor"):
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=case["capacity_factor"], **case["moe"]))
params = materialize(model.init_model(cfg), jax.random.PRNGKey(0))
out = {}
for shape in run["meshes"]:
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(
        tuple(shape.values())), tuple(shape))
    engine = ServeEngine(cfg, params, batch_slots=run["slots"],
                         max_seq=run["max_seq"], mesh=mesh,
                         rules=preset(case["serve_rules"]))
    first = []
    decode = engine._decode

    def recorded(*args):
        o = decode(*args)
        if not first:
            first.append(np.asarray(o[0]).tolist())
        return o
    engine._decode = recorded
    for i, p in enumerate(run["prompts"]):
        engine.submit(Request(rid=i, prompt=np.asarray(p, np.int32),
                              max_new_tokens=run["new"]))
    engine.run_until_drained()
    out[json.dumps(shape)] = {
        "tokens": {str(i): r.output for i, r in engine.done.items()},
        "logits": first[0]}
print("OUT " + json.dumps(out))
"""


def ref_config(case):
    cfg = ref_reduced_config(case["arch"])
    if case.get("capacity_factor"):
        cfg = torch_world.with_moe(cfg, cfg.moe.n_experts,
                                   case["capacity_factor"], **case["moe"])
    return cfg


def ref_params(cfg):
    return materialize(ref_model.init_model(cfg), jax.random.PRNGKey(0))


def inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.standard_normal((8, 16, cfg.d_model)).astype(np.float32),
        "batch": SyntheticTokenPipeline(cfg.vocab_size, 32, 8,
                                        seed=1).batch_at(0),
        # one length: the reference's engine compiles a prefill a length
        "prompts": rng.integers(0, cfg.vocab_size, size=(4, 8)).astype(
            np.int32)}


def _layer(params, slot, part):
    return jax.tree_util.tree_map(lambda t: t[0],
                                  params["stack"][f"slot{slot}"][part])


def ref_layers_of(cfg, params, x):
    """The reference's one-device blocks on x (the first of each kind)."""
    x = jnp.asarray(x)
    out = {}
    for slot in range(cfg.period):
        kind, ffn = cfg.mixer_kind(slot), cfg.ffn_kind(slot)
        if kind == "attn" and "attn" not in out:
            out["attn"] = ref_attention.attn_forward(
                _layer(params, slot, "mixer"), cfg, x)
        if kind == "ssm" and "ssm" not in out:
            out["ssm"] = ref_ssm.ssm_forward(_layer(params, slot, "mixer"),
                                             cfg, x)
        if ffn == "dense" and "mlp" not in out:
            out["mlp"] = ref_layers.apply_mlp(_layer(params, slot, "ffn"), x,
                                              gated=cfg.gated_mlp,
                                              act=cfg.act)
        if ffn == "moe" and "moe" not in out:
            out["moe"] = ref_moe.moe_forward_dense(
                _layer(params, slot, "ffn"), cfg, x)[0]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


def ref_loss(cfg, params, batch):
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: ref_model.loss_fn(p, cfg, b, remat="none"),
        has_aux=True))(params)
    return {"loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": [np.asarray(g, np.float32)
                      for g in jax.tree_util.tree_leaves(grads)]}


def ref_decode(cfg, params, prompts, steps):
    cache = ref_model.init_cache(cfg, prompts.shape[0], 32)
    logits, cache, lengths = jax.jit(
        lambda p, t, c: ref_model.prefill(p, cfg, {"tokens": t}, c))(
        params, jnp.asarray(prompts), cache)
    out = {"prefill": np.asarray(logits), "steps": []}
    step = jax.jit(lambda p, t, c, n: ref_model.decode_step(p, cfg, t, c, n))
    for _ in range(steps):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        logits, cache, lengths = step(params, tok, cache, lengths)
        out["steps"].append(np.asarray(logits))
    return out


def ref_engine(case, mesh, prompts):
    """The JAX package's engine on ``mesh``, in a subprocess."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    run = dict(SERVE, case=case, meshes=[mesh], prompts=prompts.tolist())
    return subprocess.Popen(
        [sys.executable, "-c", REF_ENGINE, json.dumps(run)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _arch(case) -> int:
    return [a["arch"] for a in ARCHS].index(case["arch"])


def step_batches(cfg):
    """The steps' batches: the first is `inputs`' loss batch, so that the
    first step's gradient is held against that case's
    jax.value_and_grad."""
    pipe = SyntheticTokenPipeline(cfg.vocab_size, 32, 8, seed=1)
    return [pipe.batch_at(j) for j in range(3)]


def ref_arch(a):
    return dict(layers=ref_layers_of(a["cfg"], a["params"], a["x"]),
                loss=ref_loss(a["cfg"], a["params"], a["batch"]),
                decode=ref_decode(a["cfg"], a["params"], a["prompts"],
                                  SERVE["decode_steps"]))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp")
    per_arch = []
    for i, case in enumerate(ARCHS):
        cfg = ref_config(case)
        params = ref_params(cfg)
        per_arch.append(dict(case, cfg=cfg, params=params,
                             **inputs(cfg, 10 + i)))
    engines = [ref_engine(case, mesh, a["prompts"])
               for case, a in zip(ARCHS, per_arch) for mesh in MESHES]

    def to_world(a, **extra):
        return dict({k: v for k, v in a.items() if k not in ("cfg", "params")},
                    params=numpy_tree(a["params"]), **extra)
    cases = {
        "cases": [to_world(a, **SERVE, mesh=mesh) for a in per_arch
                  for mesh in MESHES],
        "planted": to_world(per_arch[1], mesh=MESHES[0]),
        "steps": [to_world(per_arch[_arch(c)], mesh=c["mesh"],
                           batches=step_batches(per_arch[_arch(c)]["cfg"]))
                  for c in STEPS],
    }
    try:
        with ThreadPoolExecutor(1 + len(per_arch)) as pool:
            running = pool.submit(spawn_world, torch_world.tp_world, 8,
                                  backend="gloo", init_file=tmp / "store",
                                  timeout_s=WORLD_TIMEOUT_S, args=(cases,))
            refs = [pool.submit(ref_arch, a) for a in per_arch]
            ref = {"archs": [r.result() for r in refs]}
            out = running.result()
        ref["engines"] = []
        for proc in engines:
            stdout, stderr = proc.communicate(timeout=WORLD_TIMEOUT_S)
            assert proc.returncode == 0, stderr
            ref["engines"].append(json.loads(stdout.split("OUT ")[-1]))
        ref["engines"] = [dict(ref["engines"][i], **ref["engines"][i + 1])
                          for i in range(0, len(engines), len(MESHES))]
    finally:
        for proc in engines:
            if proc.poll() is None:
                proc.kill()
    return out, ref


CASE_IDS = [f"{a['arch']}-{m['data']}x{m['model']}" for a in ARCHS
            for m in MESHES]


def _case(i):
    return ARCHS[i // len(MESHES)], MESHES[i % len(MESHES)]


def _rows(out, i, key):
    """A per-rank output over the rank's rows, made whole: the ranks of
    the first "model" index in row order, every rank of a "model" group
    holding the same values."""
    ranks = [r["cases"][i] for r in out]
    parts = {}
    for r in ranks:
        got = r[key] if not isinstance(key, tuple) else r[key[0]][key[1]]
        if r["index"] in parts:
            np.testing.assert_array_equal(got, parts[r["index"]])
        parts[r["index"]] = got
    return np.concatenate([parts[k] for k in sorted(parts)])


@pytest.mark.parametrize("i", range(len(CASE_IDS)), ids=CASE_IDS)
def test_blocks_under_the_cut_match_one_device(world, i):
    """Attention and the MLP (qwen2), the Mamba2 block (mamba2), the MoE
    layer (jamba, expert-parallel) on the rank's rows, each rank with its
    part of the heads or FF columns: the reference's one-device blocks
    within 1e-4, the ranks of a "model" group alike."""
    out, ref = world
    want = ref["archs"][i // len(MESHES)]["layers"]
    assert out[0]["cases"][i]["tp"] == MESHES[i % len(MESHES)]["model"]
    assert set(out[0]["cases"][i]["layers"]) == set(want)
    for name in want:
        got = _rows(out, i, ("layers", name))
        assert np.abs(got - want[name]).max() < TOL, name


@pytest.mark.parametrize("i", range(len(CASE_IDS)), ids=CASE_IDS)
def test_loss_and_gradient_under_the_cut(world, i):
    """loss_fn under the cut (vocab-parallel embedding, logits and
    log-sum-exp): the loss on every rank and its metrics within 1e-4 of
    the reference's, and the whole gradient (summed over "data",
    gathered over the cut) within 1e-4 of each leaf's max |g| of
    ``jax.value_and_grad``'s."""
    out, ref = world
    want = ref["archs"][i // len(MESHES)]["loss"]
    for r in out:
        assert abs(r["cases"][i]["loss"]["loss"] - want["loss"]) < TOL
    got = out[0]["cases"][i]["loss"]
    for k in ("ce", "z_loss", "tokens"):
        assert abs(got["metrics"][k] - want["metrics"][k]) < TOL, k
    assert len(got["grads"]) == len(want["grads"])
    for a, b in zip(got["grads"], want["grads"]):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max()


@pytest.mark.parametrize("i", range(len(CASE_IDS)), ids=CASE_IDS)
def test_kernels_see_the_rank_part(world, i):
    """The shapes that reached the kernels in loss_fn: flash attention at
    H/M query heads (and the kv heads they read), the SSD scan at H/M
    heads, the grouped matmul at f/M expert columns, the unembedding at
    V/M logits."""
    out, _ = world
    arch, mesh = _case(i)
    cfg = torch_world.tp_config(arch)
    M, B = mesh["model"], 8 // mesh["data"]
    for r in out:
        seen = r["cases"][i]["shapes"]
        assert seen["logits"] == [(B, 32, cfg.vocab_size // M)]
        if cfg.ssm is not None:
            H = cfg.ssm.n_heads(cfg.d_model)
            assert seen["ssd"] == [(B, 32, H // M, cfg.ssm.head_dim)]
        if cfg.family != "ssm":
            hq = cfg.n_heads // M
            hk = max(cfg.n_kv_heads // M, 1)
            assert seen["flash"] == [((B, 32, hq, cfg.d_head),
                                      (B, 32, hk, cfg.d_head))]
        if cfg.moe is not None:
            f = cfg.moe.d_ff_expert // M
            E_loc = cfg.moe.n_experts // mesh["data"]
            assert seen["gmm"] == sorted({(E_loc, cfg.d_model, f),
                                          (E_loc, f, cfg.d_model)})


@pytest.mark.parametrize("i", range(len(CASE_IDS)), ids=CASE_IDS)
def test_prefill_and_decode_under_the_cut(world, i):
    """prefill (every row on every rank, the rank's heads of a cache laid
    out as the reference's) and two greedy decode steps of the rank's
    rows under ``decode`` / ``ep``: the logits within 1e-4 of the
    reference's one-device prefill and decode_step."""
    out, ref = world
    want = ref["archs"][i // len(MESHES)]["decode"]
    for r in out:
        got = r["cases"][i]["decode"]
        assert np.abs(got["prefill"] - want["prefill"]).max() < TOL
        assert len(got["steps"]) == len(want["steps"])
        for a, b in zip(got["steps"], want["steps"]):
            assert np.abs(a - b).max() < TOL


@pytest.mark.parametrize("i", range(len(CASE_IDS)), ids=CASE_IDS)
def test_engine_matches_the_jax_engine_on_a_mesh(world, i):
    """ServeEngine on the mesh under ``decode`` (``ep`` for jamba)
    against the JAX package's engine on a jax.sharding.Mesh of the same
    shape with the same weights: the same greedy tokens on every rank,
    the first tick's logits within 1e-4."""
    out, ref = world
    arch, mesh = _case(i)
    want = ref["engines"][i // len(MESHES)][json.dumps(mesh)]
    for r in out:
        got = r["cases"][i]["engine"]
        assert {str(k): v for k, v in got["tokens"].items()} == \
            want["tokens"]
        assert np.abs(got["logits"] - np.asarray(want["logits"])).max() \
            < TOL


def test_planted_traps_read_above_the_bars(world):
    """mamba2 on (4, 2), where in_proj's and the conv's contiguous cuts
    do not fall on head boundaries: taking the rank's columns as that
    contiguous cut, or normalising y by the rank's channels alone,
    moves the Mamba2 block's output above the block bar; dividing the
    loss's shares over the "model" ranks as if they were replicas shrinks
    the gradient by M, above the gradient bar."""
    out, ref = world
    want = ref["archs"][1]
    for name in ("in_proj", "norm"):
        parts = {}
        for r in out:
            parts[r["cases"][2]["index"]] = r["planted"][name]
        got = np.concatenate([parts[k] for k in sorted(parts)])
        assert np.abs(got - want["layers"]["ssm"]).max() > 100 * TOL, name
    worst = max(np.abs(a - b).max() / np.abs(b).max() for a, b in zip(
        out[0]["planted"]["rep"], want["loss"]["grads"]))
    assert worst > 100 * GRAD_TOL


@pytest.mark.parametrize("i", range(len(STEPS)),
                         ids=[f"{c['arch']}-{c['rules']}" for c in STEPS])
def test_train_steps_under_the_cut(world, i):
    """Three sharded steps on (4, 2) under base (mamba2) and ep (jamba)
    against the one-device step on the same weights and batches (rank 0;
    tests/test_torch_train.py holds that step against the reference's):
    the loss within 1e-4 on every rank and the parameters within the
    reference's bar after each step; and the gradient the first step
    reduced (from AdamW's first moment) within 1e-4 of each leaf's
    max |g| of ``jax.value_and_grad``'s, and its norm within 1e-4."""
    out, ref = world
    got0 = out[0]["steps"][i]
    for step, (loss, params) in enumerate(got0["one"]):
        for r in out:
            assert abs(r["steps"][i]["metrics"][step]["loss"] - loss) \
                < TOL, step
        for a, b in zip(got0["params"][step], params, strict=True):
            assert np.abs(a - b).max() < STEP_PARAM_TOL, step
    want = ref["archs"][_arch(STEPS[i])]["loss"]["grads"]
    for a, b in zip(got0["grads"], want, strict=True):
        assert np.abs(a - b).max() <= GRAD_TOL * np.abs(b).max()
    norm = np.sqrt(sum(float(np.square(b.astype(np.float64)).sum())
                       for b in want))
    assert abs(got0["metrics"][0]["grad_norm"] - norm) < 1e-4 * norm
