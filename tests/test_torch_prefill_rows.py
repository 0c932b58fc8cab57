"""A batched prefill with its rows cut over the mesh, on a gloo world of
8 CPU ranks, held against the JAX package's one-device prefill.

`serve.engine.make_prefill_step(cfg, mesh, rules, batch=B)` cuts the
rows as the reference's dry-run lowers its prefill (its
``batch_shardings_for``: over ("pod", "data") when their product divides
B, else none; `parallel.sharding.prefill_layout`): each rank prefills its
rows only, into its part of the rows' cache, and the logits come back
whole.  The reduced qwen2 on {"data": 8} (a row a rank) and (4, 2) (2
rows, half the heads), with 6 heads on (2, 4) (attention
sequence-parallel over "model": the heads do not divide it), mamba2 on
(2, 4) (4 rows, 2 of 8 SSM heads),
jamba under ``ep`` on (4, 2) at a capacity that drops nothing
(expert-parallel on the rank's rows), whisper's frames and llava's
patches on {"data": 4}: a prefill of 8 rows in float32, the gathered
logits within 1e-4 of the reference's, each rank's cache part within
1e-4 of the reference cache's part (its rows, and its kv heads, slots
and SSM heads as the layout cuts them: `models.model.cache_part`), the
lengths equal; then two greedy decode steps from the cut cache under
`serving_layout`.  ``batch`` unset or 1, and ``decode_sp``, keep every
row on every rank.

One world (tests/torch_world.py: one process and one torch thread a
rank) runs every case while the reference runs in this process;
weights and inputs cross over as numpy."""
import dataclasses
import math
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_world
from repro.configs import reduced_config as ref_reduced_config
from repro.models import model as ref_model
from repro.models.param import materialize
from repro_torch.configs import reduced_config
from repro_torch.launch.mesh import spawn_world
from repro_torch.models import model as model_lib
from repro_torch.models.param import tree_map
from repro_torch.parallel.sharding import (
    Constrainer, preset, prefill_layout, rules_for, serving_layout,
)
from repro_torch.serve.engine import make_prefill_step
from test_torch_matchmaker import one_torch_thread  # noqa: F401
from test_torch_multidevice import numpy_tree
from test_torch_parallel import FakeMesh

WORLD_TIMEOUT_S = 300.0
#: float32 on both sides, different summation orders (the values are
#: O(1)-O(100)); the reference suite's bar
TOL = 1e-4
B, PROMPT, MAX_SEQ, DECODE_STEPS = 8, 8, 32, 2

CASES = [
    dict(arch="qwen2-1.5b", rules="decode", mesh={"data": 8}),
    dict(arch="qwen2-1.5b", rules="decode", mesh={"data": 4, "model": 2}),
    # 6 heads do not divide "model": attention sequence-parallel over it
    dict(arch="qwen2-1.5b", rules="decode", mesh={"data": 2, "model": 4},
         changes=dict(n_heads=6)),
    dict(arch="mamba2-1.3b", rules="decode", mesh={"data": 2, "model": 4}),
    # a capacity that drops nothing on either side (E / top_k)
    dict(arch="jamba-v0.1-52b", rules="ep", mesh={"data": 4, "model": 2},
         capacity_factor=8.0),
    dict(arch="whisper-medium", rules="decode", mesh={"data": 4}),
    dict(arch="llava-next-mistral-7b", rules="decode", mesh={"data": 4}),
]
IDS = [f"{c['arch']}-{'x'.join(str(n) for n in c['mesh'].values())}"
       for c in CASES]


class RankMesh:
    """A shape-only mesh at one rank's coordinate: what the layout and
    `models.model.cache_part` read of a `launch.mesh.WorkerMesh`."""

    empty = False

    def __init__(self, shape, coord):
        self.shape, self.coord = dict(shape), dict(coord)
        self.axis_names = tuple(self.shape)

    def canonical(self, axes):
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes):
        return math.prod(self.shape[a] for a in self.canonical(axes))

    def index(self, axes):
        i = 0
        for a in self.canonical(axes):
            i = i * self.shape[a] + self.coord[a]
        return i


def ref_config(case):
    cfg = dataclasses.replace(ref_reduced_config(case["arch"]),
                              **case.get("changes", {}))
    if case.get("capacity_factor"):
        cfg = torch_world.with_moe(cfg, cfg.moe.n_experts,
                                   case["capacity_factor"])
    return cfg


def inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    size=(B, PROMPT)).astype(np.int32)}
    if cfg.encoder is not None:
        batch["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend is not None:
        batch["patches"] = rng.standard_normal(
            (B, cfg.frontend.n_prefix, cfg.frontend.d_input)).astype(
            np.float32)
    return batch


def ref_serve(cfg, params, batch):
    """The reference's one-device prefill of the whole batch and
    `DECODE_STEPS` greedy decode steps."""
    cache = ref_model.init_cache(cfg, B, MAX_SEQ)
    b = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, cache, lengths = jax.jit(
        lambda p, b, c: ref_model.prefill(p, cfg, b, c))(params, b, cache)
    out = {"logits": np.asarray(logits), "lengths": np.asarray(lengths),
           "cache": numpy_tree(cache), "steps": []}
    step = jax.jit(lambda p, t, c, n: ref_model.decode_step(p, cfg, t, c, n))
    for _ in range(DECODE_STEPS):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)[:, None]
        logits, cache, lengths = step(params, tok, cache, lengths)
        out["steps"].append(np.asarray(logits))
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prefill_rows")
    per_case = []
    for i, case in enumerate(CASES):
        cfg = ref_config(case)
        params = materialize(ref_model.init_model(cfg),
                             jax.random.PRNGKey(0))
        per_case.append((cfg, params, inputs(cfg, 20 + i)))
    cases = [dict(case, params=numpy_tree(params), batch=batch,
                  max_seq=MAX_SEQ, decode_steps=DECODE_STEPS)
             for case, (_, params, batch) in zip(CASES, per_case)]
    with ThreadPoolExecutor(2) as pool:
        running = pool.submit(spawn_world, torch_world.prefill_rows_world, 8,
                              backend="gloo", init_file=tmp / "store",
                              timeout_s=WORLD_TIMEOUT_S, args=(cases,))
        ref = [ref_serve(*c) for c in per_case]
        out = running.result()
    return out, ref


def _ranks(out, i):
    return [r[i] for r in out if r[i] is not None]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_rows_follow_the_reference(world, i):
    """The rows are cut over every batch axis of the mesh (8 rows divide
    them), as the reference's ``batch_shardings_for``; the decode step's
    serving layout cuts them the same way, so its cache is the
    prefill's."""
    out, _ = world
    case = CASES[i]
    ranks = _ranks(out, i)
    assert len(ranks) == math.prod(case["mesh"].values())
    for r in ranks:
        assert r["rows"] == ("data",) and r["kv_seq"] == ()
        assert r["decode_rows"] == r["rows"]


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_kernels_see_the_rank_rows(world, i):
    """The prefill's kernels ran at the rank's row count: flash attention
    (the encoder's, the decoder's and the cross calls) and the SSD scan
    on B / |rows| rows, the unembedding's logits for them; jamba's grouped
    matmul on the rank's own experts (expert-parallel: E / "data" of
    them, their FF columns cut over "model")."""
    out, _ = world
    case = CASES[i]
    cfg = torch_world.tp_config(case)
    n = B // math.prod(case["mesh"][a] for a in ("data",))
    for r in _ranks(out, i):
        seen = r["shapes"]
        assert seen["logits"] and all(s[0] == n for s in seen["logits"])
        assert all(q[0] == n and k[0] == n for q, k in seen["flash"])
        assert all(x[0] == n for x in seen["ssd"])
        if case.get("changes"):     # sequence-parallel: a part of the queries
            m = case["mesh"]["model"]
            assert all(q[1] == PROMPT // m and k[1] == PROMPT
                       for q, k in seen["flash"])
        assert bool(seen["flash"]) == (cfg.family != "ssm")
        assert bool(seen["ssd"]) == (cfg.ssm is not None)
        if cfg.moe is not None:
            E_loc = cfg.moe.n_experts // case["mesh"]["data"]
            f = cfg.moe.d_ff_expert // case["mesh"].get("model", 1)
            assert seen["gmm"] == sorted({(E_loc, cfg.d_model, f),
                                          (E_loc, f, cfg.d_model)})


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_cut_prefill_matches_one_device(world, i):
    """The gathered logits within 1e-4 of the reference's one-device
    prefill of the whole batch, the lengths equal, on every rank."""
    out, ref = world
    for r in _ranks(out, i):
        assert r["logits"].shape == ref[i]["logits"].shape
        assert np.abs(r["logits"] - ref[i]["logits"]).max() < TOL
        np.testing.assert_array_equal(r["lengths"], ref[i]["lengths"])


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_each_rank_fills_its_rows_of_the_cache(world, i):
    """Each rank's cache part within 1e-4 of the reference cache's part
    for that rank (its rows; its kv heads, slots and SSM heads as the
    layout cuts them), the slot positions equal."""
    out, ref = world
    case = CASES[i]
    cfg = torch_world.tp_config(case)
    rules = preset(case["rules"])
    whole = tree_map(torch.tensor, ref[i]["cache"])
    for r in _ranks(out, i):
        layout = Constrainer(rules, RankMesh(case["mesh"], r["coord"]),
                             rows=r["rows"], kv_seq=r["kv_seq"])
        want = _flat(model_lib.cache_part(whole, cfg, layout))
        got = _flat(tree_map(torch.from_numpy, r["cache"]))
        assert set(got) == set(want)
        for path, b in want.items():
            a = got[path]
            assert a.shape == b.shape and a.dtype == b.dtype, path
            if b.dtype == torch.int32:
                assert torch.equal(a, b), path
            else:
                assert float((a - b).abs().max()) < TOL, path


def _flat(tree, pre=""):
    """{path: leaf} of a tree of dicts."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{pre}{k}/"))
        else:
            out[pre + k] = v
    return out


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_decode_follows_from_the_cut_cache(world, i):
    """Two greedy decode steps of `make_decode_step` on the cache the
    cut prefill filled: each step's gathered logits within 1e-4 of the
    reference's decode_step after its prefill."""
    out, ref = world
    for r in _ranks(out, i):
        assert len(r["steps"]) == DECODE_STEPS
        for a, b in zip(r["steps"], ref[i]["steps"]):
            assert np.abs(a - b).max() < TOL


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-v0.1-52b"])
@pytest.mark.parametrize("shape,batch,rows", [
    ({"data": 4, "model": 2}, 8, ("data",)),
    ({"data": 4, "model": 2}, 1, ()),
    ({"data": 4, "model": 2}, None, ()),
    ({"data": 4, "model": 2}, 6, ()),
    ({"pod": 2, "data": 4, "model": 2}, 16, ("pod", "data")),
    # the reference keeps every row where the product does not divide;
    # the serving layout would cut them over "pod"
    ({"pod": 2, "data": 4, "model": 2}, 4, ()),
    ({"data": 1, "model": 8}, 8, ()),
])
def test_prefill_rows_are_all_or_nothing(arch, shape, batch, rows):
    mesh = FakeMesh(shape)
    rules = rules_for(reduced_config(arch), "prefill")
    step = make_prefill_step(reduced_config(arch), mesh, rules, batch=batch)
    assert step.layout.rows == rows
    assert step.layout.kv_seq == ()
    if shape.get("pod") and batch == 4:
        assert serving_layout(rules, mesh, batch).rows == ("pod",)


@pytest.mark.parametrize("shape", [{"data": 8}, {"data": 4, "model": 2},
                                   {"pod": 2, "data": 2, "model": 2}])
def test_decode_sp_and_one_row_keep_every_row(shape):
    """``decode_sp`` cuts the caches' slots over "data", its batch axis:
    its prefill keeps every row on a mesh without "pod" (with one, the
    rows go over "pod" where it divides them); the engine's prefill of
    one request (``batch`` unset or 1) keeps every row under every
    preset."""
    mesh = FakeMesh(shape)
    sp = preset("decode_sp")
    layout = prefill_layout(sp, mesh, 8)
    assert layout.kv_seq == ("data",)
    assert layout.rows == (("pod",) if "pod" in shape else ())
    for name in ("decode", "ep", "decode_sp"):
        for batch in (None, 1):
            assert prefill_layout(preset(name), mesh, batch).rows == ()
    engine_kv = serving_layout(sp, mesh, 8).kv_seq
    assert make_prefill_step(reduced_config("qwen2-1.5b"), mesh, sp,
                             engine_kv).layout.rows == ()
