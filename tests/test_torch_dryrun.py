"""The dry-run (`repro_torch.launch.dryrun`, `launch.roofline_adjust`)
against the JAX package's, on what compares without 512 devices: the
input specs, the call sites and their arithmetic, the collective byte
model, the model FLOPs, the ranks' shard shapes on 16×16, the depth
extrapolation, and a fake world's count against a real gloo world's.
The H100's half (sites per step against measured launches, the bound
against a measured step) is `chip_smoke.py`'s phase 29 and
tests/test_torch_cuda.py."""
import dataclasses
import json
import math
import os
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.utils._pytree import tree_flatten

import chip_smoke
import torch_world
from repro.configs import get_config as ref_get_config
from repro.configs import input_specs as ref_input_specs
from repro.launch import roofline_adjust as ref_ra
from repro.models import model as ref_model
from repro.models.param import is_param
from repro.parallel import sharding as ref_sh
from repro_torch.configs import (
    ARCH_NAMES, SHAPES, applicable, get_config, input_specs, reduced_config,
)
from repro_torch.configs.shapes import ShapeCell
from repro_torch.kernels import sites
from repro_torch.launch import dryrun
from repro_torch.launch import roofline_adjust as ra
from repro_torch.launch.mesh import WorkerMesh, spawn_world
from repro_torch.models import model as model_lib
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.train.optimizer import OptimizerConfig

CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES]
RUNNABLE = [(a, s) for a, s in CELLS
            if applicable(get_config(a), SHAPES[s])[0]]


def _ref_dryrun(name):
    """A function of the reference dry-run (its module sets XLA_FLAGS
    when imported; the environment is put back)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dryrun
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return getattr(ref_dryrun, name)


def _ref_cache_shardings():
    """The reference dry-run's ``cache_shardings``."""
    return _ref_dryrun("cache_shardings")


def _paths(tree, pre=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, f"{pre}{k}/"))
        return out
    return {pre.rstrip("/"): tree}


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    """Every (arch × shape): the same names, shapes and dtypes as the
    reference's ShapeDtypeStructs, on the meta device (nothing
    allocated)."""
    cfg, cell = get_config(arch), SHAPES[shape]
    port = _paths(input_specs(cfg, cell))
    ref = {jax.tree_util.keystr(p).replace("']['", "/").strip("[']"): leaf
           for p, leaf in jax.tree_util.tree_flatten_with_path(
               ref_input_specs(ref_get_config(arch), cell))[0]}
    assert set(port) == set(ref)
    for name, t in port.items():
        assert t.device.type == "meta", name
        assert tuple(t.shape) == tuple(ref[name].shape), name
        assert str(t.dtype).split(".")[1] == str(ref[name].dtype), name


def test_decode_cache_bytes_equal_reference():
    """maverick's long_500k cache (27 GB global) is described, not
    allocated, and holds the reference's bytes."""
    cell = SHAPES["long_500k"]
    port = input_specs(get_config("llama4-maverick-400b-a17b"), cell)
    ref = ref_input_specs(ref_get_config("llama4-maverick-400b-a17b"), cell)
    total = sum(t.numel() * t.element_size()
                for t in tree_leaves(port["cache"]))
    assert total == sum(l.size * jnp.dtype(l.dtype).itemsize
                        for l in jax.tree_util.tree_leaves(ref["cache"]))
    assert 10e9 < total < 100e9


# ---------------------------------------------------------------------------
# call sites and their arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_sites_match_reference(arch, shape):
    cfg, cell = get_config(arch), SHAPES[shape]
    ref_cfg = ref_get_config(arch)
    assert ra.attention_sites(cfg, cell) == ref_ra.attention_sites(ref_cfg,
                                                                   cell)
    assert ra.ssd_sites(cfg, cell) == ref_ra.ssd_sites(ref_cfg, cell)
    for S in (1, 7, cell.seq_len):
        for w in (None, 1, 16, 4096, cell.seq_len + 1):
            assert ra._causal_fraction(S, w) == ref_ra._causal_fraction(S, w)


def test_chip_smoke_bounds_are_the_site_formulas():
    """`chip_smoke.py`'s bounds (read from the data: the mask, the group
    sizes) and the dry-run's site pricing (from shapes alone) agree at a
    fully masked causal shape: every slot holds a key, every group full."""
    from repro_torch.kernels.flash_attention.ref import attention_mask

    B, S, Hq, Hkv, Dh = 2, 96, 4, 2, 32
    q = torch.zeros(B, S, Hq, Dh, dtype=torch.bfloat16)
    k = torch.zeros(B, S, Hkv, Dh, dtype=torch.bfloat16)
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).contiguous()
    for window in (None, 16):
        mask = attention_mask(pos, pos, causal=True, window=window)
        site = ra.Site("flash_attention", (B, S, S, Hq, Hkv, Dh), "bfloat16",
                       causal=True, window=window)
        assert chip_smoke.flash_bound(q, k, k, pos, pos, mask)[2:] == \
            ra.kernel_cost(site)
        bwd = dataclasses.replace(site, kernel="flash_attention_bwd")
        assert chip_smoke.flash_bwd_bound(q, k, pos, pos, mask)[2:] == \
            ra.kernel_cost(bwd)
        assert chip_smoke.flash_bound(q, k, k, pos, pos, mask)[:2] == \
            ra.bound_ms(*ra.kernel_cost(site), torch.bfloat16)
    Bs, H, P, G, N, chunk = 2, 4, 16, 1, 8, 32
    x = torch.zeros(Bs, S, H, P, dtype=torch.bfloat16)
    Bm = torch.zeros(Bs, S, G, N, dtype=torch.bfloat16)
    dt = torch.zeros(Bs, S, H)
    site = ra.Site("ssd", (Bs, S, H, P, G, N), "bfloat16", chunk=chunk)
    assert chip_smoke.ssd_bound(x, dt, Bm, Bm, None, chunk)[2:] == \
        ra.kernel_cost(site)
    bwd = dataclasses.replace(site, kernel="ssd_bwd")
    assert chip_smoke.ssd_bwd_bound(x, Bm, None, None, chunk)[2:] == \
        ra.kernel_cost(bwd)
    E, C, K, Nn = 4, 24, 64, 48
    lhs = torch.zeros(E * C, K, dtype=torch.bfloat16)
    rhs = torch.zeros(E, K, Nn, dtype=torch.bfloat16)
    gs = torch.full((E,), C, dtype=torch.int32)
    out = torch.zeros(E * C, Nn)
    site = ra.Site("gmm", (E * C, K, Nn, E), "bfloat16", rows=E * C, live=E,
                   out_dtype="float32")
    assert chip_smoke.gmm_bound(lhs, rhs, gs, out)[2:] == ra.kernel_cost(site)
    for need, which in (((True, False), "dlhs"), ((False, True), "drhs")):
        bwd = dataclasses.replace(site, kernel="gmm_bwd", need=need)
        assert chip_smoke.gmm_bwd_bound(lhs, rhs, gs, out, which)[2:] == \
            ra.kernel_cost(bwd)


def test_plain_calibration_counts_the_plain_versions():
    """The calibrated plain cost per element is the plain version's
    count: 4 Dh FLOPs a score element forward (QK^T and PV), more than
    the kernel's bytes (the scores go through memory)."""
    cal = ra._calibrate_attention()
    assert cal["f_fwd"] == 4 * cal["dh"]
    assert cal["f_grad"] > 2 * cal["f_fwd"]
    site = ra.Site("flash_attention", (2, 512, 512, 4, 2, 64), "bfloat16",
                   causal=True)
    assert ra.plain_cost(site)[0] > 10 * ra.kernel_cost(site)[0]
    cs = ra._calibrate_ssd()
    assert 0 < cs["f_fwd"] < cs["f_grad"]


# ---------------------------------------------------------------------------
# the collective byte model, in a fake world
# ---------------------------------------------------------------------------

def test_collective_model_counts_the_reference_shapes():
    """The shapes of the reference's ``test_collective_parser_counts_
    shapes``, as collectives of a fake world of 16 ranks: all-reduce 2x
    its result, the others 1x; a group inside one node of 8 ranks rides
    NVLink, one across nodes the network."""
    with dryrun.fake_world(16):
        node = dist.new_group(list(range(8)))
        four = dist.new_group([0, 1, 2, 3])
        wide = dist.new_group(list(range(0, 16, 2)))
        bf16 = dict(dtype=torch.bfloat16)
        x, parts = torch.zeros(16, 128), [torch.zeros(1, 256, **bf16)
                                          for _ in range(4)]
        a2a = torch.zeros(8, 64, **bf16), torch.zeros(8, 64, **bf16)
        rs = torch.zeros(2, 32), torch.zeros(16, 32)
        got = torch.zeros(10, dtype=torch.int32)
        counter = dryrun.OpCounter()
        with counter:
            dist.all_reduce(x, group=node)
            dist.all_gather(parts, parts[0], group=four)
            dist.all_to_all_single(*a2a, group=wide)
            dist.reduce_scatter_tensor(*rs, group=wide)
            dist.recv(got, src=1)
    assert counter.coll == {"all-reduce": 2 * 16 * 128 * 4,
                            "all-gather": 4 * 256 * 2,
                            "all-to-all": 8 * 64 * 2,
                            "reduce-scatter": 2 * 32 * 4,
                            "collective-permute": 10 * 4}
    assert counter.links == {
        "nvlink": 2 * 16 * 128 * 4 + 4 * 256 * 2,
        "network": 8 * 64 * 2 + 2 * 32 * 4 + 10 * 4}
    assert counter.bytes == 0 and not dist.is_initialized()


# ---------------------------------------------------------------------------
# model FLOPs, shard shapes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_model_flops_per_chip_is_the_reference_formula(arch):
    ref_cfg = ref_get_config(arch)
    for cell in SHAPES.values():
        tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                      else 1)
        want = ((6 if cell.kind == "train" else 2)
                * ref_cfg.active_param_count_estimate() * tokens / 256)
        assert dryrun.model_flops_per_chip(get_config(arch), cell,
                                           256) == want


def _shard(shape, spec, mesh_shape):
    out = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else (
            entry if isinstance(entry, tuple) else (entry,))
        out.append(dim // int(np.prod([mesh_shape[a] for a in axes])))
    return tuple(out)


MESH = {"data": 16, "model": 16}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_shards_follow_reference_specs(arch):
    """Each rank's parameter (and moment) shards in the dry-run's train
    step on 16×16 are the reference's ``spec_for`` cut of every leaf
    under its training rules."""
    abstract = AbstractMesh((16, 16), ("data", "model"))
    ref_cfg = ref_get_config(arch)
    rules = ref_sh.rules_for(ref_cfg, "train")
    want = {jax.tree_util.keystr(p).replace("']['", "/").strip("[']"):
            _shard(leaf.shape, ref_sh.spec_for(leaf.shape, leaf.axes, rules,
                                               abstract), MESH)
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                ref_model.init_model(ref_cfg), is_leaf=is_param)[0]}
    from torch._subclasses.fake_tensor import FakeTensorMode
    with dryrun.fake_world(256), FakeTensorMode():
        mesh = WorkerMesh(MESH, "cpu")
        built = dryrun.build_train(get_config(arch), mesh,
                                   SHAPES["train_4k"])
        got = {k: tuple(t.shape) for k, t in
               _paths(built.arguments["params"]).items()}
        moments = [tuple(t.shape) for t in
                   tree_leaves(built.arguments["mu"])]
    assert got == want
    assert moments == list(got.values())


@pytest.mark.parametrize("arch,shape", [
    (a, s) for a in ("llama4-maverick-400b-a17b", "jamba-v0.1-52b",
                     "qwen2-1.5b", "mamba2-1.3b")
    for s in ("decode_32k", "long_500k") if (a, s) in RUNNABLE])
def test_decode_cache_shards_follow_reference(arch, shape):
    """Each rank's part of the decode cache on 16×16 is the reference's
    ``cache_shardings`` cut for the keys, values and SSM states: batch
    over "data" where it divides, kv heads over "model" where they
    divide, else the slots (over "data" and "model" for one row).  The
    port's own layout cuts the slot positions with the keys (the
    reference keeps them whole) and gives a rank the conv channels of its
    SSM heads (the reference's even cut of the channels is not
    head-aligned)."""
    cfg, cell = get_config(arch), SHAPES[shape]
    abstract = AbstractMesh((16, 16), ("data", "model"))
    B, S = cell.global_batch, cell.seq_len
    ref_cache = ref_model.init_cache(ref_get_config(arch), B, S,
                                     abstract=True)
    ref_sh_tree = _ref_cache_shardings()(ref_get_config(arch), abstract,
                                         ref_cache, B)
    want = {jax.tree_util.keystr(p).replace("']['", "/").strip("[']"):
            _shard(leaf.shape, sh.spec, MESH)
            for (p, leaf), sh in zip(
                jax.tree_util.tree_flatten_with_path(ref_cache)[0],
                jax.tree_util.tree_leaves(ref_sh_tree))}
    from torch._subclasses.fake_tensor import FakeTensorMode
    with dryrun.fake_world(256), FakeTensorMode():
        mesh = WorkerMesh(MESH, "cpu")
        built = dryrun.build_decode(cfg, mesh, cell)
        got = {k: tuple(t.shape) for k, t in
               _paths(built.arguments["cache"]).items()}
    assert set(got) == set(want)
    for name, shape_ in got.items():
        leaf = name.rsplit("/", 1)[1]
        if leaf in ("k", "v", "ssm"):
            assert shape_ == want[name], name
        elif leaf == "pos":
            assert shape_ == got[name[:-3] + "k"][:3], name
        else:                                   # conv: the rank's heads
            s = cfg.ssm
            di, H = s.d_inner(cfg.d_model), s.n_heads(cfg.d_model)
            assert shape_[-1] == di // 16 + 2 * s.ngroups * s.d_state, name
            assert H % 16 == 0


PROD_MESHES = {"16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}


@pytest.mark.parametrize("mesh_name", PROD_MESHES)
@pytest.mark.parametrize("arch", [a for a, s in RUNNABLE
                                  if s == "prefill_32k"])
def test_prefill_rows_and_cache_follow_reference(arch, mesh_name):
    """The prefill step's rows on each production mesh are the
    reference's ``batch_shardings_for`` batch axes (("pod", "data") when
    they divide the batch, else none), and each rank's part of the cache
    holds the rows the reference's ``cache_shardings`` gives it; the
    step takes the whole batch."""
    shape = PROD_MESHES[mesh_name]
    cfg, cell = get_config(arch), SHAPES["prefill_32k"]
    ref_cfg = ref_get_config(arch)
    abstract = AbstractMesh(tuple(shape.values()), tuple(shape))
    B, S = cell.global_batch, cell.seq_len
    b_sh = _ref_dryrun("batch_shardings_for")(
        ref_cfg, abstract, ref_input_specs(ref_cfg, cell), B)
    bdims = {sh.spec[0] for sh in b_sh.values()}
    assert len(bdims) == 1
    bdim = bdims.pop()
    want_rows = () if bdim is None else tuple(
        bdim if isinstance(bdim, tuple) else (bdim,))
    ref_cache = ref_model.init_cache(ref_cfg, B, S, abstract=True)
    ref_sh = _ref_cache_shardings()(ref_cfg, abstract, ref_cache, B)
    want = {jax.tree_util.keystr(p).replace("']['", "/").strip("[']"):
            _shard(leaf.shape, sh.spec, shape)[1]
            for (p, leaf), sh in zip(
                jax.tree_util.tree_flatten_with_path(ref_cache)[0],
                jax.tree_util.tree_leaves(ref_sh))}
    from torch._subclasses.fake_tensor import FakeTensorMode
    with dryrun.fake_world(math.prod(shape.values())), FakeTensorMode():
        mesh = WorkerMesh(shape, "cpu")
        built = dryrun.build_prefill(cfg, mesh, cell)
        got = {k: t.shape[1] for k, t in
               _paths(built.arguments["cache"]).items()}
        batch = {k: tuple(t.shape) for k, t in
                 built.arguments["batch"].items()}
    assert tuple(built.notes["rows"]) == want_rows
    assert want_rows == tuple(a for a in ("pod", "data") if a in shape)
    assert got == want
    assert all(b[0] == B for b in batch.values())


def _count(run):
    counter = dryrun.OpCounter()
    with dryrun.recording(counter):
        run()
    return counter


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b"])
def test_cut_prefill_counts_the_uncut_prefill_of_its_rows(arch):
    """In a fake world of 16 on (data 4, model 4), the prefill step of B
    rows cut over "data" counts what the uncut step counts over B / 4
    rows -- the same FLOPs, sites, eager bytes and collective bytes --
    and the step's own gather of its results over the rows besides (the
    logits' all-gather, the lengths made whole): no more."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.layers import _rope_freqs
    from repro_torch.parallel import collectives as coll
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.serve.engine import make_prefill_step

    cfg = _tiny(arch, periods=1)
    B, S, n = 8, 32, 4
    rules = rules_for(cfg, "prefill")

    def batch(rows):
        return {k: torch.empty(v.shape, dtype=v.dtype) for k, v in
                input_specs(cfg, ShapeCell("t", "prefill", S, rows)).items()}
    try:
        with dryrun.fake_world(16), FakeTensorMode():
            mesh = WorkerMesh({"data": n, "model": 4}, "cpu")
            params = dryrun._serving_params(cfg, mesh, rules)
            counts = {}
            for name, rows, step in (
                    ("cut", B, make_prefill_step(cfg, mesh, rules, batch=B)),
                    ("uncut", B // n, make_prefill_step(cfg, mesh, rules))):
                cache = model_lib.init_cache(cfg, B // n, S, device="cpu",
                                             layout=step.layout)
                b = batch(rows)
                counts[name] = _count(lambda: step(params, b, cache))
                assert step.layout.rows == (("data",) if name == "cut"
                                            else ())
            logits = torch.empty((B // n, cfg.vocab_size))
            lengths = torch.empty((B // n,), dtype=torch.int32)
            counts["gather"] = _count(lambda: (
                coll.all_gather(logits, mesh, ("data",), 0),
                lengths.repeat(n)))
    finally:
        _rope_freqs.cache_clear()
    cut, uncut, gather = (counts[k] for k in ("cut", "uncut", "gather"))
    assert cut.flops == uncut.flops and not gather.flops
    assert Counter(cut.sites) == Counter(uncut.sites) and cut.sites
    assert cut.bytes == uncut.bytes + gather.bytes
    assert cut.coll == {k: uncut.coll[k] + gather.coll[k]
                        for k in dryrun.COLLECTIVE_KINDS}
    assert cut.links == {k: uncut.links[k] + gather.links[k]
                         for k in uncut.links}
    assert gather.coll["all-gather"] == B * cfg.vocab_size * 4


# ---------------------------------------------------------------------------
# the count: depth extrapolation, sites, arguments, a real world
# ---------------------------------------------------------------------------

TINY = ShapeCell("tiny", "train", 32, 8)
TINY_PREFILL = ShapeCell("tiny_prefill", "prefill", 32, 8)
SMALL_MESH = {"data": 2, "model": 2}


def _tiny(arch, periods=4):
    cfg = reduced_config(arch)
    enc = cfg.encoder
    return dataclasses.replace(
        cfg, n_layers=periods * cfg.period,
        encoder=None if enc is None else dataclasses.replace(enc,
                                                             n_layers=3))


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "whisper-medium"])
def test_depth_extrapolation_equals_full_depth(arch):
    """The reference's depth variants (1× and 2× period, unrolled),
    extrapolated, give the full-depth trace's count exactly: the port's
    loop counts every layer."""
    cfg = _tiny(arch, periods=3)
    with dryrun.fake_world(4):
        mesh = WorkerMesh(SMALL_MESH, "cpu")
        full = dryrun.costs_of(dryrun.trace(cfg, mesh, TINY,
                                            remat="none")[0])
        variants, extrapolate = dryrun._depth_variants(cfg)
        ex = extrapolate([dryrun.costs_of(dryrun.trace(
            v, mesh, TINY, unroll=True, remat="none")[0])
            for v in variants])
    for k in set(full) | set(ex):
        assert ex.get(k, 0.0) == full.get(k, 0.0), k


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "whisper-medium", "jamba-v0.1-52b"])
def test_sites_per_step_are_the_training_launches(arch):
    """On a mesh of one rank the dry-run's step is `run_fixed`'s: its
    kernel sites are the launches `chip_smoke.training_launches` gates
    on the card, and its argument bytes the state's (parameters and both
    moments) and the batch."""
    cfg = _tiny(arch, periods=1)
    opt = OptimizerConfig(state_dtype=cfg.optimizer_state_dtype, lr=1e-3)
    with dryrun.fake_world(1):
        mesh = WorkerMesh({"data": 1, "model": 1}, "cpu")
        counter, built = dryrun.trace(cfg, mesh, TINY, remat="none",
                                      opt_cfg=opt)
    launches = chip_smoke.training_launches(cfg)
    assert dict(Counter(s.kernel for s in counter.sites)) == {
        k: n for k, n in launches.items() if n}
    params = model_lib.init_model(cfg, device="cpu")
    state = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    args = {k: dryrun._bytes_of(v) for k, v in built.arguments.items()}
    assert args["params"] == state
    assert args["mu"] == args["nu"] == 4 * sum(
        t.numel() for t in tree_leaves(params))


@pytest.mark.parametrize("arch,kind", [
    *((a, k) for a in ("qwen2-1.5b", "mamba2-1.3b", "whisper-medium",
                       "jamba-v0.1-52b")
      for k in ("train", "prefill", "decode")),
    ("llava-next-mistral-7b", "prefill")])
def test_config_sites_are_the_recorded_sites(arch, kind):
    """The reference-style enumeration from the config
    (`roofline_adjust.config_sites`, which `kernel_adjusted` prices when
    given no recorded sites) is, on one rank, exactly the calls the
    trace records: the same kernels at the same shapes, masks and
    dtypes, remat "full" recomputing each training forward."""
    cfg = _tiny(arch, periods=1)
    cell = ShapeCell("tiny", kind, 32, 2)
    with dryrun.fake_world(1):
        mesh = WorkerMesh({"data": 1, "model": 1}, "cpu")
        counter, _ = dryrun.trace(cfg, mesh, cell, remat="full")
    assert Counter(counter.sites) == Counter(ra.config_sites(cfg, cell))


def test_remat_full_records_the_recomputed_forwards():
    cfg = _tiny("qwen2-1.5b", periods=2)
    with dryrun.fake_world(1):
        mesh = WorkerMesh({"data": 1, "model": 1}, "cpu")
        counter, _ = dryrun.trace(cfg, mesh, TINY, remat="full")
    assert Counter(s.kernel for s in counter.sites) == {
        "flash_attention": 2 * cfg.n_layers,
        "flash_attention_bwd": cfg.n_layers}


def test_fake_world_counts_what_a_gloo_world_runs(tmp_path):
    """A reduced config's step on a fake {"data": 2, "model": 2} world
    counts the FLOPs, bytes, collective bytes and sites that the same
    step counts when it runs for real on rank 0 of a gloo world of 4 CPU
    processes, under zero3 (the batch over every axis) and under base
    (heads, MLP and vocabulary cut over "model"); so does its prefill
    step, the rows cut over "data" and the logits gathered."""
    cfg = _tiny("qwen2-1.5b", periods=1)
    case = {"cfg": cfg, "cell": TINY, "mesh": SMALL_MESH,
            "rules": ["zero3", "base"], "prefill": TINY_PREFILL}
    real = spawn_world(torch_world.dryrun_counts, 4, backend="gloo",
                       init_file=tmp_path / "store", timeout_s=120,
                       args=(case,))[0]
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in input_specs(cfg, TINY).items()}
    with dryrun.fake_world(4):
        mesh = WorkerMesh(SMALL_MESH, "cpu")
        for rules in case["rules"]:
            counter, _ = dryrun.trace(cfg, mesh, TINY, remat="none",
                                      rules_name=rules, batch=batch)
            fake = torch_world.dryrun_numbers(counter)
            assert fake == real[rules], rules
            assert sum(fake["coll"].values()) > 0
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in input_specs(cfg, TINY_PREFILL).items()}
        counter, built = dryrun.trace(cfg, mesh, TINY_PREFILL, batch=batch)
        fake = torch_world.dryrun_numbers(counter)
        assert built.notes["rows"] == ["data"]
        assert fake == real["prefill"]
        assert fake["coll"]["all-gather"] > 0


def test_int8_without_pod_is_the_uncompressed_step():
    """As the reference's: the compressed step re-reduces over "pod", and
    a mesh without one trains uncompressed; the result says so."""
    cfg = _tiny("qwen2-1.5b", periods=2)
    with dryrun.fake_world(4):
        mesh = WorkerMesh(SMALL_MESH, "cpu")
        squeezed, built = dryrun.trace(cfg, mesh, TINY, remat="none",
                                       rules_name="base",
                                       grad_compression="int8")
        plain, _ = dryrun.trace(cfg, mesh, TINY, remat="none",
                                rules_name="base")
    assert built.notes["grad_compression"]["applied"] is None
    assert torch_world.dryrun_numbers(squeezed) == \
        torch_world.dryrun_numbers(plain)


# ---------------------------------------------------------------------------
# run_cell, the CLI, the hook
# ---------------------------------------------------------------------------

def test_run_cell_tears_down_and_refuses_a_live_group(tmp_path):
    assert dryrun.main(["--arch", "whisper-medium", "--shape", "decode_32k",
                        "--out", str(tmp_path)]) == 0
    assert not dist.is_initialized() and sites.recorder is None
    res = json.loads((tmp_path / "whisper-medium_decode_32k_single.json")
                     .read_text())
    for key in ("roofline", "roofline_extrapolated",
                "roofline_kernel_adjusted", "memory",
                "collective_bytes_per_chip"):
        assert key in res, key
    assert res["memory"]["fits_hbm"] and not res["cuda_initialized"]
    assert res["sites"] == {"flash_attention": 48}
    skipped = dryrun.run_cell("qwen2-1.5b", "long_500k")
    assert skipped["skipped"] and "quadratic" in skipped["reason"]
    with dryrun.fake_world(1):
        with pytest.raises(RuntimeError, match="already exists"):
            dryrun.run_cell("whisper-medium", "decode_32k")
    assert not dist.is_initialized()


def test_recording_puts_the_wrappers_back():
    counter = dryrun.OpCounter()
    with pytest.raises(ValueError):
        with dryrun.recording(counter):
            assert sites.recorder is not None
            raise ValueError("inside")
    assert sites.recorder is None


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-1.3b",
                                  "whisper-medium"])
def test_unroll_is_the_rolled_result(arch):
    """``unroll=True`` on every entry point: forward, loss_fn, prefill,
    decode_step, stack_forward and a train step give unroll=False's
    results bit for bit."""
    from repro_torch.models import transformer as tfm
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = reduced_config(arch)
    params = model_lib.init_model(cfg, device="cpu")
    batch = {k: torch.zeros(v.shape, dtype=v.dtype)
             for k, v in input_specs(cfg, ShapeCell("t", "train", 16, 2)
                                     ).items()}
    batch["tokens"] = torch.arange(32, dtype=torch.int32).reshape(2, 16)
    batch["labels"] = batch["tokens"] + 1
    for k in ("frames", "patches"):
        if k in batch:
            batch[k] = torch.linspace(-1, 1, batch[k].numel()).reshape(
                batch[k].shape)

    def both(fn):
        a, b = (tree_flatten(fn(u))[0] for u in (False, True))
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert torch.equal(x, y)

    both(lambda u: model_lib.forward(params, cfg, batch, unroll=u))
    both(lambda u: model_lib.loss_fn(params, cfg, batch, unroll=u)[0])
    x = torch.linspace(-1, 1, 2 * 16 * cfg.d_model).reshape(2, 16,
                                                           cfg.d_model)
    if cfg.encoder is None:
        both(lambda u: tfm.stack_forward(params["stack"], cfg, x,
                                         unroll=u)[0])
    prompt = {k: v for k, v in batch.items() if k != "labels"}
    S = 16 + (cfg.frontend.n_prefix if cfg.frontend is not None else 0) + 1

    def serve(u):
        cache = model_lib.init_cache(cfg, 2, S, device="cpu")
        logits, cache, lengths = model_lib.prefill(params, cfg, prompt,
                                                   cache, unroll=u)
        tok = logits.argmax(-1, keepdim=True)
        return logits, model_lib.decode_step(params, cfg, tok, cache,
                                             lengths, unroll=u)[0]

    both(serve)

    def step(u):
        state = init_train_state(tree_map(torch.clone, params),
                                 OptimizerConfig())
        fn = make_train_step(cfg, OptimizerConfig(), unroll=u, remat="none",
                             device="cpu")
        state, metrics = fn(state, batch)
        return metrics["loss"], state.params

    both(step)
