"""repro_torch.parallel against the JAX package's parallel/: the sharding
rules (a twin of tests/test_sharding.py, and every config's parameter
specs against the reference's on shape-only meshes), the logical axes of
every parameter, and, in one gloo world of 8 ranks on the CPU
(tests/torch_world.py), the expert-parallel MoE layer against the
reference's dense dispatch and the int8-compressed mean.

The world is spawned once for the module (rendezvous through a
``file://`` store in a temporary directory, one torch thread a rank, one
timeout for the world), and the reference runs in this process while it
works."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

import torch_world
from repro.configs import ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.configs import reduced_config as ref_reduced_config
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models.param import axes_tree as ref_axes_tree
from repro.models.param import is_param, materialize
from repro.parallel import sharding as ref_sh
from repro_torch.configs import get_config
from repro_torch.launch.mesh import spawn_world
from repro_torch.models import model as model_lib
from repro_torch.models.param import Leaf, tree_leaves
from repro_torch.parallel import sharding as sh
from repro_torch.parallel.sharding import P

#: EP against the dense dispatch, as the reference's multi-device test
EP_TOL = 1e-4
AUX_TOL = 0.1
#: the layer's gradients, x max |g_ref| of each
GRAD_TOL = 1e-4
#: a gradient that is 0 in exact arithmetic, x the largest of any leaf
ZERO_TOL = 1e-5
#: the world's timeout (it takes about 10 s)
WORLD_TIMEOUT_S = 240.0
#: seeds of the compressed mean's bias estimate
SEEDS = 64


class FakeMesh:
    """Shape-only stand-in so we can test 16x16 rules without devices."""

    def __init__(self, shape):
        self.shape = shape
        self.empty = False


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"16x16": MESH, "2x16x16": MESH3,
          "4x2": FakeMesh({"data": 4, "model": 2}),
          "2x2x2": FakeMesh({"pod": 2, "data": 2, "model": 2}),
          "2x4": FakeMesh({"data": 2, "model": 4}),
          "1x8": FakeMesh({"data": 1, "model": 8}),
          "pod8": FakeMesh({"pod": 8})}
WORKLOADS = ("train", "prefill", "decode", "decode_long")


def spec(ref_spec):
    """A reference PartitionSpec as the port's P."""
    return P(*tuple(ref_spec))


# ---------------------------------------------------------------------------
# the rules (tests/test_sharding.py's twins)
# ---------------------------------------------------------------------------

def test_basic_rules():
    r = sh.rules_for(get_config("qwen2-1.5b"), "train")
    assert r.name == "zero3"
    assert sh.logical_to_spec(("embed", "mlp"), r, MESH) == P("data", "model")
    assert sh.logical_to_spec(("batch", "seq"), r, MESH) == \
        P(("data", "model"), None)
    assert sh.logical_to_spec(("embed", "mlp"), sh.preset("base"), MESH) == \
        P(None, "model")


def test_moe_rules_expert_axis():
    r = sh.rules_for(get_config("llama4-scout-17b-a16e"), "train")
    assert sh.logical_to_spec(("expert", "embed", "mlp"), r, MESH) == \
        P("data", None, "model")


def test_duplicate_mesh_axis_dropped():
    r = sh.rules_for(get_config("granite-8b"), "train")
    assert sh.logical_to_spec(("embed", "embed"), r, MESH) == P("data", None)


def test_batch_axes_multi_pod():
    r = sh.rules_for(get_config("llama4-scout-17b-a16e"), "train")
    assert sh.logical_to_spec(("batch", "seq", "embed"), r, MESH3)[0] == \
        ("pod", "data")


def test_spec_for_divisibility_guard():
    r = sh.rules_for(get_config("mamba2-1.3b"), "train")
    assert sh.spec_for((50280, 2048), ("vocab", "embed"), r, MESH)[0] is None
    assert sh.spec_for((51200, 2048), ("vocab", "embed"), r, MESH)[0] == \
        "model"


@pytest.mark.parametrize("arch", ARCH_NAMES)
@pytest.mark.parametrize("workload", ["train", "decode"])
def test_all_param_specs_divisible(arch, workload):
    cfg = get_config(arch)
    rules = sh.rules_for(cfg, workload)
    for leaf in tree_leaves(model_lib.leaf_tree(cfg)):
        for dim, ax in zip(leaf.shape,
                           sh.spec_for(leaf.shape, leaf.axes, rules, MESH)):
            if ax is not None:
                size = 1
                for a in (ax if isinstance(ax, tuple) else (ax,)):
                    size *= MESH.shape[a]
                assert dim % size == 0, (arch, leaf, ax)


def test_presets_are_the_references():
    for name in ("base", "fsdp", "ep", "decode", "decode_sp", "zero3",
                 "zero3_ep"):
        assert sh.preset(name).rules == ref_sh.preset(name).rules, name
        assert sh.preset(name).name == ref_sh.preset(name).name


def ref_leaves(cfg):
    """(path, Param) of the reference's tree, in its flattening order."""
    return [(".".join(str(k.key) for k in path), p)
            for path, p in jax.tree_util.tree_leaves_with_path(
                ref_model.init_model(cfg), is_leaf=is_param)]


def port_leaves(cfg):
    out = {}

    def walk(t, pre):
        if isinstance(t, Leaf):
            out[pre] = t
        else:
            for k, v in t.items():
                walk(v, f"{pre}.{k}" if pre else k)
    walk(model_lib.leaf_tree(cfg), "")
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_axes_trees_are_the_references(arch):
    """Every leaf's path, full shape and logical axes against the
    reference's ``axes_tree(init_model(cfg))``; `axes_tree` is the same
    tree of axes."""
    ref, port = ref_leaves(ref_get_config(arch)), port_leaves(
        get_config(arch))
    assert sorted(port) == sorted(path for path, _ in ref)
    for path, p in ref:
        assert port[path] == Leaf(tuple(p.shape), tuple(p.axes)), path
    ref_axes = jax.tree_util.tree_leaves(
        ref_axes_tree(ref_model.init_model(ref_get_config(arch))),
        is_leaf=lambda x: isinstance(x, tuple))
    assert sorted(map(repr, map(tuple, ref_axes))) == sorted(
        map(repr, tree_leaves(model_lib.axes_tree(get_config(arch)))))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_are_the_references(arch, mesh):
    """spec_for and logical_to_spec of every parameter, for every
    workload's preset, against the reference's; placements name a Shard
    on each mesh axis the spec uses."""
    m = MESHES[mesh]
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    port = port_leaves(cfg)
    for workload in WORKLOADS:
        rules = sh.rules_for(cfg, workload)
        ref_rules = ref_sh.rules_for(ref_cfg, workload)
        assert rules.name == ref_rules.name
        for path, p in ref_leaves(ref_cfg):
            leaf = port[path]
            got = sh.spec_for(leaf.shape, leaf.axes, rules, m)
            assert got == spec(ref_sh.spec_for(p.shape, p.axes, ref_rules,
                                               m)), (workload, path)
            assert sh.logical_to_spec(leaf.axes, rules, m) == spec(
                ref_sh.logical_to_spec(p.axes, ref_rules, m))
            placed = sh.placements(got, m)
            for name, pl in zip(m.shape, placed):
                used = [d for d, ax in enumerate(got) if ax is not None and
                        name in (ax if isinstance(ax, tuple) else (ax,))]
                assert (pl.dim == used[0]) if used else pl.is_replicate()


def test_spec_trees_and_batch_specs():
    cfg = get_config("jamba-v0.1-52b")
    rules = sh.rules_for(cfg, "train")
    axes = model_lib.axes_tree(cfg)
    ref_axes = ref_axes_tree(ref_model.init_model(ref_get_config(
        "jamba-v0.1-52b")))
    for m in MESHES.values():
        got = tree_leaves(sh.spec_tree(axes, rules, m))
        want = jax.tree_util.tree_leaves(
            ref_sh.spec_tree(ref_axes, ref_sh.rules_for(
                ref_get_config("jamba-v0.1-52b"), "train"), m),
            is_leaf=lambda x: isinstance(x, JP))
        assert sorted(map(repr, got)) == sorted(repr(spec(w)) for w in want)
        assert sh.batch_spec(m, None) == spec(ref_sh.batch_spec(m, None))
    placed = sh.named_sharding_tree(axes, rules, MESH)
    assert len(tree_leaves(placed)) == len(tree_leaves(axes))


def test_constraint_decisions():
    """The reference constrainer's decisions: no constraint on an empty
    mesh or where every axis drops; a tuple falls back to its prefix; a
    heads axis that cannot shard gives "model" to the sequence."""
    r = sh.rules_for(get_config("qwen2-1.5b"), "train")          # zero3
    # 256 rows on 512 ranks: the prefix ("pod", "data"), and the freed
    # "model" goes to the sequence
    assert sh.constraint_spec((256, 64), ("batch", "seq"), r, MESH3) == \
        P(("pod", "data"), "model")
    assert sh.constraint_spec((2, 60), ("batch", "seq"), r, MESH3) == \
        P("pod", None)
    base = sh.preset("base")
    # 40 heads on model=16: heads dropped, seq takes "model"
    assert sh.constraint_spec((32, 4096, 40, 128),
                              ("batch", "seq", "heads_act", None), base,
                              MESH) == P("data", "model", None, None)
    assert sh.constraint_spec((3, 5), ("batch", "seq"), base, MESH) is None
    empty = FakeMesh({"data": 16})
    empty.empty = True
    assert sh.constraint_spec((32, 4), ("batch", None), base, empty) is None
    c = sh.constrainer(base, MESH)
    x = torch.zeros(2, 3)
    assert c(x, ("batch", "seq")) is x
    assert sh.row_axes(r, MESH3, 512) == ("pod", "data", "model")
    assert sh.row_axes(r, MESH3, 64) == ("pod", "data")
    assert sh.row_axes(base, FakeMesh({"data": 4, "model": 2}), 8) == \
        ("data",)
    assert sh.row_axes(r, FakeMesh({"data": 4, "model": 2}), 2) == ()


# ---------------------------------------------------------------------------
# the world: EP and the compressed mean
# ---------------------------------------------------------------------------

MOE_CASE = dict(arch="llama4-scout-17b-a16e", n_experts=4,
                capacity_factor=8.0)


def moe_reference():
    """The reference test's layer: reduced llama4-scout with 4 experts and
    a capacity that drops no token, x (8, 16, d)."""
    cfg = ref_reduced_config(MOE_CASE["arch"])
    cfg = torch_world.with_moe(cfg, MOE_CASE["n_experts"],
                               MOE_CASE["capacity_factor"])
    p = materialize(ref_moe.init_moe(cfg), jax.random.PRNGKey(0))
    x = jax.random.normal(jax.random.PRNGKey(1), (8, 16, cfg.d_model),
                          jnp.float32)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)
    return cfg, p, x, w


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cfg, p, x, w = moe_reference()
    case = dict(MOE_CASE, params=jax.tree_util.tree_map(np.asarray, p),
                x=np.asarray(x), w=w)
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (8, 256),
                                     jnp.float32))
    init = tmp_path_factory.mktemp("world") / "store"
    with ThreadPoolExecutor(1) as pool:       # the reference meanwhile
        world = pool.submit(spawn_world, torch_world.parallel_world, 8,
                            backend="gloo", init_file=init,
                            timeout_s=WORLD_TIMEOUT_S,
                            args=(case, g, list(range(SEEDS))))
        ref = dense_reference(cfg, p, x, w)
        out = world.result()
    return out, ref, g


def dense_reference(cfg, p, x, w):
    """y, aux and the vjp of the reference's dense dispatch at w."""
    y, f_vjp = jax.vjp(lambda p_, x_: ref_moe.moe_forward_dense(
        p_, cfg, x_)[0], p, x)
    aux = ref_moe.moe_forward_dense(p, cfg, x)[1]
    dp, dx = f_vjp(jnp.asarray(w))
    ref = {"y": np.asarray(y), "aux": float(aux), "dx": np.asarray(dx),
           "dw": [np.asarray(a) for a in jax.tree_util.tree_leaves(dp)],
           "names": [".".join(str(k.key) for k in path) for path, _ in
                     jax.tree_util.tree_leaves_with_path(dp)]}
    return ref


def assembled(out, layout, key):
    """A layout's rows from every rank, in row order."""
    parts = {}
    for r in out:
        part = r["moe"][layout]
        parts.setdefault(part["index"], part[key])
    return np.concatenate([parts[i] for i in range(len(parts))])


@pytest.mark.parametrize("layout", list(torch_world.EP_LAYOUTS))
def test_moe_layer_on_a_mesh_matches_dense_reference(world, layout):
    """EP on (4, 2) with the tokens replicated over "model" and with them
    cut over "model" too, and the dense dispatch over the gathered batch
    on (8,), against the reference's moe_forward_dense: y within 1e-4,
    aux within 0.1 (EP's is the mean of local estimates), the gradients
    of sum(y * w) within 1e-4 of each one's max."""
    out, ref, _ = world
    r0 = out[0]["moe"][layout]
    assert r0["used_ep"] == layout.startswith("ep")
    assert np.abs(assembled(out, layout, "y") - ref["y"]).max() < EP_TOL
    auxes = {r["moe"][layout]["aux"] for r in out}
    assert len(auxes) == 1
    assert abs(auxes.pop() - ref["aux"]) < AUX_TOL
    dx = assembled(out, layout, "dx")
    assert np.abs(dx - ref["dx"]).max() <= GRAD_TOL * np.abs(ref["dx"]).max()
    want = dict(zip(ref["names"], ref["dw"]))
    assert sorted(r0["dw"]) == sorted(want)
    largest = max(np.abs(w).max() for w in want.values())
    for name, got in r0["dw"].items():
        w = want[name]
        if name == "router":
            # top-1 gates are 1 whatever the logits: the router's gradient
            # is 0 in exact arithmetic, rounding noise on both sides
            assert max(np.abs(got).max(), np.abs(w).max()) <= \
                ZERO_TOL * largest
            continue
        assert np.abs(got - w).max() <= GRAD_TOL * np.abs(w).max(), name


@pytest.mark.parametrize("layout", list(torch_world.EP_LAYOUTS))
def test_moe_aux_on_a_mesh_is_the_mean_of_local_estimates(world, layout):
    """Under EP, aux is the mean over the "data" ranks of the reference's
    aux on each one's tokens (the reference's pmean of local estimates),
    and the dense dispatch on a mesh gives the global aux: the value
    within 1e-5, and its gradient (x's and the router's) within 1e-4 of
    each one's max."""
    out, _, _ = world
    cfg, p, x, _ = moe_reference()

    def aux_of(router, x_):
        q = dict(p, router=router)
        if layout == "dense_on_mesh":
            return ref_moe.moe_forward_dense(q, cfg, x_)[1]
        return jnp.mean(jnp.stack([
            ref_moe.moe_forward_dense(q, cfg, x_[2 * i:2 * i + 2])[1]
            for i in range(4)]))
    aux, (d_router, d_x) = jax.value_and_grad(aux_of, argnums=(0, 1))(
        p["router"], x)
    assert abs(out[0]["moe"][layout]["aux"] - float(aux)) < 1e-5
    got_dx = assembled(out, layout, "daux_dx")
    assert np.abs(got_dx - d_x).max() <= GRAD_TOL * np.abs(d_x).max()
    got_r = out[0]["moe"][layout]["daux_router"]
    assert np.abs(got_r - d_router).max() <= \
        GRAD_TOL * np.abs(d_router).max()


def test_compressed_psum_bounded_and_identical(world):
    """The reference's test_compressed_psum_unbiased bar: every rank's
    mean within amax/127 of the exact mean, and every rank holds the same
    bits (the rounding draws are the same on every rank)."""
    out, _, g = world
    exact = g.mean(axis=0, keepdims=True)
    step = float(np.abs(g).max()) / 127.0
    first = out[0]["compressed"]["outs"]
    assert np.abs(first[0] - exact).max() <= step
    assert np.abs(first - exact).max() <= step
    for r in out[1:]:
        assert np.array_equal(r["compressed"]["outs"], first)


def test_compressed_psum_unbiased(world):
    """Stochastic rounding makes the mean unbiased.  In units of the scale
    s = amax/127 an element's error is the mean of n = 8 independent
    rounding errors of variance at most 1/4, so the mean error over S = 64
    seeds and M = 256 elements has a standard deviation of at most
    sqrt(1/(4 n S M)); it must stay within five of them."""
    out, _, g = world
    exact = g.mean(axis=0, keepdims=True)
    scale = float(np.abs(g).max()) / 127.0
    outs = out[0]["compressed"]["outs"]
    err = (outs - exact[None]) / scale
    n, S, M = 8, outs.shape[0], g.shape[1]
    sigma = np.sqrt(1.0 / (4 * n * S * M))
    assert abs(err.mean()) <= 5 * sigma
    # a rounding that always went down (floor without u) would be biased
    assert abs(err.mean()) < 0.5 / n


def test_compressed_psum_tree_keeps_dtypes_and_pods_agree(world):
    out, _, g = world
    by_pod = {}
    for r in out:
        c = r["compressed"]
        by_pod.setdefault(c["pod"], []).append(c["tree"])
        assert c["tree_dtypes"] == ["torch.float32", "torch.float64"]
    # ranks (0, d, m) and (1, d, m) held rows r and r + 4
    for rank in range(4):
        a = out[rank]["compressed"]["tree"]
        b = out[rank + 4]["compressed"]["tree"]
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
        exact = (g[rank] + g[rank + 4]) / 2
        step = max(np.abs(g[rank]).max(), np.abs(g[rank + 4]).max()) / 127
        assert np.abs(np.concatenate([a[0][0], a[1][0]]) - exact).max() \
            <= step + 1e-6


def test_mesh_defaults_to_the_gpu(tmp_path):
    """A mesh's device is the GPU unless the caller asks for the CPU, as
    `init_model` and `make_train_step` default: without one it raises
    where there is no GPU, and ``device="cpu"`` keeps the ranks on the
    CPU."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import WorkerMesh, make_worker_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        assert make_worker_mesh(device="cpu").device == torch.device("cpu")
        if torch.cuda.is_available():
            assert WorkerMesh({"data": 1, "model": 1}).device.type == "cuda"
            assert make_worker_mesh().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="device='cpu'"):
                WorkerMesh({"data": 1, "model": 1})
            with pytest.raises(RuntimeError, match="device='cpu'"):
                make_worker_mesh()
    finally:
        dist.destroy_process_group()
