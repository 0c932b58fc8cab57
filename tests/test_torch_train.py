"""The port's training path on the CPU against the JAX package's.

Weights are the reference's own (``materialize`` with a JAX key), carried
across by `params_from_reference`; batches come from the synthetic
pipeline, whose numpy code both packages share.  Both sides run the
reduced configs in float32, so they differ only in the order of float32
sums:

  * `loss_fn`'s loss and metrics: relative 1e-5;
  * gradients against ``jax.value_and_grad(loss_fn, remat="none")``, per
    leaf: max |diff| <= 1e-4 x max |g_ref| of that leaf (a leaf whose
    gradient is 0 in exact arithmetic, whisper's key biases, is held on
    both sides to 1e-6 x the largest gradient of any leaf); the port's
    ``remat="full"`` and ``"dots"`` against its own ``"none"``, the same;
    mamba2 with its scans through `SSDFn` (the plain backward of the SSD
    kernel's closed forms) against the reference, the same; jamba and
    llama4-scout with their expert products through `GmmFn` (the plain
    backward of the grouped matmul), the same;
  * `adamw_update` on identical numpy inputs: 1e-6 (both state policies,
    the clip active);
  * `lr_schedule`: relative 1e-6;
  * three `make_train_step` steps against the reference's on a 1 x 1
    mesh, for qwen2 and for llama4-scout (MoE on every layer): loss and
    grad_norm within relative 1e-4 each step.

Updated parameters are compared only where the reference's gradient is
large: AdamW's first step moves each element by about lr * sign(g), so an
element whose gradient is a rounding away from 0 may move by 2 lr
between two right implementations (and at step 0 of a warmup the
learning rate is 0, so nothing moves).  `updated_params_agree` compares
the elements with |g_ref| > 1e-4 x max |g_ref| of their leaf (at 1e-6 a
few elements of reduced qwen2 already differ by 1.5e-5 after one step)
and checks that they are most of the elements: the rest, 29% of reduced
qwen2's, are mostly rows of the tied embedding whose softmax
probabilities underflow, so that their gradient is all but 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint.manager import CheckpointManager as RefCheckpointManager
from repro.configs import reduced_config as ref_reduced_config
from repro.data.pipeline import SyntheticTokenPipeline as RefPipeline
from repro.data.pipeline import stub_modality_inputs as ref_stub_inputs
from repro.models import model as ref_model
from repro.models.param import materialize
from repro.parallel.sharding import rules_for
from repro.train import optimizer as ref_opt
from repro.train.schedule import lr_schedule as ref_lr_schedule
from repro.train.train_step import init_train_state as ref_init_state
from repro.train.train_step import make_train_step as ref_make_train_step
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import reduced_config
from repro_torch.data.pipeline import (
    SyntheticTokenPipeline, stub_modality_inputs,
)
from repro_torch.launch import train as launch_train
from repro_torch.models import model as model_lib
from repro_torch.models.param import params_from_reference, tree_leaves, tree_map
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.schedule import lr_schedule
from repro_torch.train.train_step import init_train_state, make_train_step
from test_torch_matchmaker import one_torch_thread  # noqa: F401

FAMILIES = ["qwen2-1.5b", "granite-8b", "mamba2-1.3b", "jamba-v0.1-52b",
            "llama4-scout-17b-a16e", "whisper-medium",
            "llava-next-mistral-7b"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4      # x max |g_ref| of the leaf
OPT_TOL = 1e-6
STEP_TOL = 1e-4
#: an element's update is compared where |g_ref| > this x max |g_ref|
MOVED = 1e-4
#: a leaf whose gradient is 0 in exact arithmetic (`zero_by_construction`)
#: must hold at most this x the largest gradient of any leaf on both sides
ZERO_TOL = 1e-6


def carried(tree):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, tree),
                                 device="cpu")


def batch_of(cfg, B=2, S=16, seed=1, step=0):
    """A pipeline batch with a few ignored labels (and the frames or
    patches of an enc-dec or VLM arch)."""
    b = SyntheticTokenPipeline(cfg.vocab_size, S, B, seed=seed).batch_at(step)
    b["labels"][0, :3] = -1
    b.update(stub_modality_inputs(cfg, B, rng_seed=seed))
    return b


def to_torch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def to_jax(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def leaf_errors(port_leaves, ref_leaves):
    """max |diff| / max |ref| of each leaf."""
    return [float(np.abs(np.asarray(a) - np.asarray(r)).max()
                  / max(np.abs(np.asarray(r)).max(), 1e-30))
            for a, r in zip(port_leaves, ref_leaves)]


def port_grads(params, cfg, batch, remat="none"):
    req = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = model_lib.loss_fn(req, cfg, batch, remat=remat)
    grads = torch.autograd.grad(loss, tree_leaves(req))
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


@pytest.fixture(scope="module")
def reference_runs():
    """Per family: the reference's weights, batch, and value_and_grad of
    its loss_fn at remat="none" (made once for the module)."""
    out = {}

    def run(arch):
        if arch not in out:
            cfg = ref_reduced_config(arch)
            params = materialize(ref_model.init_model(cfg),
                                 jax.random.PRNGKey(0))
            b = batch_of(cfg)
            (loss, metrics), grads = jax.jit(jax.value_and_grad(
                lambda p, batch: ref_model.loss_fn(p, cfg, batch,
                                                   remat="none"),
                has_aux=True))(params, to_jax(b))
            out[arch] = dict(params=params, batch=b, loss=loss,
                             metrics=metrics, grads=grads)
        return out[arch]

    return run


# ---------------------------------------------------------------------------
# loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_matches_reference(reference_runs, arch):
    ref = reference_runs(arch)
    loss, metrics = model_lib.loss_fn(carried(ref["params"]),
                                      reduced_config(arch),
                                      to_torch(ref["batch"]), remat="none")
    assert set(metrics) == set(ref["metrics"])
    assert rel(loss, ref["loss"]) <= LOSS_TOL
    for k, v in ref["metrics"].items():
        assert metrics[k].dtype == torch.float32, k
        assert abs(float(metrics[k]) - float(v)) <= LOSS_TOL * max(
            abs(float(v)), 1.0), k
    assert float(metrics["tokens"]) == 29.0       # 32 labels, 3 ignored


@pytest.mark.parametrize("arch", FAMILIES)
def test_gradients_match_reference(reference_runs, arch):
    ref = reference_runs(arch)
    _, _, grads = port_grads(carried(ref["params"]), reduced_config(arch),
                             to_torch(ref["batch"]))
    ref_leaves = jax.tree_util.tree_leaves(ref["grads"])
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(ref["grads"])[0]]
    assert len(grads) == len(ref_leaves)
    zero = [zero_by_construction(reduced_config(arch), n) for n in names]
    scale = max(float(np.abs(np.asarray(r)).max()) for r in ref_leaves)
    for n, z, g, r in zip(names, zero, grads, ref_leaves):
        if z:
            assert max(float(g.abs().max()), float(np.abs(r).max())) \
                <= ZERO_TOL * scale, n
    errs = leaf_errors([g.numpy() for g, z in zip(grads, zero) if not z],
                       [r for r, z in zip(ref_leaves, zero) if not z])
    names = [n for n, z in zip(names, zero) if not z]
    worst = max(range(len(errs)), key=errs.__getitem__)
    assert errs[worst] <= GRAD_TOL, (names[worst], errs[worst])


def zero_by_construction(cfg, name: str) -> bool:
    """Whether a leaf's gradient is 0 in exact arithmetic: without RoPE
    an attention key bias adds q . b to every logit of a query, which the
    softmax cancels (whisper's self- and cross-attention).  Both sides
    then hold float32 rounding noise (about 1e-8 against a largest
    gradient of 1.65 for reduced whisper), whose ratio says nothing."""
    return not cfg.rope and name.endswith("['wk']['b']")


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "llama4-scout-17b-a16e"])
def test_moe_models_through_the_gmm_function_match_reference(reference_runs,
                                                             monkeypatch,
                                                             arch):
    """jamba and llama4-scout with every expert product forced through
    `GmmFn` on the CPU (`gmm_plain` forward and the plain backward whose
    closed forms the backward kernel computes, instead of autograd through
    `gmm_plain`): three products and three backward calls per MoE layer,
    and loss and gradients against jax.value_and_grad of the
    reference's."""
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.models import moe as moe_mod
    cfg = reduced_config(arch)
    calls = {"forward": 0, "backward": 0}
    backward = gmm_ops.gmm_backward

    def through_fn(lhs, rhs, group_sizes, *, out_dtype=None,
                   host_sizes=None):
        calls["forward"] += 1
        assert host_sizes == (int(group_sizes[0]),) * len(group_sizes)
        return gmm_ops.GmmFn.apply(lhs, rhs, group_sizes, out_dtype)

    def counted(*args, **kw):
        calls["backward"] += 1
        return backward(*args, **kw)

    monkeypatch.setattr(moe_mod, "gmm", through_fn)
    monkeypatch.setattr(gmm_ops, "gmm_backward", counted)
    ref = reference_runs(arch)
    loss, _, grads = port_grads(carried(ref["params"]), cfg,
                                to_torch(ref["batch"]))
    moe_layers = sum(cfg.ffn_kind(i) == "moe" for i in range(cfg.n_layers))
    assert moe_layers > 0
    assert calls == {"forward": 3 * moe_layers, "backward": 3 * moe_layers}
    assert rel(loss, ref["loss"]) <= LOSS_TOL
    errs = leaf_errors([g.numpy() for g in grads],
                       jax.tree_util.tree_leaves(ref["grads"]))
    assert max(errs) <= GRAD_TOL


def test_mamba2_through_the_ssd_function_matches_reference(reference_runs,
                                                         monkeypatch):
    """mamba2 with every scan forced through `SSDFn` on the CPU (its
    plain forward and the plain backward, the closed forms the kernel's
    backward computes, instead of autograd through `ssd_chunked`): loss
    and gradients against jax.value_and_grad of the reference's."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.models import ssm as ssm_mod
    arch = "mamba2-1.3b"
    cfg = reduced_config(arch)
    calls = {"forward": 0, "backward": 0}
    backward = ssd_ops.ssd_backward

    def through_fn(x, dt, A, Bm, Cm, D, *, chunk=256, initial_state=None):
        calls["forward"] += 1
        return ssd_ops.SSDFn.apply(x, dt, A, Bm, Cm, D, initial_state, chunk)

    def counted(*args, **kw):
        calls["backward"] += 1
        return backward(*args, **kw)

    monkeypatch.setattr(ssm_mod, "ssd", through_fn)
    monkeypatch.setattr(ssd_ops, "ssd_backward", counted)
    ref = reference_runs(arch)
    loss, _, grads = port_grads(carried(ref["params"]), cfg,
                                to_torch(ref["batch"]))
    assert calls == {"forward": cfg.n_layers, "backward": cfg.n_layers}
    assert rel(loss, ref["loss"]) <= LOSS_TOL
    ref_leaves = jax.tree_util.tree_leaves(ref["grads"])
    assert len(grads) == len(ref_leaves)
    assert max(leaf_errors([g.numpy() for g in grads], ref_leaves)) \
        <= GRAD_TOL


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "jamba-v0.1-52b",
                                  "whisper-medium", "llava-next-mistral-7b"])
def test_remat_policies_give_the_same_gradients(arch, remat):
    cfg = reduced_config(arch)
    params = model_lib.init_model(cfg, device="cpu")
    batch = to_torch(batch_of(cfg))
    loss0, _, g0 = port_grads(params, cfg, batch)
    loss, _, g = port_grads(params, cfg, batch, remat=remat)
    assert rel(loss, loss0) <= LOSS_TOL
    assert max(leaf_errors([a.numpy() for a in g],
                           [b.numpy() for b in g0])) <= GRAD_TOL


class CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_keeps_the_matmul_outputs():
    """In the backward pass "full" recomputes the linear layers'
    products, "dots" keeps them: it runs the same products as "none"."""
    cfg = reduced_config("qwen2-1.5b")
    params = tree_map(lambda p: p.detach().requires_grad_(),
                      model_lib.init_model(cfg, device="cpu"))
    batch = to_torch(batch_of(cfg))
    counts = {}
    for remat in ("none", "full", "dots"):
        loss, _ = model_lib.loss_fn(params, cfg, batch, remat=remat)
        with CountMatmuls() as mode:
            torch.autograd.grad(loss, tree_leaves(params))
        counts[remat] = mode.n
    assert counts["dots"] == counts["none"] < counts["full"]


class CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func)] = self.calls.get(str(func), 0) + 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("n_layers", [2, 4])
def test_backward_stacks_each_stacked_leaf_once(n_layers):
    """The layers' gradients reach each stacked leaf through one stack,
    not through a zero-padded copy of the whole stack per layer."""
    cfg = dataclasses.replace(reduced_config("qwen2-1.5b"),
                              n_layers=n_layers)
    params = tree_map(lambda p: p.requires_grad_(),
                      model_lib.init_model(cfg, device="cpu"))
    loss, _ = model_lib.loss_fn(params, cfg, to_torch(batch_of(cfg)),
                                remat="none")
    with CountOps() as mode:
        torch.autograd.grad(loss, tree_leaves(params))
    stacked = len(tree_leaves(params["stack"]))
    assert mode.calls.get("aten.stack.default") == stacked
    assert mode.calls.get("aten.select_backward.default", 0) <= 1  # the CE


def test_unknown_remat_and_unroll_are_refused(reference_runs):
    """An unknown remat policy is refused; ``unroll=True`` is accepted (the
    depth loop is a Python loop either way): the same loss bit for bit as
    ``unroll=False``, and the reference's ``loss_fn(unroll=True)`` within
    `LOSS_TOL`."""
    arch = "qwen2-1.5b"
    cfg = reduced_config(arch)
    ref = reference_runs(arch)
    params = carried(ref["params"])
    batch = to_torch(ref["batch"])
    with pytest.raises(ValueError, match="unknown remat policy"):
        model_lib.loss_fn(params, cfg, batch, remat="some")
    rolled, _ = model_lib.loss_fn(params, cfg, batch, remat="none")
    unrolled, _ = model_lib.loss_fn(params, cfg, batch, remat="none",
                                    unroll=True)
    assert torch.equal(rolled, unrolled)
    ref_unrolled, _ = ref_model.loss_fn(ref["params"], ref_reduced_config(arch),
                                        to_jax(ref["batch"]), remat="none",
                                        unroll=True)
    assert rel(unrolled, ref_unrolled) <= LOSS_TOL


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------

def adam_inputs(rng, clip_scale):
    """A small tree of parameters, gradients (norm ~ clip_scale) and
    nonzero moments, as float32 numpy arrays."""
    shapes = {"a": {"w": (8, 16), "b": (16,)}, "e": (3, 4, 5)}

    def draw(scale):
        return jax.tree_util.tree_map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda x: isinstance(x, tuple))

    p, g = draw(0.5), draw(clip_scale / 12.0)
    mu, nu = draw(0.01), jax.tree_util.tree_map(np.abs, draw(0.001))
    return p, g, mu, nu


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("count", [0, 4])
def test_adamw_update_matches_reference(rng, state_dtype, count):
    cfg = dict(lr=1e-3, grad_clip=1.0, state_dtype=state_dtype,
               keep_nu_fp32=True)
    p, g, mu, nu = adam_inputs(rng, clip_scale=5.0)   # clip active
    bf = ml_dtypes.bfloat16
    mu_in = jax.tree_util.tree_map(
        lambda a: a.astype(bf) if state_dtype == "bfloat16" else a, mu)
    ref_state = {"mu": jax.tree_util.tree_map(jnp.asarray, mu_in),
                 "nu": jax.tree_util.tree_map(jnp.asarray, nu),
                 "count": jnp.asarray(count, jnp.int32)}
    rp, rs, rm = ref_opt.adamw_update(
        jax.tree_util.tree_map(jnp.asarray, p),
        jax.tree_util.tree_map(jnp.asarray, g), ref_state,
        ref_opt.OptimizerConfig(**cfg), jnp.asarray(3e-4, jnp.float32))
    state = {"mu": params_from_reference(mu_in, device="cpu"),
             "nu": params_from_reference(nu, device="cpu"),
             "count": torch.tensor(count, dtype=torch.int32)}
    pp, ps, pm = opt_mod.adamw_update(
        params_from_reference(p, device="cpu"),
        params_from_reference(g, device="cpu"), state,
        OptimizerConfig(**cfg), torch.tensor(3e-4))
    assert float(rm["clip_factor"]) < 1.0
    for k in ("grad_norm", "clip_factor"):
        assert rel(pm[k], rm[k]) <= OPT_TOL, k
    assert int(ps["count"]) == int(rs["count"]) == count + 1
    for port_tree, ref_tree in ((pp, rp), (ps["mu"], rs["mu"]),
                                (ps["nu"], rs["nu"])):
        for a, r in zip(tree_leaves(port_tree),
                        jax.tree_util.tree_leaves(ref_tree)):
            assert str(a.dtype).split(".")[1] == str(r.dtype)
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(r, np.float32),
                                       rtol=OPT_TOL, atol=OPT_TOL)


def test_adamw_slabs_change_nothing(rng, monkeypatch):
    """A leaf past the chunk threshold is updated in slabs of leading
    rows; the result is the one-piece update's, bit for bit."""
    p, g, mu, nu = adam_inputs(rng, clip_scale=5.0)

    def run():
        t = lambda tree: params_from_reference(tree, device="cpu")
        state = {"mu": t(mu), "nu": t(nu),
                 "count": torch.tensor(2, dtype=torch.int32)}
        out, st, _ = opt_mod.adamw_update(t(p), t(g), state,
                                          OptimizerConfig(), 1e-3)
        return tree_leaves(out) + tree_leaves(st["mu"]) + tree_leaves(
            st["nu"])

    whole = run()
    monkeypatch.setattr(opt_mod, "_CHUNK_THRESHOLD", 20)
    assert len(list(opt_mod._slabs(torch.zeros(8, 16)))) == 8
    assert len(list(opt_mod._slabs(torch.zeros(3, 4, 5)))) == 3
    for a, b in zip(run(), whole):
        assert torch.equal(a, b)


def test_adamw_init_follows_the_state_policy():
    params = {"w": torch.zeros(3, 4, dtype=torch.bfloat16)}
    st = opt_mod.adamw_init(params, OptimizerConfig(state_dtype="bfloat16"))
    assert st["mu"]["w"].dtype == torch.bfloat16
    assert st["nu"]["w"].dtype == torch.float32
    assert st["count"].dtype == torch.int32 and st["count"].dim() == 0
    st = opt_mod.adamw_init(params, OptimizerConfig(
        state_dtype="bfloat16", keep_nu_fp32=False))
    assert st["nu"]["w"].dtype == torch.bfloat16


@pytest.mark.parametrize("step", [0, 5, 10, 500, 10_000])
def test_lr_schedule_matches_reference(step):
    kw = dict(peak=1e-3, warmup_steps=10, total_steps=1000, min_ratio=0.1)
    want = float(ref_lr_schedule(jnp.asarray(step, jnp.int32), **kw))
    assert rel(lr_schedule(step, **kw), want) <= OPT_TOL
    got = lr_schedule(torch.tensor(step, dtype=torch.int32), **kw)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert rel(got, want) <= OPT_TOL
    assert rel(lr_schedule(float(step)), float(ref_lr_schedule(step))) \
        <= OPT_TOL


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def updated_params_agree(port_params, ref_params, ref_grads, tol=1e-5):
    """Updated parameters within ``tol`` where |g_ref| > MOVED x max
    |g_ref| of the leaf, and those are most of the elements."""
    left_out = total = 0
    for a, r, g in zip(tree_leaves(port_params),
                       jax.tree_util.tree_leaves(ref_params),
                       jax.tree_util.tree_leaves(ref_grads)):
        g = np.abs(np.asarray(g))
        moved = g > MOVED * max(g.max(), 1e-30)
        np.testing.assert_allclose(a.numpy()[moved], np.asarray(r)[moved],
                                   atol=tol, rtol=tol)
        left_out += int((~moved).sum())
        total += g.size
    assert left_out < 0.5 * total, (left_out, total)


def test_three_train_steps_match_reference(reference_runs):
    """make_train_step against the reference's on a 1 x 1 mesh, with no
    warmup, so the first step moves every parameter."""
    train_steps_match(reference_runs, "qwen2-1.5b")


def test_moe_train_steps_match_reference(reference_runs):
    """The same for llama4-scout (an MoE FFN on every layer, top-1, a
    shared expert, chunked attention)."""
    train_steps_match(reference_runs, "llama4-scout-17b-a16e")


def train_steps_match(reference_runs, arch):
    ref = reference_runs(arch)
    cfg, pcfg = ref_reduced_config(arch), reduced_config(arch)
    lr_kwargs = dict(peak=1e-3, warmup_steps=0, total_steps=10)
    opt = dict(lr=1e-3)
    mesh1 = Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    ref_step = jax.jit(ref_make_train_step(
        cfg, ref_opt.OptimizerConfig(**opt), mesh1, rules_for(cfg, "train"),
        remat="none", lr_kwargs=lr_kwargs))
    ref_state = ref_init_state(ref["params"], ref_opt.OptimizerConfig(**opt),
                               jax.random.PRNGKey(0))
    step = make_train_step(pcfg, OptimizerConfig(**opt), remat="none",
                           lr_kwargs=lr_kwargs, device="cpu")
    state = init_train_state(carried(ref["params"]), OptimizerConfig(**opt))
    with jax.set_mesh(mesh1):
        for i in range(3):
            b = batch_of(cfg, step=i)     # step 0's is reference_runs'
            ref_state, rm = ref_step(ref_state, to_jax(b))
            state, m = step(state, to_torch(b))
            for k in ("loss", "grad_norm"):
                assert rel(m[k], rm[k]) <= STEP_TOL, (i, k)
            assert rel(m["lr"], rm["lr"]) <= OPT_TOL
            if i == 0:
                updated_params_agree(state.params, ref_state.params,
                                     ref["grads"])
    assert int(state.step) == int(ref_state.step) == 3


def test_accumulated_microbatches_match_the_whole_batch():
    """accum_steps=2 against 1 on the same batch (every label valid, so
    the two halves have equal token counts and the mean of their means
    is the batch's mean)."""
    cfg = reduced_config("granite-8b")
    b = to_torch(SyntheticTokenPipeline(cfg.vocab_size, 16, 4,
                                        seed=3).batch_at(0))
    kw = dict(remat="none", device="cpu",
              lr_kwargs=dict(peak=1e-3, warmup_steps=0, total_steps=10))
    out = {}
    for accum in (1, 2):
        params = model_lib.init_model(cfg, device="cpu")
        if accum == 1:
            _, _, grads = port_grads(params, cfg, b)
        state = init_train_state(params, OptimizerConfig())
        out[accum] = make_train_step(cfg, OptimizerConfig(),
                                     accum_steps=accum, **kw)(state, b)
    (s1, m1), (s2, m2) = out[1], out[2]
    for k in ("loss", "ce", "z_loss", "tokens"):
        assert rel(m2[k], m1[k]) <= 1e-6, k
    assert rel(m2["grad_norm"], m1["grad_norm"]) <= 1e-5
    for a, c, g in zip(tree_leaves(s2.params), tree_leaves(s1.params),
                       grads):
        moved = g.abs() > MOVED * g.abs().max()
        torch.testing.assert_close(a[moved], c[moved], atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="multiple of accum_steps"):
        make_train_step(cfg, OptimizerConfig(), accum_steps=3, **kw)(
            s1, b)


# ---------------------------------------------------------------------------
# pipeline and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
def test_batches_are_the_references(seed):
    ref = RefPipeline(1000, 64, 4, seed=seed)
    port = SyntheticTokenPipeline(1000, 64, 4, seed=seed)
    np.testing.assert_array_equal(port.motifs, ref.motifs)
    for step in range(4):
        want = ref.batch_at(step)
        got = port.batch_at(step)
        as_tensors = port.torch_batch_at(step, device="cpu")
        assert set(got) == set(want) == set(as_tensors)
        for k in want:
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
            assert as_tensors[k].dtype == torch.int32
            np.testing.assert_array_equal(as_tensors[k].numpy(), want[k])


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b",
                                  "qwen2-1.5b"])
def test_stub_modality_inputs_are_the_references(arch):
    cfg = reduced_config(arch)
    want = ref_stub_inputs(ref_reduced_config(arch), 2, rng_seed=3)
    got = stub_modality_inputs(cfg, 2, rng_seed=3)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def state_tree():
    gen = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 8, generator=gen).bfloat16(),
                       "b": torch.randn(8, generator=gen)},
            "opt": {"mu": {"w": torch.randn(4, 8, generator=gen)},
                    "count": torch.tensor(3, dtype=torch.int32)},
            "step": torch.tensor(3, dtype=torch.int32)}


def assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("async_mode", [False, True])
def test_checkpoint_round_trip(tmp_path, async_mode):
    tree = state_tree()
    mgr = CheckpointManager(str(tmp_path), async_mode=async_mode)
    mgr.save(5, tree, extra={"note": "x"})
    mgr.wait()
    assert mgr.latest_step() == 5
    assert mgr.read_meta(5) == {"step": 5, "extra": {"note": "x"}}
    assert_trees_equal(mgr.restore(5, state_tree(), device="cpu"), tree)
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore(5, {**tree, "step": torch.zeros(2, dtype=torch.int32)})
    with pytest.raises(KeyError, match="missing leaf"):
        mgr.restore(5, {**tree, "other": torch.zeros(())})
    (tmp_path / "step_00000009.tmp").mkdir()
    assert mgr.all_steps() == [5]          # uncommitted: invisible


def test_async_save_holds_the_step_it_was_given(tmp_path):
    """The trainer updates its tensors in place right after a save: the
    asynchronous write must hold the values of the save's call, not
    what the tensors hold when the thread gets to them."""
    tree = state_tree()
    want = [t.clone() for t in tree_leaves(tree)]
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, tree)
    for t in tree_leaves(tree):
        t.add_(1)
    mgr.wait()
    got = tree_leaves(mgr.restore(1, state_tree(), device="cpu"))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_checkpoint_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_mode=False, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, state_tree())
    assert mgr.all_steps() == [3, 4]


def test_checkpoints_cross_between_the_packages(tmp_path, reference_runs):
    """What the reference writes the port restores to the same arrays,
    and the reverse (bfloat16 widened to float32 on disk by both)."""
    arch = "qwen2-1.5b"
    cfg = dataclasses.replace(ref_reduced_config(arch),
                              param_dtype="bfloat16")
    params = materialize(ref_model.init_model(cfg), jax.random.PRNGKey(2))
    ref_tree = {"params": params, "step": jnp.asarray(7, jnp.int32)}
    RefCheckpointManager(str(tmp_path / "ref"), async_mode=False).save(
        7, ref_tree)
    port_tree = {"params": carried(params),
                 "step": torch.tensor(7, dtype=torch.int32)}
    got = CheckpointManager(str(tmp_path / "ref")).restore(7, port_tree)
    assert_trees_equal(got, port_tree)

    CheckpointManager(str(tmp_path / "port"), async_mode=False).save(
        7, port_tree)
    back = RefCheckpointManager(str(tmp_path / "port")).restore(7, ref_tree)
    for a, r in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(ref_tree)):
        assert a.dtype == r.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(r, np.float32))


def test_run_fixed_trains_checkpoints_and_resumes(tmp_path, capsys):
    """Reduced qwen2 on the CPU: 4 finite steps, checkpoints at 2 and 4;
    resuming from 2 restores the step-2 state bit for bit (parameters,
    both moments, the step) and retakes steps 2 and 3 with the same
    losses."""
    cfg = reduced_config("qwen2-1.5b")
    kw = dict(steps=4, batch=2, seq=16, ckpt_dir=str(tmp_path),
              device="cpu", log_every=1, ckpt_every=2)
    seen, at_2 = [], []

    def on_step(i, state, m, s):
        seen.append((i, s))
        if i == 1:
            at_2.extend(t.clone() for t in tree_leaves(
                vars(state)))

    losses = launch_train.run_fixed(cfg, on_step=on_step, **kw)
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    assert all(s > 0 for _, s in seen)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [2, 4]
    assert mgr.read_meta(4)["step"] == 4
    restored = []
    again = launch_train.run_fixed(
        cfg, resume_from=2, on_resume=lambda state: restored.extend(
            t.clone() for t in tree_leaves(vars(state))), **kw)
    assert len(restored) == len(at_2) and int(restored[-1]) == 2
    for a, b in zip(restored, at_2):
        assert a.dtype == b.dtype and torch.equal(a, b)
    np.testing.assert_allclose(again, losses[2:], rtol=1e-6)
    assert "step    3 loss" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-mistral-7b"])
def test_run_fixed_trains_the_modal_families(tmp_path, arch):
    """One CPU step of reduced whisper (frames through the encoder) and
    llava (patches before the text), the batch's modality inputs made by
    `make_batch`, and a checkpoint of the encoder's or projector's
    leaves beside the rest."""
    losses = launch_train.run_fixed(
        reduced_config(arch), steps=1, batch=2, seq=16,
        ckpt_dir=str(tmp_path), device="cpu", log_every=1, ckpt_every=1)
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert CheckpointManager(str(tmp_path)).all_steps() == [1]
    with np.load(tmp_path / "step_00000001" / "arrays.npz") as saved:
        side = "encoder" if arch.startswith("whisper") else "projector"
        assert any(side in n for n in saved.files)


def test_train_step_refuses_gradient_compression():
    """int8 compression re-reduces over a mesh's "pod" axis: one device
    has none, so asking for it raises instead of training uncompressed
    (the sharded step with a "pod" axis is in
    tests/test_torch_multidevice.py)."""
    with pytest.raises(NotImplementedError, match='"pod" axis'):
        make_train_step(reduced_config("qwen2-1.5b"), OptimizerConfig(),
                        grad_compression="int8", device="cpu")


def test_launcher_refuses_what_is_not_ported(tmp_path):
    base = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path)]
    # a mesh needs a world of several ranks (torchrun; the world's run is
    # in tests/test_torch_multidevice.py)
    with pytest.raises(RuntimeError, match="torchrun"):
        launch_train.main(base + ["--model-parallel", "2"])
    # --elastic runs (on the one device outside a world; the world's runs
    # are in tests/test_torch_elastic.py)
    elastic = launch_train.main(base + ["--elastic"])
    assert len(elastic) == 1 and np.isfinite(elastic[0])
    assert len(launch_train.main(base)) == 1
