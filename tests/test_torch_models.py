"""The port's dense, encoder-decoder (whisper) and VLM (llava) models
against the JAX package's, on the CPU.

Weights are the reference's own (``materialize`` with a JAX key),
carried across by `params_from_reference`; inputs are made with numpy.
Both sides run the reduced configs in float32, so they differ only in
the order of floating-point sums (XLA:CPU's dot products against
PyTorch's): layers are held to 1e-5 and whole models to 1e-4, both far
inside the reference's own model tolerance (ATOL = 2e-2,
tests/test_models.py), which the prefill-then-decode twin keeps.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro.models.param import materialize
from repro_torch.configs import ARCH_NAMES, get_config, reduced_config
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import model as model_lib
from repro_torch.models.param import Init, params_from_reference
from test_torch_matchmaker import one_torch_thread  # noqa: F401

DENSE = ["qwen2-1.5b", "granite-8b", "qwen3-32b", "starcoder2-7b"]
LAYER_TOL = 1e-5    # float32 on both sides; only summation order differs
MODEL_TOL = 1e-4    # the same, accumulated over two layers and the unembed
ATOL = 2e-2         # the reference's prefill/decode tolerance


def ref_params(cfg, seed=0):
    return materialize(ref_model.init_model(cfg), jax.random.PRNGKey(seed))


def carried(params):
    return params_from_reference(jax.tree_util.tree_map(np.asarray, params),
                                 device="cpu")


def t(x):
    return torch.from_numpy(np.asarray(x))


def close(port, ref, tol):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               atol=tol, rtol=tol)


def test_reduced_configs_equal_the_reference():
    for arch in ARCH_NAMES:
        assert repr(reduced_config(arch)) == repr(ref_reduced_config(arch))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms(rng):
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    close(layers.apply_rmsnorm({"scale": t(scale)}, t(x), 1e-5),
          ref_layers.apply_rmsnorm({"scale": jnp.asarray(scale)},
                                   jnp.asarray(x), 1e-5), LAYER_TOL)
    close(layers.apply_layernorm({"scale": t(scale), "bias": t(bias)}, t(x)),
          ref_layers.apply_layernorm(
              {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
              jnp.asarray(x)), LAYER_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_rotates_interleaved_pairs(rng, theta):
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(100, 107)]).astype(np.int32)
    close(layers.apply_rope(t(x), t(pos), theta),
          ref_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
          LAYER_TOL)


def test_linear_adds_bias_after_the_product(rng):
    x = rng.standard_normal((3, 4, 32)).astype(np.float32)
    w = rng.standard_normal((32, 48)).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    close(layers.apply_linear({"w": t(w), "b": t(b)}, t(x)),
          ref_layers.apply_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                  jnp.asarray(x)), LAYER_TOL)


def test_linear_in_bfloat16_rounds_like_the_reference(rng):
    """bf16 in, float32 accumulation, the product rounded to bf16 before
    the bias: one bf16 ulp (2^-8 relative) apart at most."""
    bf = ml_dtypes.bfloat16
    x = rng.standard_normal((4, 64)).astype(bf)
    w = (rng.standard_normal((64, 16)) / 8).astype(bf)
    b = rng.standard_normal(16).astype(bf)
    ref = ref_layers.apply_linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                  jnp.asarray(x))
    port = layers.apply_linear(
        params_from_reference({"w": w, "b": b}, device="cpu"),
        params_from_reference({"x": x}, device="cpu")["x"])
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=2 ** -7,
                               atol=2 ** -7)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu")])
def test_mlp(rng, gated, act):
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    p = {"up": rng.standard_normal((32, 64)).astype(np.float32) / 6,
         "down": rng.standard_normal((64, 32)).astype(np.float32) / 8}
    if gated:
        p["gate"] = rng.standard_normal((32, 64)).astype(np.float32) / 6
    close(layers.apply_mlp({k: t(v) for k, v in p.items()}, t(x),
                           gated=gated, act=act),
          ref_layers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), gated=gated, act=act),
          LAYER_TOL)


def test_init_draws_the_reference_distributions():
    gen = torch.Generator().manual_seed(0)
    init = Init(gen, torch.device("cpu")).stacked(3)
    w = init.dense((256, 512), "float32")
    assert w.shape == (3, 256, 512)
    assert float(w.abs().max()) <= 2 / 16 + 1e-7        # [-2, 2] / sqrt(256)
    # truncated standard normal on [-2, 2] has std 0.8796
    assert abs(float(w.std()) * 16 - 0.8796) < 0.01
    e = init.embed((1000, 64), "bfloat16")
    assert e.dtype == torch.bfloat16 and abs(float(e.float().std()) - 1) < 0.02
    assert torch.equal(init.ones((4,), "float32"), torch.ones(3, 4))


def test_stacked_dense_draws_one_layer_at_a_time(monkeypatch):
    """A stack over `DENSE_DRAW_MAX` values is its layers drawn one after
    another, each as an unstacked draw of the same generator (a float32
    temporary of one layer, never of the stack), rounded once to the
    output's dtype; a stack within it is drawn whole, as before."""
    from repro_torch.models import param

    def draws(lead, dtype):
        gen = torch.Generator().manual_seed(3)
        init = Init(gen, torch.device("cpu"))
        if lead:
            return init.stacked(lead[-1]).stacked(lead[0]).dense(
                (48, 80), dtype)
        return torch.stack([init.dense((48, 80), dtype) for _ in range(6)])

    whole = draws((2, 3), "float32")
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(whole, torch.nn.init.trunc_normal_(
        torch.empty(2, 3, 48, 80), 0.0, 1.0, -2.0, 2.0,
        generator=gen).mul_(1 / 48 ** 0.5))
    monkeypatch.setattr(param, "DENSE_DRAW_MAX", 48 * 80)
    for dtype in ("float32", "bfloat16"):
        stacked = draws((2, 3), dtype)
        assert stacked.shape == (2, 3, 48, 80)
        assert stacked.dtype == getattr(torch, dtype)
        assert torch.equal(stacked.reshape(6, 48, 80), draws((), dtype))
    assert not torch.equal(draws((2, 3), "float32"), whole)
    assert torch.equal(draws((2, 3), "bfloat16"),
                       draws((2, 3), "float32").to(torch.bfloat16))


# ---------------------------------------------------------------------------
# attention block and whole models, with the reference's weights
# ---------------------------------------------------------------------------

def tokens(rng, cfg, B, S):
    return rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_attention_block(rng, arch):
    cfg = ref_reduced_config(arch)
    p = ref_params(cfg)["stack"]["slot0"]["mixer"]
    p0 = jax.tree_util.tree_map(lambda a: a[0], p)
    x = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    ref_out, (ref_k, _) = ref_attn.attn_forward(p0, cfg, jnp.asarray(x),
                                                return_kv=True)
    out, (k, _) = attn.attn_forward(carried(p0), reduced_config(arch), t(x),
                                    return_kv=True)
    close(out, ref_out, LAYER_TOL)
    close(k, ref_k, LAYER_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_reference(rng, arch):
    cfg = ref_reduced_config(arch)
    params = ref_params(cfg)
    toks = tokens(rng, cfg, 2, 24)
    ref_logits, _ = ref_model.forward(params, cfg,
                                      {"tokens": jnp.asarray(toks)},
                                      remat="none")
    logits = model_lib.forward(carried(params), reduced_config(arch),
                               {"tokens": t(toks)})
    assert logits.dtype == torch.float32
    close(logits, ref_logits, MODEL_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(rng, arch):
    """The port's prefill and decode steps against the reference's own,
    step by step, with the same weights and caches of the same size."""
    cfg, pcfg = ref_reduced_config(arch), reduced_config(arch)
    params = ref_params(cfg, seed=1)
    port = carried(params)
    toks = tokens(rng, cfg, 2, 16)
    ref_cache = ref_model.init_cache(cfg, 2, 40)
    cache = model_lib.init_cache(pcfg, 2, 40, device="cpu")
    ref_logits, ref_cache, ref_len = ref_model.prefill(
        params, cfg, {"tokens": jnp.asarray(toks[:, :10])}, ref_cache)
    logits, cache, lengths = model_lib.prefill(
        port, pcfg, {"tokens": t(toks[:, :10])}, cache)
    close(logits, ref_logits, MODEL_TOL)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    for s in range(10, 16):
        ref_logits, ref_cache, ref_len = ref_model.decode_step(
            params, cfg, jnp.asarray(toks[:, s:s + 1]), ref_cache, ref_len)
        logits, cache, lengths = model_lib.decode_step(
            port, pcfg, t(toks[:, s:s + 1]), cache, lengths)
        close(logits, ref_logits, MODEL_TOL)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    ref_k = ref_cache["slot0"]["self"]["k"]
    close(cache["slot0"]["self"]["k"], ref_k, LAYER_TOL)
    np.testing.assert_array_equal(cache["slot0"]["self"]["pos"].numpy(),
                                  np.asarray(ref_cache["slot0"]["self"]["pos"]))


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_forward(rng, arch):
    """Twin of tests/test_models.py::test_prefill_decode_matches_forward on
    the port: prefill of a prefix, then token-by-token decode of the rest
    with the ground-truth tokens, against the teacher-forced forward."""
    cfg = reduced_config(arch)
    params = model_lib.init_model(cfg, device="cpu")
    B, S = 1, 24
    toks = t(tokens(rng, cfg, B, S))
    n_pre = S // 2
    full = model_lib.forward(params, cfg, {"tokens": toks})
    cache = model_lib.init_cache(cfg, B, S + 64, device="cpu")
    logits, cache, lengths = model_lib.prefill(
        params, cfg, {"tokens": toks[:, :n_pre]}, cache)
    close(logits, full[:, n_pre - 1], ATOL)
    for s in range(n_pre, S):
        logits, cache, lengths = model_lib.decode_step(
            params, cfg, toks[:, s:s + 1], cache, lengths)
        close(logits, full[:, s], ATOL)


def test_cache_fill_rolls_over_a_window():
    """slot = position % C; a write longer than C keeps the last C."""
    cfg = reduced_config("qwen2-1.5b")
    cache = attn.init_kv_cache(cfg, 1, 4, torch.float32, device="cpu")
    k = torch.arange(6, dtype=torch.float32).reshape(1, 6, 1, 1).expand(
        1, 6, cfg.n_kv_heads, cfg.d_head)
    pos = torch.arange(6, dtype=torch.int32)[None]
    attn.cache_fill(cache, k, k, pos)
    assert cache["pos"].tolist() == [[4, 5, 2, 3]]
    assert cache["k"][0, :, 0, 0].tolist() == [4.0, 5.0, 2.0, 3.0]


# ---------------------------------------------------------------------------
# the encoder-decoder (whisper) and VLM (llava) families
# ---------------------------------------------------------------------------

def modal(rng, cfg, B):
    """numpy frames (enc-dec) or patches (VLM) for a batch of B."""
    out = {}
    if cfg.encoder is not None:
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.frontend is not None:
        out["patches"] = rng.standard_normal(
            (B, cfg.frontend.n_prefix, cfg.frontend.d_input)).astype(
            np.float32)
    return out


def both(batch):
    """The same numpy batch as the reference's and the port's."""
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: t(v) for k, v in batch.items()})


def leaf_shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(leaf_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_init_model_tree_is_the_carried_tree(arch):
    """`init_model`'s paths and shapes are those `params_from_reference`
    carries (the encoder, the cross-attention and the projector
    included), so the reference's weights load unchanged."""
    cfg = ref_reduced_config(arch)
    want = leaf_shapes(carried(ref_params(cfg)))
    got = leaf_shapes(model_lib.init_model(reduced_config(arch),
                                           device="cpu"))
    assert got == want
    assert ("encoder.final_norm.scale" in got) == (cfg.encoder is not None)
    assert ("projector.w" in got) == (cfg.frontend is not None)


@pytest.mark.parametrize("B,S", [(2, 12), (1, 1)])
def test_cross_attention_block(rng, B, S):
    """whisper's cross-attention over an encoder output: keys at 0..F-1,
    no RoPE, no causal mask; (k, v) for the cross cache."""
    cfg = ref_reduced_config("whisper-medium")
    p = jax.tree_util.tree_map(lambda a: a[0],
                               ref_params(cfg)["stack"]["slot0"]["cross"])
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, cfg.encoder.n_frames,
                               cfg.d_model)).astype(np.float32)
    ref_out, (ref_k, ref_v) = ref_attn.attn_forward(
        p, cfg, jnp.asarray(x), kv_ctx=jnp.asarray(enc), return_kv=True)
    out, (k, v) = attn.attn_forward(carried(p), reduced_config(
        "whisper-medium"), t(x), kv_ctx=t(enc), return_kv=True)
    close(out, ref_out, LAYER_TOL)
    close(k, ref_k, LAYER_TOL)
    close(v, ref_v, LAYER_TOL)


def test_cross_attention_decode(rng):
    """One decode step against a cross cache (its empty slots masked):
    the output as the reference's, and the cache not written."""
    cfg, pcfg = ref_reduced_config("whisper-medium"), reduced_config(
        "whisper-medium")
    p = jax.tree_util.tree_map(lambda a: a[0],
                               ref_params(cfg)["stack"]["slot0"]["cross"])
    F = cfg.encoder.n_frames
    cache = {k: rng.standard_normal((3, F, cfg.n_kv_heads, cfg.d_head))
             .astype(np.float32) for k in ("k", "v")}
    cache["pos"] = np.tile(np.arange(F, dtype=np.int32), (3, 1))
    cache["pos"][1, F - 5:] = -1
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    lengths = np.array([4, 9, 30], np.int32)
    ref_out, _ = ref_attn.attn_decode(
        p, cfg, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cache.items()},
        jnp.asarray(lengths), cross=True)
    port_cache = {k: t(v.copy()) for k, v in cache.items()}
    out, back = attn.attn_decode(carried(p), pcfg, t(x), port_cache,
                                 t(lengths), cross=True)
    close(out, ref_out, LAYER_TOL)
    assert back is port_cache
    for k, v in cache.items():
        np.testing.assert_array_equal(port_cache[k].numpy(), v)


def test_encoder_matches_reference(rng):
    cfg = ref_reduced_config("whisper-medium")
    params = ref_params(cfg)
    frames = modal(rng, cfg, 2)["frames"]
    want = ref_model._encode(params, cfg, jnp.asarray(frames), remat="none")
    got = model_lib._encode(carried(params), reduced_config("whisper-medium"),
                            t(frames))
    close(got, want, LAYER_TOL)


MODAL = ["whisper-medium", "llava-next-mistral-7b"]


@pytest.mark.parametrize("arch", MODAL)
def test_modal_forward_matches_reference(rng, arch):
    """Logits for the text positions only (llava's prefix produces none),
    with the frames or patches of the batch."""
    cfg = ref_reduced_config(arch)
    params = ref_params(cfg)
    ref_b, port_b = both({"tokens": tokens(rng, cfg, 2, 20),
                          **modal(rng, cfg, 2)})
    ref_logits, _ = ref_model.forward(params, cfg, ref_b, remat="none")
    logits = model_lib.forward(carried(params), reduced_config(arch), port_b)
    assert logits.shape == (2, 20, cfg.vocab_size)
    close(logits, ref_logits, MODEL_TOL)


@pytest.mark.parametrize("arch", MODAL)
def test_modal_prefill_and_decode_match_reference(rng, arch):
    """The port's prefill and decode steps against the reference's, step
    by step; ``lengths`` count a VLM prefix, as the reference's do, and
    the cross cache holds the encoder's keys at positions 0..F-1."""
    cfg, pcfg = ref_reduced_config(arch), reduced_config(arch)
    params = ref_params(cfg, seed=1)
    port = carried(params)
    toks = tokens(rng, cfg, 2, 16)
    extra = modal(rng, cfg, 2)
    ref_b, port_b = both({"tokens": toks[:, :10], **extra})
    ref_cache = ref_model.init_cache(cfg, 2, 40)
    cache = model_lib.init_cache(pcfg, 2, 40, device="cpu")
    ref_logits, ref_cache, ref_len = ref_model.prefill(params, cfg, ref_b,
                                                       ref_cache)
    logits, cache, lengths = model_lib.prefill(port, pcfg, port_b, cache)
    close(logits, ref_logits, MODEL_TOL)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    prefix = cfg.frontend.n_prefix if cfg.frontend is not None else 0
    assert lengths.tolist() == [prefix + 10] * 2
    for s in range(10, 16):
        ref_logits, ref_cache, ref_len = ref_model.decode_step(
            params, cfg, jnp.asarray(toks[:, s:s + 1]), ref_cache, ref_len)
        logits, cache, lengths = model_lib.decode_step(
            port, pcfg, t(toks[:, s:s + 1]), cache, lengths)
        close(logits, ref_logits, MODEL_TOL)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    for kind in ref_cache["slot0"]:
        close(cache["slot0"][kind]["k"], ref_cache["slot0"][kind]["k"],
              LAYER_TOL)
        np.testing.assert_array_equal(
            cache["slot0"][kind]["pos"].numpy(),
            np.asarray(ref_cache["slot0"][kind]["pos"]))
    assert set(cache["slot0"]) == set(ref_cache["slot0"])


@pytest.mark.parametrize("arch", MODAL)
def test_modal_prefill_decode_matches_forward(rng, arch):
    """Prefill of a prefix, then token-by-token decode of the rest with
    the ground-truth tokens, against the teacher-forced forward; decode
    leaves the cross cache as the prefill wrote it."""
    cfg = reduced_config(arch)
    params = model_lib.init_model(cfg, device="cpu")
    S, n_pre = 24, 12
    toks = t(tokens(rng, cfg, 1, S))
    extra = {k: t(v) for k, v in modal(rng, cfg, 1).items()}
    full = model_lib.forward(params, cfg, {"tokens": toks, **extra})
    prefix = cfg.frontend.n_prefix if cfg.frontend is not None else 0
    cache = model_lib.init_cache(cfg, 1, prefix + S + 8, device="cpu")
    logits, cache, lengths = model_lib.prefill(
        params, cfg, {"tokens": toks[:, :n_pre], **extra}, cache)
    crosskv = {k: v.clone() for k, v in cache["slot0"].get(
        "crosskv", {}).items()}
    close(logits, full[:, n_pre - 1], ATOL)
    for s in range(n_pre, S):
        logits, cache, lengths = model_lib.decode_step(
            params, cfg, toks[:, s:s + 1], cache, lengths)
        close(logits, full[:, s], ATOL)
    assert int(lengths[0]) == prefix + S
    for k, v in crosskv.items():
        assert torch.equal(cache["slot0"]["crosskv"][k], v)
    if cfg.encoder is not None:
        assert cache["slot0"]["crosskv"]["pos"].tolist()[0][0] == list(
            range(cfg.encoder.n_frames))


@pytest.mark.parametrize("arch", MODAL)
def test_modal_forward_is_differentiable(arch):
    """Every leaf gets a gradient, the encoder's and the projector's
    included (the encoder's only through the cross-attention's keys and
    values)."""
    from repro_torch.models.param import tree_leaves, tree_map
    cfg = reduced_config(arch)
    params = tree_map(lambda p: p.requires_grad_(),
                      model_lib.init_model(cfg, device="cpu"))
    rng = np.random.default_rng(2)
    batch = {"tokens": t(tokens(rng, cfg, 2, 8)),
             **{k: t(v) for k, v in modal(rng, cfg, 2).items()}}
    logits = model_lib.forward(params, cfg, batch)
    grads = torch.autograd.grad(logits.square().mean(), tree_leaves(params),
                                allow_unused=True)
    side = params.get("encoder", params.get("projector"))
    for g in grads[-len(tree_leaves(side)):]:
        assert g is not None and bool(g.abs().max() > 0)
    assert all(g is not None for g in grads)


def test_full_width_qwen2_shapes():
    """The served config is the published one: 28 layers, 1536 wide,
    12 query heads over 2 kv heads of 128, a 151,936-token vocab."""
    cfg = get_config("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size) == (
        28, 1536, 12, 2, 128, 8960, 151_936)
    assert cfg.qkv_bias and cfg.tie_embeddings
    assert cfg.param_dtype == "bfloat16"
