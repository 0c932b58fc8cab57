"""The port's dense models against the JAX package's, on the CPU.

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


@pytest.mark.parametrize("arch,item", [
    ("whisper-medium", "item 11"), ("llava-next-mistral-7b", "item 11")])
def test_other_families_are_refused_with_their_roadmap_item(arch, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        model_lib.init_model(reduced_config(arch), device="cpu")


def test_full_width_qwen2_shapes():
    """The served config is the published one: 28 layers, 1536 wide,
    12 query heads over 2 kv heads of 128, a 151,936-token vocab."""
    cfg = get_config("qwen2-1.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size) == (
        28, 1536, 12, 2, 128, 8960, 151_936)
    assert cfg.qkv_bias and cfg.tie_embeddings
    assert cfg.param_dtype == "bfloat16"
