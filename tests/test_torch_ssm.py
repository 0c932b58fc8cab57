"""The port's Mamba2 model against the JAX package's, on the CPU.

Weights are the reference's own (``materialize`` with a JAX key),
carried across by `params_from_reference`; inputs are made with numpy.
Both sides run ``reduced_config("mamba2-1.3b")`` in float32 (2 layers,
d_model 64, 8 SSM heads of 16, d_state 16, chunk 32), so they differ only
in the order of float32 sums: the block is held to 1e-5, whole-model
logits to 1e-4 of their largest magnitude, and prefill-then-decode to the
reference's own model tolerance (ATOL = 2e-2, tests/test_models.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as ref_reduced_config
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import model as model_lib
from repro_torch.models import ssm
from repro_torch.models.param import Init
from test_torch_matchmaker import one_torch_thread  # noqa: F401
from test_torch_models import carried, close, ref_params, t, tokens

ARCH = "mamba2-1.3b"
LAYER_TOL = 1e-5
MODEL_TOL = 1e-4    # of max |logits|
ATOL = 2e-2         # the reference's prefill/decode tolerance


def close_logits(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port.numpy(), ref, rtol=0,
                               atol=MODEL_TOL * np.abs(ref).max())


def first_layer(tree):
    return jax.tree_util.tree_map(lambda a: a[0], tree)


def test_ssm_block_forward_matches_reference(rng):
    cfg = ref_reduced_config(ARCH)
    p0 = first_layer(ref_params(cfg)["stack"]["slot0"]["mixer"])
    x = rng.standard_normal((2, 45, cfg.d_model)).astype(np.float32)
    ref_out, ref_state = ref_ssm.ssm_forward(p0, cfg, jnp.asarray(x),
                                             return_state=True)
    out, state = ssm.ssm_forward(carried(p0), reduced_config(ARCH), t(x),
                                 return_state=True)
    close(out, ref_out, LAYER_TOL)
    close(state["ssm"], ref_state["ssm"], LAYER_TOL)
    close(state["conv"], ref_state["conv"], LAYER_TOL)


def test_ssm_block_with_an_initial_state_matches_reference(rng):
    """``initial_state``: the scan enters from a carried state, as the
    reference's does; output and final state within the block's
    tolerance."""
    cfg = ref_reduced_config(ARCH)
    p0 = first_layer(ref_params(cfg, seed=2)["stack"]["slot0"]["mixer"])
    s = cfg.ssm
    H = s.n_heads(cfg.d_model)
    x = rng.standard_normal((2, 40, cfg.d_model)).astype(np.float32)
    init = (rng.standard_normal((2, H, s.head_dim, s.d_state)) * 0.3).astype(
        np.float32)
    ref_out, ref_state = ref_ssm.ssm_forward(
        p0, cfg, jnp.asarray(x), initial_state=jnp.asarray(init),
        return_state=True)
    out, state = ssm.ssm_forward(carried(p0), reduced_config(ARCH), t(x),
                                 initial_state=t(init), return_state=True)
    close(out, ref_out, LAYER_TOL)
    close(state["ssm"], ref_state["ssm"], LAYER_TOL)


@pytest.mark.parametrize("split", [32, 19])
def test_chunked_prefill_with_a_carried_state_is_one_prefill(rng, split):
    """The block's scan over a prompt in two pieces, the second entering
    from the first's final state, gives the whole prompt's outputs and
    final state (a cut at a chunk boundary and inside a chunk).  The
    block's conv starts each piece from zeros, as the reference's does,
    so the pieces are cut after the conv: the scan's inputs are the
    whole prompt's."""
    from repro_torch.models.ssm import ssd
    cfg = reduced_config(ARCH)
    p = jax.tree_util.tree_map(
        lambda a: a[0], ref_params(ref_reduced_config(ARCH), seed=4)[
            "stack"]["slot0"]["mixer"])
    p = carried(p)
    x = t(rng.standard_normal((2, 50, cfg.d_model)).astype(np.float32))
    scans = []

    def recorded(xs, dt, A, Bm, Cm, D, *, chunk, initial_state=None):
        scans.append((xs, dt, A, Bm, Cm, D, chunk))
        return ssd(xs, dt, A, Bm, Cm, D, chunk=chunk,
                   initial_state=initial_state)

    ssm.ssd, saved = recorded, ssm.ssd
    try:
        _, whole = ssm.ssm_forward(p, cfg, x, return_state=True)
    finally:
        ssm.ssd = saved
    xs, dt, A, Bm, Cm, D, chunk = scans[0]
    y, final = ssd(xs, dt, A, Bm, Cm, D, chunk=chunk)
    cut = [a[:, :split] for a in (xs, dt, Bm, Cm)]
    rest = [a[:, split:] for a in (xs, dt, Bm, Cm)]
    y1, s1 = ssd(cut[0], cut[1], A, cut[2], cut[3], D, chunk=chunk)
    y2, s2 = ssd(rest[0], rest[1], A, rest[2], rest[3], D, chunk=chunk,
                 initial_state=s1)
    close(torch.cat([y1, y2], dim=1), y.numpy(), LAYER_TOL)
    close(s2, final.numpy(), LAYER_TOL)
    close(s2, whole["ssm"].numpy(), LAYER_TOL)


def test_ssm_block_decode_matches_reference(rng):
    cfg, pcfg = ref_reduced_config(ARCH), reduced_config(ARCH)
    p0 = first_layer(ref_params(cfg, seed=3)["stack"]["slot0"]["mixer"])
    base = ssm.init_ssm_state(pcfg, 2, "float32", device="cpu")
    state = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(
        np.float32) * 0.5) for k, v in base.items()}
    ref_state = {k: jnp.asarray(v.numpy()) for k, v in state.items()}
    port = carried(p0)
    for _ in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        ref_out, ref_state = ref_ssm.ssm_decode(p0, cfg, jnp.asarray(x),
                                                ref_state)
        views = dict(state)
        out, new = ssm.ssm_decode(port, pcfg, t(x), state)
        assert all(new[k] is views[k] for k in state)   # updated in place
        close(out, ref_out, LAYER_TOL)
        close(state["ssm"], ref_state["ssm"], LAYER_TOL)
        close(state["conv"], ref_state["conv"], LAYER_TOL)


def test_forward_matches_reference(rng):
    cfg = ref_reduced_config(ARCH)
    params = ref_params(cfg)
    toks = tokens(rng, cfg, 2, 70)          # three chunks, the last ragged
    ref_logits, _ = ref_model.forward(params, cfg,
                                      {"tokens": jnp.asarray(toks)},
                                      remat="none")
    logits = model_lib.forward(carried(params), reduced_config(ARCH),
                               {"tokens": t(toks)})
    assert logits.dtype == torch.float32
    close_logits(logits, ref_logits)


@pytest.mark.parametrize("start,tol", [(0, LAYER_TOL), (500, 1e-4)])
def test_sinusoidal_positions_match_reference(start, tol):
    """Both sides compute the frequencies with float32 exp, whose last
    bit may differ between XLA and PyTorch; the angle is position x
    frequency, so at position ~500 one ulp of a frequency (~6e-8) moves
    it by ~3e-5."""
    pos = np.stack([np.arange(start, start + 9),
                    np.arange(start + 20, start + 29)]).astype(np.int32)
    for d in (64, 2048, 7):
        close(model_lib.sinusoidal(t(pos), d),
              ref_model.sinusoidal(jnp.asarray(pos), d), tol)


def test_prefill_and_decode_match_reference(rng):
    """The port's prefill and decode steps against the reference's own,
    step by step, with the same weights and states of the same shape."""
    cfg, pcfg = ref_reduced_config(ARCH), reduced_config(ARCH)
    params = ref_params(cfg, seed=1)
    port = carried(params)
    toks = tokens(rng, cfg, 2, 50)
    ref_cache = ref_model.init_cache(cfg, 2, 64)
    cache = model_lib.init_cache(pcfg, 2, 64, device="cpu")
    ref_logits, ref_cache, ref_len = ref_model.prefill(
        params, cfg, {"tokens": jnp.asarray(toks[:, :37])}, ref_cache)
    logits, cache, lengths = model_lib.prefill(
        port, pcfg, {"tokens": t(toks[:, :37])}, cache)
    close(logits, ref_logits, ATOL)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    for s in range(37, 50):
        ref_logits, ref_cache, ref_len = ref_model.decode_step(
            params, cfg, jnp.asarray(toks[:, s:s + 1]), ref_cache, ref_len)
        logits, cache, lengths = model_lib.decode_step(
            port, pcfg, t(toks[:, s:s + 1]), cache, lengths)
        close(logits, ref_logits, ATOL)
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(ref_len))
    for k in ("conv", "ssm"):
        close(cache["slot0"]["ssm"][k], ref_cache["slot0"]["ssm"][k],
              LAYER_TOL)


@pytest.mark.parametrize("n_pre", [12, 40])
def test_prefill_decode_matches_forward(rng, n_pre):
    """Prefill of a prefix (shorter and longer than a chunk), then
    token-by-token decode of the rest, against the teacher-forced
    forward."""
    cfg = reduced_config(ARCH)
    params = model_lib.init_model(cfg, device="cpu")
    S = 56
    toks = t(tokens(rng, cfg, 1, S))
    full = model_lib.forward(params, cfg, {"tokens": toks})
    cache = model_lib.init_cache(cfg, 1, S, device="cpu")
    logits, cache, lengths = model_lib.prefill(
        params, cfg, {"tokens": toks[:, :n_pre]}, cache)
    close(logits, full[:, n_pre - 1], ATOL)
    for s in range(n_pre, S):
        logits, cache, lengths = model_lib.decode_step(
            params, cfg, toks[:, s:s + 1], cache, lengths)
        close(logits, full[:, s], ATOL)


@pytest.mark.parametrize("n_pre", [1, 2])
def test_prompts_shorter_than_the_conv_window(rng, n_pre):
    """A prompt of fewer than d_conv - 1 tokens: the decode window is
    zero-padded in front, so prefill then decode equals the forward, and
    the prefill's logits equal the reference's forward logits."""
    cfg, pcfg = ref_reduced_config(ARCH), reduced_config(ARCH)
    params = ref_params(cfg, seed=4)
    port = carried(params)
    S = 8
    toks = tokens(rng, cfg, 1, S)
    ref_logits, _ = ref_model.forward(params, cfg,
                                      {"tokens": jnp.asarray(toks)},
                                      remat="none")
    full = model_lib.forward(port, pcfg, {"tokens": t(toks)})
    cache = model_lib.init_cache(pcfg, 1, S, device="cpu")
    logits, cache, lengths = model_lib.prefill(
        port, pcfg, {"tokens": t(toks[:, :n_pre])}, cache)
    close_logits(logits, np.asarray(ref_logits)[:, n_pre - 1])
    conv = cache["slot0"]["ssm"]["conv"]
    assert conv.shape[2] == pcfg.ssm.d_conv - 1
    assert not bool(conv[:, :, :pcfg.ssm.d_conv - 1 - n_pre].any())
    close(logits, full[:, n_pre - 1], LAYER_TOL)
    for s in range(n_pre, S):
        logits, cache, lengths = model_lib.decode_step(
            port, pcfg, t(toks[:, s:s + 1]), cache, lengths)
        close(logits, full[:, s], LAYER_TOL)


def test_initialisers_draw_the_reference_ranges():
    """A = exp(A_log) in [1, 16), softplus(dt_bias) in [1e-3, 1e-1] (the
    Mamba2 init), conv taps truncated at 2 / sqrt(d_conv), D ones."""
    gen = torch.Generator().manual_seed(0)
    init = Init(gen, torch.device("cpu")).stacked(4)
    A = torch.exp(init.a_log((5000,)))
    assert A.dtype == torch.float32 and A.shape == (4, 5000)
    assert float(A.min()) >= 1.0 and float(A.max()) < 16.0 + 1e-5
    assert abs(float(A.mean()) - 8.5) < 0.1
    dt = torch.nn.functional.softplus(init.dt_bias((5000,)))
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    # log-uniform: the median step is sqrt(1e-3 * 1e-1) = 1e-2
    assert abs(float(dt.log10().median()) + 2) < 0.05
    cfg = reduced_config(ARCH)
    p = model_lib.init_model(cfg, device="cpu")["stack"]["slot0"]["mixer"]
    assert float(p["conv_w"].abs().max()) <= 2 / cfg.ssm.d_conv ** 0.5
    assert torch.equal(p["D"], torch.ones_like(p["D"]))
    assert set(p) == {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                      "norm_scale", "out_proj"}


def test_port_params_have_the_reference_tree():
    cfg = reduced_config(ARCH)
    port = model_lib.init_model(cfg, device="cpu")
    ref = carried(ref_params(ref_reduced_config(ARCH)))

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), tree.dtype)

    assert shapes(port) == shapes(ref)


def test_full_width_mamba2_shapes():
    """The served config is the published one: 48 layers, 2048 wide,
    d_inner 4096 in 64 heads of 64, d_state 128, one group, a 4-tap conv,
    chunk 256, a 50,280-token tied vocab, bf16, no FFN and no RoPE."""
    cfg = get_config(ARCH)
    s = cfg.ssm
    assert (cfg.n_layers, cfg.d_model, s.d_inner(cfg.d_model),
            s.n_heads(cfg.d_model), s.head_dim, s.d_state, s.ngroups,
            s.d_conv, s.chunk, cfg.vocab_size) == (
        48, 2048, 4096, 64, 64, 128, 1, 4, 256, 50_280)
    assert cfg.tie_embeddings and not cfg.rope
    assert cfg.param_dtype == "bfloat16"
    assert {cfg.mixer_kind(i) for i in range(cfg.n_layers)} == {"ssm"}
    assert {cfg.ffn_kind(i) for i in range(cfg.n_layers)} == {"none"}
    assert abs(cfg.param_count_estimate() / 1e9 - 1.34) < 0.02
