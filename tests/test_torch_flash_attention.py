"""The port's `flash_attention` on CPU tensors against the JAX package's
Pallas kernel (interpret mode) and its dense oracle.

On a CPU tensor the port's wrapper runs its plain PyTorch version; the
same numpy inputs go through `flash_attention_pallas(interpret=True)` and
`attention_reference`.  Tolerances are the reference suite's own
(tests/test_kernel_flash_attention.py): 2e-5 for float32 inputs, 2e-2
for bfloat16, whose output is rounded to bf16 (an ulp of 2^-8 relative)
on both sides.

The plain forward's log-sum-exp (`attention_reference(...,
return_lse=True)`, what the forward kernel saves for the backward) is held
against ``torch.logsumexp`` of the masked logits, +inf on the rows that
see no key, and its output against the JAX reference's.  The plain
backward, `ref.attention_backward_reference`, given an lse (the plain
forward's, or the JAX forward's output with ``torch.logsumexp``'s lse), is
held against ``jax.vjp`` of the JAX package's `attention_reference` and
of its ``ops.flash_attention`` (the jnp path the reference's training
differentiates) on chip_smoke's `FLASH_BWD_CASES` (the reference suite's
shapes, fully masked rows, softcap, window, G = 1, 4 and 6, Sq != Skv)
in float32, each gradient within 1e-5 x its max; the tensor-core
instance's rounding mirror (`ref.attention_backward_passes`: P and dS in
bfloat16) within the bfloat16 gate of 2e-2 on the cases that instance
takes; `FlashAttentionFn` on CPU tensors is held against autograd through
`attention_reference`, and saves the plain forward's lse.

The CUDA wrapper's choices that need no card are held here too: `route`
(which of the three instances a call takes) and `bwd_route` (the
backward's two) against chip_smoke's own statements of them, `split_plan` (how the decode instance cuts the cache),
and the decode instance's two passes, written out in plain torch
(`attention_split_reference`), against the Pallas kernel and the oracle.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_reference
from repro_torch.kernels.build import launch_counts
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention.ops import (
    BWD_MAX_KEY_TILES, BWD_MAX_QUERY_TILES, SPLIT_SLICE, SPLIT_TARGET_BLOCKS,
    FlashAttentionFn, bwd_route, flash_attention_backward,
    flash_attention_forward, route, split_plan,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_backward_passes, attention_backward_reference,
    attention_mask, attention_split_reference,
)
from repro_torch.kernels.flash_attention.ref import (
    attention_reference as plain_attention,
)
from test_kernel_flash_attention import CASES
from test_torch_cuda import (
    FLASH_BWD_CASES, FLASH_BWD_TIMED, FLASH_BWD_TOL, FLASH_CASES,
    FLASH_WGMMA_CASES, MODAL_FLASH_CALLS, check_fully_masked_rows,
    check_rolling_window, flash_bwd_inputs, flash_bwd_route, flash_route,
)
from chip_smoke import (
    CONFIG_FLASH_CALLS, CONFIGS, FLASH_GROUP_CASES, FLASH_GROUP_DECODE,
)
from test_torch_matchmaker import one_torch_thread  # noqa: F401

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def inputs(rng, B, Sq, Skv, Hq, Hkv, Dh, dtype):
    """The reference suite's `_mk`: normal q/k/v, queries at the last Sq
    positions, every 7th cache slot empty."""
    np_dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    q = rng.standard_normal((B, Sq, Hq, Dh)).astype(np_dt)
    k = rng.standard_normal((B, Skv, Hkv, Dh)).astype(np_dt)
    v = rng.standard_normal((B, Skv, Hkv, Dh)).astype(np_dt)
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32),
                         (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    kp[:, ::7] = -1
    return q, k, v, qp, kp


def to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def test_cuda_cases_are_the_reference_cases():
    assert FLASH_CASES == CASES


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,causal,window,softcap", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_pallas_and_oracle(rng, B, Sq, Skv, Hq, Hkv, Dh,
                                        causal, window, softcap, dtype):
    q, k, v, qp, kp = inputs(rng, B, Sq, Skv, Hq, Hkv, Dh, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = dict(launch_counts)
    out = flash_attention(*map(to_torch, (q, k, v, qp, kp)), **kw)
    assert launch_counts == before          # the CPU branch launches nothing
    assert out.dtype == to_torch(q).dtype and out.shape == q.shape
    jx = [jnp.asarray(a) for a in (q, k, v, qp, kp)]
    pallas = flash_attention_pallas(*jx, interpret=True, **kw)
    oracle = attention_reference(*jx, **kw)
    tol = TOL[dtype]
    for ref in (pallas, oracle):
        np.testing.assert_allclose(as_f32(out), as_f32(ref), atol=tol,
                                   rtol=tol)


def test_fully_masked_rows_give_zero():
    check_fully_masked_rows(flash_attention, torch.device("cpu"))


def test_rolling_window_is_permutation_invariant():
    check_rolling_window(flash_attention, torch.device("cpu"))


def test_mask_rule():
    qp = torch.tensor([[5, 9]], dtype=torch.int32)
    kp = torch.tensor([[-1, 3, 5, 6, 8]], dtype=torch.int32)
    m = attention_mask(qp, kp, causal=True, window=4)
    assert m.tolist() == [[[False, True, True, False, False],
                           [False, False, False, True, True]]]
    # only empty slots are masked: broadcastable over queries, as in JAX
    m = attention_mask(qp, kp, causal=False, window=None)
    assert m.expand(1, 2, 5).tolist() == [[[False, True, True, True, True]] * 2]


def test_other_devices_are_refused():
    q = torch.zeros((1, 1, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention(q, q, q, torch.zeros((1, 1), dtype=torch.int32),
                        torch.zeros((1, 1), dtype=torch.int32))


# (label, B, Sq, Skv, Hq, Hkv, Dh): qwen2-1.5b's and jamba-v0.1-52b's
# attention at the serving run's shapes (8 slots, a 2048-slot cache,
# prompts of 64 to 1024 tokens)
SERVING = [(f"{arch}-{kind}", B, Sq, Skv, Hq, Hkv, 128)
           for arch, Hq, Hkv in (("qwen2", 12, 2), ("jamba", 32, 8))
           for kind, B, Sq, Skv in (("prefill-64", 1, 64, 64),
                                    ("prefill-1024", 1, 1024, 1024),
                                    ("prefill-2048", 1, 2048, 2048),
                                    ("decode", 8, 1, 2048))]


def empty(shape, dtype):
    return torch.empty(shape, dtype=getattr(torch, dtype))


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,causal,window,softcap", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_of_the_reference_cases(B, Sq, Skv, Hq, Hkv, Dh, causal,
                                      window, softcap, dtype):
    q = empty((B, Sq, Hq, Dh), dtype)
    k, v = empty((B, Skv, Hkv, Dh), dtype), empty((B, Skv, Hkv, Dh), dtype)
    got = route(q, k, v)
    assert got == flash_route(q.dtype, Sq, Hq, Hkv, Dh)
    if Sq * (Hq // Hkv) <= 32:
        assert got == "split"
    elif dtype == "bfloat16" and Dh in (64, 128):
        assert got == "wgmma"
    else:
        assert got == "simt"


@pytest.mark.parametrize("label,B,Sq,Skv,Hq,Hkv,Dh", SERVING)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_of_the_serving_shapes(label, B, Sq, Skv, Hq, Hkv, Dh, dtype):
    """Every decode tick takes the split; every prefill the tensor cores in
    bfloat16 and the SIMT instance in float32."""
    q = empty((B, Sq, Hq, Dh), dtype)
    k, v = empty((B, Skv, Hkv, Dh), dtype), empty((B, Skv, Hkv, Dh), dtype)
    want = ("split" if label.endswith("decode")
            else "wgmma" if dtype == "bfloat16" else "simt")
    assert route(q, k, v) == want == flash_route(q.dtype, Sq, Hq, Hkv, Dh)


def test_route_of_the_wgmma_edge_cases():
    for B, Sq, Skv, Hq, Hkv, Dh, *_ in FLASH_WGMMA_CASES:
        q = empty((B, Sq, Hq, Dh), "bfloat16")
        k = v = empty((B, Skv, Hkv, Dh), "bfloat16")
        assert route(q, k, v) == "wgmma"


@pytest.mark.parametrize("call", MODAL_FLASH_CALLS, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_of_the_modal_calls(call, dtype):
    """whisper's encoder, decoder and cross calls and llava's: each takes
    the instance the smoke's launch gates count it on in bfloat16 (the
    decode split for a tick, the tensor cores for every prefill, the
    encoder and a prompt of 48 tokens at G = 1; a prompt of 32 at G = 1
    is a decode-sized call), and in float32 the split or SIMT."""
    label, B, Sq, Skv, Hq, Hkv, Dh, causal, want = call
    q = empty((B, Sq, Hq, Dh), dtype)
    k, v = empty((B, Skv, Hkv, Dh), dtype), empty((B, Skv, Hkv, Dh), dtype)
    if dtype == "float32" and want == "wgmma":
        want = "simt"
    assert route(q, k, v) == want == flash_route(q.dtype, Sq, Hq, Hkv, Dh)


# the group sizes of starcoder2-7b (G = 9), qwen3-32b (8) and
# llama4-scout (5) at the reference suite's widths: a prefill whose Sq
# is not a multiple of the packed positions, and a decode call
GROUP_CASES = [(B, Sq, Skv, Hq, Hkv, 64, True, window, None)
               for Hq, Hkv in ((9, 1), (16, 2), (10, 2))
               for B, Sq, Skv, window in ((2, 37, 100, None),
                                          (1, 1, 90, 32))]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,causal,window,softcap",
                         GROUP_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_matches_pallas_at_the_new_group_sizes(
        rng, B, Sq, Skv, Hq, Hkv, Dh, causal, window, softcap, dtype):
    test_port_matches_pallas_and_oracle(rng, B, Sq, Skv, Hq, Hkv, Dh, causal,
                                        window, softcap, dtype)


def test_group_cases_take_the_configs_group_sizes():
    """The card's cases at G = 9, 8 and 5 are the new configurations'
    (heads over kv heads), each a prefill ending inside a packed tile of
    floor(64 / G) positions and one with an empty batch row, on the
    tensor cores; their decode ticks on the split."""
    from repro_torch.configs import get_config
    groups = {get_config(name).n_heads // get_config(name).n_kv_heads
              for name, *_ in CONFIGS} - {4}          # granite's G = 4
    assert {Hq // Hkv for _, _, _, Hq, Hkv, *_ in FLASH_GROUP_CASES} == \
        {Hq // Hkv for Hq, Hkv in FLASH_GROUP_DECODE} == groups == {9, 8, 5}
    for B, Sq, Skv, Hq, Hkv, Dh, *_, empty_row in FLASH_GROUP_CASES:
        q = empty((B, Sq, Hq, Dh), "bfloat16")
        k = v = empty((B, Skv, Hkv, Dh), "bfloat16")
        assert route(q, k, v) == "wgmma"
        assert Sq % (64 // (Hq // Hkv)) != 0 or empty_row
    assert any(case[-1] for case in FLASH_GROUP_CASES)
    for Hq, Hkv in FLASH_GROUP_DECODE:
        q = empty((8, 1, Hq, 128), "bfloat16")
        k = v = empty((8, 2048, Hkv, 128), "bfloat16")
        assert route(q, k, v) == "split"


@pytest.mark.parametrize("call", CONFIG_FLASH_CALLS, ids=lambda c: c[0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_route_of_the_config_calls(call, dtype):
    """Each configuration's timed prefill and tick carry its heads and
    take the instance its serving gates count them on."""
    from repro_torch.configs import get_config
    label, B, Sq, Skv, Hq, Hkv, Dh, causal, want = call
    cfg = get_config(label.rsplit("-", 1)[0])
    assert (Hq, Hkv, Dh) == (cfg.n_heads, cfg.n_kv_heads, cfg.d_head)
    q = empty((B, Sq, Hq, Dh), dtype)
    k, v = empty((B, Skv, Hkv, Dh), dtype), empty((B, Skv, Hkv, Dh), dtype)
    if dtype == "float32" and want == "wgmma":
        want = "simt"
    assert route(q, k, v) == want == flash_route(q.dtype, Sq, Hq, Hkv, Dh)


def test_route_sends_a_misaligned_view_to_simt():
    """TMA needs 16-byte aligned tensors: a view 2 bytes into its storage
    goes to the SIMT instance (whose wrapper then refuses it on the card,
    as before)."""
    q = empty((1, 129 * 64 * 12 + 1), "bfloat16")[:, 1:].view(1, 129, 12, 64)
    k = v = empty((1, 129, 2, 64), "bfloat16")
    assert q.data_ptr() % 16 == 2
    assert route(q, k, v) == "simt"
    assert route(q.clone(), k, v) == "wgmma"
    # the decode split reads with 16-byte loads too, but its choice is
    # the shape's: the wrapper's alignment check refuses the view
    assert route(q[:, :1], k, v) == "split"


def test_route_caps_the_tensor_cores_keys():
    q = empty((1, 64, 12, 128), "bfloat16")
    k = v = empty((1, 1, 2, 128), "bfloat16").expand(1, 2048 * 128 + 1, 2,
                                                     128)
    assert route(q, k, v) == "simt"
    assert route(q, k[:, :2048 * 128], v[:, :2048 * 128]) == "wgmma"


PLANS = [(B, Sq, Skv, Hkv, G) for B, Sq, Skv, Hkv, G in (
    (8, 1, 2048, 2, 6), (8, 1, 2048, 8, 4), (1, 1, 256, 4, 2),
    (1, 1, 100_000, 1, 32), (64, 1, 2048, 8, 4), (300, 1, 64, 8, 1),
    (1, 4, 37, 2, 8), (2, 2, 33, 1, 16), (1, 1, 1, 1, 1), (4, 3, 999, 3, 5),
    (8, 1, 1500, 16, 1), (8, 1, 1056, 8, 4))]


@pytest.mark.parametrize("B,Sq,Skv,Hkv,G", PLANS)
def test_split_plan_covers_every_slot_once(B, Sq, Skv, Hkv, G):
    plan = split_plan(B, Sq, Skv, Hkv, G)
    rows = Sq * G
    warps = 8 // -(-rows // 4)
    tile = SPLIT_SLICE * warps
    assert plan.warps == warps
    assert plan.keys_per_split % tile == 0 and plan.keys_per_split >= tile
    starts = range(0, Skv, plan.keys_per_split)
    assert len(starts) == plan.n_splits
    ranges = [(s, min(Skv, s + plan.keys_per_split)) for s in starts]
    assert all(e > s for s, e in ranges)                  # none empty
    covered = [j for s, e in ranges for j in range(s, e)]
    assert covered == list(range(Skv))                    # each slot once
    # enough blocks, unless every split is already one tile
    n_tiles = -(-Skv // tile)
    assert (B * Hkv * plan.n_splits >= SPLIT_TARGET_BLOCKS
            or plan.n_splits == n_tiles)


def test_split_plan_refuses_prefill_rows():
    with pytest.raises(ValueError, match="decode instance"):
        split_plan(1, 6, 128, 2, 6)


def split_sizes(Sq, Skv, Hq, Hkv):
    """The decode instance's split of these shapes where it takes them;
    else some other cuts, the parts' merge being the point."""
    if Sq * (Hq // Hkv) <= 32:
        return [split_plan(1, Sq, Skv, Hkv, Hq // Hkv).keys_per_split, 32]
    return [64, 100]


@pytest.mark.parametrize("B,Sq,Skv,Hq,Hkv,Dh,causal,window,softcap", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_and_merge_matches_pallas_and_oracle(
        rng, B, Sq, Skv, Hq, Hkv, Dh, causal, window, softcap, dtype):
    q, k, v, qp, kp = inputs(rng, B, Sq, Skv, Hq, Hkv, Dh, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    jx = [jnp.asarray(a) for a in (q, k, v, qp, kp)]
    pallas = flash_attention_pallas(*jx, interpret=True, **kw)
    oracle = attention_reference(*jx, **kw)
    tol = TOL[dtype]
    for keys in split_sizes(Sq, Skv, Hq, Hkv):
        out = attention_split_reference(*map(to_torch, (q, k, v, qp, kp)),
                                        keys_per_split=keys, **kw)
        assert out.dtype == to_torch(q).dtype and out.shape == q.shape
        for ref in (pallas, oracle):
            np.testing.assert_allclose(as_f32(out), as_f32(ref), atol=tol,
                                       rtol=tol)


def test_split_and_merge_of_a_cross_decode(rng):
    """whisper's cross-attention tick: one query row a kv head (G = 1)
    against a full 1500-slot cache, no causal mask, cut as the decode
    instance cuts it for 8 slots of 16 heads (a 220-key tail in the last
    split): every slot counted once, as the oracle counts it."""
    B, Skv, H, Dh = 2, 1500, 3, 64
    plan = split_plan(8, 1, Skv, 16, 1)
    assert plan.n_splits * plan.keys_per_split >= Skv > (
        plan.n_splits - 1) * plan.keys_per_split
    q, k, v, _, _ = inputs(rng, B, 1, Skv, H, H, Dh, "float32")
    qp = np.full((B, 1), 7, np.int32)      # before every key: no mask
    kp = np.broadcast_to(np.arange(Skv, dtype=np.int32), (B, Skv)).copy()
    out = attention_split_reference(*map(to_torch, (q, k, v, qp, kp)),
                                    keys_per_split=plan.keys_per_split,
                                    causal=False)
    want = attention_reference(*map(jnp.asarray, (q, k, v, qp, kp)),
                               causal=False)
    np.testing.assert_allclose(as_f32(out), as_f32(want), atol=2e-5,
                               rtol=2e-5)


def test_split_and_merge_of_fully_masked_rows_and_splits(rng):
    """A split with no valid key (the empty end of a cache) adds nothing;
    a row with no valid key anywhere gives 0, not NaN."""
    q, k, v, qp, kp = map(to_torch, inputs(rng, 2, 1, 256, 8, 2, 64,
                                           "float32"))
    kp[0, 40:] = -1                 # row 0: splits past slot 40 are empty
    kp[1] = -1                      # row 1: nothing to attend
    out = attention_split_reference(q, k, v, qp, kp, keys_per_split=32)
    ref = flash_attention(q, k, v, qp, kp)
    assert not bool(out.isnan().any())
    assert float(out[1].abs().max()) == 0.0
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    jx = [jnp.asarray(a.numpy()) for a in (q, k, v, qp, kp)]
    np.testing.assert_allclose(
        as_f32(out), as_f32(flash_attention_pallas(*jx, interpret=True)),
        atol=2e-5, rtol=2e-5)


def test_split_and_merge_of_a_permuted_rolling_window(rng):
    """A windowed decode over a rolling cache, its slots in any order, in
    splits that cut the window: the same output as the ordered cache."""
    C, W = 256, 96
    q, k, v, _, _ = map(to_torch, inputs(rng, 1, 1, C, 4, 2, 32,
                                         "float32"))
    qp = torch.tensor([[1000 + C]], dtype=torch.int32)
    kp = torch.arange(1000, 1000 + C, dtype=torch.int32)[None]
    perm = torch.as_tensor(np.random.default_rng(3).permutation(C))
    kw = dict(causal=True, window=W)
    ordered = attention_split_reference(q, k, v, qp, kp, keys_per_split=64,
                                        **kw)
    permuted = attention_split_reference(
        q, k[:, perm].contiguous(), v[:, perm].contiguous(), qp,
        kp[:, perm].contiguous(), keys_per_split=64, **kw)
    torch.testing.assert_close(permuted, ordered, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(ordered, flash_attention(q, k, v, qp, kp, **kw),
                               atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

BWD_TOL = 1e-5      # x max |grad| of each gradient; float32 on both sides


def assert_grads_close(got, want, tol=BWD_TOL):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = as_f32(a), as_f32(b)
        assert a.shape == b.shape, name
        assert np.isfinite(a).all(), name
        err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert err <= tol, (name, err)


def test_backward_cases_cover_the_hard_parts():
    """Fully masked rows, a softcap, a window, G = 1, 4 and 6, Sq != Skv,
    Dh 32/64/128, a shape the forward sends to the decode split, and both
    backward instances in bfloat16."""
    groups = {c[3] // c[4] for c in FLASH_BWD_CASES}
    assert {1, 4, 6} <= groups
    assert any(c[9] for c in FLASH_BWD_CASES)
    assert any(c[8] for c in FLASH_BWD_CASES)
    assert any(c[7] for c in FLASH_BWD_CASES)
    assert any(c[1] != c[2] for c in FLASH_BWD_CASES)
    assert {c[5] for c in FLASH_BWD_CASES} == {32, 64, 128}
    assert any(flash_route(torch.float32, c[1], c[3], c[4], c[5]) == "split"
               for c in FLASH_BWD_CASES)
    assert {flash_bwd_route(torch.bfloat16, c[5])
            for c in FLASH_BWD_CASES} == {"wgmma", "simt"}


def masked_logits(q, k, qp, kp, causal, window, softcap):
    """The logits of `attention_reference`, masked to -inf, (B, Hkv, G,
    Sq, Skv), in float64: an independent statement of what lse sums."""
    B, Sq, Hq, Dh = q.shape
    Hkv = k.shape[2]
    qf = q.double().reshape(B, Sq, Hkv, Hq // Hkv, Dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.double()) / Dh ** 0.5
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    mask = attention_mask(qp, kp, causal=causal, window=window)[:, None, None]
    return torch.where(mask, logits, -torch.inf)


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_plain_forward_lse(case):
    """The plain (out, lse) forward: lse against torch.logsumexp of the
    masked logits, +inf exactly on the rows that see no key (so that the
    backward's exp(c - lse) is 0 there); out the same as without lse and
    within the reference suite's tolerance of the JAX reference's."""
    (q, k, v, qp, kp), kw, _ = flash_bwd_inputs(case, torch.float32,
                                                torch.device("cpu"))
    B, Sq, Hq, _ = q.shape
    out, lse = plain_attention(q, k, v, qp, kp, return_lse=True, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (B, Sq, Hq)
    want = torch.logsumexp(masked_logits(q, k, qp, kp, **kw), dim=-1)
    want = want.permute(0, 3, 1, 2).reshape(B, Sq, Hq)
    assert torch.equal(torch.isinf(lse), torch.isinf(want))
    assert bool(torch.isposinf(lse[:, :case[9]]).all())
    assert not bool(torch.isneginf(lse).any())
    finite = ~torch.isinf(want)
    np.testing.assert_allclose(lse[finite].numpy(), want[finite].numpy(),
                               atol=1e-5, rtol=1e-6)
    assert torch.equal(out, plain_attention(q, k, v, qp, kp, **kw))
    jx = attention_reference(*(jnp.asarray(a.numpy())
                               for a in (q, k, v, qp, kp)), **kw)
    np.testing.assert_allclose(out.numpy(), as_f32(jx), atol=2e-5, rtol=2e-5)
    assert torch.equal(flash_attention_forward(q, k, v, qp, kp, **kw)[1], lse)


def test_plain_forward_lse_of_a_fully_masked_batch_row():
    """A batch row with no key at all: lse +inf on every row, output 0."""
    (q, k, v, qp, kp), kw, _ = flash_bwd_inputs(FLASH_BWD_CASES[0],
                                                torch.float32,
                                                torch.device("cpu"))
    kp[1] = -1
    out, lse = plain_attention(q, k, v, qp, kp, return_lse=True, **kw)
    assert bool(torch.isposinf(lse[1]).all())
    assert not bool(torch.isinf(lse[0, 1:]).any())    # position 0: empty
    assert float(out[1].abs().max()) == 0.0


def out_and_lse(q, k, v, qp, kp, kw, source, jax_out):
    """(out, lse) for the plain backward: the port's plain forward in its
    lse form, or the JAX forward's output with torch.logsumexp's lse."""
    if source == "plain-forward":
        return plain_attention(q, k, v, qp, kp, return_lse=True, **kw)
    B, Sq, Hq, _ = q.shape
    lse = torch.logsumexp(masked_logits(q, k, qp, kp, **kw), dim=-1)
    return (to_torch(np.array(jax_out)),
            lse.permute(0, 3, 1, 2).reshape(B, Sq, Hq).float())


@pytest.mark.parametrize("source", ["plain-forward", "logsumexp"])
@pytest.mark.parametrize("case", FLASH_BWD_CASES)
def test_plain_backward_matches_jax_vjp(case, source):
    """attention_backward_reference, given an lse (the plain forward's,
    or torch.logsumexp's beside the JAX forward's output), against
    jax.vjp of the reference's oracle and of its ops.flash_attention."""
    (q, k, v, qp, kp), kw, dout = flash_bwd_inputs(case, torch.float32,
                                                   torch.device("cpu"))

    @jax.jit
    def outputs_and_vjps(q, k, v, qp, kp, dout):
        res = []
        for fn in (attention_reference, ref_ops.flash_attention):
            out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, qp, kp, **kw),
                               q, k, v)
            res.append((out, vjp(dout)))
        return res

    for out, want in outputs_and_vjps(*(jnp.asarray(a.numpy()) for a in (
            q, k, v, qp, kp, dout))):
        o, lse = out_and_lse(q, k, v, qp, kp, kw, source, out)
        got = attention_backward_reference(q, k, v, o, dout, lse, qp, kp,
                                           **kw)
        assert [g.dtype for g in got] == [torch.float32] * 3
        assert_grads_close(got, want)
    masked = case[9]
    if masked:                      # rows that see no key get dq = 0
        assert float(got[0][:, :masked].abs().max()) == 0.0


TC_CASES = [c for c in FLASH_BWD_CASES
            if flash_bwd_route(torch.bfloat16, c[5]) == "wgmma"]


@pytest.mark.parametrize("case", TC_CASES)
def test_tensor_core_mirror_matches_jax_vjp(case):
    """The tensor-core instance's roundings in plain torch (P and dS to
    bfloat16 before their products, float32 sums), on bfloat16 inputs,
    against jax.vjp of the reference at the same values in float32:
    within the card's bfloat16 gate (FLASH_BWD_TOL) of each gradient's
    max; rows that see no key get dq = 0 exactly."""
    (q, k, v, qp, kp), kw, dout = flash_bwd_inputs(case, torch.bfloat16,
                                                   torch.device("cpu"))
    out, lse = plain_attention(q, k, v, qp, kp, return_lse=True, **kw)
    got = attention_backward_passes(q, k, v, out, dout, lse, qp, kp, **kw)
    assert [g.dtype for g in got] == [torch.bfloat16] * 3
    f32 = [jnp.asarray(a.float().numpy()) for a in (q, k, v, dout)]
    _, vjp = jax.vjp(lambda a, b, c: attention_reference(
        a, b, c, jnp.asarray(qp.numpy()), jnp.asarray(kp.numpy()), **kw),
        *f32[:3])
    want = vjp(f32[3])
    assert_grads_close(got, want, tol=FLASH_BWD_TOL[torch.bfloat16])
    if case[9]:
        assert float(got[0][:, :case[9]].float().abs().max()) == 0.0


def test_tensor_core_mirror_rounds_p_and_ds():
    """The mirror differs from the float32 plain backward by its
    bfloat16 roundings of P and dS: on the same float32 inputs it moves
    each gradient by more than float32's sums would (1e-5 of its max)
    and by less than the bfloat16 gate."""
    (q, k, v, qp, kp), kw, dout = flash_bwd_inputs(FLASH_BWD_CASES[2],
                                                   torch.float32,
                                                   torch.device("cpu"))
    out, lse = plain_attention(q, k, v, qp, kp, return_lse=True, **kw)
    exact = attention_backward_reference(q, k, v, out, dout, lse, qp, kp,
                                         **kw)
    rounded = attention_backward_passes(q, k, v, out, dout, lse, qp, kp,
                                        **kw)
    for a, b in zip(rounded, exact):
        rel = float((a - b).abs().max() / b.abs().max())
        assert 1e-5 < rel < FLASH_BWD_TOL[torch.bfloat16]


def test_plain_backward_keeps_the_input_dtypes():
    (q, k, v, qp, kp), kw, dout = flash_bwd_inputs(FLASH_BWD_CASES[1],
                                                   torch.bfloat16,
                                                   torch.device("cpu"))
    out, lse = flash_attention_forward(q, k, v, qp, kp, **kw)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    dq, dk, dv = attention_backward_reference(q, k, v, out, dout, lse, qp,
                                              kp, **kw)
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16


@pytest.mark.parametrize("case", [FLASH_BWD_CASES[i] for i in (2, 6, 10, 11)])
def test_flash_attention_fn_matches_autograd(case):
    """FlashAttentionFn on CPU tensors (the plain forward, the plain
    backward) against autograd through attention_reference, and the
    wrapper's CPU path is that autograd."""
    (q, k, v, qp, kp), kw, dout = flash_bwd_inputs(case, torch.float32,
                                                   torch.device("cpu"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = plain_attention(*leaves, qp, kp, **kw)
    want = torch.autograd.grad(out, leaves, dout)
    before = dict(launch_counts)
    fn_out = FlashAttentionFn.apply(*leaves, qp, kp, kw["causal"],
                                    kw["window"], kw["softcap"], None)
    torch.testing.assert_close(fn_out, out, atol=0, rtol=0)
    assert_grads_close(torch.autograd.grad(fn_out, leaves, dout), want)
    wrapped = flash_attention(*leaves, qp, kp, **kw)
    assert_grads_close(torch.autograd.grad(wrapped, leaves, dout), want,
                       tol=0.0)
    assert launch_counts == before          # the CPU branch launches nothing


def test_flash_attention_fn_saves_the_lse():
    """FlashAttentionFn on CPU tensors saves q, k, v, the output, the
    plain forward's lse ((B, Sq, Hq), float32, +inf on the rows that see
    no key) and the positions; its backward is the plain backward with
    that lse."""
    case = FLASH_BWD_CASES[10]
    (q, k, v, qp, kp), kw, dout = flash_bwd_inputs(case, torch.float32,
                                                   torch.device("cpu"))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fn_out = FlashAttentionFn.apply(*leaves, qp, kp, kw["causal"],
                                    kw["window"], kw["softcap"], None)
    saved = fn_out.grad_fn.saved_tensors
    assert len(saved) == 7
    out, lse = plain_attention(q, k, v, qp, kp, return_lse=True, **kw)
    assert torch.equal(saved[3], out) and torch.equal(saved[4], lse)
    assert saved[4].dtype == torch.float32
    assert bool(torch.isposinf(saved[4][:, :case[9]]).all())
    got = torch.autograd.grad(fn_out, leaves, dout)
    want = attention_backward_reference(q, k, v, out, dout, lse, qp, kp,
                                        **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("case", FLASH_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_route_of_the_backward_cases(case, dtype):
    """The backward's instance from dtype, head dim and alignment: the
    tensor cores for bfloat16 at Dh 64 or 128, the SIMT instance for the
    rest; never the decode split, which is the forward's alone."""
    B, Sq, Skv, Hq, Hkv, Dh = case[:6]
    q = empty((B, Sq, Hq, Dh), dtype)
    k, v = empty((B, Skv, Hkv, Dh), dtype), empty((B, Skv, Hkv, Dh), dtype)
    assert bwd_route(q, k, v) == flash_bwd_route(q.dtype, Dh)


def test_bwd_route_of_the_training_shapes_and_its_limits():
    """qwen2's training shapes take the tensor cores; a misaligned view,
    and more query or key tiles than its marks hold, the SIMT instance."""
    for B, S in FLASH_BWD_TIMED:
        q = empty((B, S, 12, 128), "bfloat16")
        k = empty((B, S, 2, 128), "bfloat16")
        assert bwd_route(q, k, k) == "wgmma"
    q = empty((1, 129 * 64 * 12 + 1), "bfloat16")[:, 1:].view(1, 129, 12, 64)
    k = empty((1, 129, 2, 64), "bfloat16")
    assert bwd_route(q, k, k) == "simt"
    assert bwd_route(q.clone(), k, k) == "wgmma"
    # G = 6: 10 positions a packed tile
    long_q = empty((1, 1, 12, 128), "bfloat16").expand(
        1, 10 * BWD_MAX_QUERY_TILES + 1, 12, 128)
    one_key = empty((1, 1, 2, 128), "bfloat16")
    assert bwd_route(long_q[:, :-1], one_key, one_key) == "wgmma"
    assert bwd_route(long_q, one_key, one_key) == "simt"
    long_k = empty((1, 1, 2, 128), "bfloat16").expand(
        1, 64 * BWD_MAX_KEY_TILES + 1, 2, 128)
    assert bwd_route(empty((1, 64, 12, 128), "bfloat16"), long_k,
                     long_k) == "simt"


def test_backward_refuses_other_devices():
    q = torch.zeros((1, 1, 2, 32), device="meta")
    pos = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention_backward(q, q, q, q, q, q[..., 0], pos, pos)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        flash_attention_forward(q, q, q, pos, pos)
