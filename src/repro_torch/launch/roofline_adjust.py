"""Kernel-adjusted roofline terms for the H100, per kernel site.

The port of the JAX package's ``launch/roofline_adjust.py``.  The
dry-run (`launch.dryrun`) counts a step's operations on fake tensors;
each call of a kernel wrapper (flash attention, the SSD scan, the
grouped matmul, the Mamba mixer's causal conv, and their backwards) is
recorded as a `Site` instead of running.  This module prices a site two ways:

  * ``plain_cost``: what the kernel's plain PyTorch version would cost,
    CALIBRATED, not hand-derived: `_calibrate_attention`,
    `_calibrate_ssd` and `_calibrate_conv` count the plain functions
    (`kernels.flash_attention.ref.attention_reference`,
    `kernels.ssd.ops.ssd_chunked`, `kernels.causal_conv.ref.
    causal_conv_silu`) and their autograd gradients with the dry-run's
    counting mode at small shapes (the reference's, for the first two)
    and divide by the score (intra-chunk, activation) elements;
    linearity in those elements makes the factor exact up to boundary
    terms.  The grouped matmul's plain cost is its kernel cost (the
    reference priced its capacity einsums as ordinary products, which is
    what the formula counts).
  * ``kernel_cost``: the least the card must do for the call, counting
    what it needs: each input read once and each output written once, and
    the products of the (query, key) pairs the mask leaves (flash), the
    causal chunk products (SSD), 2 K N per row in a group (gmm), 2 K
    (forward) and 4 K (backward) per activation element (the conv).
    These are the formulas `chip_smoke.py`'s bounds use (`flash_cost`,
    `flash_bwd_cost`, `ssd_cost`, `ssd_bwd_cost`, `gmm_cost`,
    `gmm_bwd_cost`, `conv_cost`, `conv_bwd_cost`; `bound_ms` turns one
    into a time).

``kernel_adjusted`` swaps the one for the other:

  adjusted = raw  -  sum_sites plain_cost(site)  +  sum_sites kernel_cost(site)

over the dry-run's recorded sites (one rank's calls), or, as the
reference does, over the call sites enumerated from the config
(`attention_sites`, `ssd_sites`, `gmm_sites`, and a conv a Mamba layer:
the whole step's, divided by the chips, under idealized even sharding).

`H100` holds the card's rates, each from the NVIDIA H100 SXM data sheet:
dense bfloat16 tensor-core FLOP/s, the FP32 and FP64 vector rates (the
port runs float32 products without TF32), HBM3 bandwidth and capacity,
NVLink bandwidth a direction within an 8-GPU node, and one 400 Gb/s NDR
port a GPU between nodes.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.configs.shapes import ShapeCell
from repro_torch.models.config import ModelConfig

#: NVIDIA H100 SXM data sheet
H100 = {
    "bf16_flops_per_s": 989e12,        # dense, tensor cores (fp16 alike)
    "fp32_flops_per_s": 67e12,         # vector (no TF32)
    "fp64_flops_per_s": 34e12,         # vector
    "hbm_bytes_per_s": 3.35e12,        # HBM3
    "hbm_bytes": 80e9,
    "nvlink_bytes_per_s": 450e9,       # a direction, within an 8-GPU node
    "network_bytes_per_s": 50e9,       # one 400 Gb/s NDR port a GPU
    "gpus_per_node": 8,
}

_AD = torch.bfloat16  # activation dtype of the calibrations


def flops_rate(dtype) -> float:
    """The card's peak rate for products (and vector work) in ``dtype``:
    the tensor cores for 16-bit types, the vector rates for float32 and
    float64 (integer work at the float32 rate)."""
    dtype = _dtype(dtype)
    if dtype in (torch.bfloat16, torch.float16):
        return H100["bf16_flops_per_s"]
    if dtype == torch.float64:
        return H100["fp64_flops_per_s"]
    return H100["fp32_flops_per_s"]


def _dtype(dtype) -> torch.dtype:
    return getattr(torch, dtype) if isinstance(dtype, str) else dtype


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """(least ms, what bounds it: "bytes" or "operations") for a call that
    moves ``nbytes`` through HBM and does ``flops`` in ``dtype``."""
    t_bytes = nbytes / H100["hbm_bytes_per_s"]
    t_ops = flops / flops_rate(dtype)
    if t_bytes >= t_ops:
        return 1e3 * t_bytes, "bytes"
    return 1e3 * t_ops, "operations"


# ---------------------------------------------------------------------------
# Per-call formulas (shared with chip_smoke.py's bounds)
# ---------------------------------------------------------------------------

def flash_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, Dh: int,
               item: int, pairs: int, attended: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one flash forward: q, both position arrays and
    the output once, the K and V rows of the ``attended`` (row, slot)
    pairs that some query attends; QK^T and PV, 4 Dh per unmasked (row,
    query, key) triple of ``pairs`` and query head."""
    nbytes = (2 * B * Sq * Hq * Dh * item + 2 * attended * Hkv * Dh * item
              + 4 * (B * Sq + B * Skv))
    return nbytes, 4 * Dh * Hq * pairs


def flash_bwd_cost(B: int, Sq: int, Skv: int, Hq: int, Hkv: int, Dh: int,
                   item: int, pairs: int) -> tuple[int, float]:
    """(bytes, FLOPs) of one flash backward: q, k, v, the output, its
    gradient and the float32 log-sum-exp read once, dq, dk, dv written
    once, the positions; FlashAttention-2's backward work, 2.5 x the
    forward's products."""
    nbytes = (item * (4 * B * Sq * Hq * Dh + 4 * B * Skv * Hkv * Dh)
              + 4 * (B * Sq + B * Skv) + 4 * B * Sq * Hq)
    return nbytes, 2.5 * 4 * Dh * Hq * pairs


def ssd_flops(S: int, chunk: int, H: int, P: int, N: int, B: int = 1,
              G: int = 1) -> int:
    """The causal FLOPs of one SSD call: per chunk of L steps and group
    the scores C B^T over the L(L+1)/2 pairs (2N each), per head the
    masked scores times x (2P each), and per head the inter-chunk output
    and state update (2PN each per step)."""
    Q = min(chunk, S)
    total = 0
    for t0 in range(0, S, Q):
        L = min(Q, S - t0)
        total += (G * L * (L + 1) * N
                  + H * (L * (L + 1) * P + 4 * L * P * N))
    return B * total


def ssd_cost(B: int, S: int, H: int, P: int, G: int, N: int, chunk: int,
             item: int, init: bool) -> tuple[int, int]:
    """(bytes, FLOPs) of one SSD forward: x, dt (float32), A, D, B and C
    per group and the initial state once in, y and the final state (float32)
    once out; `ssd_flops`."""
    state = B * H * P * N * 4
    nbytes = (2 * B * S * H * P * item + B * S * H * 4 + 2 * H * 4
              + 2 * B * S * G * N * item + state + (state if init else 0))
    return nbytes, ssd_flops(S, chunk, H, P, N, B, G)


def ssd_bwd_flops(S: int, chunk: int, H: int, P: int, N: int, B: int = 1,
                  G: int = 1) -> int:
    """The backward's causal FLOPs: per chunk and group the scores once,
    per head the masked products of the key side (dx, dB) and the query
    side (dC), and the state terms (8PN a step)."""
    Q = min(chunk, S)
    total = 0
    for t0 in range(0, S, Q):
        L = min(Q, S - t0)
        total += (G * L * (L + 1) * N
                  + H * (L * (L + 1) * 2 * (N + P) + 8 * L * P * N))
    return B * total


def ssd_bwd_cost(B: int, S: int, H: int, P: int, G: int, N: int,
                 chunk: int, item: int, init: bool,
                 dfinal: bool) -> tuple[int, int]:
    """(bytes, FLOPs) of one SSD backward: x and dy, B and C per group,
    dt, A, D, the states the forward kept (every chunk's but a first one
    without an initial state, 4 bytes an element) and the final state's
    gradient once in; dx, dB, dC, ddt, dA, dD and the initial state's
    gradient once out; `ssd_bwd_flops`."""
    n_chunks = -(-S // min(chunk, S))
    state = B * H * P * N * 4
    kept = (n_chunks - (not init)) * state
    nbytes = (3 * B * S * H * P * item + 4 * B * S * G * N * item
              + 2 * B * S * H * 4 + 4 * H * 4 + kept
              + (state if dfinal else 0) + (state if init else 0))
    return nbytes, ssd_bwd_flops(S, chunk, H, P, N, B, G)


def gmm_cost(T: int, K: int, N: int, E: int, rows: int, live: int,
             lhs_item: int, rhs_item: int, out_item: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one grouped matmul: lhs, the weights of the
    ``live`` experts (non-empty groups), the group sizes and the output
    once; 2 K N per row in a group (``rows`` of the T)."""
    nbytes = (T * K * lhs_item + live * K * N * rhs_item + 4 * E
              + T * N * out_item)
    return nbytes, 2 * rows * K * N


def gmm_bwd_cost(T: int, K: int, N: int, E: int, rows: int, live: int,
                 lhs_item: int, rhs_item: int, dout_item: int,
                 which: str) -> tuple[int, int]:
    """`gmm_cost`'s rule for one gradient (``which``: "dlhs" or "drhs"):
    dout and the group sizes in, and rhs of the live groups (dlhs) or lhs
    (drhs); the gradient (lhs's or rhs's shape) out."""
    nbytes = T * N * dout_item + 4 * E + (
        live * K * N * rhs_item + T * K * lhs_item if which == "dlhs"
        else T * K * lhs_item + E * K * N * rhs_item)
    return nbytes, 2 * rows * K * N


def conv_cost(B: int, S: int, C: int, K: int,
              item: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one causal conv forward (with its bias and
    SiLU): x, the K taps and the bias once in, y once out; a product and
    a sum a tap and output element."""
    return (2 * B * S * C + K * C + C) * item, 2 * K * B * S * C


def conv_bwd_cost(B: int, S: int, C: int, K: int,
                  item: int) -> tuple[int, int]:
    """(bytes, FLOPs) of one causal conv backward: dy, x, the taps and
    the bias once in; dx and the taps' and the bias's gradients once
    out; dx's and dw's products and sums, 4 K an element."""
    return (3 * B * S * C + 2 * K * C + 2 * C) * item, 4 * K * B * S * C


# ---------------------------------------------------------------------------
# Sites
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Site:
    """One call of a kernel wrapper as the dry-run records it.

    ``kernel`` is the launch count's key (`kernels.build.launch_counts`):
    "flash_attention", "flash_attention_bwd", "ssd", "ssd_bwd", "gmm",
    "gmm_bwd", "causal_conv", "causal_conv_bwd".  ``shape``: (B, Sq, Skv,
    Hq, Hkv, Dh) for flash, (B, S, H, P, G, N) for SSD, (T, K, N, E) for
    gmm, (B, S, C, K) for the conv.  ``dtype`` is the inputs'
    (lhs's for gmm).  Flash: ``causal``, ``window``; SSD: ``chunk``,
    ``init`` (an initial state), ``dfinal`` (a final state's gradient);
    gmm: ``rows`` in groups, ``live`` non-empty groups, ``out_dtype`` (the
    output's, or the output gradient's) and, for the backward, ``need``
    (dlhs, drhs)."""

    kernel: str
    shape: tuple[int, ...]
    dtype: str
    causal: bool = False
    window: int | None = None
    chunk: int = 0
    init: bool = False
    dfinal: bool = False
    rows: int = 0
    live: int = 0
    out_dtype: str = ""
    need: tuple[bool, bool] = (True, True)

    @property
    def item(self) -> int:
        return _dtype(self.dtype).itemsize


def flash_pairs(B: int, Sq: int, Skv: int, causal: bool,
                window: int | None) -> int:
    """Unmasked (row, query, key) triples of a call whose every slot holds
    a key, with the queries at the last Sq of the Skv positions (a
    prefill, a decode row): causal, each sees the keys at or before it
    (at most ``window`` of them); otherwise every key.  Under sequence
    parallelism this is the last rank's share, the most any rank does."""
    if not causal:
        return B * Sq * Skv
    total = 0
    for i in range(Skv - Sq, Skv):
        seen = i + 1
        total += seen if window is None else min(seen, window)
    return B * total


def kernel_cost(site: Site) -> tuple[float, float]:
    """(bytes, FLOPs) of a site at the kernel model (the per-call
    formulas above)."""
    k, s, item = site.kernel, site.shape, site.item
    if k in ("flash_attention", "flash_attention_bwd"):
        B, Sq, Skv, Hq, Hkv, Dh = s
        pairs = flash_pairs(B, Sq, Skv, site.causal, site.window)
        if k == "flash_attention":
            return flash_cost(B, Sq, Skv, Hq, Hkv, Dh, item, pairs, B * Skv)
        return flash_bwd_cost(B, Sq, Skv, Hq, Hkv, Dh, item, pairs)
    if k == "ssd":
        return ssd_cost(*s, site.chunk, item, site.init)
    if k == "ssd_bwd":
        return ssd_bwd_cost(*s, site.chunk, item, site.init, site.dfinal)
    if k == "causal_conv":
        return conv_cost(*s, item)
    if k == "causal_conv_bwd":
        return conv_bwd_cost(*s, item)
    if k in ("gmm", "gmm_bwd"):
        T, K, N, E = s
        out_item = _dtype(site.out_dtype or site.dtype).itemsize
        if k == "gmm":
            return gmm_cost(T, K, N, E, site.rows, site.live, item, item,
                            out_item)
        nbytes = flops = 0
        for which, need in zip(("dlhs", "drhs"), site.need):
            if need:
                b, f = gmm_bwd_cost(T, K, N, E, site.rows, site.live, item,
                                    item, out_item, which)
                nbytes, flops = nbytes + b, flops + f
        return nbytes, flops
    raise ValueError(f"no kernel model for {k!r}")


def _elems(site: Site) -> int:
    """The elements a plain version's cost is linear in: the score
    rectangle B Hq Sq Skv (flash), the intra-chunk squares B nc Q^2 H
    (SSD), the activation B S C (the conv)."""
    s = site.shape
    if site.kernel.startswith("causal_conv"):
        B, S, C, _ = s
        return B * S * C
    if site.kernel.startswith("flash"):
        B, Sq, Skv, Hq, _, _ = s
        return B * Hq * Sq * Skv
    B, S, H = s[:3]
    Q = min(site.chunk, S)
    return B * -(-S // Q) * Q * Q * H


def plain_cost(site: Site) -> tuple[float, float]:
    """(bytes, FLOPs) of a site at its plain version's calibrated cost
    (a backward: the gradient's count less its forward's)."""
    if site.kernel.startswith("gmm"):
        return kernel_cost(site)
    cal = (_calibrate_attention() if site.kernel.startswith("flash")
           else _calibrate_conv() if site.kernel.startswith("causal_conv")
           else _calibrate_ssd())
    n = _elems(site)
    if site.kernel.endswith("_bwd"):
        return ((cal["b_grad"] - cal["b_fwd"]) * n,
                (cal["f_grad"] - cal["f_fwd"]) * n)
    return cal["b_fwd"] * n, cal["f_fwd"] * n


# ---------------------------------------------------------------------------
# Calibration (cached per process)
# ---------------------------------------------------------------------------

def _count(fn, *shapes):
    """(FLOPs, bytes) of ``fn`` on fake tensors of ``shapes`` ((shape,
    dtype, requires_grad) each), by the dry-run's counting mode."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import OpCounter

    with FakeTensorMode():
        args = [torch.empty(s, dtype=d).requires_grad_(g)
                for s, d, g in shapes]
        with OpCounter() as counter:
            fn(*args)
    return counter.total_flops(), float(counter.bytes)


@functools.lru_cache(maxsize=None)
def _calibrate_attention() -> dict[str, float]:
    """Per-score-element flops/bytes of the dense plain version, forward
    and forward + backward (autograd's)."""
    from repro_torch.kernels.flash_attention.ref import attention_reference

    B, Sq, Skv, Hq, Hkv, Dh = 2, 256, 512, 4, 2, 64
    elems = B * Hq * Sq * Skv

    def fwd(q, k, v, qp, kp):
        return attention_reference(q, k, v, qp, kp, causal=True)

    def grad(q, k, v, qp, kp):
        loss = fwd(q, k, v, qp, kp).float().sum()
        torch.autograd.grad(loss, (q, k, v))

    shapes = [((B, Sq, Hq, Dh), _AD), ((B, Skv, Hkv, Dh), _AD),
              ((B, Skv, Hkv, Dh), _AD), ((B, Sq), torch.int32),
              ((B, Skv), torch.int32)]
    f_fwd, b_fwd = _count(fwd, *((s, d, False) for s, d in shapes))
    f_grad, b_grad = _count(grad, *((s, d, i < 3)
                                    for i, (s, d) in enumerate(shapes)))
    return {"f_fwd": f_fwd / elems, "b_fwd": b_fwd / elems,
            "f_grad": f_grad / elems, "b_grad": b_grad / elems, "dh": Dh}


@functools.lru_cache(maxsize=None)
def _calibrate_ssd() -> dict[str, float]:
    """Per-intra-chunk-element flops/bytes of the chunked plain SSD."""
    from repro_torch.kernels.ssd.ops import ssd_chunked

    B, S, H, P, G, N, Q = 2, 512, 4, 64, 1, 64, 128
    elems = B * (S // Q) * Q * Q * H

    def fwd(x, dt, A, Bm, Cm, D):
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk=Q)[0]

    def grad(x, dt, A, Bm, Cm, D):
        loss = fwd(x, dt, A, Bm, Cm, D).float().sum()
        torch.autograd.grad(loss, (x, dt, Bm, Cm))

    shapes = [((B, S, H, P), _AD), ((B, S, H), torch.float32),
              ((H,), torch.float32), ((B, S, G, N), _AD),
              ((B, S, G, N), _AD), ((H,), torch.float32)]
    f_fwd, b_fwd = _count(fwd, *((s, d, False) for s, d in shapes))
    f_grad, b_grad = _count(grad, *((s, d, i in (0, 1, 3, 4))
                                    for i, (s, d) in enumerate(shapes)))
    return {"f_fwd": f_fwd / elems, "b_fwd": b_fwd / elems,
            "f_grad": f_grad / elems, "b_grad": b_grad / elems}


@functools.lru_cache(maxsize=None)
def _calibrate_conv() -> dict[str, float]:
    """Per-activation-element flops/bytes of the plain causal conv and
    its SiLU."""
    from repro_torch.kernels.causal_conv.ref import causal_conv_silu

    B, S, C, K = 2, 256, 256, 4
    elems = B * S * C

    def grad(x, w, b):
        loss = causal_conv_silu(x, w, b).float().sum()
        torch.autograd.grad(loss, (x, w, b))

    shapes = [((B, S, C), _AD), ((K, C), _AD), ((C,), _AD)]
    f_fwd, b_fwd = _count(causal_conv_silu, *((s, d, False)
                                              for s, d in shapes))
    f_grad, b_grad = _count(grad, *((s, d, True) for s, d in shapes))
    return {"f_fwd": f_fwd / elems, "b_fwd": b_fwd / elems,
            "f_grad": f_grad / elems, "b_grad": b_grad / elems}


# ---------------------------------------------------------------------------
# Call-site enumeration from the config
# ---------------------------------------------------------------------------

def _causal_fraction(S: int, window: int | None) -> float:
    """Fraction of the Sq×Skv rectangle the kernel actually computes."""
    if window is None or window >= S:
        return 0.5 + 0.5 / max(S, 1)
    w = window
    # rows 0..w-1 see i+1 keys; rows w..S-1 see w keys
    total = w * (w + 1) / 2 + (S - w) * w
    return total / (S * S)


def attention_sites(cfg: ModelConfig, cell: ShapeCell):
    """Yield (elems_full, frac_eff, io_bytes, train?) per step, global
    (pre-division by chips). Covers decoder self-attn, encoder self-attn,
    and cross-attention; decode covers the cache-read row."""
    B = cell.global_batch
    Dh = cfg.d_head
    sites = []
    train = cell.kind == "train"

    if cell.kind in ("train", "prefill"):
        Sq = cell.seq_len
        for i in range(cfg.n_layers):
            if cfg.mixer_kind(i) != "attn":
                continue
            w = (cfg.attn_window
                 if cfg.attn_window is not None
                 and not cfg.layer_uses_global_attn(i) else None)
            elems = B * cfg.n_heads * Sq * Sq
            frac = _causal_fraction(Sq, w)
            io = (2 * B * Sq * cfg.n_heads * Dh
                  + 2 * B * Sq * cfg.n_kv_heads * Dh) * 2
            sites.append((elems, frac, io, train))
        if cfg.encoder is not None:
            F = cfg.encoder.n_frames
            for _ in range(cfg.encoder.n_layers):
                elems = B * cfg.n_heads * F * F
                io = 4 * B * F * cfg.n_heads * Dh * 2
                sites.append((elems, 1.0, io, train))
            for _ in range(cfg.n_layers):  # cross-attn q=Sq kv=F
                elems = B * cfg.n_heads * Sq * F
                io = (2 * B * Sq * cfg.n_heads * Dh
                      + 2 * B * F * cfg.n_kv_heads * Dh) * 2
                sites.append((elems, 1.0, io, train))
    else:  # decode: one token against the cache
        S = cell.seq_len
        for i in range(cfg.n_layers):
            if cfg.mixer_kind(i) != "attn":
                continue
            cap = cfg.kv_cache_len(i, S)
            elems = B * cfg.n_heads * 1 * cap
            io = (2 * B * 1 * cfg.n_heads * Dh
                  + 2 * B * cap * cfg.n_kv_heads * Dh) * 2
            sites.append((elems, 1.0, io, False))
        if cfg.encoder is not None:
            F = cfg.encoder.n_frames
            for _ in range(cfg.n_layers):
                elems = B * cfg.n_heads * 1 * F
                io = (2 * B * cfg.n_heads * Dh
                      + 2 * B * F * cfg.n_kv_heads * Dh) * 2
                sites.append((elems, 1.0, io, False))
    return sites


def ssd_sites(cfg: ModelConfig, cell: ShapeCell):
    """(elems_intra, io_bytes, train?) per SSM layer per step."""
    if cfg.ssm is None:
        return []
    s = cfg.ssm
    B = cell.global_batch
    H = s.n_heads(cfg.d_model)
    P, N, G = s.head_dim, s.d_state, s.ngroups
    sites = []
    train = cell.kind == "train"
    if cell.kind in ("train", "prefill"):
        S = cell.seq_len
        Q = min(s.chunk, S)
        nc = -(-S // Q)
        for i in range(cfg.n_layers):
            if cfg.mixer_kind(i) != "ssm":
                continue
            elems = B * nc * Q * Q * H
            io = (2 * B * S * H * P + B * S * H * 4
                  + 2 * B * S * G * N) * 2 + B * H * P * N * 4
            sites.append((elems, io, train))
    else:
        # decode step is O(H·P·N) — reference == kernel, no adjustment
        pass
    return sites


def gmm_sites(cfg: ModelConfig, cell: ShapeCell):
    """(rows, K, N, E, train?) per expert product per step, global: three
    products (gate, up: d -> f; down: f -> d) per MoE layer over the
    capacity buffer of E groups of C rows (`models.moe.capacity` of the
    step's tokens, the dense dispatch)."""
    if cfg.moe is None:
        return []
    from repro_torch.models.moe import capacity

    m = cfg.moe
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    rows = m.n_experts * capacity(cfg, tokens)
    d, f = cfg.d_model, m.d_ff_expert
    train = cell.kind == "train"
    sites = []
    for i in range(cfg.n_layers):
        if cfg.ffn_kind(i) != "moe":
            continue
        sites += [(rows, d, f, m.n_experts, train),
                  (rows, d, f, m.n_experts, train),
                  (rows, f, d, m.n_experts, train)]
    return sites


def config_sites(cfg: ModelConfig, cell: ShapeCell, *,
                 remat: str = "full") -> list[Site]:
    """The step's kernel calls enumerated from the config, global: each of
    `attention_sites`, `ssd_sites` and `gmm_sites`, and each Mamba layer's
    causal conv, as `Site`s in the activation dtype, a training site with
    its backward and, under ``remat="full"``, its recomputed forward."""
    dt = str(cfg.activation_dtype)
    B, S = cell.global_batch, cell.seq_len
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    out = []

    def add(fwd: Site, train: bool):
        out.append(fwd)
        if train:
            if remat == "full":
                out.append(fwd)
            out.append(dataclasses.replace(fwd, kernel=fwd.kernel + "_bwd"))

    def window(i):
        return (cfg.attn_window if cfg.attn_window is not None
                and not cfg.layer_uses_global_attn(i) else None)

    if cell.kind in ("train", "prefill"):
        for i in range(cfg.n_layers):
            if cfg.mixer_kind(i) == "attn":
                add(Site("flash_attention", (B, S, S, Hq, Hkv, Dh), dt,
                         causal=True, window=window(i)),
                    cell.kind == "train")
        if cfg.encoder is not None:
            F = cfg.encoder.n_frames
            for _ in range(cfg.encoder.n_layers):
                add(Site("flash_attention", (B, F, F, Hq, Hkv, Dh), dt),
                    cell.kind == "train")
            for _ in range(cfg.n_layers):
                add(Site("flash_attention", (B, S, F, Hq, Hkv, Dh), dt),
                    cell.kind == "train")
    else:
        for i in range(cfg.n_layers):
            if cfg.mixer_kind(i) == "attn":
                add(Site("flash_attention",
                         (B, 1, cfg.kv_cache_len(i, S), Hq, Hkv, Dh), dt,
                         causal=True, window=window(i)), False)
        if cfg.encoder is not None:
            for _ in range(cfg.n_layers):
                add(Site("flash_attention",
                         (B, 1, cfg.encoder.n_frames, Hq, Hkv, Dh), dt),
                    False)
    if cfg.ssm is not None and cell.kind != "decode":
        s = cfg.ssm
        shape = (B, S, s.n_heads(cfg.d_model), s.head_dim, s.ngroups,
                 s.d_state)
        conv_ch = s.d_inner(cfg.d_model) + 2 * s.ngroups * s.d_state
        for i in range(cfg.n_layers):
            if cfg.mixer_kind(i) == "ssm":
                add(Site("causal_conv", (B, S, conv_ch, s.d_conv), dt),
                    cell.kind == "train")
                add(Site("ssd", shape, dt, chunk=s.chunk),
                    cell.kind == "train")
    for rows, K, N, E, train in gmm_sites(cfg, cell):
        add(Site("gmm", (rows, K, N, E), dt, rows=rows, live=E,
                 out_dtype="float32"), train)
    return out


# ---------------------------------------------------------------------------
# The adjustment
# ---------------------------------------------------------------------------

def kernel_adjusted(raw: dict[str, float], cfg: ModelConfig,
                    cell: ShapeCell, chips: int, *,
                    sites: list[Site] | None = None,
                    remat: str = "full") -> dict[str, float]:
    """raw: {"flops": per-chip, "bytes": per-chip}, a count that priced
    every kernel site at its plain version.  Returns adjusted per-chip
    {"flops", "bytes"} plus the breakdown.  ``sites`` are one rank's
    recorded calls (already per chip); without them the config's sites
    (`config_sites`, global) are divided by ``chips``."""
    per = 1
    if sites is None:
        sites, per = config_sites(cfg, cell, remat=remat), chips
    acc = {"ref_attn_ssd_flops": 0.0, "ref_attn_ssd_bytes": 0.0,
           "kernel_attn_ssd_flops": 0.0, "kernel_attn_ssd_bytes": 0.0,
           "ref_conv_flops": 0.0, "ref_conv_bytes": 0.0,
           "kernel_conv_flops": 0.0, "kernel_conv_bytes": 0.0,
           "gmm_flops": 0.0, "gmm_bytes": 0.0}
    for site in sites:
        rb, rf = plain_cost(site)
        kb, kf = kernel_cost(site)
        if site.kernel.startswith("gmm"):
            acc["gmm_flops"] += kf
            acc["gmm_bytes"] += kb
            continue
        group = "conv" if site.kernel.startswith("causal_conv") \
            else "attn_ssd"
        acc[f"ref_{group}_flops"] += rf
        acc[f"ref_{group}_bytes"] += rb
        acc[f"kernel_{group}_flops"] += kf
        acc[f"kernel_{group}_bytes"] += kb

    def swapped(what):
        return sum(acc[f"kernel_{g}_{what}"] - acc[f"ref_{g}_{what}"]
                   for g in ("attn_ssd", "conv")) / per
    return {
        "flops": max(raw["flops"] + swapped("flops"), 0.0),
        "bytes": max(raw["bytes"] + swapped("bytes"), 0.0),
        **{f"{k}_per_chip": v / per for k, v in acc.items()},
    }


def step_bound(flops_by_dtype: dict[str, float], nbytes: float,
               link_bytes: dict[str, float]) -> dict[str, float]:
    """The three roofline terms (seconds) of a step on one card: its
    products at the rate of their dtype, its bytes over HBM, and its
    collectives' bytes over NVLink and the network."""
    compute = sum(f / flops_rate(d) for d, f in flops_by_dtype.items())
    coll = (link_bytes.get("nvlink", 0.0) / H100["nvlink_bytes_per_s"]
            + link_bytes.get("network", 0.0) / H100["network_bytes_per_s"])
    return {"compute_s": compute, "memory_s": nbytes / H100["hbm_bytes_per_s"],
            "collective_s": coll}


__all__ = ["H100", "Site", "flops_rate", "bound_ms", "flash_cost",
           "flash_bwd_cost", "ssd_flops", "ssd_cost", "ssd_bwd_flops",
           "ssd_bwd_cost", "gmm_cost", "gmm_bwd_cost", "conv_cost",
           "conv_bwd_cost", "flash_pairs",
           "kernel_cost", "plain_cost", "attention_sites", "ssd_sites",
           "gmm_sites", "config_sites", "kernel_adjusted", "step_bound"]
