"""Attention entry point: the Hopper kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.

`flash_attention` keeps the JAX package's signature and layouts
(q (B, Sq, Hq, Dh), k/v (B, Skv, Hkv, Dh), int32 positions (B, S)).  On
a CUDA tensor it checks dtype, shape, contiguity, alignment and device,
then launches one of the three instances of `flash_attention.cu` on the
current stream, or raises; on a CPU tensor, and only there, it runs
`ref.attention_reference`.

`route` picks the instance from dtype, shape and alignment alone: the
decode instance (``"split"``: the cache split across blocks, the parts
merged by a second kernel in the same call) for at most 32 query rows
per kv head (Sq * G <= 32: every decode tick); the tensor-core prefill
instance (``"wgmma"``: TMA ring, wgmma for Q K^T and P V) for the rest in
bfloat16 with Dh 64 or 128 and 16-byte aligned q, k and v; the SIMT
instance (``"simt"``) for everything else: float32 prefill (FP32 FMAs;
TF32 would miss the 2e-5 tolerance) and Dh = 32.  `split_plan` sizes the
decode split from shapes.  `launch_counts["flash_attention"]` counts
every call; `route_counts` counts each instance.

Gradients: when grad is enabled and q, k or v requires grad, a CUDA
call goes through `FlashAttentionFn`, whose forward is the same routed
launch asked also for each row's log-sum-exp (`flash_attention_forward`:
every instance writes it, float32 (B, Sq, Hq), +inf for a row that sees
no key; serving calls ask for none and write nothing more), saved beside
the output; its backward launches `flash_attention_bwd.cu`
(`flash_attention_backward`, which takes that lse): D = dO . O, then
dk/dv and dq from q, k, v, dO, lse and D, nothing recomputed of the
statistics.  `bwd_route` picks the backward's instance like `route`:
``"wgmma"`` (bfloat16, Dh 64 or 128, 16-byte aligned: S^T, dP^T, dV, dK
and S, dP, dQ as wgmma products on TMA rings, P and dS rounded to
bfloat16 before their products) or ``"simt"`` (float32 -- TF32 would miss
the 1e-4 gate -- and Dh 32: f32 FMAs).  `launch_counts
["flash_attention_bwd"]` counts each backward call, `bwd_route_counts`
each instance.  On CPU tensors `flash_attention` runs
`ref.attention_reference`, which autograd differentiates, and
`FlashAttentionFn` and `flash_attention_backward` run the plain forward
with its lse and `ref.attention_backward_reference`.

The CUDA sources are built at first use by `repro_torch.kernels.build`
(nvcc into ``build/repro_torch/``, bound with ctypes, no PyTorch
headers), each into a library of its own.

While the dry-run records (`kernels.sites.recorder`, `launch.dryrun`),
each wrapper hands its call to the recorder before it looks at the
device: nothing is built, launched or counted.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.kernels import sites
from repro_torch.kernels.build import build_library, launch_counts
from repro_torch.kernels.flash_attention.ref import (
    NEG_INF, attention_backward_reference, attention_reference,
)

_BWD_INSTANCES = {"simt": 0, "wgmma": 1}

SOURCE = Path(__file__).with_name("flash_attention.cu")
BWD_SOURCE = Path(__file__).with_name("flash_attention_bwd.cu")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INSTANCES = {"simt": 0, "split": 1, "wgmma": 2}
_HEAD_DIMS = (32, 64, 128)
_MAX_GROUP = 32                 # query heads per kv head (rows per block)
_MAX_GRID_YZ = 65535
#: query rows per kv head (Sq * G) up to which a call takes the decode
#: instance; its blocks hold 8 warps of 4 rows, each warp taking slices of
#: SPLIT_SLICE keys (one a lane)
SPLIT_ROWS, SPLIT_WARPS, SPLIT_WARP_ROWS, SPLIT_SLICE = 32, 8, 4, 32
#: blocks the decode split aims for: two for each of the H100's 132 SMs
SPLIT_TARGET_BLOCKS = 2 * 132
#: keys per KV tile of the tensor-core instance, and the most tiles its
#: live-tile marks hold (Skv up to 262,144)
WGMMA_TILE, WGMMA_MAX_TILES = 128, 2048
#: launches by instance since the count was last reset; only the CUDA
#: branch of `flash_attention` adds to it, once per call, beside
#: launch_counts["flash_attention"]
route_counts = {"wgmma": 0, "split": 0, "simt": 0}
#: the backward's launches by instance, beside
#: launch_counts["flash_attention_bwd"]
bwd_route_counts = {"wgmma": 0, "simt": 0}
_lib: ctypes.CDLL | None = None
#: the opt-in dynamic shared-memory limit of each device set up so far
_max_smem: dict[int, int] = {}
#: nvcc's output (ptxas register and shared-memory report) of the build
#: this process loaded, or None before the first build.
build_log: str | None = None
#: the backward's library, the devices it is set up on, and its build's
#: nvcc output
_bwd_lib: ctypes.CDLL | None = None
_bwd_devices: set[int] = set()
bwd_build_log: str | None = None


def build() -> Path:
    """Compile `flash_attention.cu` unless this source and these flags
    were built before; returns the shared library's path."""
    global build_log
    out, log = build_library(SOURCE, NVCC_FLAGS)
    if log is not None:
        build_log = log
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_launch.argtypes = [
            i, i, i, i, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i, i,
            f, f, i, i, vp]
        lib.flash_attention_launch.restype = i
        lib.flash_attention_smem.argtypes = [i, i, i]
        lib.flash_attention_smem.restype = i
        lib.flash_attention_wgmma_smem.argtypes = [i, i]
        lib.flash_attention_wgmma_smem.restype = i
        lib.flash_attention_init.argtypes = [i]
        lib.flash_attention_init.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_backward() -> Path:
    """Compile `flash_attention_bwd.cu` unless this source and these
    flags were built before; returns the shared library's path."""
    global bwd_build_log
    out, log = build_library(BWD_SOURCE, NVCC_FLAGS)
    if log is not None:
        bwd_build_log = log
    return out


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = ctypes.CDLL(str(build_backward()))
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_attention_bwd_launch.argtypes = [
            i, i, i, i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i,
            i, i, i, i, i, f, f, vp]
        lib.flash_attention_bwd_launch.restype = i
        lib.flash_attention_bwd_init.argtypes = [i]
        lib.flash_attention_bwd_init.restype = i
        lib.flash_attention_bwd_error_string.argtypes = [i]
        lib.flash_attention_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _device_smem(lib: ctypes.CDLL, index: int) -> int:
    """The device's opt-in shared-memory limit; the first call per device
    also lets the kernel use all of it."""
    if index not in _max_smem:
        got = lib.flash_attention_init(index)
        if got < 0:
            raise RuntimeError("flash_attention kernel set-up failed: "
                               + lib.flash_attention_error_string(-got)
                               .decode())
        _max_smem[index] = got
    return _max_smem[index]


class SplitPlan(NamedTuple):
    """How the decode instance cuts the cache: ``n_splits`` ranges of
    ``keys_per_split`` slots (the last one shorter), one block each; the
    block's ``warps`` warps a row group take every ``warps``-th slice of
    `SPLIT_SLICE` keys of its range, and the block writes one part per
    query row."""
    n_splits: int
    keys_per_split: int
    warps: int


def split_plan(B: int, Sq: int, Skv: int, Hkv: int, G: int) -> SplitPlan:
    """The decode split for these shapes, from shapes alone: splits of a
    whole number of the block's KV tiles (a slice a warp), at least one,
    none empty, and enough of them that B * Hkv * n_splits reaches
    `SPLIT_TARGET_BLOCKS` (or one tile each)."""
    rows = Sq * G
    if not 0 < rows <= SPLIT_ROWS:
        raise ValueError(f"split_plan: {rows} query rows per kv head, the "
                         f"decode instance takes 1 to {SPLIT_ROWS}")
    warps = SPLIT_WARPS // -(-rows // SPLIT_WARP_ROWS)
    tile = SPLIT_SLICE * warps
    n_tiles = -(-Skv // tile)
    want = -(-SPLIT_TARGET_BLOCKS // (B * Hkv))
    per = max(1, n_tiles // want)
    return SplitPlan(-(-n_tiles // per), per * tile, warps)


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The instance a CUDA launch takes, from dtype, shape and alignment
    alone: ``"split"`` for at most 32 query rows per kv head (decode),
    ``"wgmma"`` for bfloat16 with Dh 64 or 128, 16-byte aligned q, k and
    v and at most `WGMMA_MAX_TILES` KV tiles, ``"simt"`` otherwise."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hkv > 0 and Hq % Hkv == 0 and 0 < Sq * (Hq // Hkv) <= SPLIT_ROWS:
        return "split"
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16 and Dh in (64, 128)
            and -(-Skv // WGMMA_TILE) <= WGMMA_MAX_TILES
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return "wgmma"
    return "simt"


#: the most packed query tiles (ceil(Sq / floor(64 / G))) and 64-key
#: tiles the backward's tensor-core instance marks in shared memory
BWD_MAX_QUERY_TILES, BWD_MAX_KEY_TILES = 8192, 4096


def bwd_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The instance a CUDA backward takes, from dtype, shape and
    alignment alone, as `route` decides the forward's: ``"wgmma"`` for
    bfloat16 with Dh 64 or 128, 16-byte aligned q, k and v, and at most
    `BWD_MAX_QUERY_TILES` packed query tiles and `BWD_MAX_KEY_TILES` key
    tiles; ``"simt"`` otherwise (float32, Dh 32).  There is no decode
    split: a backward runs over whole sequences."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv if Hkv > 0 and Hq % Hkv == 0 else 0
    if (q.dtype == k.dtype == v.dtype == torch.bfloat16 and Dh in (64, 128)
            and 0 < G <= _MAX_GROUP
            and -(-Sq // (64 // G)) <= BWD_MAX_QUERY_TILES
            and -(-Skv // 64) <= BWD_MAX_KEY_TILES
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        return "wgmma"
    return "simt"


def wgmma_smem_bytes(dh: int, warpgroups: int) -> int:
    """Dynamic shared memory of one tensor-core block with ``warpgroups``
    consumer warpgroups (1 or 2) at head dim ``dh`` (builds the kernel if
    need be)."""
    return _library().flash_attention_wgmma_smem(dh, warpgroups)


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if t is None:
        raise TypeError(f"flash_attention: {name} is required, got None")
    if t.dtype != dtype:
        raise TypeError(f"flash_attention: {name} must be {dtype}, "
                        f"got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"flash_attention: {name} must have shape "
                         f"{tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"flash_attention: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"flash_attention: {name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"flash_attention: {name} must be 16-byte aligned")


def _check_call(name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, window, softcap):
    """The checks both wrappers make of shapes and options; returns the
    kernels' dtype code."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: float32 or bfloat16 only, got {q.dtype}")
    if Dh not in _HEAD_DIMS:
        raise ValueError(f"{name}: head dim must be one of {_HEAD_DIMS}, "
                         f"got {Dh}")
    if Hkv <= 0 or Hq % Hkv or Hq // Hkv > _MAX_GROUP:
        raise ValueError(f"{name}: Hq={Hq} must be a multiple of Hkv={Hkv} "
                         f"with at most {_MAX_GROUP} per group")
    if min(B, Sq, Skv) <= 0:
        raise ValueError(f"{name}: empty shapes B={B} Sq={Sq} Skv={Skv}")
    if max(B, Hkv) > _MAX_GRID_YZ:
        raise ValueError(f"{name}: B={B} and Hkv={Hkv} must be at most "
                         f"{_MAX_GRID_YZ} (the grid's y and z axes)")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"{name}: softcap must be positive, got {softcap}")
    return _DTYPES[q.dtype]


class FlashAttentionFn(torch.autograd.Function):
    """`flash_attention` with a gradient: the forward is the routed
    kernel asked for its log-sum-exp (`flash_attention_forward`; the
    plain version on CPU tensors), and it saves q, k, v, the output, the
    lse and the positions; the backward is `flash_attention_backward`
    (the backward kernel, or its plain version on CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, softcap,
                scale):
        out, lse = flash_attention_forward(q, k, v, q_pos, kv_pos,
                                           causal=causal, window=window,
                                           softcap=softcap, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, kv_pos)
        ctx.options = dict(causal=causal, window=window, softcap=softcap,
                           scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, kv_pos = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, lse, q_pos,
                                              kv_pos, **ctx.options)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> torch.Tensor:
    """Position-masked GQA attention (see ref.py for the semantics);
    returns (B, Sq, Hq, Dh) in q's dtype.  A CUDA call that autograd
    records (grad enabled, q, k or v requiring grad) goes through
    `FlashAttentionFn`."""
    if sites.recorder is not None:
        return sites.recorder.flash_attention(
            q, k, v, q_pos, kv_pos, causal=causal, window=window,
            softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, q_pos, kv_pos, causal=causal,
                                   window=window, softcap=softcap,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, q_pos, kv_pos, causal, window,
                                      softcap, scale)
    return _forward(q, k, v, q_pos, kv_pos, causal, window, softcap, scale,
                    with_lse=False)[0]


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The forward as training runs it: `flash_attention`'s output and
    each row's log-sum-exp of its valid logits, float32 (B, Sq, Hq), +inf
    for a row that sees no key (`ref.attention_reference` with
    ``return_lse``).  On CUDA tensors the routed instance writes both in
    one launch, counted like `flash_attention`'s; autograd does not
    record it (`FlashAttentionFn` does)."""
    if sites.recorder is not None:
        return sites.recorder.flash_attention_forward(
            q, k, v, q_pos, kv_pos, causal=causal, window=window,
            softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, q_pos, kv_pos, causal=causal,
                                   window=window, softcap=softcap,
                                   scale=scale, return_lse=True)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    return _forward(q, k, v, q_pos, kv_pos, causal, window, softcap, scale,
                    with_lse=True)


def _forward(q, k, v, q_pos, kv_pos, causal, window, softcap, scale, *,
             with_lse):
    """The routed launch of `flash_attention.cu` on CUDA tensors: the
    output, and with ``with_lse`` the rows' log-sum-exp (else None)."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev, dt = q.device, q.dtype
    dtype_code = _check_call("flash_attention", q, k, v, window, softcap)
    _check("q", q, dt, (B, Sq, Hq, Dh), dev)
    _check("k", k, dt, (B, Skv, Hkv, Dh), dev)
    _check("v", v, dt, (B, Skv, Hkv, Dh), dev)
    _check("q_pos", q_pos, torch.int32, (B, Sq), dev)
    _check("kv_pos", kv_pos, torch.int32, (B, Skv), dev)
    lib = _library()
    instance = route(q, k, v)
    need = (wgmma_smem_bytes(Dh, 2) if instance == "wgmma"
            else lib.flash_attention_smem(Dh, Hq // Hkv, Sq)
            if instance == "simt" else 0)
    if need > _device_smem(lib, dev.index):
        raise ValueError(f"flash_attention: needs {need} B of shared "
                         f"memory, the device allows "
                         f"{_max_smem[dev.index]}")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Sq, Hq), dtype=torch.float32, device=dev)
           if with_lse else None)
    n_splits = keys_per_split = 0
    ws = None
    if instance == "split":
        # each part's (acc, m, l) for its rows; made per call (nothing
        # outlives the call), from the graph's pool under a CUDA graph
        plan = split_plan(B, Sq, Skv, Hkv, Hq // Hkv)
        n_splits, keys_per_split = plan.n_splits, plan.keys_per_split
        ws = torch.empty(B * Hkv * n_splits * Sq * (Hq // Hkv) * (Dh + 2),
                         dtype=torch.float32, device=dev)
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    err = lib.flash_attention_launch(
        dev.index, _INSTANCES[instance], dtype_code, Dh, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Sq, Skv, Hq, Hkv,
        int(causal), window or 0, float(scale),
        float(softcap or 0.0), n_splits, keys_per_split,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"({instance}): "
                           + lib.flash_attention_error_string(err).decode())
    launch_counts["flash_attention"] += 1
    route_counts[instance] += 1
    return out, lse


def flash_attention_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of `flash_attention` at its output
    ``out`` for the output gradient ``dout``, given the forward's
    log-sum-exp ``lse`` (`flash_attention_forward`; see
    `ref.attention_backward_reference`), in q's and k's dtypes.  On CUDA
    tensors it checks them as the forward does (``dout`` is made
    contiguous first: autograd often hands over a view; ``lse`` float32
    (B, Sq, Hq) on q's device) and launches the instance `bwd_route`
    names on the current stream, or raises; on CPU tensors, and only
    there, it runs the plain version."""
    if sites.recorder is not None:
        return sites.recorder.flash_attention_backward(
            q, k, v, out, dout, lse, q_pos, kv_pos, causal=causal,
            window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return attention_backward_reference(
            q, k, v, out, dout, lse, q_pos, kv_pos, causal=causal,
            window=window, softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_backward: no kernel for device "
                         f"{q.device}")
    return _backward(bwd_route(q, k, v), q, k, v, out, dout, lse, q_pos,
                     kv_pos, causal, window, softcap, scale)


def _backward_instance(
    instance: str,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    softcap: float | None = None,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`flash_attention_backward` on CUDA tensors through ``instance``
    (``"wgmma"`` or ``"simt"``) rather than the one `bwd_route` picks, to
    time and test one instance against the other (the port itself calls
    `flash_attention_backward`): the SIMT instance takes every call the
    backward takes, the tensor-core one only what `bwd_route` sends it.
    Counted like the backward's launches."""
    if instance not in bwd_route_counts:
        raise ValueError(f"flash_attention_backward: no instance "
                         f"{instance!r}")
    if instance == "wgmma" and bwd_route(q, k, v) != "wgmma":
        raise ValueError("flash_attention_backward: the wgmma instance does "
                         "not take this call")
    return _backward(instance, q, k, v, out, dout, lse, q_pos, kv_pos,
                     causal, window, softcap, scale)


def _backward(instance, q, k, v, out, dout, lse, q_pos, kv_pos, causal,
              window, softcap, scale):
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    dev, dt = q.device, q.dtype
    dtype_code = _check_call("flash_attention_backward", q, k, v, window,
                             softcap)
    if Hq > _MAX_GRID_YZ:
        raise ValueError(f"flash_attention_backward: Hq={Hq} must be at most "
                         f"{_MAX_GRID_YZ} (the grid's y axis)")
    dout = dout.contiguous()
    for name, t, shape in (("q", q, (B, Sq, Hq, Dh)),
                           ("k", k, (B, Skv, Hkv, Dh)),
                           ("v", v, (B, Skv, Hkv, Dh)),
                           ("out", out, (B, Sq, Hq, Dh)),
                           ("dout", dout, (B, Sq, Hq, Dh))):
        _check(name, t, dt, shape, dev)
    _check("lse", lse, torch.float32, (B, Sq, Hq), dev)
    _check("q_pos", q_pos, torch.int32, (B, Sq), dev)
    _check("kv_pos", kv_pos, torch.int32, (B, Skv), dev)
    lib = _bwd_library()
    if dev.index not in _bwd_devices:
        got = lib.flash_attention_bwd_init(dev.index)
        if got < 0:
            raise RuntimeError(
                "flash_attention_backward kernel set-up failed: "
                + lib.flash_attention_bwd_error_string(-got).decode())
        _bwd_devices.add(dev.index)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    # D = dO . O per row and head; made per call (nothing outlives it)
    dsum = torch.empty((B, Sq, Hq), dtype=torch.float32, device=dev)
    if scale is None:
        scale = 1.0 / (Dh ** 0.5)
    err = lib.flash_attention_bwd_launch(
        dev.index, _BWD_INSTANCES[instance], dtype_code, Dh, q.data_ptr(),
        k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), q_pos.data_ptr(), kv_pos.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), B, Sq, Skv, Hq, Hkv,
        int(causal), window or 0, float(scale), float(softcap or 0.0),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_backward kernel launch failed "
                           f"({instance}): "
                           + lib.flash_attention_bwd_error_string(err)
                           .decode())
    launch_counts["flash_attention_bwd"] += 1
    bwd_route_counts[instance] += 1
    return dq, dk, dv


__all__ = ["flash_attention", "flash_attention_forward",
           "flash_attention_backward", "FlashAttentionFn",
           "attention_reference", "attention_backward_reference", "NEG_INF",
           "build", "build_backward", "bwd_route", "bwd_route_counts",
           "launch_counts", "route", "route_counts", "split_plan",
           "SplitPlan", "wgmma_smem_bytes"]
