"""Chunked SSD (state-space duality), the Mamba2 scan: the Hopper kernel
for CUDA tensors, the plain PyTorch version for CPU tensors.

Block decomposition over chunks of length Q (Dao & Gu, arXiv:2405.21060
§6), as in the JAX package's ``repro/kernels/ssd/ops.py``:

  within-chunk (quadratic):
      L[i,j]   = exp(cumA_i - cumA_j) * dt_j          (j <= i, else 0)
      scores   = (C_i . B_j) * L[i,j]
      Y_intra  = scores @ X
  chunk state contribution:
      S_c      = sum_j exp(cumA_Q - cumA_j) * dt_j * X_j (outer) B_j
  inter-chunk recurrence (linear scan over n_chunks):
      state_c  = exp(cumA_Q) * state_{c-1} + S_c
      Y_inter[i] = exp(cumA_i) * (C_i @ state_{c-1})

`ssd` keeps the JAX signature and layouts.  On a CUDA tensor it checks
dtype, shape, strides and device, then launches one of the two instances
of `ssd.cu` on the current stream, or raises; on a CPU tensor, and only
there, it runs `ssd_chunked`, the plain version, which mirrors
``ssd_chunked_jnp``.  `ssd_decode_step`, the one-token update, is plain
PyTorch on every device, as the JAX package computes it outside any
kernel.

`route` picks the instance from dtype, shape and alignment alone: the
tensor-core instance (``"mma"``: chunk-parallel passes on ``mma.sync``,
the scores C B^T formed once per group, whose plain-PyTorch mirror is
`ref.ssd_passes`) for
bfloat16 with head dim and d_state 64 or 128, a chunk that is a multiple
of 64, and x, B and C 16-byte aligned with strides a multiple of 8
elements; the SIMT instance (``"simt"``: one block a head, scalar FP32
FMAs) for the rest: float32 (TF32 or bf16 operands would not keep its
2e-3 gate) and the small shapes.  `launch_counts["ssd"]` counts every
call, whatever the number of passes; `route_counts` counts each
instance.

Gradients: a CUDA call that autograd records (grad enabled, any input
requiring grad) goes through `SSDFn`, whose forward is the routed launch
asked to keep the state entering each chunk (`ssd_forward`: float32
from the SIMT instance, bf16 hi + lo planes from the tensor-core
one, written in the same kernels), and whose backward launches
`ssd_bwd.cu` (`ssd_backward`): the chunk-parallel U_c = sum exp(cum)
dy^T C, the reverse walk over the chunks for the state's gradient, the
key-side (dx, dB, ddt) and query-side (dC, dcum) tile passes (on the
tensor-core instance after C B^T formed once per group, and on
``wgmma`` with TMA-staged tiles), then fixed-order reductions (da, then
ddt and dA; dB and dC over heads; dD), seven kernels on one stream
(eight on the tensor cores), no atomics.  The backward recomputes cum
itself (a scan of dt A per chunk), so the forward keeps only the
entering states.
`bwd_route` names the backward's instance as `route` names the
forward's: the tensor-core backward reads the tensor-core forward's
states.  `launch_counts["ssd_bwd"]` counts each backward call,
`bwd_route_counts` each instance.  On CPU tensors `ssd` runs
`ssd_chunked`, which autograd differentiates, and `SSDFn` and
`ssd_backward` run `ssd_chunked` and `ref.ssd_backward_reference`.

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

import torch
import torch.nn.functional as F

from repro_torch.kernels import sites
from repro_torch.kernels.build import build_library, launch_counts
from repro_torch.kernels.ssd.ref import (
    acc_dtype, expand_groups, ssd_backward_reference, ssd_reference,
)

SOURCE = Path(__file__).with_name("ssd.cu")
BWD_SOURCE = Path(__file__).with_name("ssd_bwd.cu")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128)
_MAX_STATE = 128                # d_state, a multiple of 16
_MAX_CHUNK = 256
_MAX_GRID_Y = 65535
#: head dims and d_states the tensor-core instance takes; its tiles are
#: MMA_TILE rows (query, key, step or head-dim rows)
MMA_HEAD_DIMS = MMA_STATES = (64, 128)
MMA_TILE = 64
#: launches by instance since the count was last reset; only the CUDA
#: branch adds to it, once per call (all four kernels of "mma" are one),
#: beside launch_counts["ssd"]
route_counts = {"mma": 0, "simt": 0}
#: the backward's launches by instance, beside launch_counts["ssd_bwd"]
bwd_route_counts = {"mma": 0, "simt": 0}
_BWD_INSTANCES = {"simt": 0, "mma": 1}
_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None
#: the opt-in dynamic shared-memory limit of each device set up so far,
#: by the forward's and the backward's library
_max_smem: dict[int, int] = {}
_bwd_max_smem: dict[int, int] = {}
#: nvcc's output (ptxas register and shared-memory report) of the build
#: this process loaded, or None before the first build.
build_log: str | None = None
bwd_build_log: str | None = None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def ssd_chunked(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 256,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,H,P), final_state (B,H,P,N)).  Sequences that are
    not a multiple of the chunk are zero-padded at the tail: pad steps
    have dt = 0, so decay = exp(0) = 1 and contribution = 0 -- the state
    passes through unchanged and padded outputs are sliced off.  Sums in
    float32 (float64 for float64 inputs)."""
    Bsz, S_orig, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S_orig)
    if S_orig % Q != 0:
        pad = Q - S_orig % Q
        x, dt, Bm, Cm = (F.pad(t, [0, 0] * (t.dim() - 2) + [0, pad])
                         for t in (x, dt, Bm, Cm))
    S = x.shape[1]
    nc = S // Q
    f = acc_dtype(x)

    xf = x.to(f).reshape(Bsz, nc, Q, H, P)
    dtf = dt.to(f).reshape(Bsz, nc, Q, H)
    Bh = expand_groups(Bm.to(f), H, 2).reshape(Bsz, nc, Q, H, N)
    Ch = expand_groups(Cm.to(f), H, 2).reshape(Bsz, nc, Q, H, N)
    Af, Df = A.to(f), D.to(f)

    dA = dtf * Af                       # (B,nc,Q,H) log-decay per step
    cumA = torch.cumsum(dA, dim=2)      # inclusive cumsum within chunk
    totA = cumA[:, :, -1, :]            # (B,nc,H)

    # ---- within-chunk quadratic term -----------------------------------
    ci = cumA[:, :, :, None, :]         # (B,nc,Q,1,H)
    cj = cumA[:, :, None, :, :]         # (B,nc,1,Q,H)
    li = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                               device=x.device))[None, None, :, :, None]
    # exp only on pairs j <= i: the others may overflow, and autograd's
    # 0 x inf through the outer select would make their gradient NaN
    decay = torch.where(li, torch.exp(torch.where(li, ci - cj, 0.0)),
                        0.0)                            # (B,nc,Q,Q,H)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * decay
    scores = scores * dtf[:, :, None, :, :]            # multiply dt_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xf)

    # ---- chunk state contributions -------------------------------------
    w = torch.exp(totA[:, :, None, :] - cumA) * dtf    # (B,nc,Q,H)
    s_contrib = torch.einsum("bcjh,bcjhp,bcjhn->bchpn", w, xf, Bh)

    # ---- inter-chunk linear recurrence ---------------------------------
    if initial_state is None:
        state = torch.zeros((Bsz, H, P, N), dtype=f, device=x.device)
    else:
        state = initial_state.to(f)
    prev = []
    for c in range(nc):
        prev.append(state)
        state = torch.exp(totA[:, c])[:, :, None, None] * state \
            + s_contrib[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B,nc,H,P,N) entering chunk

    # ---- inter-chunk output term ---------------------------------------
    y_inter = torch.einsum("bcihn,bchpn->bcihp",
                           Ch * torch.exp(cumA)[..., None], prev_states)

    y = y_intra + y_inter + Df[None, None, None, :, None] * xf
    y = y.reshape(Bsz, S, H, P)[:, :S_orig].to(x.dtype)
    return y, state


def ssd_decode_step(
    state: torch.Tensor,  # (B,H,P,N) float32
    x_t: torch.Tensor,    # (B,H,P)
    dt_t: torch.Tensor,   # (B,H)
    A: torch.Tensor,      # (H,)
    B_t: torch.Tensor,    # (B,G,N)
    C_t: torch.Tensor,    # (B,G,N)
    D: torch.Tensor,      # (H,)
    *,
    out: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token state update; O(H*P*N) per token, O(1) in context.
    With ``out`` (which may be ``state`` itself) the new state is written
    there in place instead of into a new tensor."""
    H = state.shape[1]
    Bh = expand_groups(B_t.float(), H, 1)              # (B,H,N)
    Ch = expand_groups(C_t.float(), H, 1)
    xf, dtf = x_t.float(), dt_t.float()
    decay = torch.exp(dtf * A.float())[:, :, None, None]
    delta = (dtf[:, :, None] * xf)[..., None] * Bh[:, :, None, :]
    new_state = torch.mul(state, decay, out=out)
    new_state += delta
    y = torch.einsum("bhpn,bhn->bhp", new_state, Ch)
    y = y + D.float()[None, :, None] * xf
    return new_state, y.to(x_t.dtype)


# ---------------------------------------------------------------------------
# the Hopper kernel
# ---------------------------------------------------------------------------

def build() -> Path:
    """Compile `ssd.cu` unless this source and these flags were built
    before; returns the shared library's path."""
    global build_log
    out, log = build_library(SOURCE, NVCC_FLAGS)
    if log is not None:
        build_log = log
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_launch.argtypes = [
            i, i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, i,
            i, ll, ll, ll, ll, ll, ll, ll, ll, ll, vp]
        lib.ssd_launch.restype = i
        lib.ssd_mma_launch.argtypes = [
            i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i,
            i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, ll, vp]
        lib.ssd_mma_launch.restype = i
        lib.ssd_mma_smem.argtypes = [i, i]
        lib.ssd_mma_smem.restype = i
        lib.ssd_smem.argtypes = [i, i]
        lib.ssd_smem.restype = i
        lib.ssd_init.argtypes = [i]
        lib.ssd_init.restype = i
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_backward() -> Path:
    """Compile `ssd_bwd.cu` unless this source and these flags were built
    before; returns the shared library's path."""
    global bwd_build_log
    out, log = build_library(BWD_SOURCE, NVCC_FLAGS)
    if log is not None:
        bwd_build_log = log
    return out


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = ctypes.CDLL(str(build_backward()))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_bwd_launch.argtypes = [
            i, i, i, vp, vp, vp, vp, vp, vp, vp, vp, i, i, vp, vp, vp, vp,
            vp, vp, vp, vp, vp, i, i, i, i, i, i, i, ll, ll, ll, ll, ll, ll,
            ll, ll, ll, vp]
        lib.ssd_bwd_launch.restype = i
        lib.ssd_bwd_workspace.argtypes = [i, i, i, i, i, i, i]
        lib.ssd_bwd_workspace.restype = ll
        lib.ssd_bwd_smem.argtypes = [i, i, i]
        lib.ssd_bwd_smem.restype = i
        lib.ssd_bwd_init.argtypes = [i]
        lib.ssd_bwd_init.restype = i
        lib.ssd_bwd_error_string.argtypes = [i]
        lib.ssd_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def _device_smem(lib: ctypes.CDLL, index: int) -> int:
    """The device's opt-in shared-memory limit; the first call per device
    also lets the kernel use all of it."""
    if index not in _max_smem:
        got = lib.ssd_init(index)
        if got < 0:
            raise RuntimeError("ssd kernel set-up failed: "
                               + lib.ssd_error_string(-got).decode())
        _max_smem[index] = got
    return _max_smem[index]


def _check(name: str, t: torch.Tensor, dtype, shape, device, *,
           rows: bool = False):
    """dtype, shape and device; contiguous, or with ``rows`` only the last
    axis (the kernel takes the strides of the others)."""
    if t.dtype != dtype:
        raise TypeError(f"ssd: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"ssd: {name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"ssd: {name} is on {t.device}, expected {device}")
    if rows:
        if t.stride(-1) != 1:
            raise ValueError(f"ssd: {name} must be contiguous in its last "
                             f"axis")
    elif not t.is_contiguous():
        raise ValueError(f"ssd: {name} must be contiguous")


def route(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
          chunk: int) -> str:
    """The instance a CUDA launch takes, from dtype, shape and alignment
    alone: ``"mma"`` for bfloat16 x, B and C with head dim and d_state in
    `MMA_HEAD_DIMS` / `MMA_STATES`, a chunk that is a multiple of
    `MMA_TILE`, each of x, B and C 16-byte aligned with its batch, step
    and head (group) strides a multiple of 8 elements, and the grid's
    B * H and chunk count at most 65,535; ``"simt"`` otherwise."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    n_chunks = -(-S // min(chunk, S)) if chunk > 0 and S > 0 else 0
    if (x.dtype == Bm.dtype == Cm.dtype == torch.bfloat16
            and P in MMA_HEAD_DIMS and N in MMA_STATES
            and chunk > 0 and chunk % MMA_TILE == 0
            and Bsz * H <= _MAX_GRID_Y and n_chunks <= _MAX_GRID_Y
            and all(t.data_ptr() % 16 == 0
                    and all(st % 8 == 0 for st in t.stride()[:3])
                    for t in (x, Bm, Cm))):
        return "mma"
    return "simt"


def bwd_route(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
              chunk: int) -> str:
    """The backward's instance: the forward's (`route`, from dtype, shape
    and alignment alone), since the tensor-core backward reads the
    entering states the tensor-core forward keeps (bf16 hi + lo) and the
    SIMT one those of either."""
    return route(x, Bm, Cm, chunk)


def mma_smem_bytes(P: int, N: int) -> int:
    """The most dynamic shared memory a block of the tensor-core instance
    needs at head dim P and d_state N (builds the kernel if need be)."""
    return _library().ssd_mma_smem(P, N)


def _checked(x, dt, A, Bm, Cm, D, chunk, initial_state):
    """Raises on what neither instance takes (dtype, shape, strides,
    device, sizes); returns B, S, H, P, G, N."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd: no kernel for device {x.device}")
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    dev, dtype = x.device, x.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"ssd: float32 or bfloat16 only, got {dtype}")
    if P not in _HEAD_DIMS:
        raise ValueError(f"ssd: head dim must be one of {_HEAD_DIMS}, "
                         f"got {P}")
    if N <= 0 or N % 16 or N > _MAX_STATE:
        raise ValueError(f"ssd: d_state must be a multiple of 16 up to "
                         f"{_MAX_STATE}, got {N}")
    if G <= 0 or H % G:
        raise ValueError(f"ssd: H={H} heads must split evenly over "
                         f"G={G} groups")
    if min(Bsz, S, H) <= 0:
        raise ValueError(f"ssd: empty shapes B={Bsz} S={S} H={H}")
    if not 0 < chunk <= _MAX_CHUNK:
        raise ValueError(f"ssd: chunk must be in 1..{_MAX_CHUNK}, "
                         f"got {chunk}")
    if Bsz > _MAX_GRID_Y:
        raise ValueError(f"ssd: B={Bsz} must be at most {_MAX_GRID_Y} "
                         f"(the grid's y axis)")
    _check("x", x, dtype, (Bsz, S, H, P), dev, rows=True)
    _check("dt", dt, torch.float32, (Bsz, S, H), dev)
    _check("A", A, torch.float32, (H,), dev)
    _check("Bm", Bm, dtype, (Bsz, S, G, N), dev, rows=True)
    _check("Cm", Cm, dtype, (Bsz, S, G, N), dev, rows=True)
    _check("D", D, torch.float32, (H,), dev)
    if initial_state is not None:
        _check("initial_state", initial_state, torch.float32,
               (Bsz, H, P, N), dev)
    return Bsz, S, H, P, G, N


def _ssd_instance(
    instance: str,
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 256,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """`ssd` on CUDA tensors through ``instance`` (``"mma"`` or
    ``"simt"``) rather than the one `route` picks, to time and test one
    instance against the other (the port itself calls `ssd`): the SIMT
    instance takes every call `ssd` takes, the tensor-core one only what
    `route` sends it.  Counted like `ssd`'s launches."""
    dims = _checked(x, dt, A, Bm, Cm, D, chunk, initial_state)
    if instance not in route_counts:
        raise ValueError(f"ssd: no instance {instance!r}")
    if instance == "mma" and route(x, Bm, Cm, chunk) != "mma":
        raise ValueError("ssd: the mma instance does not take this call")
    return _launch(instance, dims, x, dt, A, Bm, Cm, D, chunk,
                   initial_state)[:2]


def _launch(instance, dims, x, dt, A, Bm, Cm, D, chunk, initial_state,
            keep=False):
    """Launches ``instance``; returns (y, final state, the entering
    states kept for the backward or None)."""
    Bsz, S, H, P, G, N = dims
    dev, dtype = x.device, x.dtype
    lib = _library()
    need = (lib.ssd_mma_smem(P, N) if instance == "mma"
            else lib.ssd_smem(P, N))
    if need > _device_smem(lib, dev.index):
        raise ValueError(f"ssd: needs {need} B of shared memory, the device "
                         f"allows {_max_smem[dev.index]}")
    Q = min(chunk, S)
    y = torch.empty((Bsz, S, H, P), dtype=dtype, device=dev)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    init = None if initial_state is None else initial_state.data_ptr()
    strides = (*x.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_chunks = -(-S // Q)
    if instance == "mma":
        # one workspace, made per call (nothing outlives the call; under a
        # CUDA graph, from the graph's pool): the chunk states (float32),
        # the entering states (bf16 hi and lo: as many bytes; a tensor of
        # their own when kept), the scores of each pair of 64-row tiles kt
        # <= qt of a chunk and group (float32) and cumA of each chunk
        # (float32, Q padded to whole tiles)
        n_tiles = -(-Q // MMA_TILE)
        states = Bsz * n_chunks * H * P * N
        scores = (Bsz * n_chunks * G * n_tiles * (n_tiles + 1) // 2
                  * MMA_TILE ** 2)
        kept = (torch.empty((Bsz, n_chunks, H, 2, P, N),
                            dtype=torch.bfloat16, device=dev)
                if keep else None)
        inside = 0 if keep else states
        ws = torch.empty(states + inside + scores
                         + Bsz * H * n_chunks * n_tiles * MMA_TILE,
                         dtype=torch.float32, device=dev)
        base = ws.data_ptr()
        at_scores = base + 4 * (states + inside)
        err = lib.ssd_mma_launch(
            dev.index, x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), init, y.data_ptr(),
            final.data_ptr(), at_scores + 4 * scores, base,
            kept.data_ptr() if keep else base + 4 * states, at_scores, Bsz,
            S, H, P, G, N, Q, *strides, stream)
    else:
        kept = (torch.empty((Bsz, n_chunks, H, P, N), dtype=torch.float32,
                            device=dev) if keep else None)
        err = lib.ssd_launch(
            dev.index, _DTYPES[dtype], x.data_ptr(), dt.data_ptr(),
            A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(), init,
            y.data_ptr(), final.data_ptr(),
            None if kept is None else kept.data_ptr(), Bsz, S, H, P, G, N,
            Q, *strides, stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed ({instance}): "
                           + lib.ssd_error_string(err).decode())
    launch_counts["ssd"] += 1
    route_counts[instance] += 1
    return y, final, kept


def ssd(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 256,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD (see the module docstring): y (B,S,H,P) in x's dtype
    and the final state (B,H,P,N) in float32.  x, Bm and Cm may be views
    whose last axis is contiguous (as `_split_xbc` makes them).  A CUDA
    call that autograd records goes through `SSDFn`."""
    if sites.recorder is not None:
        return sites.recorder.ssd(x, dt, A, Bm, Cm, D, chunk=chunk,
                                  initial_state=initial_state)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                           initial_state=initial_state)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, D, initial_state)):
        return SSDFn.apply(x, dt, A, Bm, Cm, D, initial_state, chunk)
    dims = _checked(x, dt, A, Bm, Cm, D, chunk, initial_state)
    return _launch(route(x, Bm, Cm, chunk), dims, x, dt, A, Bm, Cm, D,
                   chunk, initial_state)[:2]


def ssd_forward(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    *,
    chunk: int = 256,
    initial_state: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """`ssd`'s routed launch that also keeps what the backward reads:
    (y, final state, kept), kept the state entering each chunk (float32
    (B, nc, H, P, N) from the SIMT instance, bf16 hi and lo planes (B, nc,
    H, 2, P, N) from the tensor-core one; chunk 0's written only with an
    initial state).  On CPU tensors it runs `ssd_chunked` and keeps
    nothing (None)."""
    if sites.recorder is not None:
        return sites.recorder.ssd_forward(x, dt, A, Bm, Cm, D, chunk=chunk,
                                          initial_state=initial_state)
    if x.device.type == "cpu":
        return (*ssd_chunked(x, dt, A, Bm, Cm, D, chunk=chunk,
                             initial_state=initial_state), None)
    dims = _checked(x, dt, A, Bm, Cm, D, chunk, initial_state)
    return _launch(route(x, Bm, Cm, chunk), dims, x, dt, A, Bm, Cm, D,
                   chunk, initial_state, keep=True)


def ssd_backward(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    D: torch.Tensor,
    dy: torch.Tensor | None,
    *,
    chunk: int = 256,
    initial_state: torch.Tensor | None = None,
    dfinal: torch.Tensor | None = None,
    kept: torch.Tensor | None = None,
) -> tuple:
    """The gradients (dx, ddt, dA, dBm, dCm, dD, dinit) of `ssd` for the
    output gradient ``dy`` and the final state's ``dfinal`` (None: 0, no
    tensor made), each in its input's dtype, dinit None without an
    initial state.  On CUDA tensors it takes the forward's ``kept``
    entering states (`ssd_forward`), checks them as the forward checks
    its inputs (``dy`` and ``dfinal`` made contiguous first: autograd
    often hands over views) and launches the instance `bwd_route` names on
    the current stream, or raises; on CPU tensors, and only there, it runs
    `ref.ssd_backward_reference`."""
    if sites.recorder is not None:
        return sites.recorder.ssd_backward(
            x, dt, A, Bm, Cm, D, dy, chunk=chunk,
            initial_state=initial_state, dfinal=dfinal, kept=kept)
    if x.device.type == "cpu":
        return ssd_backward_reference(x, dt, A, Bm, Cm, D, initial_state,
                                      dy, dfinal, chunk)
    return _backward(bwd_route(x, Bm, Cm, chunk), x, dt, A, Bm, Cm, D, dy,
                     chunk, initial_state, dfinal, kept)


def _backward_instance(instance: str, x, dt, A, Bm, Cm, D, dy, *,
                       chunk=256, initial_state=None, dfinal=None,
                       kept=None) -> tuple:
    """`ssd_backward` on CUDA tensors through ``instance`` (``"mma"`` or
    ``"simt"``) rather than the one `bwd_route` picks, to time and test
    one instance against the other: the SIMT instance takes every call the
    backward takes (either format of kept states), the tensor-core one
    only what `bwd_route` sends it.  Counted like the backward's
    launches."""
    if instance not in bwd_route_counts:
        raise ValueError(f"ssd_backward: no instance {instance!r}")
    if instance == "mma" and bwd_route(x, Bm, Cm, chunk) != "mma":
        raise ValueError("ssd_backward: the mma instance does not take "
                         "this call")
    return _backward(instance, x, dt, A, Bm, Cm, D, dy, chunk,
                     initial_state, dfinal, kept)


def _backward(instance, x, dt, A, Bm, Cm, D, dy, chunk, initial_state,
              dfinal, kept):
    Bsz, S, H, P, G, N = _checked(x, dt, A, Bm, Cm, D, chunk, initial_state)
    dev, dtype = x.device, x.dtype
    Q = min(chunk, S)
    n_chunks = -(-S // Q)
    dy = torch.zeros_like(x) if dy is None else dy.contiguous()
    _check("dy", dy, dtype, (Bsz, S, H, P), dev)
    if dfinal is not None:
        dfinal = dfinal.contiguous()
        _check("dfinal", dfinal, torch.float32, (Bsz, H, P, N), dev)
    if kept is None:
        raise ValueError("ssd_backward: needs the forward's kept entering "
                         "states (ssd_forward)")
    enter_f32 = kept.dtype == torch.float32
    if enter_f32:
        _check("kept", kept, torch.float32, (Bsz, n_chunks, H, P, N), dev)
    else:
        _check("kept", kept, torch.bfloat16, (Bsz, n_chunks, H, 2, P, N),
               dev)
    if instance == "mma" and enter_f32:
        raise ValueError("ssd_backward: the mma instance reads the "
                         "tensor-core forward's bf16 hi + lo states")
    lib = _bwd_library()
    if dev.index not in _bwd_max_smem:
        got = lib.ssd_bwd_init(dev.index)
        if got < 0:
            raise RuntimeError("ssd_backward kernel set-up failed: "
                               + lib.ssd_bwd_error_string(-got).decode())
        _bwd_max_smem[dev.index] = got
    code = _BWD_INSTANCES[instance]
    need = lib.ssd_bwd_smem(code, P, N)
    if need > _bwd_max_smem[dev.index]:
        raise ValueError(f"ssd_backward: needs {need} B of shared memory, "
                         f"the device allows {_bwd_max_smem[dev.index]}")
    dx = torch.empty((Bsz, S, H, P), dtype=dtype, device=dev)
    ddt = torch.empty((Bsz, S, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dB = torch.empty((Bsz, S, G, N), dtype=dtype, device=dev)
    dC = torch.empty((Bsz, S, G, N), dtype=dtype, device=dev)
    dD = torch.empty((H,), dtype=torch.float32, device=dev)
    dinit = (None if initial_state is None
             else torch.empty_like(initial_state))
    # the passes' workspace, made per call (`Workspace` in ssd_bwd.cu)
    ws = torch.empty(lib.ssd_bwd_workspace(Bsz, S, H, G, P, N, Q),
                     dtype=torch.float32, device=dev)
    strides = (*x.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3])
    err = lib.ssd_bwd_launch(
        dev.index, code, _DTYPES[dtype], x.data_ptr(), dt.data_ptr(),
        A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), D.data_ptr(),
        dy.data_ptr(), kept.data_ptr(), int(enter_f32),
        int(initial_state is not None),
        None if dfinal is None else dfinal.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dD.data_ptr(), None if dinit is None else dinit.data_ptr(),
        ws.data_ptr(), Bsz, S, H, P, G, N, Q, *strides,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_backward kernel launch failed ({instance}): "
                           + lib.ssd_bwd_error_string(err).decode())
    launch_counts["ssd_bwd"] += 1
    bwd_route_counts[instance] += 1
    return dx, ddt, dA, dB, dC, dD, dinit


class SSDFn(torch.autograd.Function):
    """`ssd` with a gradient: the forward is the routed kernel asked to
    keep the entering states (`ssd_forward`; `ssd_chunked` on CPU
    tensors), and it saves x, dt, A, Bm, Cm, D, the initial state and
    the kept states; the backward is `ssd_backward` (the
    backward kernel, or `ref.ssd_backward_reference` on CPU tensors).  A
    final state nobody uses gives no gradient tensor."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, initial_state, chunk):
        y, final, kept = ssd_forward(x, dt, A, Bm, Cm, D, chunk=chunk,
                                     initial_state=initial_state)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, initial_state, kept)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, D, initial_state, kept = ctx.saved_tensors
        grads = ssd_backward(x, dt, A, Bm, Cm, D, dy, chunk=ctx.chunk,
                             initial_state=initial_state, dfinal=dfinal,
                             kept=kept)
        return (*(g if need else None
                  for g, need in zip(grads, ctx.needs_input_grad)), None)


__all__ = ["ssd", "ssd_chunked", "ssd_decode_step", "ssd_reference",
           "ssd_forward", "ssd_backward", "ssd_backward_reference", "SSDFn",
           "route", "route_counts", "bwd_route", "bwd_route_counts",
           "mma_smem_bytes", "build", "build_backward", "launch_counts"]
