"""The Mamba mixer's causal depthwise conv and its SiLU, silu(conv(x) +
b), as one Hopper kernel each way on CUDA tensors, the plain PyTorch
version (`ref.causal_conv_silu`) on CPU tensors.

`causal_conv_silu` takes x (B, S, C), which may be a view whose last
axis is contiguous (the model passes its fused projection's xBC
columns), the taps w (K, C) and the bias b (C,), and returns (B, S, C)
in x's dtype.  On a CUDA tensor it checks dtype, shape, strides and
device and launches `causal_conv.cu`'s forward on the current stream,
or raises; a call that autograd records (grad enabled, an input
requiring grad) goes through `CausalConvFn`, whose backward launches
the library's backward entry point once: d(pre-SiLU) recomputed from x,
dx, and dw and db as fixed-order float32 sums (two kernels, no atomics).
The forward keeps nothing but its inputs.  On a CPU tensor, and only
there, every call runs the plain version, which autograd
differentiates.  float32 and bfloat16; K (``d_conv``) up to 4.  w and b
are taken in x's dtype, as the plain version rounds them; the gradients
come back in each input's own dtype.

The forward reads and writes 8 bytes a lane and row, the backward two
elements (its lanes hold more state), where C, x's strides and every
pointer allow it, and one element a lane otherwise (the library decides):
every shape the model makes takes the kernel.  `launch_counts["causal_conv"]` and
`launch_counts["causal_conv_bwd"]` count the calls of each entry point.

The CUDA source is built at first use by `repro_torch.kernels.build`
(nvcc into ``build/repro_torch/``, bound with ctypes, no PyTorch
headers).  While the dry-run records (`kernels.sites.recorder`,
`launch.dryrun`), `causal_conv_silu` hands its call to the recorder
before it looks at the device: nothing is built, launched or counted.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import sites
from repro_torch.kernels.build import build_library, launch_counts
from repro_torch.kernels.causal_conv.ref import (
    causal_conv_silu as causal_conv_silu_reference,
)

SOURCE = Path(__file__).with_name("causal_conv.cu")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_TAPS = 4
_lib: ctypes.CDLL | None = None
#: SM count of each device set up so far
_sms: dict[int, int] = {}
#: nvcc's output (ptxas register and shared-memory report) of the build
#: this process loaded, or None before the first build.
build_log: str | None = None


def build() -> Path:
    """Compile `causal_conv.cu` unless this source and these flags were
    built before; returns the shared library's path."""
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
        lib.causal_conv_fwd_launch.argtypes = [
            i, vp, ll, ll, vp, vp, vp, i, i, i, i, i, vp]
        lib.causal_conv_fwd_launch.restype = i
        lib.causal_conv_bwd_launch.argtypes = [
            i, vp, ll, ll, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, i, vp]
        lib.causal_conv_bwd_launch.restype = i
        lib.causal_conv_bwd_workspace.argtypes = [
            i, vp, ll, ll, vp, vp, vp, vp, i, i, i, i, i]
        lib.causal_conv_bwd_workspace.restype = ll
        lib.causal_conv_error_string.argtypes = [i]
        lib.causal_conv_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _device_sms(dev: torch.device) -> int:
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return _sms[dev.index]


def _checked(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, who: str):
    """Raises on what the kernels do not take; returns (B, S, C, K) and
    w and b in x's dtype, contiguous."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{who}: float32 or bfloat16 only, got {x.dtype}")
    if x.dim() != 3 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"{who}: x (B, S, C), w (K, C) and b (C,), got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    Bsz, S, C = x.shape
    K = w.shape[0]
    if not 1 <= K <= MAX_TAPS:
        raise ValueError(f"{who}: 1 to {MAX_TAPS} taps, got {K}")
    if w.shape[1] != C or b.shape[0] != C:
        raise ValueError(f"{who}: w {tuple(w.shape)} and b {tuple(b.shape)} "
                         f"do not match C = {C}")
    if min(Bsz, S, C) <= 0:
        raise ValueError(f"{who}: empty shapes B={Bsz} S={S} C={C}")
    if x.stride(-1) != 1:
        raise ValueError(f"{who}: x must be contiguous in its last axis")
    if x.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x.device}")
    for name, t in (("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"{who}: {name} is on {t.device}, expected "
                             f"{x.device}")
    return (Bsz, S, C, K), w.to(x.dtype).contiguous(), \
        b.to(x.dtype).contiguous()


def causal_conv_forward(x: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """The forward kernel on CUDA tensors (see the module docstring)."""
    (Bsz, S, C, K), w, b = _checked(x, w, b, "causal_conv")
    dev = x.device
    lib = _library()
    y = torch.empty((Bsz, S, C), dtype=x.dtype, device=dev)
    err = lib.causal_conv_fwd_launch(
        _DTYPES[x.dtype], x.data_ptr(), x.stride(0), x.stride(1),
        w.data_ptr(), b.data_ptr(), y.data_ptr(), Bsz, S, C, K,
        _device_sms(dev), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("causal_conv kernel launch failed: "
                           + lib.causal_conv_error_string(err).decode())
    launch_counts["causal_conv"] += 1
    return y


def causal_conv_backward(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                         dy: torch.Tensor) -> tuple:
    """(dx, dw, db) of `causal_conv_silu` for the output gradient ``dy``,
    each in its input's dtype (dx contiguous), from one launch of the
    backward entry point on CUDA tensors."""
    (Bsz, S, C, K), wx, bx = _checked(x, w, b, "causal_conv_backward")
    dev = x.device
    dy = dy.contiguous()
    if dy.dtype != x.dtype or tuple(dy.shape) != (Bsz, S, C) \
            or dy.device != dev:
        raise ValueError(f"causal_conv_backward: dy must be {x.dtype} "
                         f"{(Bsz, S, C)} on {dev}, got {dy.dtype} "
                         f"{tuple(dy.shape)} on {dy.device}")
    lib = _library()
    dx = torch.empty((Bsz, S, C), dtype=x.dtype, device=dev)
    dw = torch.empty((K, C), dtype=x.dtype, device=dev)
    db = torch.empty((C,), dtype=x.dtype, device=dev)
    sms = _device_sms(dev)
    args = (_DTYPES[x.dtype], x.data_ptr(), x.stride(0), x.stride(1),
            wx.data_ptr(), bx.data_ptr(), dy.data_ptr(), dx.data_ptr())
    n = lib.causal_conv_bwd_workspace(*args, Bsz, S, C, K, sms)
    if n < 0:
        raise ValueError(f"causal_conv_backward: no launch for B={Bsz} "
                         f"S={S} C={C}")
    ws = torch.empty(n, dtype=torch.float32, device=dev)
    err = lib.causal_conv_bwd_launch(
        *args, dw.data_ptr(), db.data_ptr(), ws.data_ptr(), Bsz, S, C, K,
        sms, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("causal_conv backward kernel launch failed: "
                           + lib.causal_conv_error_string(err).decode())
    launch_counts["causal_conv_bwd"] += 1
    return dx, dw.to(w.dtype), db.to(b.dtype)


class CausalConvFn(torch.autograd.Function):
    """`causal_conv_silu` with a gradient on CUDA tensors: the forward
    kernel, saving only its inputs (x as the view it was given), and the
    backward kernel."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return causal_conv_forward(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        grads = causal_conv_backward(x, w, b, dy)
        return tuple(g if need else None
                     for g, need in zip(grads, ctx.needs_input_grad))


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """silu(causal conv of x with taps w, + b) in x's dtype (see the
    module docstring)."""
    if sites.recorder is not None:
        return sites.recorder.causal_conv_silu(x, w, b)
    if x.device.type == "cpu":
        return causal_conv_silu_reference(x, w, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return CausalConvFn.apply(x, w, b)
    return causal_conv_forward(x, w, b)


__all__ = ["causal_conv_silu", "causal_conv_silu_reference",
           "causal_conv_forward", "causal_conv_backward", "CausalConvFn",
           "build", "launch_counts"]
