"""Water-fill entry point: the Hopper kernel for CUDA tensors, the plain
PyTorch version for CPU tensors.

`waterfill` takes the matchmaker's chunked layout -- the same
(nch, chunk, R) / (R, Wp) arrays the JAX package's scan and Pallas
kernel consume, with R left at its natural width (no TPU sublane pad).
On a CUDA tensor it launches `waterfill.cu` on the current stream, or
raises; on a CPU tensor, and only there, it runs
`ref.waterfill_reference` over the same rows.

The CUDA source is compiled at first use with ``nvcc`` into a plain-C
shared library under ``build/repro_torch/`` at the repository root
(named after a hash of the source and flags, so an edit rebuilds) and
bound with ctypes: no PyTorch headers, so the build takes seconds.
A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from repro_torch.core.matchmaker.base import FIT_EPS
from repro_torch.kernels.waterfill.ref import waterfill_reference

SOURCE = Path(__file__).with_name("waterfill.cu")
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC")

#: Kernel launches since the count was last reset, by kernel name.  Only
#: the CUDA branch of a wrapper adds to it, once per launch.
launch_counts = {"waterfill": 0}

_DTYPES = {torch.float64: 0, torch.float32: 1}
_WARP_TOTALS_BYTES = 2 * 32 * 8       # the kernel's static shared memory
_lib: ctypes.CDLL | None = None
#: the opt-in dynamic shared-memory limit of each device set up so far
_max_smem: dict[int, int] = {}
#: nvcc's output (ptxas register and shared-memory report) of the build
#: this process loaded, or None before the first build.
build_log: str | None = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the water-fill kernel is built from source")


def build() -> Path:
    """Compile `waterfill.cu` unless this source and these flags were
    built before; returns the shared library's path."""
    global build_log
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"waterfill-{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp_out), str(SOURCE)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        build_log = proc.stdout + proc.stderr
        os.replace(tmp_out, out)       # atomic: concurrent builds agree
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        lib.waterfill_launch.argtypes = [
            i, i, vp, d, vp, vp, vp, vp, vp, vp, vp, vp, vp,
            i, i, i, i, i, d, vp]
        lib.waterfill_launch.restype = i
        lib.waterfill_init.argtypes = [i]
        lib.waterfill_init.restype = i
        lib.waterfill_step_floor.argtypes = [i, i, i, i, vp, vp]
        lib.waterfill_step_floor.restype = i
        lib.waterfill_error_string.argtypes = [i]
        lib.waterfill_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _device_smem(lib: ctypes.CDLL, index: int) -> int:
    """The device's opt-in shared-memory limit; the first call per device
    also lets the kernel use all of it."""
    if index not in _max_smem:
        got = lib.waterfill_init(index)
        if got < 0:
            raise RuntimeError("waterfill kernel set-up failed: "
                               + lib.waterfill_error_string(-got).decode())
        _max_smem[index] = got
    return _max_smem[index]


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"waterfill: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"waterfill: {name} must have shape {tuple(shape)},"
                         f" got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"waterfill: {name} is on {t.device}, "
                         f"expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"waterfill: {name} must be contiguous")


def waterfill(
    freeT: torch.Tensor,       # (R, Wp)
    left: float,               # claim budget (may be inf)
    want: torch.Tensor,        # (nch, chunk, R)
    safe: torch.Tensor,        # (nch, chunk, R)
    big: torch.Tensor,         # (nch, chunk, R)
    demand: torch.Tensor,      # (nch, chunk)
    crow: torch.Tensor,        # (nch, chunk, Wp) uint8
    chunk_min: torch.Tensor,   # (nch, R)
):
    """Returns (takes (nch, chunk, Wp) int32, freeT_after (R, Wp),
    ran (nch,) bool) on the inputs' device -- the JAX package's
    `waterfill` contract.  The CPU branch runs every chunk (the plain
    version has no drain guard; a chunk the guard would skip takes
    nothing either way), so its `ran` is all True."""
    nch, chunk, R = want.shape
    Wp = crow.shape[2]
    if freeT.device.type == "cpu":
        takes, free_after = waterfill_reference(
            freeT.T, want.reshape(nch * chunk, R),
            demand.reshape(nch * chunk), crow.reshape(nch * chunk, Wp),
            budget=left)
        return (takes.reshape(nch, chunk, Wp), free_after.T,
                torch.ones(nch, dtype=torch.bool))
    if freeT.device.type != "cuda":
        raise ValueError(f"waterfill: no kernel for device {freeT.device}")
    dev, dt = freeT.device, freeT.dtype
    if dt not in _DTYPES:
        raise TypeError(f"waterfill: float64 or float32 only, got {dt}")
    _check("freeT", freeT, dt, (R, Wp), dev)
    for name, t in (("want", want), ("safe", safe), ("big", big)):
        _check(name, t, dt, (nch, chunk, R), dev)
    _check("demand", demand, dt, (nch, chunk), dev)
    _check("crow", crow, torch.uint8, (nch, chunk, Wp), dev)
    _check("chunk_min", chunk_min, dt, (nch, R), dev)
    if Wp % 32:       # whole warps: the scans shuffle across all 32 lanes
        raise ValueError(f"waterfill: Wp must be a multiple of 32, got {Wp}")
    lib = _library()
    takes = torch.empty((nch, chunk, Wp), dtype=torch.int32, device=dev)
    ran = torch.empty(nch, dtype=torch.int32, device=dev)
    free_out = torch.empty_like(freeT)
    smem = R * Wp * freeT.element_size()
    in_smem = smem + _WARP_TOTALS_BYTES <= _device_smem(lib, dev.index)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.waterfill_launch(
        dev.index, _DTYPES[dt], freeT.data_ptr(), float(left),
        want.data_ptr(), safe.data_ptr(), big.data_ptr(), demand.data_ptr(),
        crow.data_ptr(), chunk_min.data_ptr(), takes.data_ptr(),
        ran.data_ptr(), free_out.data_ptr(), R, Wp, nch, chunk,
        int(in_smem), FIT_EPS, stream)
    if err != 0:
        raise RuntimeError("waterfill kernel launch failed: "
                           + lib.waterfill_error_string(err).decode())
    launch_counts["waterfill"] += 1
    return takes, free_out, ran != 0


def step_floor(steps: int, threads: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Launches the step-floor probe on the current stream: ``steps``
    rounds of the water-fill's cohort step with only its scans and
    barrier left, in one block of ``threads`` threads.  Its time is the
    floor the serial chain of cohort steps puts under the water-fill.  A
    measurement aid: it is not the water-fill and is not counted in
    `launch_counts`."""
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"step_floor: threads must be a multiple of 32 "
                         f"in [32, 1024], got {threads}")
    lib = _library()
    out = torch.empty(1, dtype=dtype, device=device)
    err = lib.waterfill_step_floor(
        out.device.index, _DTYPES[dtype], steps, threads, out.data_ptr(),
        torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError("step-floor probe launch failed: "
                           + lib.waterfill_error_string(err).decode())
    return out


__all__ = ["waterfill", "waterfill_reference", "build", "launch_counts",
           "step_floor"]
