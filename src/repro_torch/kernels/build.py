"""Builds the port's CUDA sources at first use, and counts their launches.

Each kernel's ``.cu`` file has a plain C interface and includes no
PyTorch headers, so ``nvcc`` builds it in seconds into a shared library
under ``build/repro_torch/`` at the repository root, named after a hash
of the source and flags (an edit rebuilds), and ctypes loads it.  A
failed build raises with nvcc's output.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

#: Kernel launches since the count was last reset, by kernel name.  Only
#: the CUDA branch of a wrapper adds to it, once per launch: one call of
#: its library's entry point, whatever number of kernels that runs (a
#: backward's passes, gmm_bwd's dlhs and drhs).
launch_counts = {"waterfill": 0, "flash_attention": 0, "ssd": 0, "gmm": 0,
                 "flash_attention_bwd": 0, "ssd_bwd": 0, "gmm_bwd": 0,
                 "causal_conv": 0, "causal_conv_bwd": 0}


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's kernels are built from source")


def build_library(source: Path, flags: tuple[str, ...]) -> tuple[Path, str | None]:
    """Compile ``source`` unless this source and these flags were built
    before.  Returns the shared library's path and nvcc's output (ptxas'
    register and shared-memory report), kept beside the library so that
    a later process reads the same report; None only if that file is
    gone."""
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{source.stem}-{tag}.so"
    log_file = out.with_suffix(".log")
    if out.exists():
        return out, log_file.read_text() if log_file.exists() else None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        tmp_out = Path(tmp) / out.name
        proc = subprocess.run(
            [nvcc(), *flags, "-o", str(tmp_out), str(source)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        log = proc.stdout + proc.stderr
        tmp_log = Path(tmp) / log_file.name
        tmp_log.write_text(log)
        os.replace(tmp_log, log_file)
        os.replace(tmp_out, out)       # atomic: concurrent builds agree
    return out, log
