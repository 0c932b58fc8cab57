"""Design studies of the SSD kernel's tensor-core instance (``"mma"`` in
`ssd.cu`), run on the card from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.ssd.study

It prints one JSON line per row, then the card's name and power limit.
The port never imports this module.

* ``scores``: ssd.cu forms the scores C B^T once per (batch row, chunk,
  group) into a float32 workspace that every head of the group reads;
  the alternative forms them per head inside the outputs pass
  (`per_head_scores.cu`: ssd.cu's passes 1 and 2, then that outputs
  pass).  At mamba2-1.3b's and jamba-v0.1-52b's scan shapes (one group)
  and the serving prefill's S = 512 and 1024, bfloat16, no initial
  state: each kernel's device time from `torch.profiler` (per call, over
  20 calls after a warm one), in turns, and the two variants' y and
  final state against each other.
* ``roundings``: what each bf16 rounding of the instance costs: the
  chunked scan in float32 on inputs that hold bf16 values, with w x, the
  scores and the entering state (bf16 hi, or hi + lo) rounded alone and
  together, against the sequential oracle on the same inputs, at
  mamba2's S = 1024 with an initial state.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels.build import build_library
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import expand_groups, ssd_reference

SOURCE = Path(__file__).with_name("per_head_scores.cu")
ARCHES = ("mamba2-1.3b", "jamba-v0.1-52b")
LENGTHS = (512, 1024)
REPS = 20
#: kernels of the two variants, by the name the profiler shows
KERNELS = ("ssd_mma_states", "ssd_mma_pass", "ssd_mma_scores",
           "ssd_mma_outputs", "ssd_per_head_outputs")


def inputs(seed, B, S, H, P, G, N, init, device, dtype=torch.bfloat16):
    """The reference suite's draws (normal x; dt = |normal| * 0.3 + 0.01;
    A = -(|normal| + 0.1); B and C normal * 0.3; D normal; an initial
    state |normal| * 0.1), x, B and C in ``dtype``."""
    rng = np.random.default_rng(seed)
    draws = {
        "x": rng.standard_normal((B, S, H, P)),
        "dt": np.abs(rng.standard_normal((B, S, H))) * 0.3 + 0.01,
        "A": -(np.abs(rng.standard_normal(H)) + 0.1),
        "Bm": rng.standard_normal((B, S, G, N)) * 0.3,
        "Cm": rng.standard_normal((B, S, G, N)) * 0.3,
        "D": rng.standard_normal(H),
        "st": np.abs(rng.standard_normal((B, H, P, N))) * 0.1,
    }
    t = {k: torch.tensor(v, dtype=torch.float32, device=device)
         for k, v in draws.items()}
    for k in ("x", "Bm", "Cm"):
        t[k] = t[k].to(dtype)
    return (t["x"], t["dt"], t["A"], t["Bm"], t["Cm"], t["D"],
            t["st"] if init else None)


def scan_shape(arch):
    """(H, P, G, N, chunk) of ``arch``'s SSD scan."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    s = cfg.ssm
    return (s.n_heads(cfg.d_model), s.head_dim, s.ngroups, s.d_state,
            s.chunk)


_lib: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """`per_head_scores.cu`, built with ssd.cu's flags; ssd.cu's hash is
    a define, so an edit of either rebuilds."""
    global _lib
    if _lib is None:
        tag = hashlib.sha256(ops.SOURCE.read_bytes()).hexdigest()[:16]
        path, _ = build_library(SOURCE,
                                ops.NVCC_FLAGS + (f"-DSSD_CU_{tag}",))
        lib = ctypes.CDLL(str(path))
        vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ssd_per_head_launch.argtypes = [
            i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i,
            i, i, i, ll, ll, ll, ll, ll, ll, ll, ll, ll, vp]
        lib.ssd_per_head_launch.restype = i
        lib.ssd_error_string.argtypes = [i]
        lib.ssd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def per_head_ssd(x, dt, A, Bm, Cm, D, *, chunk, initial_state=None):
    """`ops.ssd`'s "mma" call with the scores formed per head; its
    workspaces as `ops._launch` makes them, but the scores'."""
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if ops.route(x, Bm, Cm, chunk) != "mma":
        raise ValueError("per_head_ssd: the mma instance does not take "
                         "this call")
    dev = x.device
    Q = min(chunk, S)
    nc, nq = -(-S // Q), -(-Q // ops.MMA_TILE)
    states = Bsz * nc * H * P * N
    ws = torch.empty(2 * states + Bsz * H * nc * nq * ops.MMA_TILE,
                     dtype=torch.float32, device=dev)
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=dev)
    final = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=dev)
    init = None if initial_state is None else initial_state.data_ptr()
    base = ws.data_ptr()
    err = library().ssd_per_head_launch(
        dev.index, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), D.data_ptr(), init, y.data_ptr(), final.data_ptr(),
        base + 8 * states, base, base + 4 * states, Bsz, S, H, P, G, N, Q,
        *x.stride()[:3], *Bm.stride()[:3], *Cm.stride()[:3],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError("per_head_ssd launch failed: "
                           + library().ssd_error_string(err).decode())
    return y, final


def kernel_ms(fn, reps=REPS) -> dict:
    """Device time per call of each of `KERNELS` that ``fn`` launches,
    from `torch.profiler` over ``reps`` calls after a warm one."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name in KERNELS:
            if name in e.key:
                out[name] = out.get(name, 0.0) \
                    + e.self_device_time_total / reps / 1e3
    out["total"] = sum(out.values())
    return out


def scores(device) -> list[dict]:
    rows = []
    for arch in ARCHES:
        H, P, G, N, chunk = scan_shape(arch)
        for S in LENGTHS:
            args = inputs(40 + S, 1, S, H, P, G, N, False, device)[:6]
            variants = {"shared": ops.ssd, "per_head": per_head_ssd}
            outs = {k: fn(*args, chunk=chunk) for k, fn in variants.items()}
            torch.cuda.synchronize()
            diff = [float((a.float() - b.float()).abs().max())
                    for a, b in zip(outs["shared"], outs["per_head"])]
            if max(diff) > 5e-2:
                raise AssertionError(f"{arch} S={S}: the variants differ "
                                     f"by {diff}")
            turns = [{"variant": k, **kernel_ms(
                lambda: variants[k](*args, chunk=chunk))}
                for k in ("shared", "per_head", "per_head", "shared")]
            nc, nq = -(-S // min(chunk, S)), -(-min(chunk, S) // 64)
            rows.append({
                "scores": arch, "S": S, "H": H, "P": P, "G": G, "N": N,
                "chunk": chunk,
                "scores_workspace_bytes": 4 * nc * G * nq * (nq + 1) // 2
                * 64 * 64,
                "bitwise_equal": all(torch.equal(a, b) for a, b in zip(
                    outs["shared"], outs["per_head"])),
                "max_abs_diff": {"y": diff[0], "state": diff[1]},
                "device_ms": turns})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def rounded_scan(x, dt, A, Bm, Cm, D, *, chunk, initial_state, round_wx,
                 round_scores, state_parts):
    """The chunked scan in float32 (S a multiple of ``chunk``) with the
    instance's roundings chosen one by one: ``round_wx`` w x to bf16
    before the state contribution, ``round_scores`` the masked, decayed
    scores to bf16 before scores @ x, ``state_parts`` the entering state
    as float32 (0), bf16 hi (1) or hi + lo (2)."""
    def bf16(t):
        return t.to(torch.bfloat16).float()

    Bsz, S, H, P = x.shape
    N, nc = Bm.shape[-1], S // chunk
    xs = x.reshape(Bsz, nc, chunk, H, P)
    dts = dt.reshape(Bsz, nc, chunk, H)
    Bh = expand_groups(Bm, H, 2).reshape(Bsz, nc, chunk, H, N)
    Ch = expand_groups(Cm, H, 2).reshape(Bsz, nc, chunk, H, N)
    cum = torch.cumsum(dts * A, dim=2)
    tot = cum[:, :, -1]
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    diff = cum[:, :, :, None] - cum[:, :, None]
    decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)), 0.0)
    scores = torch.einsum("bcihn,bcjhn->bcijh", Ch, Bh) * decay \
        * dts[:, :, None]
    if round_scores:
        scores = bf16(scores)
    y = torch.einsum("bcijh,bcjhp->bcihp", scores, xs)
    wx = (torch.exp(tot[:, :, None] - cum) * dts)[..., None] * xs
    if round_wx:
        wx = bf16(wx)
    contrib = torch.einsum("bcjhp,bcjhn->bchpn", wx, Bh)
    state, entering = initial_state, []
    for c in range(nc):
        entering.append(state)
        state = torch.exp(tot[:, c])[:, :, None, None] * state + contrib[:, c]
    enter = torch.stack(entering, dim=1)
    if state_parts:
        hi = bf16(enter)
        enter = hi + bf16(enter - hi) if state_parts == 2 else hi
    y = y + torch.einsum("bcihn,bchpn->bcihp",
                         Ch * torch.exp(cum)[..., None], enter)
    y = y.reshape(Bsz, S, H, P) + D[:, None] * x
    return y, state


def roundings(device, S=1024) -> dict:
    H, P, G, N, chunk = scan_shape(ARCHES[0])
    x, dt, A, Bm, Cm, D, st = inputs(40 + S, 1, S, H, P, G, N, True, device)
    x, Bm, Cm = x.float(), Bm.float(), Cm.float()
    yr, fr = ssd_reference(x, dt, A, Bm, Cm, D, initial_state=st)
    variants = {                 # round_wx, round_scores, state_parts
        "none": (False, False, 0), "w_x": (True, False, 0),
        "scores": (False, True, 0), "state_hi": (False, False, 1),
        "state_hi_lo": (False, False, 2), "kernel": (True, True, 2),
        "kernel_state_hi": (True, True, 1)}
    row = {"roundings": ARCHES[0], "S": S, "init": True,
           "max_abs_y": float(yr.abs().max())}
    for name, (wx, sc, parts) in variants.items():
        y, fin = rounded_scan(x, dt, A, Bm, Cm, D, chunk=chunk,
                              initial_state=st, round_wx=wx,
                              round_scores=sc, state_parts=parts)
        row[name] = {"y": float((y - yr).abs().max()),
                     "state": float((fin - fr).abs().max())}
    print(json.dumps(row), flush=True)
    return row


def main() -> int:
    if not torch.cuda.is_available():
        print("study: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", torch.cuda.current_device())
    scores(device)
    roundings(device)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
