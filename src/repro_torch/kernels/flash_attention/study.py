"""Design study of the flash backward's tensor-core dk/dv kernel
(`flash_bwd_dkdv_wgmma` in `flash_attention_bwd.cu`), run on the card
from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.flash_attention.study

It prints one JSON line per row, then the card's name and power limit.
The port never imports this module.

At qwen2-1.5b's training shapes (B x S = 8 x 512 and 2 x 2048, 12 query
heads over 2 kv heads of 128, bfloat16, every slot filled) it reads each
backward kernel's device time from `torch.profiler` (per call, over 20
calls after a warm one) for:

* ``causal`` and ``full`` (no causal mask: every dk/dv block walks every
  query tile, twice the work): if the two take about the same time, the
  causal call is set by its longest block (key tile 0 walks every query
  tile, the last one a few) and not by the work in all;
* variants of the dk/dv kernel, each a copy of the source with one part
  taken out (the results are then wrong; only the time is read):
  ``no_softmax`` (P^T and dS^T are not formed: the products run on the
  raw S^T and dP^T, no lse, D or mask read), ``no_ss`` (S^T = K Q^T and
  dP^T = V dO^T are not computed) and ``no_rs`` (dV += P^T dO and
  dK += dS^T Q are not computed); each built into its own library and
  timed in turns with the kernel as it is.
"""
from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from repro_torch.kernels.build import BUILD_DIR, build_library
from repro_torch.kernels.flash_attention import ops

SHAPES = ((8, 512), (2, 2048))
REPS = 20
KERNELS = ("dot", "dkdv", "dq")

_SOFTMAX = """        p_ds(p, scale2, s[x], dp[x], L.x, Dd.x, ok0, &s[x], &dp[x]);
        p_ds(p, scale2, s[x + 1], dp[x + 1], L.y, Dd.y, ok1, &s[x + 1],
             &dp[x + 1]);
"""
_SS = """#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(s, kmajor(kt, kk), kmajor(qs, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_ss_n64(dp, kmajor(vt, kk), kmajor(ds, kk), kk > 0);
"""
_RS = """#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_rs<DH>(dv, pa + 4 * c, mnmajor(ds, c));
#pragma unroll
    for (int c = 0; c < 4; ++c) wgmma_rs<DH>(dk, sa + 4 * c, mnmajor(qs, c));
"""
#: each variant: the text of the dk/dv kernel it replaces, and with what
VARIANTS = {
    "no_softmax": (_SOFTMAX, "        (void)ok0; (void)ok1;\n"),
    "no_ss": (_SS, """#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
"""),
    "no_rs": (_RS, ""),
}


def variant_sources() -> dict[str, Path]:
    """Writes each variant's source under the build directory (each part
    it replaces must appear exactly once) and returns the paths."""
    src = ops.BWD_SOURCE.read_text()
    out = BUILD_DIR / "variants"
    out.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: its text appears "
                               f"{src.count(old)} times in {ops.BWD_SOURCE}")
        path = out / f"flash_attention_bwd_{name}.cu"
        path.write_text(src.replace(old, new))
        paths[name] = path
    return paths


def use(source: Path) -> None:
    """Points the backward wrapper at ``source``'s library."""
    ops.BWD_SOURCE = source
    ops._bwd_lib = None
    ops._bwd_devices.clear()


def inputs(B, S, device, causal=True):
    """chip_smoke's training-shape inputs, the forward's output and lse."""
    from chip_smoke import flash_bwd_inputs
    case = (B, S, S, 12, 2, 128, causal, None, None, 0)
    (q, k, v, qp, kp), kw, dout = flash_bwd_inputs(case, torch.bfloat16,
                                                   device, dense=True)
    out, lse = ops.flash_attention_forward(q, k, v, qp, kp, **kw)
    return (q, k, v, out, dout, lse, qp, kp), kw


def timed(args, kw) -> dict:
    from chip_smoke import BWD_KERNELS, device_ms_by
    return device_ms_by(lambda: ops.flash_attention_backward(*args, **kw),
                        REPS, "flash_bwd_", BWD_KERNELS)


def main() -> int:
    if not torch.cuda.is_available():
        print("study: no CUDA device", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parents[4]
    sys.path.insert(0, str(root))
    from chip_smoke import card_line
    device = torch.device("cuda", 0)
    base = ops.BWD_SOURCE
    paths = variant_sources()
    with ThreadPoolExecutor(len(paths) + 1) as pool:
        list(pool.map(lambda p: build_library(p, ops.NVCC_FLAGS),
                      [base, *paths.values()]))
    for B, S in SHAPES:
        shape = f"{B}x{S}"
        causal, kw = inputs(B, S, device)
        full, full_kw = inputs(B, S, device, causal=False)
        use(base)
        for label, args, opts in (("causal", causal, kw),
                                  ("full", full, full_kw),
                                  ("causal", causal, kw)):
            print(json.dumps({"flash_bwd_study": label, "shape": shape,
                              "device_ms": timed(args, opts)}), flush=True)
        for name, path in paths.items():
            for label, source in ((name, path), ("as_is", base)):
                use(source)
                print(json.dumps({"flash_bwd_study": label, "shape": shape,
                                  "device_ms": timed(causal, kw)}),
                      flush=True)
    use(base)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
