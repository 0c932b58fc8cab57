"""Times the grouped matmul's backward kernel of one tree of this
repository by kernel, with the floor its loads put under each gradient, so
that two commits can be compared on one card.

Run it once for each tree, each in a process of its own, in turns (A, B,
B, A)::

    python3 src/repro_torch/kernels/moe_gmm/bwd_study.py --root OTHER_TREE
    python3 src/repro_torch/kernels/moe_gmm/bwd_study.py

``--root`` names the checkout whose ``chip_smoke.py`` and
``src/repro_torch`` are imported (default: this one).  For each of that
tree's ``chip_smoke.moe_training_shapes()`` (jamba's gate/up and down
products in a training step) it prints one JSON line: that tree's
``time_gmm_bwd`` row (the tensor-core instance checked against the plain
backward, then CUDA events and device time in all and by kernel), and the
floor probe of dlhs and of drhs: the same launch with the products taken
out, the ring's loads and barriers alone (no stores), on a bfloat16
cotangent, so no cast runs.  A tree whose ``ops`` has ``bwd_stream_floor``
launches it; an older one, from before that probe (the first tensor-core
backward's, one block per 128 x 128 tile), is built again from its own
``gmm_bwd.cu`` with every consumer warpgroup idle (`idle_consumers`).  Then one line for one full-width MoE layer of
jamba in bfloat16 at the training batch's tokens (`layer_backward`): its
whole backward, CUDA events (median) and device time.  Then the card's
name and power limit.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

#: what the first tensor-core backward's kernels test before their
#: products and stores; the probe makes it false
_LIVE = "const bool live = "


def idle_consumers(source: str) -> str:
    """``gmm_bwd.cu`` of a tree without a floor switch, its consumer
    warpgroups made idle: they wait for each stage and release it, and
    neither multiply nor store."""
    if source.count(_LIVE) != 2:
        raise ValueError("bwd_study: this gmm_bwd.cu has no two "
                         f"{_LIVE!r} tests to turn off")
    return source.replace(_LIVE, _LIVE + "false && ")


def floor_launcher(gm, build_dir: Path):
    """fn(lhs, rhs, gs, dout, which) launching the tree's floor probe of
    one gradient (``which``: "dlhs" or "drhs")."""
    if hasattr(gm, "bwd_stream_floor"):
        return gm.bwd_stream_floor
    idle = build_dir / "gmm_bwd_idle.cu"
    build_dir.mkdir(parents=True, exist_ok=True)
    idle.write_text(idle_consumers(gm.BWD_SOURCE.read_text()))
    source, lib = gm.BWD_SOURCE, gm._bwd_library()
    gm.BWD_SOURCE, gm._bwd_lib = idle, None
    try:
        idle_lib = gm._bwd_library()
    finally:
        gm.BWD_SOURCE, gm._bwd_lib = source, lib

    def launch(lhs, rhs, gs, dout, which):
        gm._bwd_lib = idle_lib
        try:
            return gm.gmm_backward(lhs, rhs, gs, dout,
                                   need=(which == "dlhs", which == "drhs"))
        finally:
            gm._bwd_lib = lib
    return launch


def layer_backward(cs, device, reps: int = 10) -> dict:
    """The backward of sum(y * dy) + aux through one full-width MoE layer
    of jamba in bfloat16 (the tree's ``moe_forward_dense``, seeded
    weights, input and dy) at the training batch's tokens: CUDA events
    (median of ``reps``) and device time of one backward pass."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.param import Init
    cfg = dataclasses.replace(get_config(cs.MOE_ARCH),
                              param_dtype="bfloat16",
                              activation_dtype="bfloat16")
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    p = moe_mod.init_moe(Init(gen, device), cfg)
    h = torch.randn((1, cs.MOE_TRAIN_TOKENS, cfg.d_model), generator=gen,
                    device=device).to(p["gate"].dtype)
    dy = torch.randn((1, cs.MOE_TRAIN_TOKENS, cfg.d_model), generator=gen,
                     device=device)
    names = ("router", "gate", "up", "down")
    leaves = [h.requires_grad_()] + [p[k].detach().requires_grad_()
                                     for k in names]
    y, aux = moe_mod.moe_forward_dense(dict(p, **dict(zip(names,
                                                          leaves[1:]))),
                                       cfg, leaves[0])
    loss = (y.float() * dy).sum() + aux

    def backward():
        return torch.autograd.grad(loss, leaves, retain_graph=True)
    row = {"study_layer": f"{cs.MOE_ARCH} MoE layer bfloat16",
           "tokens": cs.MOE_TRAIN_TOKENS,
           "backward_ms": cs.cuda_ms(backward, reps),
           "backward_device_ms": cs.device_ms(backward, reps)}
    del p, h, dy, leaves, y, aux, loss
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[4]))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bwd_study: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as cs
    from repro_torch.kernels.build import BUILD_DIR
    from repro_torch.kernels.moe_gmm import ops as gm
    gm.build_backward()
    floor = floor_launcher(gm, BUILD_DIR / "bwd_study")
    device = torch.device("cuda", 0)
    for label, rows, K, N in cs.moe_training_shapes():
        row = cs.time_gmm_bwd(gm, label, rows, K, N, device)
        lhs, rhs, gs = cs.moe_serving_inputs(rows, K, N, torch.bfloat16,
                                             device)
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        dout = torch.randn((rows, N), generator=gen, device=device,
                           dtype=torch.bfloat16)
        floors = {}
        for which in ("dlhs", "drhs"):
            def probe():
                return floor(lhs, rhs, gs, dout, which)
            by, _ = cs.device_ms_per_launch(probe, cs.KERNEL_REPS,
                                            (f"gmm_bwd_{which}",))
            floors[which] = {"ms": cs.cuda_ms(probe, cs.KERNEL_REPS),
                             "device_ms": by[f"gmm_bwd_{which}"]}
        print(json.dumps({
            "root": str(root), "study_row": label, "ms": row["ms"],
            "device_ms": row["device_ms"],
            "kernels_device_ms": row["kernels_device_ms"],
            "cast_device_ms": row["cast_device_ms"],
            "dlhs_ms": row["dlhs"]["ms"], "drhs_ms": row["drhs"]["ms"],
            "library_ms": row["library_ms"], "floor": floors}), flush=True)
        del lhs, rhs, dout
        torch.cuda.empty_cache()
    print(json.dumps({"root": str(root), **layer_backward(cs, device)}),
          flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
