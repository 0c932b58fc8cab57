"""The training check: three steps of the plain reference from the same
weights and batches, and the numbers compared with the program's.

The reference runs the model of `perfbench.reference.mamba2_lm` with
autograd, a row of the batch at a time (their gradients summed), and
AdamW as published (Loshchilov & Hutter; bias-corrected moments,
decoupled weight decay, the update clipped by the global gradient
norm), with the learning-rate schedule of the job's traffic file
(linear warm-up, then cosine decay to ``min_ratio`` of the peak).  The
moments are float32; the parameters are kept in the configuration's
dtypes, each step's float32 result rounded to them.

A leaf is one layer's slice of a parameter.  Compared, each against the
reference's reading of the same leaf:
  loss_gap    the largest relative gap of the three steps' losses;
  grad_gap    the first gradient's norm as the optimizer took it (its
              first moment after one step over 1 - b1), by leaf;
  change_gap  the norm of each leaf's change over the three steps;
the gap of two norms over the larger of the reference's norm and the
median leaf's, worst leaf first.  Leaves whose reference gradient is
under a thousandth of the median leaf's are left out of both.
"""
from __future__ import annotations

import math

import torch

from perfbench.reference import mamba2_lm as lm


def leaf_keys(z: lm.Sizes) -> dict:
    """key -> (path, stack index, shape) of every leaf."""
    keys = {}
    for i, slot in z.layers():
        for k, shp in z.layer_shapes(slot).items():
            path = f"stack.slot{slot}.{k}"
            keys[f"{path}[{i}]"] = (path, i, shp)
    keys["embed.table"] = ("embed.table", -1, (z.vocab, z.d))
    keys["final_norm.scale"] = ("final_norm.scale", -1, (z.d,))
    if not z.tied:
        keys["unembed.w"] = ("unembed.w", -1, (z.d, z.vocab))
    return keys


def lr_at(step: int, lr: dict) -> float:
    warm, total = lr["warmup_steps"], lr["total_steps"]
    peak, low = lr["peak"], lr["min_ratio"]
    if step < warm:
        return peak * step / max(warm, 1)
    prog = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (low + (1 - low) * 0.5 * (1 + math.cos(math.pi * prog)))


def readings(config: dict, traffic: dict, seed: int, batches, device,
             prec: str = "f32") -> dict:
    """The reference's losses of the first ``len(batches)`` steps, its
    first gradient's norm by leaf, and each leaf's change over them."""
    z = lm.Sizes(config["sizes"])
    dtype = getattr(torch, config["sizes"]["param_dtype"])
    opt, job = traffic["optimizer"], traffic
    keys = leaf_keys(z)
    stored = {k: lm.leaf(seed, p, i, shp, dtype, device).to(
        torch.float32 if p.rsplit(".", 1)[-1] in lm.FLOAT32_LEAVES
        else dtype) for k, (p, i, shp) in keys.items()}
    start = {k: v.clone() for k, v in stored.items()}
    mu = {k: torch.zeros(v.shape, device=device) for k, v in stored.items()}
    nu = {k: torch.zeros(v.shape, device=device) for k, v in stored.items()}
    out = {"losses": []}
    with lm.exact_matmuls():
        for step, (tokens, labels) in enumerate(batches):
            work = {k: v.float().requires_grad_() for k, v in stored.items()}
            lw = [{k: work[f"stack.slot{slot}.{k}[{i}]"]
                   for k in z.layer_shapes(slot)} for i, slot in z.layers()]
            top = {"embed": work["embed.table"],
                   "final_norm": work["final_norm.scale"]}
            top["unembed"] = (work["embed.table"].T if z.tied
                              else work["unembed.w"])
            total = 0.0
            for r in range(tokens.shape[0]):
                loss = lm.train_loss(lw, top, z, tokens[r:r + 1],
                                     labels[r:r + 1], prec,
                                     job["z_loss"], labels.numel())
                loss.backward()
                total += float(loss.detach())
            out["losses"].append(total)
            with torch.no_grad():
                grads = {k: work[k].grad for k in work}
                del work, lw, top
                gnorm = math.sqrt(sum(float(g.square().sum())
                                      for g in grads.values()))
                clip = min(opt["grad_clip"] / max(gnorm, 1e-9), 1.0)
                count = step + 1
                c1, c2 = 1 - opt["b1"] ** count, 1 - opt["b2"] ** count
                lr = lr_at(step, job["lr"])
                for k, g in grads.items():
                    g = g * clip
                    mu[k].mul_(opt["b1"]).add_((1 - opt["b1"]) * g)
                    nu[k].mul_(opt["b2"]).add_((1 - opt["b2"]) * g.square())
                    upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + opt["eps"])
                    p = stored[k].float()
                    p = p - lr * (upd + opt["weight_decay"] * p)
                    stored[k] = p.to(stored[k].dtype)
                if step == 0:
                    out["grad_norms"] = {
                        k: float(m.norm()) / (1 - opt["b1"])
                        for k, m in mu.items()}
                del grads
    out["changes"] = {k: float((stored[k].float() - start[k].float()).norm())
                      for k in stored}
    return out


def compare(got: dict, ref: dict) -> dict:
    """The three gaps of ``got``'s readings from the reference's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                     ref["losses"]))
    g_ref = ref["grad_norms"]
    med = sorted(g_ref.values())[len(g_ref) // 2]
    live = [k for k, v in g_ref.items() if v >= 1e-3 * med]

    def gap(a: dict, b: dict) -> tuple[float, str]:
        m = sorted(b[k] for k in live)[len(live) // 2]
        return max((abs(a[k] - b[k]) / max(b[k], m), k) for k in live)

    g, gk = gap(got["grad_norms"], g_ref)
    c, ck = gap(got["changes"], ref["changes"])
    return {"loss_gap": loss, "grad_gap": g, "grad_leaf": gk,
            "change_gap": c, "change_leaf": ck,
            "left_out": sorted(set(g_ref) - set(live))}
