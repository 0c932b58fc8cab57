"""AdamW on the port's parameter trees (nested dicts of tensors).

The port of the JAX package's ``train/optimizer.py``: the same config,
the same state (``mu``, ``nu`` trees beside the parameters and an int32
``count``) and the same float32 arithmetic, step for step: global-norm
clipping, bias correction, decoupled weight decay.  Moments follow the
config's ``state_dtype`` policy (float32, or bfloat16 for the largest
archs), and ``keep_nu_fp32`` keeps the second moment in float32 under
the bfloat16 policy.

Unlike the reference, whose arrays are immutable, `adamw_update` writes
the new parameters and moments into the tensors it is given (under
``torch.no_grad()``), and returns those same trees: a second copy of a
1.5 B-parameter model and its moments would not be free.  A leaf of at
least ``_CHUNK_THRESHOLD`` elements is updated a slab of leading rows at
a time, each slab at most that many elements, as the reference's
``lax.map`` over the leading axis caps its float32 working set; the
update is elementwise, so the slabs change nothing in the result.

Under a mesh (`train.train_step`'s sharded step) the trees hold each
rank's shards; only the gradient's global norm needs the other ranks.
The norm and the clip factor run under the program span
``"optimizer.norm"`` (`observability.steps.span`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.param import torch_dtype, tree_leaves, tree_map
from repro_torch.observability.steps import span
from repro_torch.parallel.collectives import psum, replication

PyTree = Any

#: leaves of at least this many elements are updated in slabs of rows
_CHUNK_THRESHOLD = 1 << 27


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"
    keep_nu_fp32: bool = True


def adamw_init(params: PyTree, cfg: OptimizerConfig) -> PyTree:
    mu_dt = torch_dtype(cfg.state_dtype)
    nu_dt = torch.float32 if cfg.keep_nu_fp32 else mu_dt
    device = tree_leaves(params)[0].device
    return {
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=mu_dt,
                                             device=p.device), params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=nu_dt,
                                             device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree: PyTree, *, mesh=None, specs: PyTree = None
                ) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32.  Under a
    ``mesh`` the leaves are this rank's shards (cut as ``specs`` say):
    each shard's sum of squares is divided by the number of ranks that
    hold it, so that the all-reduce over the mesh counts every element
    once, and every rank gets the norm of the whole tree."""
    if mesh is None:
        return torch.sqrt(sum(
            torch.linalg.vector_norm(leaf, dtype=torch.float32).square()
            for leaf in tree_leaves(tree)))
    # leaf by leaf by name: a tree's key order need not be the specs'
    total = sum(tree_leaves(tree_map(
        lambda leaf, spec: torch.linalg.vector_norm(
            leaf, dtype=torch.float32).square() / replication(spec, mesh),
        tree, specs)))
    return torch.sqrt(psum(total, mesh, mesh.axis_names))


def _slabs(*leaves: torch.Tensor):
    """The leaves cut into slabs of leading rows of at most
    `_CHUNK_THRESHOLD` elements (one slab for a smaller leaf)."""
    p = leaves[0]
    if p.dim() < 2 or p.numel() < _CHUNK_THRESHOLD or p.shape[0] <= 1:
        yield leaves
        return
    rows = max(1, _CHUNK_THRESHOLD // (p.numel() // p.shape[0]))
    for r0 in range(0, p.shape[0], rows):
        yield tuple(t[r0:r0 + rows] for t in leaves)


@torch.no_grad()
def adamw_update(
    params: PyTree,
    grads: PyTree,
    state: PyTree,
    cfg: OptimizerConfig,
    lr,
    *,
    mesh=None,
    specs: PyTree = None,
) -> tuple[PyTree, PyTree, dict]:
    """One AdamW step at learning rate ``lr`` (a float or a 0-d tensor).
    Updates ``params`` and the moments in place and returns (params, new
    state, {"grad_norm", "clip_factor"}).  Under a ``mesh`` every tree
    holds this rank's shards and the clip factor is the whole tree's
    (`global_norm`)."""
    count = state["count"] + 1
    with span("optimizer.norm"):
        gnorm = global_norm(grads, mesh=mesh, specs=specs)
        clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                           max=1.0)

    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def upd(p, g, mu, nu):
        g = g.float() * clip
        mu_n = b1 * mu.float() + (1 - b1) * g
        nu_n = b2 * nu.float() + (1 - b2) * torch.square(g)
        mhat = mu_n / c1
        nhat = nu_n / c2
        step = mhat / (torch.sqrt(nhat) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        p_n = p.float() - lr * step
        p.copy_(p_n)
        mu.copy_(mu_n)
        nu.copy_(nu_n)

    for leaves in zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(state["mu"]), tree_leaves(state["nu"])):
        for slab in _slabs(*leaves):
            upd(*slab)
    new_state = {"mu": state["mu"], "nu": state["nu"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "clip_factor": clip}


__all__ = ["OptimizerConfig", "adamw_init", "adamw_update", "global_norm"]
