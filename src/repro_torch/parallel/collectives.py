"""Collectives on a mesh's sub-groups, and the int8-compressed mean.

The port of the JAX package's ``parallel/collectives.py``, and the
collectives the port's per-rank bodies use where the reference opens a
``shard_map`` (expert-parallel MoE, sequence-parallel attention, the
compressed gradient reduction).  Every function takes a mesh
(`launch.mesh.WorkerMesh`) and the mesh axes to work over; a group of
one rank costs nothing.

Only collectives that gloo carries, on CPU and on CUDA tensors, are
used: ``all_reduce`` of float32 and int32 (sum, max), ``all_gather``
(the list form) and ``all_to_all_single``.  Tensors of another dtype
(bfloat16) cross the wire as their bytes (a ``uint8`` view), and their
sum (`psum`) is formed from an all-gather: the ranks' parts added in
float32 in rank order and rounded once, so every rank holds the same
bits.  There is no reduce-scatter: it is a `psum` and the rank's slice.

Autograd passes through `all_gather` (its gradient is the reduce-scatter
of the cotangents: the sum over the group, then the rank's slice),
`all_to_all` (the reverse all-to-all, which is the same exchange),
`psum` (a psum) and `share_mean` (the group mean, whose gradient is the
cotangent over the group size).  These are the transposes of a program
whose loss is the sum of the ranks' own losses, which is how
`train.train_step` forms the gradient.

compressed_psum -- int8 mean with stochastic rounding: a shared scale
  (the group's ``amax / 127``, one float32 max), ``floor(x/s + u)``
  clipped to +-127 as int8, an exact int32 sum, and the mean.  ``u`` is
  drawn from a ``torch.Generator`` seeded from the caller's (key,
  counter) on the tensor's device, so every rank draws the same ``u`` and
  ends with the same bits; JAX's bits cannot be reproduced, so the
  reference's tests hold the error bound, not equality.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

PyTree = Any

#: dtypes gloo reduces and moves as they are
_NATIVE = (torch.float32, torch.float64, torch.int32, torch.int64,
           torch.int8, torch.uint8)


def _wire(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.dtype in _NATIVE else x.view(torch.uint8)


def _gather_parts(x: torch.Tensor, mesh, axes) -> list[torch.Tensor]:
    """Every rank's ``x`` over the group of ``axes``, in group order."""
    n = mesh.size(axes)
    if n == 1:
        return [x]
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(parts, w, group=mesh.group(axes))
    return [p.view(x.dtype) if p.dtype != x.dtype else p for p in parts]


def _psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    if mesh.size(axes) == 1:
        return x
    if x.dtype in _NATIVE:
        y = x.contiguous().clone()
        dist.all_reduce(y, group=mesh.group(axes))
        return y
    parts = _gather_parts(x, mesh, axes)
    total = parts[0].float()
    for p in parts[1:]:
        total = total + p.float()
    return total.to(x.dtype)


def pmax(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The group's elementwise max (float32 or int32)."""
    if mesh.size(axes) == 1:
        return x
    y = x.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return y


def _gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    return torch.cat(_gather_parts(x, mesh, axes), dim=dim)


def _own(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    n = mesh.size(axes)
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * step, step)


def _a2a(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    if mesh.size(axes) == 1:
        return x
    w = _wire(x)
    out = torch.empty_like(w)
    dist.all_to_all_single(out, w, group=mesh.group(axes))
    return out.view(x.dtype) if out.dtype != x.dtype else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        g = _psum(g.contiguous(), ctx.mesh, ctx.axes)
        return _own(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), \
            None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _a2a(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.mesh, ctx.axes), None, None


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _ShareMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.n = mesh.size(axes)
        return _psum(x, mesh, axes) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None, None


class _ToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g.contiguous(), ctx.mesh, ctx.axes), None, None


class _FromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(), \
            None, None, None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _own(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group order
    (differentiable: the gradient is the reduce-scatter)."""
    if mesh.size(axes) == 1:
        return x
    return _AllGather.apply(x, mesh, axes, dim)


def own_slice(x: torch.Tensor, mesh, axes, dim: int = 0) -> torch.Tensor:
    """The rank's equal part of ``x`` along ``dim`` over the group."""
    if mesh.size(axes) == 1:
        return x
    return _own(x, mesh, axes, dim)


def all_to_all(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` (n, ...) with n the group's size: part i goes to the group's
    rank i, and part i of the result came from rank i
    (differentiable)."""
    if mesh.size(axes) == 1:
        return x
    return _AllToAll.apply(x, mesh, axes)


def psum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The group's sum, the same bits on every rank (differentiable)."""
    if mesh.size(axes) == 1:
        return x
    return _Psum.apply(x, mesh, axes)


def share_mean(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The group's mean, whose gradient is each rank's share (the
    cotangent over the group's size)."""
    if mesh.size(axes) == 1:
        return x
    return _ShareMean.apply(x, mesh, axes)


# ---------------------------------------------------------------------------
# Megatron's region maps (activation tensor parallelism over "model")
# ---------------------------------------------------------------------------
#
# Within a "model" group that computes one set of rows, a tensor is either
# replicated (every rank holds the same value, and gets the same whole
# cotangent in the backward pass) or the rank's own part.  The maps below
# cross between the two; every rank of the group then back-propagates the
# same loss, and a replicated leaf's gradient comes out whole and equal on
# every rank of the group.

def to_model(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """A replicated tensor entering the rank's own computation (a
    column-parallel product): the identity, whose gradient is the sum of
    the ranks' partial cotangents."""
    if mesh.size(axes) == 1:
        return x
    return _ToModel.apply(x, mesh, axes)


def from_model(x: torch.Tensor, mesh, axes="model") -> torch.Tensor:
    """The ranks' partial results summed into a replicated tensor (after
    a row-parallel product; a vocab-parallel sum): a psum whose gradient
    is the replicated cotangent as it is."""
    if mesh.size(axes) == 1:
        return x
    return _FromModel.apply(x, mesh, axes)


def gather_from_model(x: torch.Tensor, mesh, axes="model",
                      dim: int = -1) -> torch.Tensor:
    """The ranks' parts concatenated along ``dim`` into a replicated
    tensor (a leaf every rank then uses alike, logits made whole): the
    gradient is the rank's part of the replicated cotangent."""
    if mesh.size(axes) == 1:
        return x
    return _GatherFromModel.apply(x, mesh, axes, dim % x.dim())


def scatter_to_model(x: torch.Tensor, mesh, axes="model",
                     dim: int = -1) -> torch.Tensor:
    """The rank's equal part along ``dim`` of a replicated tensor: the
    gradient is the ranks' parts gathered, whole on every rank."""
    if mesh.size(axes) == 1:
        return x
    return _ScatterToModel.apply(x, mesh, axes, dim % x.dim())


def vocab_logsumexp(logits: torch.Tensor, mesh, axes="model"
                    ) -> torch.Tensor:
    """log(sum(exp)) over the last dim of logits cut over ``axes``: the
    group's max (a constant shift, held out of the gradient), then the
    sum of the exps over the group (`from_model`).  Replicated."""
    if mesh.size(axes) == 1:
        return torch.logsumexp(logits, dim=-1)
    top = pmax(logits.detach().amax(dim=-1).float(), mesh, axes)
    top = torch.where(torch.isfinite(top), top, 0.0)
    total = from_model(torch.exp(logits - top[..., None]).sum(dim=-1),
                       mesh, axes)
    return top + torch.log(total)


def whole_leaf(w: torch.Tensor, full: int, dim: int, mesh, *,
               alike: bool, axes="model") -> torch.Tensor:
    """A leaf whose ``dim`` (``full`` wide whole) the storage cuts over
    ``axes`` where it divides: as it is when whole, else gathered.  With
    ``alike`` the ranks use it alike (replicated computation: the
    gradient is the rank's part), else each for its own part (the
    gradient is the sum of the ranks', then the rank's part)."""
    if w.shape[dim] == full:
        return w
    if w.shape[dim] * mesh.size(axes) != full:
        raise ValueError(f"a leaf of {w.shape[dim]} along {dim} is neither "
                         f"whole ({full}) nor a part over {axes}")
    if alike:
        return gather_from_model(w, mesh, axes, dim)
    return all_gather(w, mesh, axes, dim % w.dim())


def part_of_leaf(w: torch.Tensor, full: int, dim: int, mesh,
                 axes="model") -> torch.Tensor:
    """A leaf the storage cuts over ``axes`` along ``dim``, as the rank's
    part: raises when it is whole (the cut is used as it is stored,
    never gathered)."""
    if w.shape[dim] * mesh.size(axes) != full:
        raise ValueError(f"expected the rank's part ({full} // "
                         f"{mesh.size(axes)}) along {dim}, got "
                         f"{w.shape[dim]}")
    return w


# ---------------------------------------------------------------------------
# Shards of a leaf (ZeRO-style storage)
# ---------------------------------------------------------------------------

def _entries(spec):
    for dim, entry in enumerate(spec):
        if entry is not None:
            yield dim, (entry if isinstance(entry, tuple) else (entry,))


def shard_of(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The rank's shard of a full leaf under ``spec`` (a view)."""
    for dim, axes in _entries(spec):
        full = _own(full, mesh, axes, dim)
    return full


@torch.no_grad()
def unshard(local: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The full leaf from every rank's shard under ``spec``."""
    for dim, axes in _entries(spec):
        if mesh.size(axes) > 1:
            local = _gather(local, mesh, axes, dim)
    return local


def replication(spec, mesh) -> int:
    """How many ranks hold each shard of a leaf under ``spec``."""
    used = {a for _, axes in _entries(spec) for a in axes}
    n = 1
    for a, size in mesh.shape.items():
        if a not in used:
            n *= size
    return n


@torch.no_grad()
def assert_replicated(tree: PyTree, mesh, what: str = "tree") -> None:
    """Raises unless every rank holds the same ``tree`` (a float64
    checksum of its leaves, all-reduced as max and min)."""
    from repro_torch.models.param import tree_leaves

    total = sum(leaf.double().sum() for leaf in tree_leaves(tree))
    axes = mesh.axis_names
    hi, lo = pmax(total, mesh, axes), -pmax(-total, mesh, axes)
    if not bool(hi == lo):
        raise AssertionError(f"{what} differs between the ranks: checksums "
                             f"{float(lo)}..{float(hi)}")


# ---------------------------------------------------------------------------
# Compressed mean
# ---------------------------------------------------------------------------

def rng_seed(key: int, counter: int) -> int:
    """A generator seed for (key, counter): the place of the reference's
    ``fold_in(PRNGKey(key), counter)``."""
    return (int(key) << 32) + int(counter)


def _stochastic_round_int8(x: torch.Tensor, scale: torch.Tensor,
                           seed: int) -> torch.Tensor:
    """Unbiased int8 quantization: floor(x/s + u), u ~ U[0,1)."""
    y = x.float() / torch.clamp(scale, min=1e-30)
    gen = torch.Generator(device=x.device)
    gen.manual_seed(seed)
    u = torch.rand(x.shape, generator=gen, dtype=torch.float32,
                   device=x.device)
    return torch.clamp(torch.floor(y + u), -127, 127).to(torch.int8)


@torch.no_grad()
def compressed_psum(g: torch.Tensor, mesh, axis_names, seed: int
                    ) -> torch.Tensor:
    """int8-compressed mean of ``g`` over ``axis_names``: the same bits
    on every rank of the group, within ``amax/127`` of the exact mean."""
    n = mesh.size(axis_names)
    amax = pmax(g.float().abs().max(), mesh, axis_names)   # shared codebook
    scale = amax / 127.0
    q = _stochastic_round_int8(g, scale, seed)
    # accumulate exactly in int32
    total = _psum(q.to(torch.int32), mesh, axis_names)
    return (total.float() * scale / n).to(g.dtype)


def compressed_psum_tree(grads: PyTree, mesh, spec_tree: PyTree = None, *,
                         axis_names: tuple[str, ...] = ("pod",),
                         seed: int = 0) -> PyTree:
    """Mean-reduce every leaf over ``axis_names`` with int8 compression;
    leaf i draws its rounding from (0, seed + i).  Leaves keep their
    shards (``spec_tree`` is the reference's, and is not needed: each
    rank reduces the shard it holds)."""
    from repro_torch.models.param import tree_leaves, tree_map

    present = tuple(a for a in axis_names if a in mesh.shape)
    if not present:
        return grads
    out = iter([compressed_psum(g, mesh, present, rng_seed(0, seed + i))
                for i, g in enumerate(tree_leaves(grads))])
    return tree_map(lambda _: next(out), grads)


def psum_scalar(x: torch.Tensor, mesh) -> torch.Tensor:
    """Mean of a replicated scalar over the whole mesh (metrics): the
    reference's identity, kept for its API."""
    return x


def reduce_scatter_matmul_hint(x: torch.Tensor) -> torch.Tensor:
    """The reference's marker for XLA's scheduler: the identity."""
    return x


__all__ = ["pmax", "all_gather", "own_slice", "all_to_all",
           "psum", "share_mean", "to_model", "from_model",
           "gather_from_model", "scatter_to_model", "vocab_logsumexp",
           "whole_leaf", "part_of_leaf", "shard_of", "unshard", "replication",
           "assert_replicated",
           "rng_seed", "compressed_psum", "compressed_psum_tree",
           "psum_scalar", "reduce_scatter_matmul_hint"]
