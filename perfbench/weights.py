"""The benchmark's weights, made from the run's seed.

Both sides read the same raw tensors: the program gets them laid out as
its parameter tree, the plain reference asks for the same leaves by path
and shape.  Each leaf of a layer stack is drawn one stack index at a
time, from a generator of its own seeded by (seed, path, index), so the
reference can make one layer again without making the rest.

Distributions (by the leaf's name; fan-in is the second-to-last axis):
  embedding table        normal(0, 1)
  norm scales, D         ones
  biases, conv_b         zeros
  A_log                  log U[1, 16)               float32
  dt_bias                softplus^-1 of LogUniform(1e-3, 1e-1), float32
  every other weight     normal(0, 1) / sqrt(fan_in)
"""
from __future__ import annotations

import hashlib
import math

import torch

ONES = ("scale", "norm_scale", "D")
ZEROS = ("b", "conv_b")


def leaf_seed(seed: int, path: str, index: int) -> int:
    tag = f"{seed}/{path}/{index}".encode()
    return int.from_bytes(hashlib.sha256(tag).digest()[:8], "little") >> 1


def draw(seed: int, path: str, index: int, shape, dtype,
         device) -> torch.Tensor:
    """One leaf (or one stack index of a stacked leaf) of ``shape``."""
    name = path.rsplit(".", 1)[-1]
    shape = tuple(shape)
    if name in ONES:
        return torch.ones(shape, dtype=dtype, device=device)
    if name in ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, path, index))
    if name == "A_log":
        u = torch.rand(shape, generator=gen, device=device)
        return torch.log(1.0 + 15.0 * u).to(dtype)
    if name == "dt_bias":
        lo, hi = math.log(1e-3), math.log(0.1)
        u = torch.rand(shape, generator=gen, device=device)
        dt0 = torch.exp(u * (hi - lo) + lo)
        return (dt0 + torch.log(-torch.expm1(-dt0))).to(dtype)
    w = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    if name == "table":
        return w
    return w.mul_(1.0 / math.sqrt(shape[-2]))


def program_tree(leaves, seed: int, device) -> dict:
    """The program's parameter tree from its tree of leaf descriptions
    (each with ``shape``, ``axes`` and ``dtype``; a leading "layers" axis
    marks a stack, drawn an index at a time)."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}.") for k, v in node.items()}
        path = prefix[:-1]
        if node.axes and node.axes[0] == "layers":
            out = torch.empty(node.shape, dtype=node.dtype, device=device)
            for i in range(node.shape[0]):
                out[i].copy_(draw(seed, path, i, node.shape[1:], node.dtype,
                                  device))
            return out
        return draw(seed, path, -1, node.shape, node.dtype, device)
    return build(leaves, "")
