"""Parameter initialisers, and the loader that carries the JAX package's
weights across.

Parameters are plain nested dicts of tensors with the JAX package's tree
paths and layouts: linear weights are stored (d_in, d_out), and every
leaf of the layer stack carries a leading ``n_scan`` axis.  `Init` draws
them with the reference's distributions from an explicit
``torch.Generator`` on an explicit device:

  * matmul weights: truncated normal in [-2, 2] times ``1/sqrt(fan_in)``;
  * embeddings: normal(0, 1);
  * zeros and ones;
  * the Mamba2 block's scan parameters (reference ``models/ssm.py``):
    ``A_log = log U[1, 16)`` and ``dt_bias``, the inverse softplus of a
    step drawn from LogUniform(1e-3, 1e-1), both float32.

Values are drawn in float32 and cast to the parameter dtype, as
``materialize`` does.  JAX's random bits cannot be reproduced, so
parity tests load the reference's own arrays with
`params_from_reference` instead.

Every draw also names its logical axes (the reference's ``Param.axes``:
``("embed", "heads")`` and the like, ``"layers"`` for a stack axis).  An
``Init`` made with ``record=True`` draws nothing and returns a `Leaf`
(shape, axes and dtype) instead, which is how `models.model.axes_tree`
builds the tree the sharding rules read, and what a checkpoint restore
takes as its target (`models.model.leaf_tree`).
"""
from __future__ import annotations

import dataclasses
import inspect
import math
from typing import Any

import numpy as np
import torch

PyTree = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; known: {tuple(_DTYPES)}")
    return _DTYPES[name]


#: the most values `Init.dense` draws as one float32 tensor (8 GiB): every
#: weight of the models served before qwen3-32b and starcoder2-7b, whose
#: stacked MLP weights are larger and are drawn a leading index at a time
DENSE_DRAW_MAX = 2 ** 31


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A parameter's full shape and logical axes, as a recording `Init`
    returns them, and its dtype (not compared: two leaves are equal by
    shape and axes)."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    dtype: torch.dtype | None = dataclasses.field(default=None,
                                                  compare=False)


def _recorded(draw):
    """A draw of `Init` that returns a `Leaf` when the Init records (the
    draw's ``dtype`` argument, float32 for the draws that take none)."""
    sig = inspect.signature(draw)

    def wrapped(self, shape, *args, axes=None, **kw):
        if not self.record:
            return draw(self, shape, *args, **kw)
        axes = (None,) * len(shape) if axes is None else tuple(axes)
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} for shape {shape}")
        dtype = sig.bind(self, shape, *args, **kw).arguments.get(
            "dtype", "float32")
        return Leaf((*self.lead, *shape), ("layers",) * len(self.lead) + axes,
                    torch_dtype(dtype))
    wrapped.__name__, wrapped.__doc__ = draw.__name__, draw.__doc__
    return wrapped


@dataclasses.dataclass(frozen=True)
class Init:
    """Draws parameters of shape ``lead + shape`` on ``device`` from
    ``generator`` (a generator of that device).  Each draw takes the
    parameter's logical ``axes``; with ``record`` it draws nothing and
    returns a `Leaf`."""

    generator: torch.Generator | None
    device: torch.device | None
    lead: tuple[int, ...] = ()
    record: bool = False

    def stacked(self, n: int) -> "Init":
        """The same draws with a leading stack axis of ``n`` layers."""
        return dataclasses.replace(self, lead=(n, *self.lead))

    def _empty(self, shape) -> torch.Tensor:
        return torch.empty((*self.lead, *shape), dtype=torch.float32,
                           device=self.device)

    @_recorded
    def dense(self, shape: tuple[int, ...], dtype, *,
              fan_in: int | None = None) -> torch.Tensor:
        """Truncated-normal matmul weight with 1/sqrt(fan_in) scaling.  A
        stack of at most `DENSE_DRAW_MAX` values is drawn whole in
        float32; a larger one one leading (layer, expert) index at a time,
        each rounded into the output, so that the float32 temporary is one
        ``shape``'s (qwen3-32b's stacked MLP weight is 8.4 G values, whose
        float32 copy does not fit beside the model on one card)."""
        if fan_in is None:
            fan_in = shape[0]
        stddev = 1.0 / math.sqrt(max(fan_in, 1))
        if math.prod(self.lead) * math.prod(shape) <= DENSE_DRAW_MAX:
            w = torch.nn.init.trunc_normal_(self._empty(shape), 0.0, 1.0,
                                            -2.0, 2.0,
                                            generator=self.generator)
            return w.mul_(stddev).to(torch_dtype(dtype))
        out = torch.empty((*self.lead, *shape), dtype=torch_dtype(dtype),
                          device=self.device)
        for part in out.view(-1, *shape):
            w = torch.nn.init.trunc_normal_(
                torch.empty(shape, dtype=torch.float32, device=self.device),
                0.0, 1.0, -2.0, 2.0, generator=self.generator)
            part.copy_(w.mul_(stddev))
        return out

    @_recorded
    def embed(self, shape: tuple[int, ...], dtype) -> torch.Tensor:
        w = self._empty(shape).normal_(generator=self.generator)
        return w.to(torch_dtype(dtype))

    @_recorded
    def uniform(self, shape: tuple[int, ...], low: float = 0.0,
                high: float = 1.0) -> torch.Tensor:
        """float32 U[low, high)."""
        return self._empty(shape).uniform_(low, high,
                                           generator=self.generator)

    @_recorded
    def a_log(self, shape: tuple[int, ...]) -> torch.Tensor:
        """float32 ``log A`` with A ~ U[1, 16), the Mamba2 init."""
        return torch.log(self.uniform(shape, 1.0, 16.0))

    @_recorded
    def dt_bias(self, shape: tuple[int, ...]) -> torch.Tensor:
        """float32 inverse softplus of dt ~ LogUniform(1e-3, 1e-1)."""
        lo, hi = math.log(1e-3), math.log(0.1)
        dt0 = torch.exp(self.uniform(shape) * (hi - lo) + lo)
        return dt0 + torch.log(-torch.expm1(-dt0))

    @_recorded
    def zeros(self, shape: tuple[int, ...], dtype) -> torch.Tensor:
        return torch.zeros((*self.lead, *shape), dtype=torch_dtype(dtype),
                           device=self.device)

    @_recorded
    def ones(self, shape: tuple[int, ...], dtype) -> torch.Tensor:
        return torch.ones((*self.lead, *shape), dtype=torch_dtype(dtype),
                          device=self.device)


def _leaf_tensor(arr: np.ndarray) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":        # ml_dtypes' bfloat16
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_reference(tree: PyTree, *,
                          device: str | torch.device) -> PyTree:
    """Loads the JAX package's parameter tree into the port.

    ``tree`` is ``materialize(init_model(cfg), key)`` with every leaf
    converted to a numpy array (``jax.tree_util.tree_map(np.asarray,
    params)``; bfloat16 leaves arrive as ml_dtypes' bfloat16).  The tree
    paths are kept as they are (``embed.table``,
    ``stack.slot{s}.{norm1,mixer.{wq,wk,wv,wo}.{w,b},q_norm,k_norm,
    norm2,ffn.{up,gate,down}}`` for attention blocks,
    ``stack.slot{s}.{norm1,mixer.{in_proj.w,conv_w,conv_b,A_log,D,
    dt_bias,norm_scale,out_proj.w}}`` for Mamba2 blocks,
    ``stack.slot{s}.ffn.{router,gate,up,down,shared.{up,gate,down}}`` for
    MoE FFNs (the router float32 whatever the parameter dtype, the
    experts (E, d, f) and (E, f, d)), ``final_norm``; for enc-dec
    models ``stack.slot{s}.{norm_ca,cross.{wq,wk,wv,wo}.{w,b}}`` (the
    decoder's cross-attention) and ``encoder.{stack,final_norm}`` (the
    encoder's blocks, the decoder's paths without cross-attention); for
    VLM models ``projector.w``, (d_input, d_model)),
    and so are the layouts: each stack leaf keeps its leading ``n_scan``
    axis, linear weights stay (d_in, d_out) and the conv taps (d_conv,
    channels), which are the layouts the port's layers read, so nothing
    is transposed."""
    if isinstance(tree, dict):
        return {k: params_from_reference(v, device=device)
                for k, v in tree.items()}
    return _leaf_tensor(tree).to(device)


def param_count(tree: PyTree) -> int:
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return tree.numel()


def tree_leaves(tree: PyTree) -> list:
    """The leaves of a tree of nested dicts, in the dicts' order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``, leaf by leaf; the result has tree's
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


__all__ = ["Init", "Leaf", "params_from_reference", "param_count", "torch_dtype",
           "tree_leaves", "tree_map"]
