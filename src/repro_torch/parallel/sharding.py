"""Logical-axis -> mesh-axis sharding rules.

The port of the JAX package's ``parallel/sharding.py``.  Model code names
the logical axes of every parameter (`models.model.axes_tree`: "embed",
"heads", "mlp", "expert", ...); this module maps them onto the mesh axes
("pod", "data", "model") with the same presets and the same rules, and
turns the result into per-leaf placements for `torch.distributed`.

Rule presets per (arch family, workload):

  base        -- heads/mlp/vocab -> "model", batch -> ("pod","data");
                 weights otherwise replicated.
  fsdp        -- base + embed -> "data": every weight matrix has one axis
                 on "model" and its d_model axis on "data".
  ep          -- MoE: expert axis -> "data" (expert parallelism, the
                 all-to-all path in models/moe.py), mlp -> "model",
                 embed -> "data" (FSDP for the dense trunk).
  decode      -- inference: weights as base, embed never sharded.
  decode_sp   -- long-context decode: seq -> "data", weights as ep.
  zero3       -- batch over the whole mesh, weights as fsdp.
  zero3_ep    -- zero3 with the experts on "data".

A spec (`P`) holds, per tensor dim, a mesh axis name, a tuple of names
or None, as the reference's PartitionSpec does, and the functions work
on any mesh whose ``shape`` maps axis names to sizes (the port's
`launch.mesh.WorkerMesh`, or a shape-only stand-in).

How the port executes a spec (see `train.train_step`): each rank stores
its shard of every leaf (``param_sharding_tree``'s placements: a
``Shard(dim)`` or ``Replicate()`` per mesh dim).  Where the rules cut
activations over "model" (base, fsdp, ep, decode, decode_sp: `model_cut`)
a leaf's "model" cut is used as it is stored -- Megatron-style activation
tensor parallelism: a rank computes its part of the heads, the MLP
columns, the SSM heads and the vocabulary -- and the leaf is all-gathered
over the other axes only (`split_model`); elsewhere (zero3, zero3_ep)
the rank all-gathers the full leaf before use, ZeRO-style.  There is no
GSPMD to hint: `Constrainer.cuts` asks the reference's decision
(`constraint_spec`, which drops an axis that does not divide and falls
back to sequence parallelism) whether a call computes its part of an
activation axis, and the constraint itself returns its tensor unchanged.
`Constrainer.kv_slots` holds the reference's decode-cache fallback (its
dry-run's ``cache_shardings``): the KV cache by kv head over "model"
where the kv heads divide it, else by slot.
"""
from __future__ import annotations

import dataclasses
from typing import Any

PyTree = Any

# mesh axes that shard the batch (data parallel), in nesting order
BATCH_AXES = ("pod", "data")


class P(tuple):
    """A partition spec: one entry per tensor dim (a mesh axis name, a
    tuple of names, or None); equal to the tuple of its entries.  A tuple
    of one name is that name, as in JAX's PartitionSpec."""

    def __new__(cls, *parts):
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Mapping: logical axis name -> mesh axis (str | tuple | None)."""

    rules: dict[str, Any]
    name: str = "custom"

    def mesh_axes(self, logical: str | None, mesh):
        if logical is None:
            return None
        ax = self.rules.get(logical, None)
        if ax is None:
            return None
        if isinstance(ax, tuple):
            present = tuple(a for a in ax if a in mesh.shape)
            return present if present else None
        return ax if ax in mesh.shape else None


def _weight_rules(*, fsdp: bool, expert_axis: str | None = None
                  ) -> dict[str, Any]:
    return {
        "vocab": "model",
        "heads": "model",
        "kv": "model",
        "mlp": "model",
        "ssm": "model",
        "embed": "data" if fsdp else None,
        "expert": expert_axis,
        "conv": None,
        "layers": None,
        # activations
        "batch": BATCH_AXES,
        "batch_logits": BATCH_AXES,   # batch axes for the CE logits
        "seq": None,
        "heads_act": "model",
        "kv_act": "model",
        "mlp_act": "model",
        "ssm_heads": "model",
        "vocab_act": "model",
    }


_ZERO3_ACT = {"batch": ("pod", "data", "model"), "heads_act": None,
              "kv_act": None, "mlp_act": None, "ssm_heads": None}

_PRESETS: dict[str, ShardingRules] = {
    "base": ShardingRules(_weight_rules(fsdp=False), "base"),
    "fsdp": ShardingRules(_weight_rules(fsdp=True), "fsdp"),
    "ep": ShardingRules(_weight_rules(fsdp=True, expert_axis="data"), "ep"),
    "decode": ShardingRules(_weight_rules(fsdp=False), "decode"),
    "decode_sp": ShardingRules(
        {**_weight_rules(fsdp=True, expert_axis="data"),
         "seq": "data", "kv_seq": "data"},
        "decode_sp"),
    "zero3": ShardingRules({**_weight_rules(fsdp=True), **_ZERO3_ACT},
                           "zero3"),
    "zero3_ep": ShardingRules(
        {**_weight_rules(fsdp=True, expert_axis="data"), **_ZERO3_ACT},
        "zero3_ep"),
}


def preset(name: str) -> ShardingRules:
    return _PRESETS[name]


def rules_for(cfg, workload: str) -> ShardingRules:
    """The rule preset for (model config, workload), as the reference
    picks it: training uses zero3 for attention-based non-MoE archs, ep
    for MoE, base (fsdp from 4 B parameters) for SSM stacks.

    workload: "train" | "prefill" | "decode" | "decode_long"
    """
    if workload == "train":
        if cfg.moe is not None:
            return _PRESETS["ep"]
        if cfg.family in ("ssm", "hybrid"):
            if cfg.param_count_estimate() >= 4_000_000_000:
                return _PRESETS["fsdp"]
            return _PRESETS["base"]
        return _PRESETS["zero3"]
    if workload in ("decode", "prefill"):
        if cfg.moe is not None:
            return _PRESETS["ep"]
        return _PRESETS["decode"]
    if workload == "decode_long":
        return _PRESETS["decode_sp"]
    raise ValueError(f"unknown workload {workload}")


def logical_to_spec(axes: tuple[str | None, ...], rules: ShardingRules,
                    mesh) -> P:
    parts = []
    used: set[str] = set()
    for lg in axes:
        ax = rules.mesh_axes(lg, mesh)
        # a mesh axis may appear at most once in a spec
        if ax is not None:
            flat = _axes_of(ax)
            if any(a in used for a in flat):
                ax = None
            else:
                used.update(flat)
        parts.append(ax)
    return P(*parts)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _map_axes(fn, tree: PyTree) -> PyTree:
    """``fn`` over the axes tuples of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    if not _is_axes(tree):
        raise TypeError(f"not a logical-axes tuple: {tree!r}")
    return fn(tree)


def spec_tree(axes_tree: PyTree, rules: ShardingRules, mesh) -> PyTree:
    """Map a tree of logical-axes tuples to a tree of specs."""
    return _map_axes(lambda axes: logical_to_spec(axes, rules, mesh),
                     axes_tree)


def _size(mesh, entry) -> int:
    n = 1
    for a in _axes_of(entry):
        n *= mesh.shape[a]
    return n


def spec_for(shape: tuple[int, ...], axes: tuple[str | None, ...],
             rules: ShardingRules, mesh) -> P:
    """Shape-aware spec: drops axes whose dim is not divisible by the mesh
    axis product (a leaf is cut into equal shards)."""
    spec = logical_to_spec(axes, rules, mesh)
    return P(*(ax if ax is None or dim % _size(mesh, ax) == 0 else None
               for dim, ax in zip(shape, spec)))


def placements(spec: P, mesh) -> tuple:
    """The spec as one placement per mesh dim, in the mesh's axis order:
    ``Shard(d)`` where tensor dim d is cut over that axis, ``Replicate()``
    elsewhere (a dim cut over a tuple of axes gets a ``Shard`` on each)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for name in mesh.shape:
        dims = [d for d, ax in enumerate(spec) if name in _axes_of(ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_spec_tree(leaf_tree: PyTree, rules: ShardingRules,
                    mesh) -> PyTree:
    """The shape-aware spec of every leaf of a `Leaf` tree
    (`models.model.leaf_tree`)."""
    from repro_torch.models.param import tree_map

    return tree_map(lambda p: spec_for(p.shape, p.axes, rules, mesh),
                    leaf_tree)


def param_sharding_tree(leaf_tree: PyTree, rules: ShardingRules,
                        mesh) -> PyTree:
    """Per-leaf placements (shape-aware) from a `Leaf` tree."""
    from repro_torch.models.param import tree_map

    return tree_map(lambda p: placements(
        spec_for(p.shape, p.axes, rules, mesh), mesh), leaf_tree)


def named_sharding_tree(axes_tree: PyTree, rules: ShardingRules,
                        mesh) -> PyTree:
    """Per-leaf placements from a tree of logical axes (not shape-aware,
    as the reference's NamedSharding tree)."""
    return _map_axes(lambda axes: placements(
        logical_to_spec(axes, rules, mesh), mesh), axes_tree)


def constraint_spec(shape: tuple[int, ...], axes: tuple[str | None, ...],
                    rules: ShardingRules, mesh) -> P | None:
    """The reference constrainer's decision for an activation of
    ``shape`` with logical ``axes``: the spec it would impose, or None
    where it imposes nothing (an empty mesh, or a fully replicated spec).

    An axis is dropped when the dim is not divisible by the mesh-axis
    product, a tuple of axes falling back to its longest prefix that
    divides; a mesh axis freed that way goes to the "seq" dim when it
    divides it (the sequence-parallel fallback)."""
    if getattr(mesh, "empty", False):
        return None
    spec = logical_to_spec(axes, rules, mesh)
    parts: list = []
    dropped: list[str] = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            parts.append(None)
            continue
        axs = list(_axes_of(ax))
        while axs and dim % _size(mesh, tuple(axs)) != 0:
            dropped.append(axs.pop())
        parts.append(tuple(axs) if len(axs) > 1 else
                     (axs[0] if axs else None))
    for ax in dropped:
        for i, lg in enumerate(axes):
            if (lg == "seq" and parts[i] is None
                    and shape[i] % mesh.shape[ax] == 0):
                parts[i] = ax
                break
    if all(p is None for p in parts):
        return None
    return P(*parts)


def row_axes(rules: ShardingRules, mesh, batch: int) -> tuple[str, ...]:
    """The mesh axes a global batch of ``batch`` rows is cut over: the
    rules' "batch" axes present in the mesh, down to the longest prefix
    whose size divides ``batch`` (the constrainer's fallback)."""
    spec = constraint_spec((batch,), ("batch",), rules, mesh)
    return () if spec is None else _axes_of(spec[0])


#: the activation axes whose cut over "model" is activation tensor
#: parallelism
MODEL_ACT_AXES = ("heads_act", "kv_act", "mlp_act", "ssm_heads", "vocab_act")


def model_cut(rules: ShardingRules, mesh) -> int:
    """The "model" axis's size where a call under ``rules`` computes its
    part of the activations over it (the rules cut an activation axis
    over "model" and keep the batch off it; the model group's ranks then
    share their rows), else 1."""
    m = mesh.shape.get("model", 1) if mesh is not None else 1
    if m <= 1 or "model" in _axes_of(rules.mesh_axes("batch", mesh)):
        return 1
    if any(rules.mesh_axes(a, mesh) == "model" for a in MODEL_ACT_AXES):
        return m
    return 1


def split_model(spec: P) -> tuple[P, P]:
    """(the spec's "model" entries, the rest): the cut a rank uses as it is
    stored under `model_cut`, and the axes it is all-gathered over."""
    used = P(*("model" if "model" in _axes_of(e) else None for e in spec))
    rest = []
    for e in spec:
        axs = tuple(a for a in _axes_of(e) if a != "model")
        rest.append(axs if len(axs) > 1 else (axs[0] if axs else None))
    return used, P(*rest)


class Constrainer:
    """``constrain(x, logical_axes)``: the reference's in-graph activation
    hint.  The port's tensors are per-rank, so it returns ``x`` as it is;
    `constraint_spec` is the decision the reference would have imposed.
    ``rows``,
    when set (`models.model.loss_fn` sets it), names the mesh axes the
    model's batch rows are cut over on this call; ``kv_seq`` (serving,
    `serving_layout`) the axes a KV cache's slots are cut over.  ``tp``
    is `model_cut`: the "model" group's size where the call computes its
    part of the activations (and its leaves come cut as `split_model`
    says), else 1."""

    def __init__(self, rules: ShardingRules, mesh,
                 rows: tuple[str, ...] | None = None,
                 kv_seq: tuple[str, ...] = ()):
        self.rules = rules
        self.mesh = mesh
        self.rows = rows
        self.kv_seq = kv_seq
        self.tp = model_cut(rules, mesh)

    def __call__(self, x, axes):
        return x

    def cuts(self, logical: str, size: int) -> bool:
        """Whether this call computes its part of an activation axis
        ``logical`` (one of `MODEL_ACT_AXES`) of ``size``: the reference
        constrainer's decision for that dim."""
        if self.tp == 1:
            return False
        spec = constraint_spec((size,), (logical,), self.rules, self.mesh)
        return spec is not None and spec[0] == "model"

    def share_axes(self) -> tuple[str, ...]:
        """The axes whose ranks hold shares of a mean (a loss, the MoE
        auxiliary loss): every mesh axis but "model" under the cut (the
        group computes one share alike)."""
        return tuple(a for a in self.mesh.axis_names
                     if self.tp == 1 or a != "model")

    def kv_slots(self, n_kv_heads: int) -> tuple[str, ...]:
        """The axes a KV cache's slots are cut over: ``kv_seq``, and
        "model" under the cut when the kv heads do not divide it (the
        reference's fallback, its dry-run's ``cache_shardings``)."""
        if self.tp == 1 or self.cuts("kv_act", n_kv_heads):
            return self.kv_seq
        return self.mesh.canonical(self.kv_seq + ("model",))


def model_tp(constrain) -> int:
    """A constrainer's `Constrainer.tp` (1 for `no_constraint`)."""
    return getattr(constrain, "tp", 1)


def cuts(constrain, logical: str, size: int) -> bool:
    """`Constrainer.cuts` of any constrainer (False for
    `no_constraint`)."""
    return model_tp(constrain) > 1 and constrain.cuts(logical, size)


def no_constraint(x, axes):
    """The constrainer of a call without a mesh."""
    return x


def constrainer(rules: ShardingRules, mesh) -> Constrainer:
    return Constrainer(rules, mesh)


def serving_layout(rules: ShardingRules, mesh, batch: int) -> Constrainer:
    """How a serving engine's state of ``batch`` rows lies on the mesh, as
    the constrainer of its decode calls: the KV caches' slots cut over
    the rules' "kv_seq" axes present in the mesh (``decode_sp``: "data"),
    and the rows over the rules' batch axes left (`row_axes`: the
    ``decode`` and ``ep`` presets cut them over "data")."""
    kv = _axes_of(rules.mesh_axes("kv_seq", mesh))
    kv = tuple(a for a in mesh.shape if a in kv and mesh.shape[a] > 1)
    rows = tuple(a for a in row_axes(rules, mesh, batch) if a not in kv)
    return Constrainer(rules, mesh, rows=rows, kv_seq=kv)


def prefill_layout(rules: ShardingRules, mesh, batch: int | None,
                   kv_seq: tuple[str, ...] | None = None) -> Constrainer:
    """How a prefill of ``batch`` rows lies on the mesh, as the
    constrainer of its call: the KV caches' slots cut over ``kv_seq``
    (`serving_layout`'s when None), and the rows over the rules' batch
    axes left -- all of them or none, as the reference's dry-run lowers
    its prefill (``batch_shardings_for``: the batch over ("pod", "data")
    when their product, above 1, divides it, else whole).  Where the
    product does not divide ``batch`` this keeps every row on every rank,
    while `serving_layout` cuts them over the longest prefix that divides
    (`row_axes`: 4 rows on pod 2 × data 4 go over "pod" there); the
    prefill follows the reference.  ``batch`` None or 1 keeps every row
    (the engine's prefill of one request); so does ``decode_sp`` on a
    mesh without "pod", its batch axis being its slots'."""
    if kv_seq is None:
        kv_seq = serving_layout(rules, mesh, batch or 1).kv_seq
    axes = tuple(a for a in _axes_of(rules.mesh_axes("batch", mesh))
                 if a not in kv_seq)
    n = _size(mesh, axes)
    rows = axes if batch is not None and n > 1 and batch % n == 0 else ()
    return Constrainer(rules, mesh, rows=rows, kv_seq=tuple(kv_seq))


def layout_rows(constrain, mesh) -> tuple[str, ...]:
    """The axes a model call's rows are cut over: the constrainer's
    ``rows``, else the batch axes ("pod", "data") present in the mesh
    (the reference's shard_map regions take their batch over those)."""
    rows = getattr(constrain, "rows", None)
    return default_rows(mesh) if rows is None else rows


def default_rows(mesh) -> tuple[str, ...]:
    """The batch axes ("pod", "data") present in the mesh."""
    return tuple(a for a in BATCH_AXES if a in mesh.shape)


def batch_spec(mesh, *extra: str | None) -> P:
    """Spec for (batch, *extra) arrays: batch over ("pod","data")."""
    present = tuple(a for a in BATCH_AXES if a in mesh.shape)
    return P(present if present else None, *extra)


__all__ = ["P", "ShardingRules", "BATCH_AXES", "preset", "rules_for",
           "logical_to_spec", "spec_tree", "spec_for", "placements",
           "param_spec_tree", "param_sharding_tree", "named_sharding_tree",
           "constraint_spec", "row_axes", "serving_layout", "prefill_layout",
           "Constrainer",
           "constrainer", "model_cut", "split_model", "model_tp", "cuts",
           "MODEL_ACT_AXES",
           "no_constraint", "layout_rows", "default_rows", "batch_spec"]
