"""The training step: loss -> gradients -> AdamW.

The port of the JAX package's ``train/train_step.py`` on one device.
``make_train_step`` builds a function over (TrainState, batch) that
differentiates `models.model.loss_fn` with autograd, applies the
learning-rate schedule and `adamw_update`, and returns the new state and
the reference's metrics (the loss's, then ``grad_norm``, ``clip_factor``
and ``lr``).

Microbatch accumulation: ``accum_steps > 1`` splits the batch on its
leading axis and sums the microbatches' gradients in float32, then
averages them and the metrics (``tokens`` is summed), as the reference's
``lax.scan`` does.

With a ``mesh`` (`launch.mesh.WorkerMesh`, one rank per coordinate)
and sharding ``rules`` the step is sharded ZeRO-style: each rank's state
holds its shard of every parameter and moment (`param_specs`,
`shard_state`).  The step all-gathers the parameters -- over every axis
where the rules keep activations uncut over "model" (zero3), over every
axis but "model" where they cut them (base, fsdp, ep:
`parallel.sharding.model_cut`; the rank then computes its part of the
heads, MLP columns, SSM heads and vocabulary with its "model" cut as
stored, `models.model.model_specs`) -- computes the loss of its own rows
of the global batch (every rank passes the same batch;
`models.model.loss_fn` under a mesh, where attention is
sequence-parallel and the MoE layers expert-parallel as the reference
selects), sums the gradients in float32 over the axes of the ranks that
hold shares of the loss (`parallel.collectives.psum`: the mesh, or the
mesh but "model" under the cut, where a "model" group computes its
share alike and a replicated leaf's gradient is already whole on each of
its ranks), keeps its shard of the sum, and updates that shard with the
whole tree's clip factor.  With ``grad_compression="int8"`` (the
reference's; its presets only: base/ep/decode, on a mesh with a
"pod" axis) the loss is a mean within each pod, the gradients are summed
exactly within the pod and then re-reduced over "pod" as an
int8-compressed mean (`parallel.collectives.compressed_psum`, leaf i of
step t rounding from (17, t + i)), and the metrics are the pods' mean.
Compression does not compose with the expert-parallel MoE layer (its
auxiliary loss is a mean over every rank), so MoE configs refuse it.
`state_shardings`, `batch_shardings` and `train_batch_specs` are the
reference's helpers, as placements.

The step's phases run under the program spans ``"forward"``,
``"backward"`` and ``"optimizer"`` (`observability.steps.span`, with the
model's sublayer spans inside the forward and ``"optimizer.norm"``
inside the optimizer).  A span enters `torch.profiler.record_function`
only while a profiler collects; otherwise it is one call and one test,
about 0.5 us of host time (a step of mamba2-1.3b opens 344 spans).  On
an H100 that step's untraced throughput with the spans stayed within its
run-to-run spread (10,323 against 10,337 tokens/s, medians of six runs
each); under the profiler a span costs about 12 us of host time.  The
backward's kernels are launched by autograd's device thread while the
main thread waits in ``torch.autograd.grad`` under ``"backward"``.
With a ``timer`` (`observability.steps.StepTimer`) the step marks its
phase boundaries (entry, each microbatch's forward and backward, the
optimizer, the end) with a CUDA event and a host stamp each; without one
it tests ``timer is not None`` once a boundary.

The state's parameters are updated in place (see `adamw_update`): the
step returns a new `TrainState` around the same parameter and moment
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.data.pipeline import make_batch_specs
from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import tree_leaves, tree_map
from repro_torch.observability.steps import StepTimer, span
from repro_torch.parallel.collectives import (
    compressed_psum, psum, rng_seed, shard_of, unshard,
)
from repro_torch.parallel.sharding import (
    P, ShardingRules, constrainer, model_cut, param_sharding_tree,
    param_spec_tree, placements, rules_for, split_model,
)
from repro_torch.train.optimizer import (
    OptimizerConfig, adamw_init, adamw_update,
)
from repro_torch.train.schedule import lr_schedule

PyTree = Any
METRICS = ("loss", "ce", "z_loss", "moe_aux", "tokens")


@dataclasses.dataclass
class TrainState:
    """Parameters, optimizer state and the int32 step (0-d, on the
    parameters' device).  The reference's ``rng`` key is left out: the
    model draws nothing from it."""
    params: PyTree
    opt: PyTree
    step: torch.Tensor


def init_train_state(params: PyTree, opt_cfg: OptimizerConfig
                     ) -> TrainState:
    device = tree_leaves(params)[0].device
    return TrainState(params=params, opt=adamw_init(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _value_and_grad(loss_for_batch, params: PyTree, batch: dict,
                    timer: StepTimer | None = None, device=None):
    """(metrics, gradients in the parameters' dtypes): the parameters are
    differentiated through detached views that require grad, so the
    state's tensors never do.  A ``timer`` is marked at the forward's
    and the backward's start."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        if timer is not None:
            timer.mark("forward", device)
        with span("forward"):
            loss, metrics = loss_for_batch(leaves, batch)
        if timer is not None:
            timer.mark("backward", device)
        with span("backward"):
            grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    mesh=None,
    rules: ShardingRules | None = None,
    *,
    accum_steps: int = 1,
    remat: str = "full",
    grad_compression: str | None = None,
    lr_kwargs: dict | None = None,
    unroll: bool = False,
    device: str | torch.device | None = None,
    timer: StepTimer | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """The step: for one device (cuda unless ``device`` says otherwise;
    the batch is moved there), or, with a ``mesh``, for this rank
    (``rules`` default to `rules_for(cfg, "train")`; the state holds this
    rank's shards, see the module docstring; the parameters' logical
    axes, the reference's ``param_axes``, come from ``cfg``).  A
    ``timer`` is marked at every phase boundary of every step."""
    dev = model_lib.resolve_device(device if mesh is None else mesh.device)
    lr_kwargs = lr_kwargs or {}
    if grad_compression not in (None, "int8"):
        raise ValueError(f"unknown grad_compression {grad_compression!r}")
    if grad_compression is not None and (mesh is None
                                         or "pod" not in mesh.shape):
        raise NotImplementedError(
            "make_train_step: grad_compression re-reduces over a mesh's "
            "\"pod\" axis, and this step has none")
    rules = rules or (rules_for(cfg, "train") if mesh is not None else None)
    if grad_compression is not None:
        if rules.name not in ("base", "ep", "decode"):
            raise ValueError(
                "int8 grad compression composes with the TP presets "
                "(base/ep), as in the reference")
        if cfg.moe is not None:
            raise ValueError(
                "int8 grad compression does not compose with the "
                "expert-parallel MoE layer")
    mean_axes = None
    if mesh is not None:
        specs = param_specs(cfg, rules, mesh)
        # the axes a leaf is gathered over: under the "model" cut its
        # "model" part is used as stored
        tp = model_cut(rules, mesh)
        gathered = tree_map(lambda s: split_model(s)[1] if tp > 1 else s,
                            specs)
        constrain = constrainer(rules, mesh)
        mean_axes = tuple(a for a in mesh.axis_names
                          if a != "pod" or grad_compression is None)
        sum_axes = tuple(a for a in mean_axes if a != "model" or tp == 1)

    def loss_for_batch(params, batch):
        if mesh is None:
            return model_lib.loss_fn(params, cfg, batch, remat=remat,
                                     unroll=unroll)
        return model_lib.loss_fn(params, cfg, batch, mesh=mesh,
                                 constrain=constrain, remat=remat,
                                 unroll=unroll, mean_axes=mean_axes)

    def compute_grads(params, batch):
        if accum_steps == 1:
            metrics, grads = _value_and_grad(loss_for_batch, params, batch,
                                             timer, dev)
            return grads, metrics
        b = next(iter(batch.values())).shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} is not a multiple of accum_steps "
                             f"{accum_steps}")
        g_acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        m_acc = {k: torch.zeros((), dtype=torch.float32, device=dev)
                 for k in METRICS}
        for mb in range(accum_steps):
            micro = {k: v.reshape(accum_steps, b // accum_steps,
                                  *v.shape[1:])[mb]
                     for k, v in batch.items()}
            metrics, g = _value_and_grad(loss_for_batch, params, micro,
                                         timer, dev)
            for a, gl in zip(tree_leaves(g_acc), tree_leaves(g)):
                a.add_(gl.float())
            m_acc = {k: m_acc[k] + metrics[k] for k in METRICS}
        inv = 1.0 / accum_steps
        for a in tree_leaves(g_acc):
            a.mul_(inv)
        return g_acc, {k: v * inv if k != "tokens" else v
                       for k, v in m_acc.items()}

    def sharded_grads(state, batch):
        """The parameters as the forward uses them in (gathered over
        ``gathered``'s axes), this rank's shard of the reduced gradient
        out."""
        full = tree_map(lambda t, s: unshard(t, s, mesh), state.params,
                        gathered)
        grads, metrics = compute_grads(full, batch)
        del full
        grads = tree_map(
            lambda g, s: shard_of(psum(g.float(), mesh, sum_axes), s,
                                  mesh).clone(), grads, gathered)
        if grad_compression is not None:
            step = int(state.step)
            it = iter([compressed_psum(g, mesh, ("pod",),
                                       rng_seed(17, step + i))
                       for i, g in enumerate(tree_leaves(grads))])
            grads = tree_map(lambda _: next(it), grads)
            metrics = {k: psum(v, mesh, ("pod",)) / mesh.shape["pod"]
                       for k, v in metrics.items()}
        return grads, metrics

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        if timer is not None:
            timer.mark("entry", dev)
        batch = {k: v.to(dev) for k, v in batch.items()}
        if mesh is None:
            grads, metrics = compute_grads(state.params, batch)
        else:
            grads, metrics = sharded_grads(state, batch)
        lr = lr_schedule(state.step, **lr_kwargs)
        if timer is not None:
            timer.mark("optimizer", dev)
        with span("optimizer"):
            new_params, new_opt, opt_metrics = adamw_update(
                state.params, grads, state.opt, opt_cfg, lr, mesh=mesh,
                specs=None if mesh is None else specs)
        if timer is not None:
            timer.mark("end", dev)
        metrics = {**metrics, **opt_metrics, "lr": lr}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1), metrics

    return train_step


# ---------------------------------------------------------------------------
# Shards of the state
# ---------------------------------------------------------------------------

def param_specs(cfg: ModelConfig, rules: ShardingRules, mesh) -> PyTree:
    """The shape-aware spec of every parameter (`spec_for` of its full
    shape and logical axes)."""
    return param_spec_tree(model_lib.leaf_tree(cfg), rules, mesh)


def _state_map(fn, state: TrainState, specs: PyTree) -> TrainState:
    return TrainState(
        params=tree_map(fn, state.params, specs),
        opt={"mu": tree_map(fn, state.opt["mu"], specs),
             "nu": tree_map(fn, state.opt["nu"], specs),
             "count": state.opt["count"]},
        step=state.step)


def shard_params(params: PyTree, specs: PyTree, mesh) -> PyTree:
    """This rank's shards (copies) of whole parameters (make the state
    from them with `init_train_state`: its moments are then shards
    too)."""
    return tree_map(lambda t, s: shard_of(t, s, mesh).clone(), params,
                    specs)


def shard_state(state: TrainState, specs: PyTree, mesh) -> TrainState:
    """This rank's shards (copies) of a whole state."""
    return _state_map(lambda t, s: shard_of(t, s, mesh).clone(), state,
                      specs)


def gather_state(state: TrainState, specs: PyTree, mesh) -> TrainState:
    """The whole state from every rank's shards (on every rank)."""
    return _state_map(lambda t, s: unshard(t, s, mesh), state, specs)


def state_shardings(leaf_tree: PyTree, rules: ShardingRules,
                    mesh) -> TrainState:
    """Placements matching TrainState(params, opt, step), from the tree
    of `Leaf`s (`models.model.leaf_tree`; shape-aware specs)."""
    p_sh = param_sharding_tree(leaf_tree, rules, mesh)
    rep = placements(P(), mesh)
    return TrainState(params=p_sh, opt={"mu": p_sh, "nu": p_sh,
                                        "count": rep}, step=rep)


def batch_shardings(batch_spec_tree: dict, mesh) -> dict:
    return {k: placements(spec, mesh) for k, spec in batch_spec_tree.items()}


def train_batch_specs(cfg: ModelConfig, mesh) -> dict:
    return make_batch_specs(cfg, mesh)


__all__ = ["TrainState", "init_train_state", "make_train_step",
           "param_specs", "shard_params", "shard_state", "gather_state", "state_shardings",
           "batch_shardings", "train_batch_specs"]
