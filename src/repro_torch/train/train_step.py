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

Gradient compression (the reference's ``grad_compression="int8"``, a
re-reduction over a mesh's ``"pod"`` axis) and the sharding helpers
(``state_shardings``, ``batch_shardings``, ``train_batch_specs``) belong
to the multi-device work (ROADMAP Queue 1 item 14): asking for
compression raises.

The step's forward and its optimizer run under the profiler labels
``"forward"`` and ``"optimizer"`` (`torch.profiler.record_function`,
which costs nothing when no profiler runs).  The backward runs on
autograd's device thread, outside the main thread's labels.

The state's parameters are updated in place (see `adamw_update`): the
step returns a new `TrainState` around the same parameter and moment
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.profiler import record_function

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import tree_leaves, tree_map
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


def _value_and_grad(loss_for_batch, params: PyTree, batch: dict):
    """(metrics, gradients in the parameters' dtypes): the parameters are
    differentiated through detached views that require grad, so the
    state's tensors never do."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(), params)
    with torch.enable_grad():
        with record_function("forward"):
            loss, metrics = loss_for_batch(leaves, batch)
        grads = torch.autograd.grad(loss, tree_leaves(leaves))
    it = iter(grads)
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), params))


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: OptimizerConfig,
    *,
    accum_steps: int = 1,
    remat: str = "full",
    grad_compression: str | None = None,
    lr_kwargs: dict | None = None,
    device: str | torch.device | None = None,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """The step for one device (cuda unless ``device`` says otherwise;
    the batch is moved there)."""
    dev = model_lib.resolve_device(device)
    lr_kwargs = lr_kwargs or {}
    if grad_compression is not None:
        raise NotImplementedError(
            f"make_train_step: grad_compression={grad_compression!r} "
            "re-reduces over a mesh's \"pod\" axis, which is not ported "
            "yet (ROADMAP Queue 1 item 14)")

    def loss_for_batch(params, batch):
        return model_lib.loss_fn(params, cfg, batch, remat=remat)

    def compute_grads(params, batch):
        if accum_steps == 1:
            metrics, grads = _value_and_grad(loss_for_batch, params, batch)
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
            metrics, g = _value_and_grad(loss_for_batch, params, micro)
            for a, gl in zip(tree_leaves(g_acc), tree_leaves(g)):
                a.add_(gl.float())
            m_acc = {k: m_acc[k] + metrics[k] for k in METRICS}
        inv = 1.0 / accum_steps
        for a in tree_leaves(g_acc):
            a.mul_(inv)
        return g_acc, {k: v * inv if k != "tokens" else v
                       for k, v in m_acc.items()}

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        batch = {k: v.to(dev) for k, v in batch.items()}
        grads, metrics = compute_grads(state.params, batch)
        lr = lr_schedule(state.step, **lr_kwargs)
        with record_function("optimizer"):
            new_params, new_opt, opt_metrics = adamw_update(
                state.params, grads, state.opt, opt_cfg, lr)
        metrics = {**metrics, **opt_metrics, "lr": lr}
        return TrainState(params=new_params, opt=new_opt,
                          step=state.step + 1), metrics

    return train_step


__all__ = ["TrainState", "init_train_state", "make_train_step"]
