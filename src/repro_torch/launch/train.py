"""Training launcher, fixed mode on one device.

The port of the JAX package's ``launch/train.py`` fixed mode: build the
state -> step loop over the synthetic pipeline's batches -> asynchronous
checkpoints.  It runs on cuda unless ``device="cpu"`` (``--device cpu``),
where every kernel runs its plain version.  On cuda, the forward and
backward of attention, the SSD scan and the grouped matmul are the
port's kernels, so every family trains there: the dense models, mamba2,
and the MoE models (jamba, the llama4 models).  One H100 holds jamba's
training state (AdamW) only at reduced widths, and attention's kernel
takes head dims 32, 64 and 128, not `reduced_config`'s 16: chip_smoke.py
trains the reduced jamba on the card with its head dim raised to 32.

`run_fixed` can also resume: ``resume_from=n`` restores the committed
checkpoint of step n into the freshly built state and runs the steps
after it, regenerating the same batches (batch i is a pure function of
the seed and i).

Inside a `torch.distributed` world of more than one rank (torchrun, or
`launch.mesh.init_world`), `run_fixed` trains on the mesh
``make_worker_mesh(world, model_parallel)`` ("data" x "model") with the
sharded step (`train.train_step`, the training preset's rules): every
rank draws the same weights from the seed and keeps its shards, draws the
same global batches and computes its own rows.  Checkpoints are the
one-device manager's format, written by rank 0 from the gathered state,
so a one-device run can resume them; resuming onto a mesh is restoring
onto another mesh (ROADMAP Queue 1 item 13) and raises, as does the
provisioner-managed elastic mode (``--elastic``, item 13).
``--model-parallel`` > 1 outside a world raises.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 6 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --steps 6 --batch 8 --seq 512
  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-v0.1-52b \\
      --reduced --device cpu --steps 4 --batch 2 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --reduced --device cpu --steps 4 --batch 2 --seq 32
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch qwen2-1.5b --reduced --device cpu --backend gloo \\
      --model-parallel 2 --steps 4 --batch 8 --seq 32
"""
from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import (
    SyntheticTokenPipeline, stub_modality_inputs,
)
from repro_torch.kernels.build import BUILD_DIR
from repro_torch.launch.mesh import init_world, make_worker_mesh
from repro_torch.models import model as model_lib
from repro_torch.parallel.collectives import assert_replicated
from repro_torch.parallel.sharding import rules_for
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import (
    TrainState, gather_state, init_train_state, make_train_step,
    param_specs, shard_params,
)

#: where checkpoints go unless the caller names a directory: inside the
#: checkout, beside the built kernels (ignored by git)
DEFAULT_CKPT_DIR = str(BUILD_DIR / "ckpt")


def build_state(cfg, opt_cfg, *, seed=0, device=None) -> TrainState:
    """Random parameters from ``seed`` (`init_model`), fresh AdamW
    state, step 0."""
    dev = model_lib.resolve_device(device)
    params = model_lib.init_model(cfg, seed=seed, device=dev)
    return init_train_state(params, opt_cfg)


def make_batch(cfg, pipe, step, batch, device) -> dict:
    b = pipe.torch_batch_at(step, device)
    for k, v in stub_modality_inputs(cfg, batch).items():
        b[k] = torch.from_numpy(v).to(device)
    return b


def _checkpointed(state: TrainState) -> dict:
    return {"params": state.params, "opt": state.opt, "step": state.step}


def run_fixed(cfg, *, steps, batch, seq, ckpt_dir, device=None,
              model_parallel=1, log_every=10, ckpt_every=20,
              resume_from=None, on_step=None, on_resume=None):
    """Trains ``steps`` steps (from ``resume_from`` when given) and
    returns the logged losses.  ``on_step(i, state, metrics, seconds)``,
    when given, is called after each step with the host time of the
    step, its batch included, ending in a synchronise of the device.
    ``on_resume(state)``, when given, is called with the restored state
    before the first resumed step.  In a world of several ranks it runs
    sharded (see the module docstring; ``device`` is the rank's), and
    only rank 0 logs and writes checkpoints."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model_parallel != 1 and world == 1:
        raise RuntimeError(
            "run_fixed: --model-parallel > 1 needs a torch.distributed "
            "world of several ranks (run under torchrun)")
    dev = model_lib.resolve_device(device)
    opt_cfg = OptimizerConfig(state_dtype=cfg.optimizer_state_dtype,
                              lr=1e-3)
    lr_kwargs = dict(peak=1e-3, warmup_steps=10, total_steps=steps)
    mesh = None
    rank0 = True
    if world > 1:
        if resume_from is not None:
            raise NotImplementedError(
                "run_fixed: resuming onto a mesh restores onto another "
                "mesh, which is not ported yet (ROADMAP Queue 1 item 13)")
        mesh = make_worker_mesh(model_parallel=model_parallel, device=dev)
        params = model_lib.init_model(cfg, device=dev)
        assert_replicated(params, mesh, "the drawn weights")
        rules = rules_for(cfg, "train")
        specs = param_specs(cfg, rules, mesh)
        state = init_train_state(shard_params(params, specs, mesh), opt_cfg)
        del params
        step_fn = make_train_step(cfg, opt_cfg, mesh, rules, remat="none",
                                  lr_kwargs=lr_kwargs)
        rank0 = mesh.rank == 0
    else:
        state = build_state(cfg, opt_cfg, device=dev)
        step_fn = make_train_step(cfg, opt_cfg, remat="none", device=dev,
                                  lr_kwargs=lr_kwargs)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, seq, batch)
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir and rank0 else None
    start = 0
    if resume_from is not None:
        if mgr is None:
            raise ValueError("run_fixed: resume_from needs a ckpt_dir")
        restored = mgr.restore(resume_from, _checkpointed(state), device=dev)
        state = TrainState(params=restored["params"], opt=restored["opt"],
                           step=restored["step"])
        start = int(state.step)
        if on_resume is not None:
            on_resume(state)

    losses = []
    t0 = time.time()
    for i in range(start, steps):
        t_step = time.perf_counter()
        b = make_batch(cfg, pipe, i, batch, dev)
        state, metrics = step_fn(state, b)
        if on_step is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            on_step(i, state, metrics, time.perf_counter() - t_step)
        if i % log_every == 0 or i == steps - 1:
            loss = float(metrics["loss"])
            losses.append(loss)
            if rank0:
                print(f"step {i:4d} loss {loss:8.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):.2f} "
                      f"({(time.time()-t0):.1f}s)", flush=True)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            whole = state if mesh is None else gather_state(state, specs,
                                                            mesh)
            if mgr:
                mgr.save(i + 1, _checkpointed(whole))
    if mgr:
        mgr.wait()
    return losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--elastic", action="store_true")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="the torch.distributed backend, needed under "
                         "torchrun")
    args = ap.parse_args(argv)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.elastic:
        raise NotImplementedError(
            "--elastic (provisioner-managed training with reshard-on-"
            "restore) is not ported yet (ROADMAP Queue 1 item 13)")
    device = args.device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        if args.backend is None:
            raise SystemExit("under torchrun, pass --backend gloo or nccl")
        device = init_world(args.backend, device=device)
    try:
        return run_fixed(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, ckpt_dir=args.ckpt_dir, device=device,
                         model_parallel=args.model_parallel)
    finally:
        if dist.is_initialized() and device is not args.device:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
