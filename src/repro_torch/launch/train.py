"""Training launcher: fixed mode, or provisioner-managed (elastic) mode.

The port of the JAX package's ``launch/train.py``.  Fixed mode builds
the state -> step loop over the synthetic pipeline's batches ->
asynchronous checkpoints.  It runs on cuda unless ``device="cpu"``
(``--device cpu``), where every kernel runs its plain version.  On cuda,
the forward and backward of attention, the SSD scan and the grouped
matmul are the port's kernels, so every family trains there: the dense
models, mamba2, and the MoE models (jamba, the llama4 models).  One H100
holds jamba's training state (AdamW) only at reduced widths, and
attention's kernel takes head dims 32, 64 and 128, not `reduced_config`'s
16: chip_smoke.py trains the reduced jamba on the card with its head dim
raised to 32.

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
so a one-device run can resume them, and a resume in a world restores a
step onto the mesh (each rank reads its shards: reshard-on-restore).
``--model-parallel`` > 1 outside a world raises.

Elastic mode (`run_elastic`, ``--elastic``) is the paper's technique
applied to SPMD training, as in the reference: the job advertises one
work unit a data-parallel shard to the JobQueue, the Provisioner scales
a pool of workers (the world's ranks stand in for pod slices; on one
process, the one device), and at every rescale the run checkpoints from
the old mesh, builds a mesh over the claimed workers and restores the
state onto it.  Rank 0 runs the control plane and broadcasts the usable
worker count each tick, so the ranks never disagree; ranks outside the
mesh skip the step and keep ticking.

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
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b \\
      --reduced --device cpu --elastic --steps 60
  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train \\
      --arch qwen2-1.5b --reduced --device cpu --backend gloo --elastic \\
      --steps 40 --batch 8 --seq 64
"""
from __future__ import annotations

import argparse
import dataclasses
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
from repro_torch.models.param import Leaf, torch_dtype, tree_map
from repro_torch.parallel.collectives import assert_replicated
from repro_torch.parallel.sharding import P, rules_for
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


def _on_mesh(cfg, opt_cfg, specs, *, with_step: bool = True
             ) -> tuple[dict, dict]:
    """(target, shardings) that restore a checkpointed state onto a mesh
    (this rank's shards under ``specs``; on one device the target alone
    serves): each leaf's whole shape and dtype (`models.model.leaf_tree`,
    AdamW's state dtypes for the moments), and the specs."""
    params = model_lib.leaf_tree(cfg)
    mu = torch_dtype(opt_cfg.state_dtype)
    nu = torch.float32 if opt_cfg.keep_nu_fp32 else mu
    scalar = Leaf((), (), torch.int32)
    target = {"params": params, "opt": {
        "mu": tree_map(lambda p: dataclasses.replace(p, dtype=mu), params),
        "nu": tree_map(lambda p: dataclasses.replace(p, dtype=nu), params),
        "count": scalar}}
    shardings = {"params": specs, "opt": {"mu": specs, "nu": specs,
                                          "count": P()}}
    if with_step:
        target["step"], shardings["step"] = scalar, P()
    return target, shardings


def _sharded_state(cfg, opt_cfg, mesh, specs) -> TrainState:
    """A world's first state: every rank draws the same weights from the
    seed and keeps its shards."""
    params = model_lib.init_model(cfg, device=mesh.device)
    assert_replicated(params, mesh, "the drawn weights")
    state = init_train_state(shard_params(params, specs, mesh), opt_cfg)
    del params
    return state


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
        mesh = make_worker_mesh(model_parallel=model_parallel, device=dev)
        rules = rules_for(cfg, "train")
        specs = param_specs(cfg, rules, mesh)
        state = _sharded_state(cfg, opt_cfg, mesh, specs)
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
        if not ckpt_dir:
            raise ValueError("run_fixed: resume_from needs a ckpt_dir")
        reader = mgr or CheckpointManager(ckpt_dir)
        if mesh is None:
            restored = reader.restore(resume_from, _checkpointed(state),
                                      device=dev)
        else:
            restored = reader.restore(resume_from,
                                      *_on_mesh(cfg, opt_cfg, specs),
                                      mesh=mesh)
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


def _from_rank0(values, dtype, device) -> list:
    """``values`` as rank 0 holds them, on every rank of the world (a
    broadcast; the values themselves outside a world)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return list(values)
    t = torch.tensor(values, dtype=dtype, device=device)
    dist.broadcast(t, src=0)
    return t.tolist()


def run_elastic(cfg, *, steps, batch, seq, ckpt_dir, log_every=10,
                device=None, on_step=None, on_rescale=None):
    """Provisioner-managed training: the worker pool's size follows
    demand, and the run rescales at checkpoint boundaries with state
    resharding (see the module docstring).  The pool is the world's
    ranks (one device outside a world).  Returns the logged losses, on
    every rank.

    ``on_step(i, state, metrics, seconds)`` is called on the mesh's
    ranks after each step (its host time, batch included, ending in a
    synchronise of the device); ``on_rescale(event)`` on every rank
    after each rescale, with the step, the worker counts, the mesh
    (None on one device), the specs and the save and restore seconds."""
    from repro_torch.core import (
        Collector, Job, JobQueue, KubeCluster, Provisioner,
        ProvisionerConfig, onprem_nodes,
    )

    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if world > 1 else 0
    dev = model_lib.resolve_device(device)
    n_dev = world
    if rank == 0:                                   # the control plane
        queue, collector = JobQueue(), Collector()
        cluster = KubeCluster(onprem_nodes(1, gpus=n_dev, cpus=64))
        pcfg = ProvisionerConfig(submit_interval_s=1, idle_timeout_s=30,
                                 startup_delay_s=0, job_filter="")
        prov = Provisioner(pcfg, queue, collector, cluster)

    # the training job advertises one work unit per desired DP shard
    demand_schedule = {0: max(1, n_dev // 2), steps // 2: n_dev}
    opt_cfg = OptimizerConfig(state_dtype=cfg.optimizer_state_dtype, lr=1e-3)
    lr_kwargs = dict(peak=1e-3, warmup_steps=10, total_steps=steps)
    mgr = CheckpointManager(ckpt_dir, async_mode=False)
    pipe = SyntheticTokenPipeline(cfg.vocab_size, seq, batch)
    rules = rules_for(cfg, "train")

    now = 0.0
    active_workers = 0
    state = mesh = specs = step_fn = None
    losses = []

    def want_workers(i):
        w = 1
        for at, n in demand_schedule.items():
            if i >= at:
                w = n
        return w

    def inside(m):
        return m is None or m.inside

    i = 0
    while i < steps:
        usable = n_claimed = 0
        if rank == 0:
            # --- control plane tick: jobs express demand, provisioner
            # scales
            target = want_workers(i)
            idle_or_running = queue.n_idle() + queue.n_running()
            for _ in range(max(0, target - idle_or_running)):
                queue.submit(Job(ad={"request_gpus": 1, "arch": cfg.name},
                                 runtime_s=1e9), now)
            prov.maybe_reconcile(now)
            cluster.schedule(now)
            collector.run_cycle(queue, now)
            n_claimed = sum(1 for w in collector.workers.values()
                            if w.claimed)
            # --- rescale boundary: mesh follows the claimed-worker count
            usable = (max(1, 1 << (n_claimed.bit_length() - 1))
                      if n_claimed else 0)
            usable = min(usable, n_dev)
        now += 2.0
        usable, n_claimed = _from_rank0([usable, n_claimed], torch.int64,
                                        dev)

        if usable and usable != active_workers:
            if rank == 0:
                print(f"[elastic] rescale: {active_workers} -> {usable} "
                      f"workers (claimed={n_claimed})", flush=True)
            save_s = restore_s = 0.0
            restoring = active_workers > 0
            if restoring:
                # checkpoint from the old mesh (rank 0 writes the gathered
                # state), then restore onto the new one (resharding)
                t0 = time.perf_counter()
                if state is not None:
                    whole = (state if mesh is None
                             else gather_state(state, specs, mesh))
                    if rank == 0:
                        mgr.save(i, {"params": whole.params,
                                     "opt": whole.opt}, blocking=True)
                    del whole
                state = None
                if world > 1:
                    dist.barrier()
                save_s = time.perf_counter() - t0
            mesh = make_worker_mesh(usable, device=dev) if world > 1 else None
            specs = (param_specs(cfg, rules, mesh) if mesh is not None
                     else None)
            step_fn = None
            if inside(mesh):
                t0 = time.perf_counter()
                if not restoring:
                    state = (build_state(cfg, opt_cfg, device=dev)
                             if mesh is None else
                             _sharded_state(cfg, opt_cfg, mesh, specs))
                else:
                    target, shardings = _on_mesh(cfg, opt_cfg, specs,
                                                 with_step=False)
                    restored = mgr.restore(
                        i, target, None if mesh is None else shardings,
                        mesh=mesh, device=dev)
                    state = TrainState(
                        params=restored["params"], opt=restored["opt"],
                        step=torch.tensor(i, dtype=torch.int32, device=dev))
                    restore_s = time.perf_counter() - t0
                step_fn = make_train_step(cfg, opt_cfg, mesh, rules,
                                          remat="none", device=dev,
                                          lr_kwargs=lr_kwargs)
            if on_rescale is not None:
                on_rescale({"step": i, "from": active_workers,
                            "to": usable, "claimed": n_claimed,
                            "mesh": mesh, "specs": specs, "save_s": save_s,
                            "restore_s": restore_s})
            active_workers = usable

        if not active_workers:
            continue

        # --- one training step on the current mesh (its ranks)
        loss = 0.0
        if step_fn is not None:
            t_step = time.perf_counter()
            b = make_batch(cfg, pipe, i, batch, dev)
            state, metrics = step_fn(state, b)
            if on_step is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                on_step(i, state, metrics, time.perf_counter() - t_step)
        if i % log_every == 0 or i == steps - 1:
            if rank == 0:
                loss = float(metrics["loss"])
            loss, = _from_rank0([loss], torch.float64, dev)
            losses.append(loss)
            if rank == 0:
                print(f"step {i:4d} loss {loss:8.4f} "
                      f"workers={active_workers}", flush=True)
        i += 1
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
    device = args.device
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and not dist.is_initialized():
        if args.backend is None:
            raise SystemExit("under torchrun, pass --backend gloo or nccl")
        device = init_world(args.backend, device=device)
    try:
        if args.elastic:
            return run_elastic(cfg, steps=args.steps, batch=args.batch,
                               seq=args.seq, ckpt_dir=args.ckpt_dir,
                               device=device)
        return run_fixed(cfg, steps=args.steps, batch=args.batch,
                         seq=args.seq, ckpt_dir=args.ckpt_dir, device=device,
                         model_parallel=args.model_parallel)
    finally:
        if dist.is_initialized() and device is not args.device:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
