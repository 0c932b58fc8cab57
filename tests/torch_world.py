"""Rank bodies of the gloo worlds that tests/test_torch_parallel.py,
tests/test_torch_multidevice.py and tests/test_torch_elastic.py spawn
(`repro_torch.launch.mesh.spawn_world`: one process and one torch thread
a rank, on the CPU).

The ``spawn`` start method imports this module in every rank, so it
imports torch and the port only: the JAX package runs in the pytest
process, and arrays cross over as numpy.  Each body returns a dict of
numpy arrays and floats per rank."""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.configs import reduced_config
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.models import model as model_lib
from repro_torch.models import moe as moe_mod
from repro_torch.models.param import (
    Leaf, params_from_reference, tree_leaves, tree_map,
)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (
    constrainer, default_rows, model_cut, preset, rules_for,
)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.train_step import (
    gather_state, init_train_state, make_train_step, param_specs, shard_state,
)

#: the learning-rate schedule of the step comparisons (no warmup: the
#: first step moves every parameter)
LR_KWARGS = dict(peak=1e-3, warmup_steps=0, total_steps=10)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


def _paths(tree: dict, pre: str = "") -> list[str]:
    """The dotted paths of a tree's leaves, in `tree_leaves` order."""
    out = []
    for k, v in tree.items():
        out += _paths(v, f"{pre}{k}.") if isinstance(v, dict) else [pre + k]
    return out


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in b.items()}


def with_moe(cfg, n_experts: int, capacity_factor: float, **changes):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=n_experts, capacity_factor=capacity_factor,
        **changes))


def sp_config():
    """granite reduced to 6 query heads, 2 kv heads, head dim 16: 6 heads
    do not divide a "model" axis of 4, so attention is
    sequence-parallel."""
    return dataclasses.replace(reduced_config("granite-8b"), n_heads=6,
                               n_kv_heads=2, d_head=16)


# ---------------------------------------------------------------------------
# tests/test_torch_parallel.py
# ---------------------------------------------------------------------------

EP_LAYOUTS = {
    # name: (mesh, rows the layer's tokens are cut over; None = default)
    "ep": ({"data": 4, "model": 2}, None),
    "ep_rows_on_model": ({"data": 4, "model": 2}, ("data", "model")),
    "dense_on_mesh": ({"data": 8}, None),
}


def moe_layouts(rank, dev, case):
    """The MoE layer under each of `EP_LAYOUTS`: this rank's rows of y,
    its aux, the gradients of sum(y * w) (x's summed over the ranks that
    hold the same rows, the weights' over the mesh)."""
    cfg = with_moe(reduced_config(case["arch"]), case["n_experts"],
                   case["capacity_factor"])
    p = params_from_reference(case["params"], device=dev)
    x, w = torch.from_numpy(case["x"]), torch.from_numpy(case["w"])
    out = {}
    for name, (shape, rows) in EP_LAYOUTS.items():
        mesh = WorkerMesh(shape, dev)
        r = rows if rows is not None else default_rows(mesh)
        xl = coll.own_slice(x, mesh, r, 0).clone().requires_grad_()
        pl = tree_map(lambda t: t.clone().requires_grad_(), p)
        y, aux = moe_mod.moe_forward(pl, cfg, xl, mesh, rows=rows)
        rep = mesh.size(mesh.axis_names) // mesh.size(r)
        obj = (y * coll.own_slice(w, mesh, r, 0)).sum() / rep
        grads = torch.autograd.grad(obj, [xl] + tree_leaves(pl),
                                    retain_graph=True)
        d_aux = torch.autograd.grad(aux, [xl, pl["router"]])
        others = [a for a in mesh.axis_names if a not in r]
        dw = {name: _np(coll.psum(g.float(), mesh, mesh.axis_names))
              for name, g in zip(_paths(pl), grads[1:])}
        out[name] = {
            "index": mesh.index(r), "parts": mesh.size(r), "y": _np(y),
            "aux": float(aux.detach()),
            "used_ep": moe_mod.use_ep(cfg, mesh, x.shape[0]),
            "dx": _np(coll.psum(grads[0], mesh, others)),
            "dw": dw if rank == 0 else None,
            # aux's gradient: x's summed as above, the router's over the
            # mesh (each rank's is its share of the mean)
            "daux_dx": _np(coll.psum(d_aux[0], mesh, others)),
            "daux_router": _np(coll.psum(d_aux[1], mesh, mesh.axis_names))}
    return out


def compressed_means(rank, dev, g, seeds):
    """compressed_psum over "pod" (8 ranks, rank r holding row r of g)
    for each seed, and compressed_psum_tree on a (2, 2, 2) mesh."""
    mesh = WorkerMesh({"pod": 8}, dev)
    gl = torch.from_numpy(g[rank:rank + 1])
    outs = torch.stack([coll.compressed_psum(gl, mesh, ("pod",), s)
                        for s in seeds])
    mesh3 = WorkerMesh({"pod": 2, "data": 2, "model": 2}, dev)
    tree = {"a": gl[:, :128], "b": {"c": gl[:, 128:].double()}}
    red = coll.compressed_psum_tree(tree, mesh3, seed=5)
    return {"outs": outs.numpy(), "pod": mesh3.coord["pod"],
            "tree": [t.numpy() for t in tree_leaves(red)],
            "tree_dtypes": [str(t.dtype) for t in tree_leaves(red)]}


def parallel_world(rank, dev, moe_case, g, seeds):
    return {"moe": moe_layouts(rank, dev, moe_case),
            "compressed": compressed_means(rank, dev, g, seeds)}


# ---------------------------------------------------------------------------
# tests/test_torch_multidevice.py
# ---------------------------------------------------------------------------

def whole_gradient(params, grads, cfg, rules, mesh) -> list:
    """The whole gradient of every leaf of ``params`` (``grads`` in
    `tree_leaves` order) from each rank's gradient of its share of the
    loss: summed over the axes of the ranks that hold shares (the mesh;
    the mesh but "model" under the "model" cut, where the rank's gradient
    is its part of a cut leaf), then gathered over the cut."""
    tp = model_cut(rules, mesh)
    axes = tuple(a for a in mesh.axis_names if a != "model" or tp == 1)
    it = iter(grads)
    whole = tree_map(
        lambda _, s: coll.unshard(coll.psum(next(it).float(), mesh, axes),
                                  s, mesh),
        params, model_lib.model_specs(cfg, rules, mesh))
    return [_np(g) for g in tree_leaves(whole)]


def sp_losses(rank, dev, case):
    """loss_fn and its gradient (made whole: `whole_gradient`) on a
    (2, 4) mesh under zero3 (rows cut over "model" too: the all-to-all)
    and base (rows replicated over "model": the slice and gather, the
    MLP and vocabulary cut over "model")."""
    cfg = sp_config()
    params = params_from_reference(case["params"], device=dev)
    batch = _batch(case["batch"])
    mesh = WorkerMesh({"data": 2, "model": 4}, dev)
    out = {}
    for name in ("zero3", "base"):
        pl = tree_map(lambda t: t.clone().requires_grad_(),
                      model_lib.model_part(params, cfg, preset(name), mesh))
        loss, metrics = model_lib.loss_fn(
            pl, cfg, batch, mesh=mesh,
            constrain=constrainer(preset(name), mesh), remat="none")
        grads = whole_gradient(pl, torch.autograd.grad(
            loss, tree_leaves(pl)), cfg, preset(name), mesh)
        out[name] = {
            "loss": float(loss.detach()),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads if rank == 0 else None}
    return out


def sharded_steps(rank, dev, case):
    """Three sharded train steps from the carried weights; each step's
    metrics, and the gathered parameters after each (rank 0)."""
    cfg = reduced_config(case["arch"])
    if case.get("n_experts"):
        cfg = with_moe(cfg, case["n_experts"], case["capacity_factor"],
                       **case["moe"])
    mesh = WorkerMesh(case["mesh"], dev)
    rules = preset(case["rules"]) if case.get("rules") else rules_for(
        cfg, "train")
    opt = OptimizerConfig(lr=1e-3)
    specs = param_specs(cfg, rules, mesh)
    state = shard_state(init_train_state(params_from_reference(
        case["params"], device=dev), opt), specs, mesh)
    step = make_train_step(cfg, opt, mesh, rules, remat="none",
                           lr_kwargs=LR_KWARGS)
    out = {"rules": rules.name, "metrics": [], "params": []}
    for b in case["batches"]:
        state, m = step(state, _batch(b))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        whole = gather_state(state, specs, mesh)
        if rank == 0:
            out["params"].append([_np(t) for t in tree_leaves(whole.params)])
    return out


def reduced_gradient(state, metrics, opt: OptimizerConfig) -> list:
    """The gradient a first step reduced, from its first moment: AdamW's
    first step stores (1 - b1) x clip_factor x g."""
    scale = (1.0 - opt.b1) * float(metrics["clip_factor"])
    return [_np(mu) / scale for mu in tree_leaves(state.opt["mu"])]


def compressed_step(rank, dev, case):
    """One exact and one int8-compressed step on (2, 2, 2) with the base
    preset from the same state: the metrics, the gathered parameters and
    reduced gradients (rank 0), and a digest of this rank's compressed
    shards."""
    cfg = reduced_config(case["arch"])
    mesh = WorkerMesh({"pod": 2, "data": 2, "model": 2}, dev)
    rules = preset("base")
    opt = OptimizerConfig(lr=1e-3)
    specs = param_specs(cfg, rules, mesh)
    out = {"coord": dict(mesh.coord)}
    for name, comp in (("exact", None), ("int8", "int8")):
        state = shard_state(init_train_state(params_from_reference(
            case["params"], device=dev), opt), specs, mesh)
        step = make_train_step(cfg, opt, mesh, rules, remat="none",
                               grad_compression=comp, lr_kwargs=LR_KWARGS)
        state, m = step(state, _batch(case["batch"]))
        digest = hashlib.sha256()
        for t in tree_leaves(state.params):
            digest.update(t.detach().contiguous().numpy().tobytes())
        whole = gather_state(state, specs, mesh)
        out[name] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "digest": digest.hexdigest(),
            "params": [_np(t) for t in tree_leaves(whole.params)]
            if rank == 0 else None,
            "grads": reduced_gradient(whole, m, opt) if rank == 0 else None}
    return out


def world_run_fixed(rank, dev, case):
    """`run_fixed` in this world with --model-parallel 2 (a (4, 2) mesh),
    checkpointing the last step from rank 0."""
    losses = launch_train.run_fixed(
        reduced_config(case["arch"]), steps=case["steps"],
        batch=case["batch"], seq=case["seq"], ckpt_dir=case["ckpt_dir"],
        device=dev, model_parallel=2, log_every=1,
        ckpt_every=case["steps"])
    return {"losses": losses}


def multidevice_world(rank, dev, cases):
    return {"sp": sp_losses(rank, dev, cases["sp"]),
            "steps": [sharded_steps(rank, dev, c) for c in cases["steps"]],
            "int8": compressed_step(rank, dev, cases["int8"]),
            "run_fixed": world_run_fixed(rank, dev, cases["run_fixed"])}


# ---------------------------------------------------------------------------
# tests/test_torch_cuda.py (on the card)
# ---------------------------------------------------------------------------

def cuda_collectives(rank, dev):
    """Each collective of `parallel.collectives` on CUDA tensors (and
    the region maps' forwards)."""
    mesh = WorkerMesh({"data": 2, "model": 2}, dev)
    x = torch.full((3, 4), float(rank), device=dev)
    b = (x + 0.5).to(torch.bfloat16)
    out = {
        "psum_f32": coll.psum(x, mesh, mesh.axis_names)[0].cpu().numpy(),
        "psum_bf16": coll.psum(b, mesh, mesh.axis_names).float().cpu(
            ).numpy(),
        "psum_i32": coll.psum(x.to(torch.int32), mesh, mesh.axis_names
                              ).cpu().numpy(),
        "pmax": coll.pmax(x, mesh, mesh.axis_names).cpu().numpy(),
        "gather_bf16": coll.all_gather(b, mesh, mesh.axis_names, 0).float(
            ).cpu().numpy(),
        "own_a2a": coll.all_to_all(b.reshape(2, 6)[:, :4].contiguous(),
                                   mesh, "model").float().cpu().numpy(),
        # the region maps of activation tensor parallelism
        "from_model_bf16": coll.from_model(b, mesh, mesh.axis_names).float(
            ).cpu().numpy(),
        "gather_from_model_bf16": coll.gather_from_model(
            b, mesh, mesh.axis_names, 0).float().cpu().numpy(),
    }
    assert out["own_a2a"].shape == (2, 4)
    assert (out["psum_f32"] == 6.0).all()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_elastic.py
# ---------------------------------------------------------------------------

def _printed(fn, *args, **kwargs):
    """(fn's result, what it printed)."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue()


def restores_across_meshes(rank, dev, case):
    """A tree saved from a mesh of ranks 0-3 (rank 0 writing the gathered
    leaves), restored onto a mesh of 8; and a checkpoint the JAX
    package's manager wrote, restored onto 8.  Each rank's shards, and
    the specs they were cut by."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.parallel.sharding import P, placements
    whole = {k: torch.from_numpy(v) for k, v in case["tree"].items()}
    whole["b"] = whole["b"].to(torch.bfloat16)
    specs = {"w": P("data"), "b": P(None, "data"), "n": P()}
    mesh4 = WorkerMesh({"data": 4}, dev)
    out = {"inside4": mesh4.inside}
    if mesh4.inside:
        mine = {k: coll.shard_of(t, specs[k], mesh4).clone()
                for k, t in whole.items()}
        gathered = {k: coll.unshard(t, specs[k], mesh4)
                    for k, t in mine.items()}
        if rank == 0:
            CheckpointManager(case["port_dir"], async_mode=False).save(
                1, gathered)
    torch.distributed.barrier()
    mesh8 = WorkerMesh({"data": 8}, dev)
    target = {k: Leaf(tuple(t.shape), (None,) * t.dim(), t.dtype)
              for k, t in whole.items()}
    got = CheckpointManager(case["port_dir"]).restore(1, target, specs,
                                                      mesh=mesh8)
    # the same by placements, from the JAX package's checkpoint
    by_placements = {k: placements(s, mesh8) for k, s in specs.items()}
    from_jax = CheckpointManager(case["jax_dir"]).restore(
        1, target, by_placements, mesh=mesh8)
    return {"index": mesh8.index("data"),
            "restored": {k: _np(t) for k, t in got.items()},
            "dtypes": {k: str(t.dtype) for k, t in got.items()},
            "from_jax": {k: _np(t) for k, t in from_jax.items()}}


def elastic_runs(rank, dev, case):
    """run_elastic on the world: with the JAX package's initial weights
    carried in (the draw that builds the first state patched), 8 steps
    logged each step; and the example's twin from the port's own seed;
    and mamba2 through ``main --elastic``.  Each run's losses and rank
    0's printed lines."""
    from unittest import mock
    carried = params_from_reference(case["params"], device=dev)
    out = {}
    with mock.patch.object(
            model_lib, "init_model",
            lambda cfg, seed=0, device=None: tree_map(
                lambda t: t.clone(), carried)):
        run = case["carried"]
        out["carried"] = _printed(
            launch_train.run_elastic, reduced_config(run["arch"]),
            steps=run["steps"], batch=run["batch"], seq=run["seq"],
            ckpt_dir=run["ckpt_dir"], log_every=1, device=dev)
    run = case["example"]
    out["example"] = _printed(
        launch_train.run_elastic, reduced_config(run["arch"]),
        steps=run["steps"], batch=run["batch"], seq=run["seq"],
        ckpt_dir=run["ckpt_dir"], log_every=run["log_every"], device=dev)
    out["main"] = _printed(launch_train.main, case["main_argv"])
    return out


def resumed_on_mesh(rank, dev, case):
    """run_fixed in the world (a mesh of 8), resumed from a one-device
    checkpoint."""
    return {"losses": launch_train.run_fixed(
        reduced_config(case["arch"]), steps=case["steps"],
        batch=case["batch"], seq=case["seq"], ckpt_dir=case["ckpt_dir"],
        device=dev, log_every=1, resume_from=case["resume_from"])}


def serve_on_mesh(rank, dev, case):
    """ServeEngine on a mesh of 4 under each of the case's rules, with
    carried weights: every request's tokens, the first tick's logits and
    the engine's ticks (ranks outside the mesh return None)."""
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.parallel.sharding import preset
    cfg = dataclasses.replace(reduced_config(case["arch"]),
                              **case.get("changes", {}))
    if case.get("capacity_factor"):
        cfg = with_moe(cfg, cfg.moe.n_experts, case["capacity_factor"])
    params = params_from_reference(case["params"], device=dev)
    out = {}
    for rules in case["rules"]:
        mesh = WorkerMesh(case["mesh"], dev)
        if not mesh.inside:
            out[rules] = None
            continue
        engine = ServeEngine(cfg, params, batch_slots=case["slots"],
                             max_seq=case["max_seq"], mesh=mesh,
                             rules=preset(rules))
        for i, p in enumerate(case["prompts"]):
            engine.submit(Request(rid=i, prompt=p,
                                  max_new_tokens=case["new"]))
        first, ticks = None, 0
        while engine.queue or engine.busy_slots():
            engine.step()
            ticks += 1
            if first is None and engine.last_logits is not None:
                first = _np(engine.last_logits)
        out[rules] = {"tokens": {i: r.output for i, r in engine.done.items()},
                      "logits": first, "ticks": ticks,
                      "layout": (engine.layout.rows, engine.layout.kv_seq)}
    return out


def merged_attention(rank, dev, case):
    """A decode step's attention over a cache cut in 4 (one part holds
    no key): the rank's flash output and lse merged over "data", and the
    attention over the whole cache; and an engine on a serving mesh with
    a "model" axis of 2: the error it raises (None), and the widths of
    the parameters and the cache it holds."""
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_forward,
    )
    from repro_torch.models.attention import merge_partials
    from repro_torch.serve.engine import ServeEngine
    t = {k: torch.from_numpy(v) for k, v in case.items()}
    out = {}
    mesh = WorkerMesh({"data": 4}, dev)
    if mesh.inside:
        part = [coll.own_slice(t[k], mesh, "data", 1).contiguous()
                for k in ("k", "v", "pos")]
        o, lse = flash_attention_forward(t["q"], *part[:2], t["q_pos"],
                                         part[2], causal=True)
        merged = merge_partials(o, lse, mesh, ("data",))
        whole = flash_attention(t["q"], t["k"], t["v"], t["q_pos"],
                                t["pos"], causal=True)
        out["err"] = float((merged - whole).abs().max())
        out["empty_part"] = bool((part[2] < 0).all())
    mesh2 = WorkerMesh({"data": 4, "model": 2}, dev)
    cfg = reduced_config("qwen2-1.5b")
    try:
        engine = ServeEngine(cfg, model_lib.init_model(cfg, device=dev),
                             mesh=mesh2, rules=rules_for(cfg, "decode"))
        out["model_axis"] = None
        out["held"] = {
            "wq": tuple(engine.params["stack"]["slot0"]["mixer"]["wq"]["w"]
                        .shape),
            "k": tuple(engine.cache["slot0"]["self"]["k"].shape)}
    except NotImplementedError as e:
        out["model_axis"] = str(e)
    return out


def elastic_world(rank, dev, cases):
    return {"restore": restores_across_meshes(rank, dev, cases["restore"]),
            "merge": merged_attention(rank, dev, cases["merge"]),
            "resume": resumed_on_mesh(rank, dev, cases["resume"]),
            "serve": [serve_on_mesh(rank, dev, c) for c in cases["serve"]],
            "elastic": elastic_runs(rank, dev, cases["elastic"])}


# ---------------------------------------------------------------------------
# tests/test_torch_tp.py
# ---------------------------------------------------------------------------

def tp_config(case):
    cfg = dataclasses.replace(reduced_config(case["arch"]),
                              **case.get("changes", {}))
    if case.get("capacity_factor"):
        cfg = with_moe(cfg, cfg.moe.n_experts, case["capacity_factor"],
                       **case.get("moe", {}))
    return cfg


def _layer(tree, slot, part):
    """Layer 0 of a slot's stacked sub-tree."""
    return tree_map(lambda t: t[0], tree["stack"][f"slot{slot}"][part])


class KernelShapes:
    """Records the shapes that reach flash attention (q, k), the SSD scan
    (x), the grouped matmul (its weights) and the unembedding (the
    logits), by wrapping the modules' references to them."""

    def __init__(self):
        from unittest import mock
        from repro_torch.models import attention, ssm
        self.seen = {"flash": set(), "ssd": set(), "gmm": set(),
                     "logits": set()}

        def record(name, fn, shape):
            def wrapped(*args, **kwargs):
                out = fn(*args, **kwargs)
                self.seen[name].add(shape(args, out))
                return out
            return wrapped
        self.patches = [
            mock.patch.object(attention, "flash_attention", record(
                "flash", attention.flash_attention,
                lambda a, o: (tuple(a[0].shape), tuple(a[1].shape)))),
            mock.patch.object(ssm, "ssd", record(
                "ssd", ssm.ssd, lambda a, o: tuple(a[0].shape))),
            mock.patch.object(moe_mod, "gmm", record(
                "gmm", moe_mod.gmm, lambda a, o: tuple(a[1].shape))),
            mock.patch.object(model_lib, "_unembed", record(
                "logits", model_lib._unembed, lambda a, o: tuple(o.shape))),
        ]

    def __enter__(self):
        for p in self.patches:
            p.start()
        return self

    def __exit__(self, *exc):
        for p in self.patches:
            p.stop()


def tp_layers(cfg, part, x, mesh, c):
    """The blocks under the cut on this rank's rows of ``x``: attention
    and the MLP (dense), the Mamba2 block, the MoE layer."""
    from repro_torch.models import attention, ssm
    from repro_torch.models.layers import apply_mlp
    xl = coll.own_slice(torch.from_numpy(x), mesh, c.rows, 0)
    out = {}
    for slot in range(cfg.period):
        kind = cfg.mixer_kind(slot)
        if kind == "attn" and "attn" not in out:
            out["attn"] = _np(attention.attn_forward(
                _layer(part, slot, "mixer"), cfg, xl, constrain=c,
                mesh=mesh))
        if kind == "ssm" and "ssm" not in out:
            out["ssm"] = _np(ssm.ssm_forward(_layer(part, slot, "mixer"),
                                             cfg, xl, constrain=c))
        ffn = cfg.ffn_kind(slot)
        if ffn == "dense" and "mlp" not in out:
            out["mlp"] = _np(apply_mlp(_layer(part, slot, "ffn"), xl,
                                       gated=cfg.gated_mlp, act=cfg.act,
                                       d_ff=cfg.d_ff, constrain=c))
        if ffn == "moe" and "moe" not in out:
            out["moe"] = _np(moe_mod.moe_forward(
                _layer(part, slot, "ffn"), cfg, xl, mesh, rows=c.rows,
                constrain=c)[0])
    return out


def tp_loss(cfg, params, rules, mesh, batch):
    """loss_fn under the cut: the loss, its metrics and the whole
    gradient (rank 0)."""
    pl = tree_map(lambda t: t.clone().requires_grad_(),
                  model_lib.model_part(params, cfg, rules, mesh))
    loss, metrics = model_lib.loss_fn(pl, cfg, batch, mesh=mesh,
                                      constrain=constrainer(rules, mesh),
                                      remat="none")
    grads = whole_gradient(pl, torch.autograd.grad(loss, tree_leaves(pl)),
                           cfg, rules, mesh)
    return {"loss": float(loss.detach()),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads if mesh.rank == 0 else None}


def tp_decode(cfg, params, rules, mesh, prompts, steps):
    """prefill (every row on every rank) and ``steps`` greedy decode
    steps of this rank's rows, under the serving layout: the prefill's
    logits, and each step's logits gathered over the rows."""
    from repro_torch.parallel.sharding import Constrainer, serving_layout
    part = model_lib.model_part(params, cfg, rules, mesh)
    B = prompts.shape[0]
    layout = serving_layout(rules, mesh, B)
    pre = Constrainer(rules, mesh, rows=(), kv_seq=layout.kv_seq)
    cache = model_lib.init_cache(cfg, B, 32, device=mesh.device,
                                 layout=pre)
    logits, cache, lengths = model_lib.prefill(
        part, cfg, {"tokens": torch.from_numpy(prompts)}, cache, mesh=mesh,
        constrain=pre)
    out = {"prefill": _np(logits), "steps": []}
    cache = tree_map(lambda t: coll.own_slice(t, mesh, layout.rows, 1)
                     .clone(), cache)
    tok = torch.argmax(logits, dim=-1)[:, None]
    for _ in range(steps):
        step, cache, _ = model_lib.decode_step(
            part, cfg, coll.own_slice(tok, mesh, layout.rows, 0).clone(),
            cache, coll.own_slice(lengths, mesh, layout.rows, 0).clone(),
            mesh=mesh, constrain=layout)
        step = coll.all_gather(step, mesh, layout.rows, 0)
        out["steps"].append(_np(step))
        tok, lengths = torch.argmax(step, dim=-1)[:, None], lengths + 1
    return out


def tp_case(rank, dev, case):
    """One (arch, mesh) case: the blocks, the loss and its gradient with
    the shapes that reached the kernels, prefill and decode, and the
    engine."""
    from repro_torch.serve.engine import Request, ServeEngine
    cfg = tp_config(case)
    params = params_from_reference(case["params"], device=dev)
    mesh = WorkerMesh(case["mesh"], dev)
    rules = preset(case["rules"])
    c = constrainer(rules, mesh)
    c.rows = default_rows(mesh)
    part = model_lib.model_part(params, cfg, rules, mesh)
    out = {"index": mesh.index(c.rows), "tp": c.tp,
           "layers": tp_layers(cfg, part, case["x"], mesh, c)}
    with KernelShapes() as shapes:
        out["loss"] = tp_loss(cfg, params, rules, mesh,
                              _batch(case["batch"]))
    out["shapes"] = {k: sorted(v) for k, v in shapes.seen.items()}
    serve = preset(case["serve_rules"])
    out["decode"] = tp_decode(cfg, params, serve, mesh, case["prompts"],
                              case["decode_steps"])
    engine = ServeEngine(cfg, params, batch_slots=case["slots"],
                         max_seq=case["max_seq"], mesh=mesh, rules=serve)
    for i, p in enumerate(case["prompts"]):
        engine.submit(Request(rid=i, prompt=p, max_new_tokens=case["new"]))
    first = None
    while engine.queue or engine.busy_slots():
        engine.step()
        if first is None and engine.last_logits is not None:
            first = _np(engine.last_logits)
    out["engine"] = {"tokens": {i: r.output for i, r in engine.done.items()},
                     "logits": first}
    return out


def planted(rank, dev, case):
    """The three traps of the cut, each planted on mamba2's case: the
    in_proj columns taken as a contiguous cut (not on head boundaries),
    the gated norm's sum of squares left unsummed over "model", and the
    loss's shares divided over the "model" ranks as if they were
    replicas.  The Mamba2 block's output (rank's rows) under the first
    two, the whole gradient under the third."""
    from unittest import mock
    from repro_torch.models import ssm
    from repro_torch.parallel.sharding import Constrainer
    cfg = tp_config(case)
    params = params_from_reference(case["params"], device=dev)
    mesh = WorkerMesh(case["mesh"], dev)
    rules = preset(case["rules"])
    c = constrainer(rules, mesh)
    c.rows = default_rows(mesh)
    part = model_lib.model_part(params, cfg, rules, mesh)
    columns = ssm._rank_columns

    def contiguous(cfg_, index, tp, device, conv):
        width = len(columns(cfg_, index, tp, device, conv))
        start = min(index * width, len(columns(cfg_, 0, 1, device, conv))
                    - width)
        return torch.arange(start, start + width, device=device)

    gated = ssm._gated_norm
    out = {}
    with mock.patch.object(ssm, "_rank_columns", contiguous):
        out["in_proj"] = tp_layers(cfg, part, case["x"], mesh, c)["ssm"]
    with mock.patch.object(ssm, "_gated_norm",
                           lambda p, y, z, eps, *a: gated(p, y, z, eps)):
        out["norm"] = tp_layers(cfg, part, case["x"], mesh, c)["ssm"]
    with mock.patch.object(Constrainer, "share_axes",
                           lambda self: self.mesh.axis_names):
        out["rep"] = tp_loss(cfg, params, rules, mesh,
                             _batch(case["batch"]))["grads"]
    return out


def tp_steps(rank, dev, case):
    """``sharded_steps`` under the case's rules, the gradient the first
    step reduced (from AdamW's first moment), and on rank 0 the
    one-device step's metrics and parameters on the same batches."""
    cfg = tp_config(case)
    mesh = WorkerMesh(case["mesh"], dev)
    rules = preset(case["rules"])
    opt = OptimizerConfig(lr=1e-3)
    specs = param_specs(cfg, rules, mesh)
    state = shard_state(init_train_state(params_from_reference(
        case["params"], device=dev), opt), specs, mesh)
    step = make_train_step(cfg, opt, mesh, rules, remat="none",
                           lr_kwargs=LR_KWARGS)
    out = {"metrics": [], "params": [], "grads": None}
    for i, b in enumerate(case["batches"]):
        state, m = step(state, _batch(b))
        out["metrics"].append({k: float(v) for k, v in m.items()})
        whole = gather_state(state, specs, mesh)
        if rank == 0:
            out["params"].append([_np(t) for t in tree_leaves(whole.params)])
            if i == 0:
                out["grads"] = reduced_gradient(whole, m, opt)
    if rank == 0:
        one = make_train_step(cfg, opt, remat="none", lr_kwargs=LR_KWARGS,
                              device=dev)
        state = init_train_state(params_from_reference(
            case["params"], device=dev), opt)
        out["one"] = []
        for b in case["batches"]:
            state, m = one(state, _batch(b))
            out["one"].append((float(m["loss"]), [
                _np(t) for t in tree_leaves(state.params)]))
    return out


def tp_world(rank, dev, cases):
    return {"cases": [tp_case(rank, dev, c) for c in cases["cases"]],
            "planted": planted(rank, dev, cases["planted"]),
            "steps": [tp_steps(rank, dev, c) for c in cases["steps"]]}


def dryrun_numbers(counter) -> dict:
    """What `launch.dryrun.OpCounter` counted, as plain values."""
    from collections import Counter
    return {"flops": dict(counter.flops), "bytes": counter.bytes,
            "coll": dict(counter.coll), "links": dict(counter.links),
            "sites": dict(Counter(s.kernel for s in counter.sites))}


def dryrun_counts(rank, dev, case):
    """`launch.dryrun.trace` of a reduced config's train step under each
    of the case's rules, and of its prefill step (the case's
    ``prefill`` cell, its rows cut over the mesh), run for real on this
    rank's CPU tensors (zero tokens, uninitialised weights: the counts
    depend on shapes alone), counted by the dry-run's mode."""
    from repro_torch.configs import input_specs
    from repro_torch.launch import dryrun

    cfg, cell = case["cfg"], case["cell"]
    mesh = WorkerMesh(case["mesh"], dev)

    def zeros(cell):
        return {k: torch.zeros(v.shape, dtype=v.dtype)
                for k, v in input_specs(cfg, cell).items()}
    out = {rules: dryrun_numbers(dryrun.trace(
        cfg, mesh, cell, fake=False, remat="none", rules_name=rules,
        batch=zeros(cell))[0]) for rules in case["rules"]}
    out["prefill"] = dryrun_numbers(dryrun.trace(
        cfg, mesh, case["prefill"], fake=False,
        batch=zeros(case["prefill"]))[0])
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_prefill_rows.py
# ---------------------------------------------------------------------------

def prefill_rows_case(rank, dev, case):
    """A batched prefill through `make_prefill_step(..., batch=B)` on the
    case's mesh under its rules (the rank's serving part of the
    weights), then ``decode_steps`` greedy steps of `make_decode_step` on
    the cache it filled: the layouts, the gathered logits, the lengths,
    the rank's cache part, the shapes that reached the kernels in the
    prefill and each step's gathered logits.  A rank
    outside the mesh returns None (after making it: group creation is
    collective)."""
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    mesh = WorkerMesh(case["mesh"], dev)
    if not mesh.inside:
        return None
    cfg = tp_config(case)
    rules = preset(case["rules"])
    part = model_lib.serving_part(params_from_reference(
        case["params"], device=dev), cfg, rules, mesh)
    batch = _batch(case["batch"])
    B = batch["tokens"].shape[0]
    step = make_prefill_step(cfg, mesh, rules, batch=B)
    rows = B // mesh.size(step.layout.rows)
    cache = model_lib.init_cache(cfg, rows, case["max_seq"], device=dev,
                                 layout=step.layout)
    with KernelShapes() as shapes:
        logits, cache, lengths = step(part, batch, cache)
    out = {"coord": dict(mesh.coord), "rows": step.layout.rows,
           "shapes": {k: sorted(v) for k, v in shapes.seen.items()},
           "kv_seq": step.layout.kv_seq, "logits": _np(logits),
           "lengths": lengths.numpy(),
           "cache": tree_map(lambda t: t.clone().numpy(), cache),
           "steps": []}
    decode = make_decode_step(cfg, mesh, rules, B)
    out["decode_rows"] = decode.layout.rows
    tok = torch.argmax(logits, dim=-1)[:, None]
    for _ in range(case["decode_steps"]):
        logits, cache, lengths = decode(part, tok, cache, lengths)
        out["steps"].append(_np(logits))
        tok = torch.argmax(logits, dim=-1)[:, None]
    return out


def prefill_rows_world(rank, dev, cases):
    return [prefill_rows_case(rank, dev, c) for c in cases]
