"""Multi-pod dry-run: trace every (arch × shape × mesh) cell on fake tensors.

The port of the JAX package's ``launch/dryrun.py``.  Where the reference
lowers and compiles each cell's step under the production mesh with no
hardware, this traces the step of one rank (rank 0) of a fake world
(``torch.distributed``'s "fake" backend: 256 ranks for the 16×16 mesh,
512 for 2×16×16) on fake tensors (``FakeTensorMode``): the same entry
points a run calls (`train.train_step.make_train_step` with the rank's
state shards, `serve.engine.make_prefill_step`, `make_decode_step` with
the serving layout's cache part), at the port's own shard shapes
(`parallel.sharding.rules_for` of the workload, or ``--rules``).  A
sharding that does not hold together fails here as it would on a mesh.
Nothing is allocated and no card is needed; no kernel is built or
launched and no CUDA context is made.

The trace runs on fake CPU tensors.  Fake CUDA tensors would make
``FakeTensorMode`` create a CUDA context on a host with a card, and
autograd cannot run them in a build without CUDA.  Instead, while the
dry-run records, every kernel wrapper hands its call to the recorder
(`kernels.sites`) before it looks at the device, and the one branch of
the model that depends on the device outside the kernels
(`models.layers.matmul_f32`) takes the card's path, so the trace follows
the card's code, not the plain versions.

Per cell, `OpCounter` (a ``TorchDispatchMode``) records per rank:

  * FLOPs of the matrix products, as ``FlopCounterMode`` counts them, by
    the inputs' dtype;
  * bytes: each aten op's inputs plus its outputs.  The port runs
    eagerly, so on the card every op is its own pass over HBM; this is
    not XLA's post-fusion count.  Views and allocations move nothing; a
    gather (an embedding, an index) reads the rows it returns, a scatter
    writes the rows it is given; an op that overwrites its output
    (``copy_``, ``fill_``, ``out=``) does not read it;
  * collective wire bytes by the reference's model (all-reduce 2x the
    result, the others 1x), each split by link class: NVLink where every
    rank of its group sits in one node of 8 consecutive ranks, the
    network otherwise (ranks are row-major, so both "model" (16) and
    "data" cross nodes);
  * the step's argument bytes, and its peak live bytes (the arguments
    plus the most that the step's new tensors hold at once);
  * each kernel call as a site (`launch.roofline_adjust.Site`), which
    returns empty outputs of the right shapes: the reference's
    ``FORCE_REFERENCE``.

Output, per cell, under the reference's key names: ``roofline`` (the
traced ops, each site at its plain version's calibrated cost),
``roofline_extrapolated`` (the reference's depth variants at 1x and 2x
period built with ``unroll=True``; the trace counts every layer, so this
equals the full-depth count), ``roofline_kernel_adjusted`` (the sites at
the kernel model), ``memory`` (``argument_size_in_bytes``,
``peak_memory_in_bytes``, ``fits_hbm`` against the card's 80 GB) and
``collective_bytes_per_chip``.  Roofline terms use `roofline_adjust.H100`.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all --mesh both --out experiments/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import weakref
from collections import Counter
from typing import Any

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import (
    ARCH_NAMES, SHAPES, applicable, get_config, input_specs,
)
from repro_torch.kernels import sites as sites_mod
from repro_torch.launch.roofline_adjust import (
    H100, Site, kernel_adjusted, kernel_cost, plain_cost, step_bound,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.param import tree_leaves, tree_map

COLLECTIVE_KINDS = ("all-reduce", "all-gather", "reduce-scatter",
                    "all-to-all", "collective-permute")

# ---------------------------------------------------------------------------
# Counting
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
#: ops that move nothing: allocations and metadata
_FREE = {_aten.empty.memory_format, _aten.empty_strided.default,
         _aten.empty_like.default, _aten.new_empty.default,
         _aten.new_empty_strided.default, _aten.detach.default,
         _aten.alias.default, _aten._unsafe_view.default,
         _aten.lift_fresh.default, _aten.set_.source_Storage_storage_offset}
#: ops that overwrite their first argument without reading it
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
               _aten.zero_.default}
#: gathers: the first argument is read only where the output comes from
_GATHERS = {_aten.embedding.default, _aten.index.Tensor,
            _aten.index_select.default, _aten.gather.default}
#: scatters into their first argument: only the rows given are written
_SCATTERS = {_aten.index_put_.default, _aten._index_put_impl_.default,
             _aten.index_put.default, _aten.scatter_.src,
             _aten.scatter_add_.default, _aten.scatter_add.default,
             _aten.index_add_.default, _aten.index_copy_.default}
_C10D_KIND = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
              "allgather_": "all-gather", "_allgather_base_": "all-gather",
              "allgather_into_tensor_coalesced_": "all-gather",
              "allgather_coalesced_": "all-gather",
              "reduce_scatter_": "reduce-scatter",
              "_reduce_scatter_base_": "reduce-scatter",
              "reduce_scatter_tensor_coalesced_": "reduce-scatter",
              "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
              "broadcast_": "collective-permute",
              "recv_": "collective-permute"}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def nbytes(t: torch.Tensor) -> int:
    """The bytes a pass over ``t`` touches: its elements, a broadcast
    (stride-0) dim counted once."""
    if t.numel() == 0:
        return 0
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n


def _storage(t: torch.Tensor) -> int | None:
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def link_class(ranks) -> str:
    """"nvlink" where every rank of a group sits in one node of
    `H100["gpus_per_node"]` consecutive ranks, "network" otherwise."""
    per = H100["gpus_per_node"]
    return "nvlink" if len({r // per for r in ranks}) <= 1 else "network"


class OpCounter(TorchDispatchMode):
    """Counts a region's work per rank (see the module docstring):
    ``flops`` by dtype name, ``bytes``, ``coll`` (wire bytes by
    collective kind) and ``links`` (by link class), ``sites`` (the kernel
    calls the recorder notes), ``peak`` (the most bytes the region's new
    tensors held at once).  While ``paused`` ops are tracked for memory
    only (a site's outputs: its cost is the site's)."""

    def __init__(self):
        super().__init__()
        self.flops: Counter = Counter()
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVE_KINDS}
        self.links = {"nvlink": 0, "network": 0}
        self.sites: list[Site] = []
        self.live = self.peak = 0
        self._owned: dict[int, int] = {}
        self._ranks: dict[int, tuple[int, ...]] = {}
        self._paused = 0

    @contextlib.contextmanager
    def paused(self):
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if func.namespace == "c10d":
            self._collective(func, args)
        elif not self._paused:
            self._count(func, args, kwargs, ins, outs, out)
        self._track(ins, outs)
        return out

    def _count(self, func, args, kwargs, ins, outs, out):
        from torch.utils.flop_counter import flop_registry

        if func in _FREE or func.is_view or func.namespace == "prim" \
                or not (outs or func._schema.is_mutable):
            return                          # metadata, views, allocations
        sids = {_storage(t) for t in ins}
        if (not func._schema.is_mutable and outs
                and all(_storage(t) in sids for t in outs)):
            return                          # returns views of its inputs
        fl = flop_registry.get(func.overloadpacket)
        if fl is not None:
            self.flops[str(ins[0].dtype).split(".")[1]] += fl(
                *args, **kwargs, out_val=out)
        first = args[0] if args and isinstance(args[0], torch.Tensor) else None
        if func in _GATHERS:
            moved = sum(nbytes(t) for t in ins if t is not first) \
                + 2 * sum(nbytes(t) for t in outs)
        elif func in _SCATTERS:
            rest = [t for t in ins if t is not first]
            moved = sum(nbytes(t) for t in rest) + max(
                (nbytes(t) for t in rest), default=0)
        else:
            skip = {id(kwargs.get("out"))}
            if func in _WRITE_ONLY:
                skip.add(id(first))
            moved = sum(nbytes(t) for t in ins if id(t) not in skip) \
                + sum(nbytes(t) for t in outs)
        self.bytes += moved

    def _collective(self, func, args):
        kind = _C10D_KIND.get(func._opname)
        if kind is None:
            return
        group = next(a for a in args if isinstance(a, torch.ScriptObject))
        ranks = self._group_ranks(group)
        result = _tensors(args[0])
        wire = (2 if kind == "all-reduce" else 1) * sum(
            nbytes(t) for t in result)
        self.coll[kind] += wire
        self.links[link_class(ranks)] += wire

    def _group_ranks(self, group) -> tuple[int, ...]:
        from torch._C._distributed_c10d import ProcessGroup

        pg = ProcessGroup.unbox(group)
        key = id(pg)
        if key not in self._ranks:
            self._ranks[key] = tuple(dist.get_process_group_ranks(pg))
        return self._ranks[key]

    def _track(self, ins, outs):
        sids = {_storage(t) for t in ins}
        for t in outs:
            sid = _storage(t)
            if sid is None or sid in sids or sid in self._owned:
                continue
            st = t.untyped_storage()
            self._owned[sid] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, sid)

    def _free(self, sid):
        self.live -= self._owned.pop(sid, 0)


# ---------------------------------------------------------------------------
# Kernel sites
# ---------------------------------------------------------------------------

def _dt(t: torch.Tensor) -> str:
    return str(t.dtype).split(".")[1]


class SiteRecorder:
    """What `kernels.sites.recorder` holds during a dry-run: each kernel
    wrapper's call becomes a `Site` in the counter's ``sites`` and returns
    empty outputs of the right shapes (made with the counter paused: the
    site prices them).  A call that autograd records gets a backward that
    records the backward's site, as the card's autograd Functions launch
    the backward kernel."""

    def __init__(self, counter: OpCounter):
        self.counter = counter

    def _empty(self, shape, dtype, like: torch.Tensor) -> torch.Tensor:
        with self.counter.paused():
            return torch.empty(shape, dtype=dtype, device=like.device)

    # flash attention ----------------------------------------------------
    @staticmethod
    def flash_site(q, k, causal, window, kernel="flash_attention") -> Site:
        B, Sq, Hq, Dh = q.shape
        return Site(kernel, (B, Sq, k.shape[1], Hq, k.shape[2], Dh), _dt(q),
                    causal=bool(causal), window=window)

    def flash_attention(self, q, k, v, q_pos, kv_pos, *, causal=True,
                        window=None, softcap=None, scale=None):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            return _FlashSite.apply(self, q, k, v, causal, window)
        return self.flash_attention_forward(q, k, v, q_pos, kv_pos,
                                            causal=causal, window=window)[0]

    def flash_attention_forward(self, q, k, v, q_pos, kv_pos, *, causal=True,
                                window=None, softcap=None, scale=None):
        self.counter.sites.append(self.flash_site(q, k, causal, window))
        return (self._empty(q.shape, q.dtype, q),
                self._empty(q.shape[:3], torch.float32, q))

    def flash_attention_backward(self, q, k, v, out, dout, lse, q_pos, kv_pos,
                                 *, causal=True, window=None, softcap=None,
                                 scale=None):
        self.counter.sites.append(self.flash_site(
            q, k, causal, window, "flash_attention_bwd"))
        return tuple(self._empty(t.shape, t.dtype, t) for t in (q, k, v))

    # SSD ------------------------------------------------------------------
    @staticmethod
    def ssd_site(x, Bm, chunk, init, kernel="ssd", dfinal=False) -> Site:
        B, S, H, P = x.shape
        return Site(kernel, (B, S, H, P, Bm.shape[2], Bm.shape[3]), _dt(x),
                    chunk=chunk, init=init, dfinal=dfinal)

    def _ssd_out(self, x, Bm, chunk):
        B, S, H, P = x.shape
        nc = -(-S // min(chunk, S))
        N = Bm.shape[3]
        return (self._empty(x.shape, x.dtype, x),
                self._empty((B, H, P, N), torch.float32, x),
                self._empty((B, nc, H, P, N), torch.float32, x))

    def ssd(self, x, dt, A, Bm, Cm, D, *, chunk=256, initial_state=None):
        if torch.is_grad_enabled() and any(
                t is not None and t.requires_grad
                for t in (x, dt, A, Bm, Cm, D, initial_state)):
            return _SSDSite.apply(self, x, dt, A, Bm, Cm, D, initial_state,
                                  chunk)
        self.counter.sites.append(self.ssd_site(x, Bm, chunk,
                                                initial_state is not None))
        return self._ssd_out(x, Bm, chunk)[:2]

    def ssd_forward(self, x, dt, A, Bm, Cm, D, *, chunk=256,
                    initial_state=None):
        self.counter.sites.append(self.ssd_site(x, Bm, chunk,
                                                initial_state is not None))
        return self._ssd_out(x, Bm, chunk)

    def ssd_backward(self, x, dt, A, Bm, Cm, D, dy, *, chunk=256,
                     initial_state=None, dfinal=None, kept=None):
        self.counter.sites.append(self.ssd_site(
            x, Bm, chunk, initial_state is not None, "ssd_bwd",
            dfinal is not None))
        grads = [self._empty(t.shape, t.dtype if t is not dt else
                             torch.float32, t) for t in (x, dt, A, Bm, Cm, D)]
        init = (None if initial_state is None
                else self._empty(initial_state.shape, initial_state.dtype,
                                 initial_state))
        return (*grads, init)

    # gmm ------------------------------------------------------------------
    @staticmethod
    def gmm_site(lhs, rhs, host_sizes, out_dtype, kernel="gmm",
                 need=(True, True)) -> Site:
        T, K = lhs.shape
        E, _, N = rhs.shape
        if host_sizes is None:
            rows, live = T, E
        else:
            rows = min(sum(max(int(g), 0) for g in host_sizes), T)
            live = sum(1 for g in host_sizes if g > 0)
        return Site(kernel, (T, K, N, E), _dt(lhs), rows=rows, live=live,
                    out_dtype=str(out_dtype or lhs.dtype).split(".")[1],
                    need=tuple(bool(n) for n in need))

    def gmm(self, lhs, rhs, group_sizes, *, out_dtype=None, host_sizes=None):
        if torch.is_grad_enabled() and (lhs.requires_grad
                                        or rhs.requires_grad):
            return _GmmSite.apply(self, lhs, rhs, out_dtype, host_sizes)
        self.counter.sites.append(self.gmm_site(lhs, rhs, host_sizes,
                                                out_dtype))
        return self._empty((lhs.shape[0], rhs.shape[2]),
                           out_dtype or lhs.dtype, lhs)

    def gmm_backward(self, lhs, rhs, group_sizes, dout, *, need=(True, True),
                     host_sizes=None):
        if not any(need):
            return None, None
        self.counter.sites.append(self.gmm_site(
            lhs, rhs, host_sizes, dout.dtype, "gmm_bwd", need))
        return tuple(self._empty(t.shape, t.dtype, t) if n else None
                     for t, n in zip((lhs, rhs), need))

    # causal conv ----------------------------------------------------------
    @staticmethod
    def conv_site(x, w, kernel="causal_conv") -> Site:
        B, S, C = x.shape
        return Site(kernel, (B, S, C, w.shape[0]), _dt(x))

    def causal_conv_silu(self, x, w, b):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (x, w, b)):
            return _ConvSite.apply(self, x, w, b)
        return self.causal_conv_forward(x, w, b)

    def causal_conv_forward(self, x, w, b):
        self.counter.sites.append(self.conv_site(x, w))
        return self._empty(x.shape, x.dtype, x)

    def causal_conv_backward(self, x, w, b, dy):
        self.counter.sites.append(self.conv_site(x, w, "causal_conv_bwd"))
        return tuple(self._empty(t.shape, t.dtype, t) for t in (x, w, b))


class _FlashSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rec, q, k, v, causal, window):
        ctx.rec, ctx.opts = rec, (causal, window)
        out, lse = rec.flash_attention_forward(q, k, v, None, None,
                                               causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)   # as FlashAttentionFn
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window = ctx.opts
        dq, dk, dv = ctx.rec.flash_attention_backward(
            q, k, v, out, dout, lse, None, None, causal=causal,
            window=window)
        return None, dq, dk, dv, None, None


class _SSDSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rec, x, dt, A, Bm, Cm, D, initial_state, chunk):
        y, final, kept = rec.ssd_forward(x, dt, A, Bm, Cm, D, chunk=chunk,
                                         initial_state=initial_state)
        ctx.rec, ctx.chunk = rec, chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, initial_state, kept)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, D, initial_state, kept = ctx.saved_tensors
        grads = ctx.rec.ssd_backward(x, dt, A, Bm, Cm, D, dy, chunk=ctx.chunk,
                                     initial_state=initial_state,
                                     dfinal=dfinal, kept=kept)
        return (None, *(g if need else None
                        for g, need in zip(grads, ctx.needs_input_grad[1:])),
                None)


class _GmmSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rec, lhs, rhs, out_dtype, host_sizes):
        ctx.rec, ctx.host_sizes = rec, host_sizes
        ctx.save_for_backward(lhs, rhs)
        return rec.gmm(lhs, rhs, None, out_dtype=out_dtype,
                       host_sizes=host_sizes)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs = ctx.saved_tensors
        need = tuple(ctx.needs_input_grad[1:3])
        dlhs, drhs = ctx.rec.gmm_backward(lhs, rhs, None, dout, need=need,
                                          host_sizes=ctx.host_sizes)
        return None, dlhs, drhs, None, None


class _ConvSite(torch.autograd.Function):
    @staticmethod
    def forward(ctx, rec, x, w, b):
        ctx.rec = rec
        ctx.save_for_backward(x, w, b)      # as CausalConvFn
        return rec.causal_conv_forward(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        grads = ctx.rec.causal_conv_backward(x, w, b, dy)
        return (None, *(g if need else None
                        for g, need in zip(grads, ctx.needs_input_grad[1:])))


@contextlib.contextmanager
def recording(counter: OpCounter):
    """Counts under ``counter`` with every kernel call recorded as a site
    (`kernels.sites.recorder`), then puts the wrappers back."""
    if sites_mod.recorder is not None:
        raise RuntimeError("dryrun: a recording is already running")
    sites_mod.recorder = SiteRecorder(counter)
    try:
        with counter:
            yield counter
    finally:
        sites_mod.recorder = None


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks on the "fake"
    backend, this process rank 0; torn down on exit.  Refuses to start
    when a process group exists."""
    if dist.is_initialized():
        raise RuntimeError("dryrun: a process group already exists; the "
                           "dry-run makes a fake world of its own")
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _fake(spec: torch.Tensor) -> torch.Tensor:
    """A fake tensor (inside the active FakeTensorMode) of a spec's shape
    and dtype."""
    return torch.empty(spec.shape, dtype=spec.dtype)


def _whole_params(cfg: ModelConfig):
    from repro_torch.models.model import leaf_tree

    return tree_map(lambda leaf: torch.empty(leaf.shape, dtype=leaf.dtype),
                    leaf_tree(cfg))


def _bytes_of(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


# ---------------------------------------------------------------------------
# Step builders (what gets traced)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Built:
    """A traceable step: ``run()`` calls it once; ``arguments`` are its
    argument trees by name (their bytes are the step's argument bytes);
    ``notes`` go into the result."""
    run: Any
    arguments: dict
    notes: dict


def build_train(cfg: ModelConfig, mesh, cell, *, remat: str = "full",
                accum_steps: int = 1, grad_compression: str | None = None,
                unroll: bool = False, rules_name: str | None = None,
                opt_cfg=None, batch=None) -> Built:
    """The rank's train step (`make_train_step`) over its state shards;
    a mesh of one rank is the one-device step (as `launch.train.run_fixed`
    runs in a world of one).  int8 compression asked for on a mesh
    without "pod" gives the uncompressed step, as the reference's does."""
    from repro_torch.parallel.sharding import preset, rules_for
    from repro_torch.train.optimizer import OptimizerConfig
    from repro_torch.train.train_step import (
        init_train_state, make_train_step, param_specs, shard_params,
    )

    rules = preset(rules_name) if rules_name else rules_for(cfg, "train")
    if opt_cfg is None:
        opt_cfg = OptimizerConfig(
            state_dtype=cfg.optimizer_state_dtype,
            keep_nu_fp32=cfg.optimizer_state_dtype != "bfloat16")
    one = math.prod(mesh.shape.values()) == 1
    applied = grad_compression if "pod" in mesh.shape else None
    notes = {"rules": rules.name, "remat": remat, "accum_steps": accum_steps}
    if grad_compression is not None:
        notes["grad_compression"] = {
            "asked": grad_compression, "applied": applied,
            **({} if applied else {"why": "the mesh has no \"pod\" axis: "
                                   "the reference's step runs "
                                   "uncompressed there"})}
    step = make_train_step(
        cfg, opt_cfg, None if one else mesh, None if one else rules,
        accum_steps=accum_steps, remat=remat, grad_compression=applied,
        unroll=unroll, device="cpu")
    params = _whole_params(cfg)
    if not one:
        params = shard_params(params, param_specs(cfg, rules, mesh), mesh)
    state = init_train_state(params, opt_cfg)
    # a constant step, which the compressed step reads on the host
    state.step = torch.tensor(0, dtype=torch.int32)
    if batch is None:
        batch = {k: _fake(v) for k, v in input_specs(cfg, cell).items()}
    args = {"params": state.params, "mu": state.opt["mu"],
            "nu": state.opt["nu"], "count": state.opt["count"],
            "step": state.step, "batch": batch}
    return Built(lambda: step(state, batch), args, notes)


def _serving_params(cfg, mesh, rules):
    from repro_torch.models.model import serving_part

    return serving_part(_whole_params(cfg), cfg, rules, mesh)


def build_prefill(cfg: ModelConfig, mesh, cell, *, unroll: bool = False,
                  batch=None) -> Built:
    """`make_prefill_step` on the whole batch of the cell's rows (fake,
    or ``batch``; the rank prefills its rows of `prefill_layout`: over
    ("pod", "data") as the reference lowers its prefill), the serving
    rank's parameters (`serving_part`) and its part of the rows' cache
    (`init_cache` under the step's layout)."""
    from repro_torch.models.model import init_cache
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.serve.engine import make_prefill_step

    rules = rules_for(cfg, "prefill")
    B, S = cell.global_batch, cell.seq_len
    step = make_prefill_step(cfg, mesh, rules, batch=B, unroll=unroll)
    params = _serving_params(cfg, mesh, rules)
    rows = B // mesh.size(step.layout.rows)
    cache = init_cache(cfg, rows, S, device="cpu", layout=step.layout)
    if batch is None:
        batch = {k: _fake(v) for k, v in input_specs(cfg, cell).items()}

    def run():
        return step(params, batch, cache)

    return Built(run, {"params": params, "batch": batch, "cache": cache},
                 {"rules": rules.name, "rows": list(step.layout.rows)})


def build_decode(cfg: ModelConfig, mesh, cell, *,
                 unroll: bool = False) -> Built:
    """`make_decode_step` (the rank decodes its rows of the serving
    layout), the serving rank's parameters and its part of the cache."""
    from repro_torch.models.model import init_cache
    from repro_torch.parallel.sharding import rules_for
    from repro_torch.serve.engine import make_decode_step

    workload = "decode_long" if cell.name == "long_500k" else "decode"
    rules = rules_for(cfg, workload)
    B, S = cell.global_batch, cell.seq_len
    step = make_decode_step(cfg, mesh, rules, B, unroll=unroll)
    params = _serving_params(cfg, mesh, rules)
    rows = B // mesh.size(step.layout.rows)
    cache = init_cache(cfg, rows, S, device="cpu", layout=step.layout)
    specs = input_specs(cfg, cell)
    tokens, lengths = _fake(specs["tokens_t"]), _fake(specs["lengths"])

    def run():
        return step(params, tokens, cache, lengths)

    return Built(run, {"params": params, "cache": cache,
                       "batch": {"tokens_t": tokens, "lengths": lengths}},
                 {"rules": rules.name})


def build_step(cfg, mesh, cell, *, unroll: bool = False, **kw) -> Built:
    if cell.kind == "train":
        return build_train(cfg, mesh, cell, unroll=unroll, **kw)
    if cell.kind == "prefill":
        return build_prefill(cfg, mesh, cell, unroll=unroll,
                             batch=kw.get("batch"))
    return build_decode(cfg, mesh, cell, unroll=unroll)


# ---------------------------------------------------------------------------
# Tracing and analysis
# ---------------------------------------------------------------------------

def trace(cfg, mesh, cell, *, unroll: bool = False, fake: bool = True,
          **build_kw) -> tuple[OpCounter, Built]:
    """Builds the cell's step on fake tensors and counts one call of it
    (inside the fake world the caller made).  With ``fake=False`` the
    step is built and run on real CPU tensors in a real world (the same
    count of the same calls, for a small config: the tests hold the two
    against each other)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.layers import _rope_freqs

    mode = (FakeTensorMode(allow_non_fake_inputs=True) if fake
            else contextlib.nullcontext())
    try:
        with mode:
            built = build_step(cfg, mesh, cell, unroll=unroll, **build_kw)
            counter = OpCounter()
            with recording(counter):
                built.run()
    finally:
        _rope_freqs.cache_clear()       # it may hold fake tensors now
    return counter, built


def costs_of(counter: OpCounter) -> dict[str, float]:
    """The counter's numbers as one flat dict (what the depth variants
    extrapolate): traced ops, collectives, and its sites at the plain and
    the kernel models (their FLOPs by dtype: the plain versions compute in
    float32, the kernels in the site's dtype)."""
    c = {"ops_bytes": float(counter.bytes)}
    for dt, f in counter.flops.items():
        c[f"ops_flops:{dt}"] = float(f)
    for k in COLLECTIVE_KINDS:
        c[f"coll:{k}"] = float(counter.coll[k])
    for k, v in counter.links.items():
        c[f"link:{k}"] = float(v)
    for site in counter.sites:
        pb, pf = plain_cost(site)
        kb, kf = kernel_cost(site)
        c["plain_bytes"] = c.get("plain_bytes", 0.0) + pb
        key = "plain_flops:float32"
        c[key] = c.get(key, 0.0) + pf
        c["kernel_bytes"] = c.get("kernel_bytes", 0.0) + kb
        key = f"kernel_flops:{site.dtype}"
        c[key] = c.get(key, 0.0) + kf
    return c


def _by_dtype(c: dict, *prefixes: str) -> dict[str, float]:
    out: dict[str, float] = {}
    for key, v in c.items():
        head, _, dt = key.partition(":")
        if head in prefixes:
            out[dt] = out.get(dt, 0.0) + v
    return out


def _coll_detail(c: dict) -> dict[str, float]:
    out = {k: c.get(f"coll:{k}", 0.0) for k in COLLECTIVE_KINDS}
    out["total"] = sum(out.values())
    out["nvlink"] = c.get("link:nvlink", 0.0)
    out["network"] = c.get("link:network", 0.0)
    return out


def _terms(flops: dict[str, float], nbytes: float, c: dict,
           model_flops: float) -> dict[str, Any]:
    terms = step_bound(flops, nbytes, {"nvlink": c.get("link:nvlink", 0.0),
                                       "network": c.get("link:network",
                                                        0.0)})
    total = sum(flops.values())
    bound = max(terms.values())
    return {
        **terms,
        "bottleneck": max(terms, key=terms.get),
        "hlo_flops_per_chip": total,
        "hlo_bytes_per_chip": nbytes,
        "flops_by_dtype": flops,
        "model_flops_per_chip": model_flops,
        "useful_flop_ratio": model_flops / total if total else 0.0,
        "step_time_lower_bound_s": bound,
        "roofline_fraction": (min(1.0, model_flops / H100["bf16_flops_per_s"]
                                  / bound) if bound > 0 else 0.0),
    }


def model_flops_per_chip(cfg: ModelConfig, cell, chips: int) -> float:
    """The reference's useful work: 6 (train) or 2 (inference) x active
    parameters x the step's tokens, over the chips."""
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode"
                                  else 1)
    mult = 6 if cell.kind == "train" else 2
    return mult * cfg.active_param_count_estimate() * tokens / chips


def analyze(c: dict, cfg, cell, chips: int, sites=None) -> dict[str, Any]:
    """The rooflines of a cost dict (`costs_of`, or extrapolated): the
    sites at their plain versions (``roofline``) and at the kernel model
    (``roofline_kernel_adjusted``; with the recorded ``sites``,
    `kernel_adjusted`'s breakdown of the swap beside it)."""
    mf = model_flops_per_chip(cfg, cell, chips)
    plain = _by_dtype(c, "ops_flops", "plain_flops")
    plain_bytes = c["ops_bytes"] + c.get("plain_bytes", 0.0)
    kernel = _by_dtype(c, "ops_flops", "kernel_flops")
    kernel_bytes = c["ops_bytes"] + c.get("kernel_bytes", 0.0)
    out = {"roofline": _terms(plain, plain_bytes, c, mf),
           "roofline_kernel_adjusted": _terms(kernel, kernel_bytes, c, mf)}
    if sites is not None:
        raw = {"flops": sum(plain.values()), "bytes": plain_bytes}
        adj = kernel_adjusted(raw, cfg, cell, chips, sites=sites)
        out["roofline_kernel_adjusted"]["adjustment"] = {
            k: v for k, v in adj.items() if k not in ("flops", "bytes")}
    return out


def _depth_variants(cfg: ModelConfig):
    """(variant_cfgs, extrapolate): the reference's unrolled variants at
    depth 1×period and 2×period (and, for enc-dec, 1×/2× encoder depth),
    extrapolated linearly.  The reference needs them because XLA counts a
    while-loop body once; the port's trace counts every layer, so the
    extrapolation equals the full-depth count (a check of the count)."""
    p = cfg.period
    if cfg.encoder is None:
        v1 = dataclasses.replace(cfg, n_layers=p)
        v2 = dataclasses.replace(cfg, n_layers=2 * p)

        def extrapolate(costs):
            c1, c2 = costs
            keys = set(c1) | set(c2)
            body = {k: max(c2.get(k, 0.0) - c1.get(k, 0.0), 0.0)
                    for k in keys}
            return {k: c1.get(k, 0.0) + (cfg.n_scan - 1) * body[k]
                    for k in keys}

        return [v1, v2], extrapolate

    enc = cfg.encoder
    v11 = dataclasses.replace(cfg, n_layers=p,
                              encoder=dataclasses.replace(enc, n_layers=1))
    v21 = dataclasses.replace(cfg, n_layers=2 * p,
                              encoder=dataclasses.replace(enc, n_layers=1))
    v12 = dataclasses.replace(cfg, n_layers=p,
                              encoder=dataclasses.replace(enc, n_layers=2))

    def extrapolate(costs):
        c11, c21, c12 = costs
        keys = set(c11) | set(c21) | set(c12)
        g = {k: (c11.get(k, 0.0), c21.get(k, 0.0), c12.get(k, 0.0))
             for k in keys}
        return {k: a + (cfg.n_scan - 1) * (b - a) + (enc.n_layers - 1)
                * (e - a) for k, (a, b, e) in g.items()}

    return [v11, v21, v12], extrapolate


def _memory(built: Built, counter: OpCounter) -> dict[str, Any]:
    args = {name: _bytes_of(tree) for name, tree in built.arguments.items()}
    arg = sum(args.values())
    peak = arg + counter.peak
    return {"argument_size_in_bytes": arg, "arguments": args,
            "temp_size_in_bytes": counter.peak,
            "peak_memory_in_bytes": peak, "hbm_bytes": H100["hbm_bytes"],
            "fits_hbm": peak <= H100["hbm_bytes"]}


def analyse_step(cfg: ModelConfig, cell, mesh, *, analysis: bool = True,
                 **build_kw) -> dict[str, Any]:
    """One cell's numbers on ``mesh`` (inside the fake world the caller
    made): the full-depth trace, then (with ``analysis``) the depth
    variants."""
    chips = math.prod(mesh.shape.values())
    t0 = time.time()
    counter, built = trace(cfg, mesh, cell, **build_kw)
    c = costs_of(counter)
    result = {
        "arch": cfg.name, "cell": cell.name, "kind": cell.kind,
        "mesh": dict(mesh.shape), "chips": chips, "trace": "fake cpu",
        **built.notes,
        "sites": dict(Counter(s.kernel for s in counter.sites)),
        "collective_bytes_per_chip": _coll_detail(c),
        "memory": _memory(built, counter),
    }
    rl = analyze(c, cfg, cell, chips, counter.sites)
    result["hlo_flops_per_chip"] = rl["roofline"]["hlo_flops_per_chip"]
    result["hlo_bytes_per_chip"] = rl["roofline"]["hlo_bytes_per_chip"]
    result["roofline"] = rl["roofline"]
    result["roofline_kernel_adjusted"] = {
        **rl["roofline_kernel_adjusted"],
        "collective_bytes_per_chip": result["collective_bytes_per_chip"]}
    result["trace_s"] = round(time.time() - t0, 2)
    if analysis:
        t0 = time.time()
        variants, extrapolate = _depth_variants(cfg)
        full = extrapolate([costs_of(trace(v, mesh, cell, unroll=True,
                                           **build_kw)[0])
                            for v in variants])
        ex = analyze(full, cfg, cell, chips)
        result["roofline_extrapolated"] = {
            **ex["roofline"],
            "collective_bytes_per_chip": _coll_detail(full)}
        result["analysis_s"] = round(time.time() - t0, 2)
    result["cuda_initialized"] = torch.cuda.is_initialized()
    return result


def run_cell(arch: str, shape: str, *, multi_pod: bool = False,
             verbose: bool = True, analysis: bool = True,
             **build_kw) -> dict[str, Any]:
    """One (arch × shape × mesh) cell in a fake world of 256 ranks (512
    with ``multi_pod``) on the production mesh; the reference's skips
    are returned as such."""
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(arch)
    cell = SHAPES[shape]
    runs, reason = applicable(cfg, cell)
    if not runs:
        return {"arch": arch, "cell": shape, "skipped": True,
                "reason": reason}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        result = analyse_step(cfg, cell, mesh, analysis=analysis,
                              **build_kw)
    if verbose:
        ma = result["memory"]
        r = result.get("roofline_kernel_adjusted", result["roofline"])
        print(
            f"[dryrun] {arch} × {shape} × {'2x16x16' if multi_pod else '16x16'}"
            f" OK  trace={result['trace_s']:.1f}s"
            f" flops/chip={r['hlo_flops_per_chip']:.3g}"
            f" bytes/chip={r['hlo_bytes_per_chip']:.3g}"
            f" coll/chip={result['collective_bytes_per_chip']['total']:.3g}"
            f" peak={ma['peak_memory_in_bytes'] / 2**30:.1f}GiB"
            f" bottleneck={r['bottleneck']}"
            f" roofline={r['roofline_fraction']:.2%}", flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCH_NAMES)
    ap.add_argument("--shape", default=None, choices=tuple(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="single",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default=None, help="output dir for JSON")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--grad-compression", default=None)
    ap.add_argument("--rules", default=None,
                    help="sharding preset override (e.g. zero3, zero3_ep)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ARCH_NAMES for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    results = []
    for arch, shape in cells:
        for mp in meshes:
            kw = {}
            if SHAPES[shape].kind == "train":
                kw = dict(remat=args.remat, accum_steps=args.accum_steps,
                          grad_compression=args.grad_compression,
                          rules_name=args.rules)
            try:
                # the reference runs its depth variants single-pod only
                # (each costs a compile); a trace is cheap, so both meshes
                res = run_cell(arch, shape, multi_pod=mp, **kw)
            except Exception as e:
                res = {"arch": arch, "cell": shape, "multi_pod": mp,
                       "error": f"{type(e).__name__}: {e}"}
                print(f"[dryrun] {arch} × {shape} FAILED: {e}", flush=True)
            res["multi_pod"] = mp
            results.append(res)
            if args.out:
                os.makedirs(args.out, exist_ok=True)
                suffix = "multi" if mp else "single"
                with open(os.path.join(
                        args.out, f"{arch}_{shape}_{suffix}.json"), "w") as f:
                    json.dump(res, f, indent=1)
    n_err = sum(1 for r in results if "error" in r)
    print(f"[dryrun] done: {len(results)} cells, {n_err} errors")
    return 1 if n_err else 0


__all__ = ["OpCounter", "SiteRecorder", "recording", "fake_world",
           "build_train", "build_prefill", "build_decode", "build_step",
           "trace", "costs_of", "analyze", "analyse_step",
           "model_flops_per_chip", "run_cell", "main", "link_class",
           "nbytes"]


if __name__ == "__main__":
    raise SystemExit(main())
