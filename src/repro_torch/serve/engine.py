"""Serving engine: continuous batching over the model's prefill/decode.

The port of the JAX package's ``serve/engine.py``.  ``make_prefill_step``
/ ``make_decode_step`` build the per-call functions, on one device or
under a mesh; ``ServeEngine`` is the host-side loop used by the examples
and by the provisioner's serve workers: it batches queued requests,
prefills them into free cache rows, decodes all rows each tick, and
reports queue depth -- the demand signal the provisioner scales on
(paper §2: "jobs waiting for resources").

Continuous batching, engine-style: each cache row is a slot; finished
sequences free their slot immediately and the next queued request is
prefilled into it while other rows keep decoding.  A request is
prefilled alone, as a batch of one into a fresh one-row cache, and that
row is copied into its slot of the engine's cache; the decode tick then
runs over every row, and greedy argmax picks each token.

Under a mesh (`launch.mesh.WorkerMesh`) the engine runs SPMD: every
rank runs the same loop over the same requests and holds its part of the
parameters and of the cache as the rules lay them out.  Where the rules
cut activations over "model" (``decode``, ``ep`` and ``decode_sp`` on a
mesh with a "model" axis: activation tensor parallelism) the rank keeps
the "model" cut of the parameters (`models.model.serving_part`: the
weights a call would gather, gathered once) and computes its part of
the heads, MLP columns, SSM heads and vocabulary;
its cache holds its kv heads (else its part of the slots over "model")
and its SSM heads (`models.model.init_cache`'s layout).  The rows are
cut as `parallel.sharding.serving_layout` says: under ``decode`` (and
``ep`` for MoE models) over "data"; under ``decode_sp`` (the rules of
``rules_for(cfg, "decode_long")``) every row, with its part of each
attention cache's slots over "data".  The engine prefills one request as
a batch of one, as the JAX package's does: every rank computes that row,
in the rank's part of a one-row cache, and the rank that holds the row
keeps it (a batched prefill, `make_prefill_step` with ``batch``, cuts
its rows over the mesh instead); a tick's tokens come from the logits
(whole over the vocabulary) gathered over the rows' axes, and the ranks
are held to the same tokens.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch.models import model as model_lib
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import (
    ShardingRules, no_constraint, prefill_layout, rules_for, serving_layout,
)

PyTree = Any


def make_prefill_step(cfg: ModelConfig, mesh, rules: ShardingRules,
                      kv_seq: tuple[str, ...] | None = None, *,
                      batch: int | None = None, unroll: bool = False):
    """``prefill_step(params, batch, cache)``: `models.model.prefill` on
    a whole batch.  Under a mesh the layout is `parallel.sharding.
    prefill_layout`'s for ``batch`` rows (``prefill_step.layout``, the
    constrainer; the cache is the rank's part of it, `models.model.
    init_cache` with ``layout=prefill_step.layout``): with the rows cut
    (over "data", and "pod", where their product divides ``batch``, as
    the reference lowers its prefill) the step takes the whole batch,
    the rank prefills its rows of every entry (tokens, and frames or
    patches), fills its rows' part of the cache, and returns the logits
    (B, V) gathered over the rows' axes and the lengths (B,) whole.
    With ``batch`` unset or 1 (the engine's prefill of one request) or
    the rows uncut, every rank computes every row.  ``kv_seq`` (the
    axes the caches' slots are cut over) defaults to `serving_layout`'s.
    """
    constrain, rows = no_constraint, ()
    if mesh is not None:
        constrain = prefill_layout(rules, mesh, batch, kv_seq)
        rows = constrain.rows

    def prefill_step(params, batch, cache):
        if rows:
            # views: nothing of the batch reaches a kernel as it is
            batch = {k: coll.own_slice(v, mesh, rows, 0)
                     for k, v in batch.items()}
        logits, cache, lengths = model_lib.prefill(
            params, cfg, batch, cache, mesh=mesh, constrain=constrain,
            unroll=unroll)
        if rows:
            # every row has the prompt's length
            logits = coll.all_gather(logits, mesh, rows, 0)
            lengths = lengths.repeat(mesh.size(rows))
        return logits, cache, lengths

    prefill_step.layout = constrain
    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh, rules: ShardingRules,
                     batch: int | None = None, *, unroll: bool = False):
    """``decode_step(params, tokens_t, cache, lengths)``: one token for
    every row.  The tokens (B, 1) and lengths (B,) are whole; under a
    mesh the cache is this rank's part (``decode_step.layout``, the
    `serving_layout` of ``batch`` rows), the rank decodes its rows, and
    the logits (B, V) come back whole, gathered over the rows' axes."""
    if mesh is None:
        def decode_step(params, tokens_t, cache, lengths):
            return model_lib.decode_step(params, cfg, tokens_t, cache,
                                         lengths, unroll=unroll)

        decode_step.layout = None
        return decode_step
    layout = serving_layout(rules, mesh, batch)

    def decode_step(params, tokens_t, cache, lengths):
        # the rank's rows as tensors of their own (the kernels take
        # 16-byte aligned positions)
        logits, cache, _ = model_lib.decode_step(
            params, cfg,
            coll.own_slice(tokens_t, mesh, layout.rows, 0).clone(), cache,
            coll.own_slice(lengths, mesh, layout.rows, 0).clone(),
            mesh=mesh, constrain=layout, unroll=unroll)
        return (coll.all_gather(logits, mesh, layout.rows, 0), cache,
                lengths + 1)

    decode_step.layout = layout
    return decode_step


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # int32 (len,)
    max_new_tokens: int = 16
    submitted_at: float = 0.0
    # filled on completion
    output: list | None = None
    finished_at: float = 0.0


@dataclasses.dataclass
class _Slot:
    rid: int = -1
    remaining: int = 0
    tokens: list = dataclasses.field(default_factory=list)


class ServeEngine:
    """Host loop: queue -> slots -> prefill/decode, on the parameters'
    device, or SPMD on every rank of a ``mesh`` (``rules`` default to
    ``rules_for(cfg, "decode")``; see the module docstring)."""

    def __init__(self, cfg: ModelConfig, params: PyTree, *,
                 batch_slots: int = 4, max_seq: int = 256, mesh=None,
                 rules: ShardingRules | None = None):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.mesh = mesh
        self.device = model_lib.params_device(params)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: deque[Request] = deque()
        self.done: dict[int, Request] = {}
        rules = rules or rules_for(cfg, "decode")
        self._decode = make_decode_step(cfg, mesh, rules, batch_slots)
        self.layout = self._decode.layout
        rows = batch_slots
        if mesh is not None:
            self.params = model_lib.serving_part(params, cfg, rules, mesh)
            rows //= mesh.size(self.layout.rows)
        self._prefill_one = make_prefill_step(
            cfg, mesh, rules, () if mesh is None else self.layout.kv_seq)
        self.cache = model_lib.init_cache(cfg, rows, max_seq,
                                          device=self.device,
                                          layout=self.layout or no_constraint)
        self.lengths = torch.zeros((batch_slots,), dtype=torch.int32,
                                   device=self.device)
        self.last_tok = torch.zeros((batch_slots, 1), dtype=torch.int64,
                                    device=self.device)
        self._reqs: dict[int, Request] = {}
        #: model calls since the engine was made: one prefill per admitted
        #: request, one decode per tick with an active slot
        self.prefill_calls = 0
        self.decode_ticks = 0
        #: the last decode tick's logits (B, V), whole
        self.last_logits = None

    # -- demand signal (paper §2) -----------------------------------------
    def queue_depth(self) -> int:
        return len(self.queue)

    def busy_slots(self) -> int:
        return sum(1 for s in self.slots if s.rid >= 0)

    def submit(self, req: Request):
        req.submitted_at = time.time()
        self.queue.append(req)

    # -- engine tick --------------------------------------------------------
    def _admit(self):
        for i, slot in enumerate(self.slots):
            if slot.rid >= 0 or not self.queue:
                continue
            req = self.queue.popleft()
            self._reqs[req.rid] = req
            prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                     device=self.device)[None, :]
            row_cache = model_lib.init_cache(
                self.cfg, 1, self.max_seq, device=self.device,
                layout=self._prefill_one.layout)
            logits, row_cache, row_len = self._prefill_one(
                self.params, {"tokens": prompt}, row_cache)
            self.prefill_calls += 1
            if self.mesh is None:
                _splice_row(self.cache, row_cache, i)
            else:
                # into the rank's row i, if it holds that row
                rows = self.layout.rows
                per = len(self.slots) // self.mesh.size(rows)
                if i // per == self.mesh.index(rows):
                    _splice_row(self.cache, row_cache, i % per)
            self.lengths[i] = row_len[0]
            nxt = int(self._agreed(torch.argmax(logits[0]))[0])
            self.last_tok[i, 0] = nxt
            slot.rid = req.rid
            slot.remaining = req.max_new_tokens - 1
            slot.tokens = [nxt]

    def _retire(self):
        for slot in self.slots:
            if slot.rid >= 0 and slot.remaining <= 0:
                req = self._reqs.pop(slot.rid)
                req.output = list(slot.tokens)
                req.finished_at = time.time()
                self.done[req.rid] = req
                slot.rid = -1
                slot.tokens = []

    def step(self) -> int:
        """One engine tick. Returns number of active slots."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s.rid >= 0]
        if active:
            logits, self.cache, self.lengths = self._decode(
                self.params, self.last_tok, self.cache, self.lengths)
            self.decode_ticks += 1
            self.last_logits = logits
            nxt = self._agreed(torch.argmax(logits, dim=-1))
            self.last_tok = nxt[:, None]
            host = nxt.tolist()
            for i in active:
                slot = self.slots[i]
                slot.tokens.append(host[i])
                slot.remaining -= 1
        self._retire()
        return len(active)

    def run_until_drained(self, max_ticks: int = 10_000) -> int:
        ticks = 0
        while (self.queue or self.busy_slots()) and ticks < max_ticks:
            self.step()
            ticks += 1
        return ticks

    def _agreed(self, tokens: torch.Tensor) -> torch.Tensor:
        """``tokens`` (at least 1-d), held equal on every rank of the
        mesh: SPMD slots must stay in step."""
        tokens = tokens.reshape(-1)
        if self.mesh is None:
            return tokens
        every = coll.all_gather(tokens.to(torch.int32)[None], self.mesh,
                                self.mesh.axis_names, 0)
        if not bool((every == every[0]).all()):
            raise AssertionError("ServeEngine: the ranks picked different "
                                 "tokens")
        return tokens


def _splice_row(full: PyTree, row: PyTree, i: int):
    """Copies a one-row cache into row ``i`` of the engine's cache (the
    batch axis is axis 1, after the layer-stack axis), whatever the
    slots hold: KV caches, SSM states, or both side by side (jamba)."""
    for k, v in full.items():
        if isinstance(v, dict):
            _splice_row(v, row[k], i)
        else:
            v[:, i:i + 1].copy_(row[k])


__all__ = ["Request", "ServeEngine", "make_prefill_step", "make_decode_step"]
