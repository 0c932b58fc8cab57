"""Serving engine: continuous batching over the model's prefill/decode.

The port of the JAX package's ``ServeEngine``, the host-side loop used
by the examples and by the provisioner's serve workers: it batches
queued requests, prefills them into free cache rows, decodes all rows
each tick, and reports queue depth -- the demand signal the provisioner
scales on (paper §2: "jobs waiting for resources").

Continuous batching, engine-style: each cache row is a slot; finished
sequences free their slot immediately and the next queued request is
prefilled into it while other rows keep decoding.  A request is
prefilled alone, as a batch of one into a fresh one-row cache, and that
row is copied into its slot of the engine's cache; the decode tick then
runs over every row, and greedy argmax picks each token.

The engine runs on the parameters' device.  The port's `parallel/`
package (sharding rules, meshes, collectives) serves training; serving
under a mesh -- the reference's ``make_prefill_step``/
``make_decode_step`` and its ``decode``/``decode_sp`` presets -- is
still to port (ROADMAP Queue 1, the rest of item 14).
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

PyTree = Any


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
    """Host loop: queue -> slots -> prefill/decode, on one device."""

    def __init__(self, cfg: ModelConfig, params: PyTree, *,
                 batch_slots: int = 4, max_seq: int = 256):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.device = model_lib.params_device(params)
        self.slots = [_Slot() for _ in range(batch_slots)]
        self.queue: deque[Request] = deque()
        self.done: dict[int, Request] = {}
        self.cache = model_lib.init_cache(cfg, batch_slots, max_seq,
                                          device=self.device)
        self.lengths = torch.zeros((batch_slots,), dtype=torch.int32,
                                   device=self.device)
        self.last_tok = torch.zeros((batch_slots, 1), dtype=torch.int64,
                                    device=self.device)
        self._reqs: dict[int, Request] = {}
        #: model calls since the engine was made: one prefill per admitted
        #: request, one decode per tick with an active slot
        self.prefill_calls = 0
        self.decode_ticks = 0

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
            row_cache = model_lib.init_cache(self.cfg, 1, self.max_seq,
                                             device=self.device)
            logits, row_cache, row_len = model_lib.prefill(
                self.params, self.cfg, {"tokens": prompt}, row_cache)
            self.prefill_calls += 1
            _splice_row(self.cache, row_cache, i)
            self.lengths[i] = row_len[0]
            nxt = int(torch.argmax(logits[0]))
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
            logits, self.cache, self.lengths = model_lib.decode_step(
                self.params, self.cfg, self.last_tok, self.cache,
                self.lengths)
            self.decode_ticks += 1
            nxt = torch.argmax(logits, dim=-1)
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


def _splice_row(full: PyTree, row: PyTree, i: int):
    """Copies a one-row cache into row ``i`` of the engine's cache (the
    batch axis is axis 1, after the layer-stack axis), whatever the
    slots hold: KV caches, SSM states, or both side by side (jamba)."""
    for k, v in full.items():
        if isinstance(v, dict):
            _splice_row(v, row[k], i)
        else:
            v[:, i:i + 1].copy_(row[k])


__all__ = ["Request", "ServeEngine"]
