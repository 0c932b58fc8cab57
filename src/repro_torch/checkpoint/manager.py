"""Checkpointing: atomic, optionally asynchronous, reshard-on-restore.

The port of the JAX package's ``checkpoint/manager.py`` with the same
on-disk format, so that either package restores what the other wrote:

    <dir>/step_<n:08d>/arrays.npz     flat {path: np.ndarray}, the path the
                                      tree's keys joined by "/"
    <dir>/step_<n:08d>/meta.json      {"step": n, "extra": {...}}
    <dir>/step_<n:08d>/DONE           commit marker

The step is written to ``step_<n>.tmp`` and renamed into place (the
commit); bfloat16 and float16 leaves are widened losslessly to float32,
since npz cannot hold bfloat16.  ``keep`` committed steps are kept, the
oldest removed.  In async mode `save` copies the tree to host memory (a
consistent view of the step) and writes it on a background thread, at
most one write outstanding (a save first waits for the last write, so
host memory holds one snapshot at a time).

Trees are nested dicts (lists and tuples by index) of tensors, numpy
arrays or numbers.  The on-disk layout is mesh-agnostic (each leaf
whole), so `restore` can put a step onto one device or onto any mesh:
with ``shardings`` (a spec or a placements tuple per leaf, over a
`launch.mesh.WorkerMesh`) each rank keeps only its shard of each leaf
(`parallel.collectives.shard_of`), reading one leaf at a time.  A
checkpoint written from a mesh of 4 ranks (rank 0 saving the gathered
state) restores onto 8, onto one device, or into the JAX package's
manager, and the reverse.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

PyTree = Any
_SEP = "/"
_WIDENED = (torch.bfloat16, torch.float16)


def _items(tree: PyTree, prefix: tuple = ()):
    """(path, leaf) pairs of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _items(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield _SEP.join(prefix), tree


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype in _WIDENED:
            t = t.float()
        elif t.device.type == "cpu":
            t = t.clone()       # the trainer updates its tensors in place
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name in ("bfloat16", "float16"):
        arr = arr.astype(np.float32)
    return arr


def _flatten_with_paths(tree: PyTree) -> dict[str, np.ndarray]:
    return {path: _host_array(leaf) for path, leaf in _items(tree)}


def _at(tree: PyTree, path: str):
    """The entry of ``tree`` at a leaf path of `_items` (specs and
    placements are tuples, so the path is followed, not the tuples)."""
    for part in path.split(_SEP) if path else ():
        tree = tree[part] if isinstance(tree, dict) else tree[int(part)]
    return tree


def _as_spec(sharding, mesh):
    """A leaf's sharding as a spec: a spec (`parallel.sharding.P`) as it
    is; a placements tuple (one ``Shard(dim)`` or ``Replicate()`` per
    mesh axis, `parallel.sharding.placements`) as the spec that gives
    it."""
    from repro_torch.parallel.sharding import P

    if isinstance(sharding, P):
        return sharding
    from torch.distributed.tensor import Shard
    if len(sharding) != len(mesh.axis_names):
        raise ValueError(f"placements {sharding} for mesh {mesh.shape}")
    cut: dict[int, tuple[str, ...]] = {}
    for name, pl in zip(mesh.axis_names, sharding):
        if isinstance(pl, Shard):
            cut[pl.dim] = cut.get(pl.dim, ()) + (name,)
    n = max(cut, default=-1) + 1
    return P(*(cut.get(d) for d in range(n)))


def _rebuild(target: PyTree, leaves: dict, prefix: tuple = ()) -> PyTree:
    if isinstance(target, dict):
        return {k: _rebuild(v, leaves, prefix + (str(k),))
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return type(target)(_rebuild(v, leaves, prefix + (str(i),))
                            for i, v in enumerate(target))
    return leaves[_SEP.join(prefix)]


class CheckpointManager:
    def __init__(self, directory: str, *, async_mode: bool = True,
                 keep: int = 3):
        self.dir = directory
        self.async_mode = async_mode
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: PyTree, *, blocking: bool = False,
             extra: dict | None = None):
        # at most one outstanding write, and one snapshot in host memory
        self.wait()
        # synchronous device->host snapshot (consistent view of the step)
        host = _flatten_with_paths(tree)
        meta = {"step": int(step), "extra": extra or {}}

        if self.async_mode and not blocking:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True
            )
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: dict, meta: dict):
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        with open(os.path.join(tmp, "DONE"), "w") as f:
            f.write("ok")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic commit
        self._gc()

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if (name.startswith("step_") and not name.endswith(".tmp")
                    and os.path.exists(os.path.join(full, "DONE"))):
                out.append(int(name[5:]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target: PyTree, shardings: PyTree = None,
                *, mesh=None, device: str | torch.device | None = None
                ) -> PyTree:
        """Restore into the structure of ``target`` (a tree of tensors, or
        of anything with a torch ``dtype`` and a whole ``shape``, such as
        `models.model.leaf_tree`'s leaves), each leaf cast to its
        target's dtype.

        ``shardings`` (the structure of ``target``; a spec or a placements
        tuple per leaf) reshard each leaf onto ``mesh`` (this rank's
        `WorkerMesh`): the rank keeps its shard of it, on the mesh's
        device.  Without them a leaf goes to ``device``, else where its
        target leaf lives when that is a tensor, else to the default
        device (cuda: `models.model.resolve_device`)."""
        from repro_torch.models.model import resolve_device
        from repro_torch.parallel.collectives import shard_of

        path = os.path.join(self.dir, f"step_{step:08d}")
        if not os.path.exists(os.path.join(path, "DONE")):
            raise FileNotFoundError(f"no committed checkpoint at {path}")
        if shardings is not None and mesh is None:
            raise ValueError("restore: shardings need the mesh they are over")
        leaves = {}
        # one leaf in host memory at a time
        with np.load(os.path.join(path, "arrays.npz")) as data:
            stored = set(data.files)
            for key, tgt in _items(target):
                if key not in stored:
                    raise KeyError(f"checkpoint missing leaf {key}")
                arr = data[key]
                if tuple(arr.shape) != tuple(tgt.shape):
                    raise ValueError(
                        f"shape mismatch for {key}: ckpt {arr.shape} vs "
                        f"target {tuple(tgt.shape)}"
                    )
                whole = torch.from_numpy(arr)
                if shardings is not None:
                    spec = _as_spec(_at(shardings, key), mesh)
                    leaves[key] = shard_of(whole, spec, mesh).to(
                        device=mesh.device, dtype=tgt.dtype, copy=True)
                    continue
                dev = (device if device is not None else tgt.device
                       if isinstance(tgt, torch.Tensor)
                       else resolve_device(None))
                leaves[key] = whole.to(device=dev, dtype=tgt.dtype)
        return _rebuild(target, leaves)

    def read_meta(self, step: int) -> dict:
        path = os.path.join(self.dir, f"step_{step:08d}", "meta.json")
        with open(path) as f:
            return json.load(f)


__all__ = ["CheckpointManager"]
