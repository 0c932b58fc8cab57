"""Meshes over a `torch.distributed` world, and the world's setup.

The port of the JAX package's ``launch/mesh.py``.  One process is one
rank at one mesh coordinate; a mesh names its axes as the reference's
does ("pod", "data", "model").  `WorkerMesh` holds what the per-rank
bodies need: ``shape`` (axis name -> size, which is what the sharding
rules read), the rank's coordinate, and one process group for every set
of axes (an all-reduce over ("data", "model") is one collective).

A mesh spans the first ranks of the world, as the reference's
``make_worker_mesh(n)`` takes the first n of ``jax.devices()``: the
world is the pool of workers, and a mesh of n < world ranks leaves the
rest outside (``inside`` is False there, and such a rank takes part in
none of the mesh's collectives).  Every rank of the world makes every
mesh, in the same order, since making a process group is collective
over the world.

The world is set up by `init_world`: from ``torchrun``'s environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``) or from an
explicit ``init_method`` (a ``file://`` store, or
``tcp://localhost:<port>``), with the backend passed explicitly: "gloo"
(on the CPU, and for several ranks that share one GPU: NCCL refuses two
ranks on one device) or "nccl".  `spawn_world` runs a function on every
rank of a fresh world in processes of its own (the ``spawn`` start
method), with one timeout for the whole world: a rank that fails or
hangs fails the call, and every process is stopped.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import pickle
import queue as queue_mod
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist


def _rank_device(device: str | torch.device | None = None,
                 local_rank: int = 0) -> torch.device:
    """The rank's device: ``cuda:<local_rank % cards>`` for "cuda" (every
    rank on card 0 when the host has one), the CPU for "cpu"."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_world: cuda asked for and no GPU")
        if dev.index is None:
            dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_world(backend: str, *, init_method: str | None = None,
               rank: int | None = None, world_size: int | None = None,
               device: str | torch.device | None = None,
               timeout_s: float = 600.0) -> torch.device:
    """Initialises the default process group and returns the rank's
    device.  Without ``rank`` the world comes from torchrun's environment
    (``env://``)."""
    local_rank = 0
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        init_method = init_method or "env://"
    elif init_method is None or world_size is None:
        raise ValueError("init_world: an explicit rank needs init_method "
                         "and world_size")
    dev = _rank_device(device, local_rank)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dev


class WorkerMesh:
    """A named mesh over the first ranks of the initialised world, in
    row-major rank order (rank = the coordinate flattened in axis order):
    the reference's ``jax.make_mesh(shape, names)`` is ``WorkerMesh(dict(
    zip(names, shape)), device)``.  The device is the GPU unless the
    caller asks for the CPU, as everywhere in the port.  A rank beyond
    the mesh's size is outside it: ``inside`` is False and ``coord`` is
    None."""

    def __init__(self, shape: dict[str, int],
                 device: torch.device | str | None = None):
        from repro_torch.models.model import resolve_device

        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        n = math.prod(self.shape.values())
        world = dist.get_world_size()
        if n > world:
            raise ValueError(f"mesh {self.shape} holds {n} ranks, the world "
                             f"{world}")
        self.device = resolve_device(device)
        self.rank = dist.get_rank()
        self.inside = self.rank < n
        self.coord = None
        if self.inside:
            coord, r = [], self.rank
            for size in reversed(self.shape.values()):
                coord.append(r % size)
                r //= size
            self.coord = dict(zip(self.axis_names, reversed(coord)))
        # one group per non-empty set of axes; every rank of the world makes
        # every group, in one order (a rank outside the mesh gets none)
        self._groups: dict[tuple[str, ...], Any] = {}
        for k in range(1, len(self.axis_names) + 1):
            for axes in itertools.combinations(self.axis_names, k):
                if k == len(self.axis_names) and n == world:
                    mine = dist.group.WORLD
                else:
                    mine, _ = dist.new_subgroups_by_enumeration(
                        self._enumerate(axes))
                self._groups[axes] = mine

    empty = False

    def _enumerate(self, axes) -> list[list[int]]:
        """The rank lists of the groups over ``axes`` (each ascending)."""
        sizes = [self.shape[a] for a in self.axis_names]
        strides = [math.prod(sizes[i + 1:]) for i in range(len(sizes))]
        rest = [a for a in self.axis_names if a not in axes]

        def ranks(coord):
            return sum(coord[a] * strides[self.axis_names.index(a)]
                       for a in self.axis_names)

        out = []
        for fixed in itertools.product(*(range(self.shape[a]) for a in rest)):
            base = dict(zip(rest, fixed))
            out.append(sorted(
                ranks({**base, **dict(zip(axes, free))})
                for free in itertools.product(
                    *(range(self.shape[a]) for a in axes))))
        return out

    def canonical(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or names) present in the mesh, in mesh order."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.canonical(axes))

    def index(self, axes) -> int:
        """The rank's position in the group over ``axes`` (its coordinate
        flattened over them, in mesh order)."""
        i = 0
        for a in self.canonical(axes):
            i = i * self.shape[a] + self.coord[a]
        return i

    def group(self, axes):
        if not self.inside:
            raise RuntimeError(f"rank {self.rank} is outside {self!r}")
        return self._groups[self.canonical(axes)]

    def __repr__(self):
        return f"WorkerMesh({self.shape}, rank={self.rank})"


def make_production_mesh(*, multi_pod: bool = False,
                         device: torch.device | str | None = None
                         ) -> WorkerMesh:
    shape = ({"pod": 2, "data": 16, "model": 16} if multi_pod
             else {"data": 16, "model": 16})
    return WorkerMesh(shape, device)


def make_worker_mesh(n_devices: int | None = None, *,
                     model_parallel: int = 1,
                     device: torch.device | str | None = None
                     ) -> WorkerMesh:
    """("data", "model") over the first ``n_devices`` ranks of the world
    (all of them by default): data = ranks / model_parallel."""
    n = n_devices or dist.get_world_size()
    if n > dist.get_world_size() or n % model_parallel:
        raise ValueError(f"make_worker_mesh: {n} ranks (world "
                         f"{dist.get_world_size()}), model_parallel "
                         f"{model_parallel}")
    return WorkerMesh({"data": n // model_parallel, "model": model_parallel},
                      device)


def mesh_chip_count(mesh) -> int:
    return math.prod(mesh.shape.values())


# ---------------------------------------------------------------------------
# A world in processes of its own
# ---------------------------------------------------------------------------

def _rank_main(fn, rank, world_size, init_method, backend, device, threads,
               args_file, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        with open(args_file, "rb") as f:
            args = pickle.load(f)
        dev = init_world(backend, init_method=init_method, rank=rank,
                         world_size=world_size, device=device)
        out = fn(rank, dev, *args)
        results.put((rank, True, out))
    except BaseException:                          # reported to the parent
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn: Callable, world_size: int, *, backend: str,
                init_file: str | os.PathLike, device: str = "cpu",
                timeout_s: float = 300.0, threads: int | None = 1,
                args: tuple = ()) -> list:
    """Runs ``fn(rank, device, *args)`` on every rank of a world of
    ``world_size`` processes (``spawn``; rendezvous through the
    ``file://`` store ``init_file``, which must not exist yet; the
    arguments are pickled beside it) and returns the ranks' results in
    rank order.  ``fn``, ``args`` and the results must be picklable.  Raises, after stopping every process, when a
    rank raises or dies, or when the world has not finished within
    ``timeout_s``."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    init_method = f"file://{os.path.abspath(init_file)}"
    # the arguments go through a file: a process's own arguments travel in
    # the pipe that starts it, and one larger than the pipe's buffer would
    # make each start wait for the child before to have imported torch
    args_file = f"{os.path.abspath(init_file)}.args"
    with open(args_file, "wb") as f:
        pickle.dump(args, f)
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world_size, init_method, backend, device, threads, args_file,
        results)) for r in range(world_size)]
    for p in procs:
        p.start()
    out: dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn_world: {world_size - len(out)} of {world_size} "
                    f"ranks unfinished after {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"spawn_world: ranks {dead} died "
                                       f"(exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                continue
            if not ok:
                raise RuntimeError(f"spawn_world: rank {rank} failed:\n"
                                   f"{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
        results.close()
    return [out[r] for r in range(world_size)]


__all__ = ["WorkerMesh", "make_production_mesh", "make_worker_mesh",
           "mesh_chip_count", "init_world", "spawn_world"]
