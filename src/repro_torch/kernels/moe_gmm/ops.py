"""Expert-grouped matmul (ragged GEMM): the Hopper kernel for CUDA
tensors, the plain PyTorch version for CPU tensors.

``gmm(lhs, rhs, group_sizes)`` computes ``out[t] = lhs[t] @ rhs[e(t)]``
for rows sorted by expert (see `ref.py`), with float32 accumulation, and
zeros for the rows past ``sum(group_sizes)``.  It takes any group sizes,
zero-sized and unaligned ones included, as the JAX package's ``ops.gmm``
does off the TPU through ``lax.ragged_dot``.  ``out_dtype`` defaults to
``lhs.dtype``; the MoE layer asks for float32, the reference's
``preferred_element_type``.

On a CUDA tensor `gmm` checks dtype, shape, contiguity and device, then
launches one of the two instances of `gmm.cu` on the current stream, or
raises; it never reads the group sizes on the host, so it does not
synchronise.  `route` picks the instance from dtype, shape and alignment
alone: the tensor-core instance (``"wgmma"``: TMA ring, wgmma) for
bfloat16 inputs whose K and N are multiples of 8 and whose tensors are
16-byte aligned, which is every expert product of the MoE layer in
bfloat16; the SIMT instance (``"simt"``) for float32 inputs (FP32 FMAs:
TF32 would miss the 1e-4 tolerance) and for the bfloat16 shapes TMA
cannot take.  `launch_counts["gmm"]` counts both; `route_counts` counts
each.  On a CPU tensor, and only there, `gmm` runs `gmm_plain`, a loop of
one matmul per group.

A CUDA call that autograd records goes through `GmmFn`, whose backward
(`gmm_backward`) launches `gmm_bwd.cu` (its own library: `build_backward`,
`bwd_build_log`) for only the gradients autograd asks for.  Its
tensor-core instance runs clusters of two blocks on 128 x 256 output
tiles (`BWD_TILE`, `BWD_CLUSTER`): dlhs = dout rhs[e]^T one cluster per
(expert, 128-row tile within its group, pair of column tiles), the pair
sharing the dout rows; drhs[e] = lhs[rows of e]^T dout[rows of e] on a
persistent grid of as many clusters as fit on the card (`drhs_clusters`)
walking (expert, pair of K tiles, N tile) experts slowest, the pair
sharing the dout rows.  `dlhs_tile` and `drhs_walk` are those walks in
plain Python, for the tests.  `bwd_stream_floor` is its floor probe (the
rings without the products).  `bwd_route` names
its instance by the forward's rules: the tensor cores (``"wgmma"``) take
the output gradient rounded once to bfloat16 (one cast pass here, as a
TPU's default-precision product rounds a float32 operand), the SIMT
instance keeps it float32.  `launch_counts["gmm_bwd"]` counts each
backward call (one launch of the library, one or two kernels),
`bwd_route_counts` each instance.  On CPU tensors `GmmFn` and
`gmm_backward` run `gmm_plain` and `ref.gmm_backward_reference`.

`tile_expert_map` is the reference kernel's row-tile-to-expert map for
groups aligned to the row tile (``kernel.py:63``); the CUDA kernel walks
the general (expert, tile-within-group) pairs of ragged groups itself.

The CUDA sources are built at first use by `repro_torch.kernels.build`
(nvcc into ``build/repro_torch/``, bound with ctypes, no PyTorch headers;
the tensor-map encoder is looked up through the CUDA runtime, so no
``-lcuda``), each into a library of its own.

While the dry-run records (`kernels.sites.recorder`, `launch.dryrun`),
each wrapper hands its call to the recorder before it looks at the
device: nothing is built, launched or counted.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import sites
from repro_torch.kernels.build import build_library, launch_counts
from repro_torch.kernels.moe_gmm.ref import (
    expert_of_row, gmm_backward_reference, gmm_reference,
)

SOURCE = Path(__file__).with_name("gmm.cu")
BWD_SOURCE = Path(__file__).with_name("gmm_bwd.cu")
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
              "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: rows per tile: the prefill-sized tile, and the tile for groups of a few
#: rows (decode), taken when the mean group T / E is at most SMALL_GROUP
BIG_TILE, SMALL_TILE, SMALL_GROUP = 64, 8, 16
#: rows per tile of the tensor-core instance: one 64-row warpgroup, or 2
#: or 3 sharing each weight stage, or 8 lhs rows a stage for the decode's
#: groups of a few rows
TC_TILES = (8, 64, 128, 192)
#: the tensor-core backward's output tile (rows, columns) of a block and
#: the blocks of a cluster (`gmm_bwd.cu`'s kTcRows, kTcCols, kCluster)
BWD_TILE, BWD_CLUSTER = (128, 256), 2
_MAX_COL_TILES = 65535          # the SIMT grid's y axis, 128 columns each
_INT32_MAX = 2 ** 31 - 1
#: launches by instance since the count was last reset; only the CUDA
#: branch of `gmm` adds to it, once per launch, beside launch_counts["gmm"]
route_counts = {"wgmma": 0, "simt": 0}
#: the backward's calls by instance, beside launch_counts["gmm_bwd"]
bwd_route_counts = {"wgmma": 0, "simt": 0}
_lib: ctypes.CDLL | None = None
_bwd_lib: ctypes.CDLL | None = None
#: nvcc's output (ptxas register and shared-memory report) of the build
#: this process loaded, or None before the first build.
build_log: str | None = None
bwd_build_log: str | None = None


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def gmm_plain(lhs: torch.Tensor, rhs: torch.Tensor,
              group_sizes: torch.Tensor, *,
              out_dtype: torch.dtype | None = None,
              host_sizes: tuple[int, ...] | None = None) -> torch.Tensor:
    """One float32 matmul per group, no gather; rows past the total are
    zero, and a group reaching past row T is cut there.  ``host_sizes``,
    when the caller knows the sizes on the host (the MoE layer's constant
    capacity), are read instead of the tensor."""
    T = lhs.shape[0]
    out = torch.zeros((T, rhs.shape[2]), dtype=torch.float32,
                      device=lhs.device)
    start = 0
    sizes = group_sizes.tolist() if host_sizes is None else host_sizes
    for g, size in enumerate(sizes):
        end = min(start + max(int(size), 0), T)
        if end > start:
            out[start:end] = lhs[start:end].float() @ rhs[g].float()
        start = end
    return out.to(out_dtype or lhs.dtype)


def tile_expert_map(group_sizes: torch.Tensor, n_tiles: int,
                    bt: int) -> torch.Tensor:
    """Expert id owning each row tile of ``bt`` rows (tiles past the
    total get E), for groups that are multiples of ``bt``."""
    offsets = torch.cumsum(group_sizes, 0)                  # end offsets
    starts = torch.arange(n_tiles, dtype=offsets.dtype,
                          device=group_sizes.device) * bt   # tile start rows
    return (starts[:, None] >= offsets[None, :]).sum(1).to(torch.int32)


# ---------------------------------------------------------------------------
# the Hopper kernel
# ---------------------------------------------------------------------------

def build() -> Path:
    """Compile `gmm.cu` unless this source and these flags were built
    before; returns the shared library's path."""
    global build_log
    out, log = build_library(SOURCE, NVCC_FLAGS)
    if log is not None:
        build_log = log
    return out


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gmm_launch.argtypes = [i, i, i, i, vp, vp, vp, vp, i, i, i, i,
                                   vp]
        lib.gmm_launch.restype = i
        lib.gmm_wgmma_launch.argtypes = [i, i, i, i, vp, vp, vp, vp, i, i,
                                         i, i, vp]
        lib.gmm_wgmma_launch.restype = i
        lib.gmm_wgmma_smem_bytes.argtypes = [i]
        lib.gmm_wgmma_smem_bytes.restype = i
        lib.gmm_error_string.argtypes = [i]
        lib.gmm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def build_backward() -> Path:
    """Compile `gmm_bwd.cu` unless this source and these flags were built
    before; returns the shared library's path."""
    global bwd_build_log
    out, log = build_library(BWD_SOURCE, NVCC_FLAGS)
    if log is not None:
        bwd_build_log = log
    return out


def _bwd_library() -> ctypes.CDLL:
    global _bwd_lib
    if _bwd_lib is None:
        lib = ctypes.CDLL(str(build_backward()))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gmm_bwd_launch.argtypes = [i, i, i, vp, vp, vp, vp, vp, vp, i, i,
                                       i, i, vp]
        lib.gmm_bwd_launch.restype = i
        lib.gmm_bwd_wgmma_launch.argtypes = [i, i, vp, vp, vp, vp, vp, vp, i,
                                             i, i, i, vp]
        lib.gmm_bwd_wgmma_launch.restype = i
        lib.gmm_bwd_drhs_clusters.argtypes = [i]
        lib.gmm_bwd_drhs_clusters.restype = i
        lib.gmm_bwd_error_string.argtypes = [i]
        lib.gmm_bwd_error_string.restype = ctypes.c_char_p
        _bwd_lib = lib
    return _bwd_lib


def row_tile(T: int, E: int) -> int:
    """Rows per tile for ``T`` rows in ``E`` groups: a shape, not a
    group size, so choosing needs nothing from the device."""
    return SMALL_TILE if T <= SMALL_GROUP * E else BIG_TILE


def tc_tile(T: int, E: int) -> int:
    """Rows per tile of the tensor-core instance for ``T`` rows in ``E``
    groups: the smallest of `TC_TILES` that holds the mean group T / E
    (a shape: nothing is read from the device), so that a group's rows
    share one weight stream."""
    mean = -(-T // E)
    return next((bm for bm in TC_TILES if mean <= bm), TC_TILES[-1])


def route(lhs: torch.Tensor, rhs: torch.Tensor, out: torch.Tensor) -> str:
    """The instance a CUDA launch takes, from dtype, shape and alignment
    alone: ``"wgmma"`` where TMA can stream bfloat16 operands (K and N
    multiples of 8, so every row stride is a multiple of 16 bytes; lhs,
    rhs and out 16-byte aligned), ``"simt"`` otherwise."""
    K, N = lhs.shape[1], rhs.shape[2]
    if (lhs.dtype == rhs.dtype == torch.bfloat16 and K > 0 and K % 8 == 0
            and N % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (lhs, rhs, out))):
        return "wgmma"
    return "simt"


def bwd_route(lhs: torch.Tensor, rhs: torch.Tensor,
              dout: torch.Tensor) -> str:
    """The instance a backward launch takes: `route`'s rules on lhs, rhs
    and the output gradient (which the backward reads where the forward
    writes its output)."""
    return route(lhs, rhs, dout)


def dlhs_pairs(K: int) -> int:
    """Pairs of column tiles (one a block of a cluster) across dlhs's K
    output columns."""
    return (-(-K // BWD_TILE[1]) + 1) // 2


def dlhs_clusters(T: int, K: int, E: int) -> int:
    """Clusters in dlhs's grid: an upper bound on the row tiles of E
    ragged groups and the zero tail (each may end in a partial tile)
    times the column pairs."""
    return (-(-T // BWD_TILE[0]) + E + 1) * dlhs_pairs(K)


def dlhs_tile(q: int, sizes, T: int, K: int) -> tuple[int, int, int, int]:
    """`find_dlhs_tile` of `gmm_bwd.cu` in plain Python: cluster q's
    (expert, r0, r1, column pair), experts slowest, then column pairs,
    then the expert's 128-row tiles; expert -1 for a tile of the zero
    tail past the groups, -2 past the end."""
    bm, pairs, start = BWD_TILE[0], dlhs_pairs(K), 0
    for e in range(len(sizes) + 1):
        g = (min(max(int(sizes[e]), 0), T - start) if e < len(sizes)
             else T - start)
        nt = -(-g // bm)
        if q < nt * pairs:
            r0 = start + (q % nt) * bm
            return (e if e < len(sizes) else -1, r0, min(start + g, r0 + bm),
                    q // nt)
        q -= nt * pairs
        start += g
    return -2, 0, 0, 0


def drhs_tiles(E: int, K: int, N: int) -> int:
    """drhs's tiles of a cluster: (expert, pair of 128-row tiles of K,
    256-column tile of N)."""
    return E * -(-K // BWD_TILE[1]) * -(-N // BWD_TILE[1])


def drhs_walk(cluster: int, clusters: int, E: int, K: int,
              N: int) -> list[tuple[int, int, int]]:
    """The tiles (expert, first row of K of the pair, first column of N)
    that cluster ``cluster`` of a persistent grid of ``clusters`` visits
    in `gmm_bwd.cu`'s drhs, in order: every ``clusters``-th tile from its
    own, experts slowest."""
    n_k, n_n = -(-K // BWD_TILE[1]), -(-N // BWD_TILE[1])
    return [(q // (n_k * n_n), (q % (n_k * n_n)) // n_n * BWD_TILE[1],
             q % n_n * BWD_TILE[1])
            for q in range(cluster, drhs_tiles(E, K, N), clusters)]


def drhs_clusters(device: torch.device) -> int:
    """The clusters of drhs's persistent grid on ``device``: as many as
    fit on it at once (builds the kernel if need be)."""
    lib = _bwd_library()
    n = lib.gmm_bwd_drhs_clusters(device.index)
    if n <= 0:
        raise RuntimeError("gmm_backward: no cluster of drhs fits: "
                           + lib.gmm_bwd_error_string(-n).decode())
    return n


def wgmma_smem_bytes(bm: int) -> int:
    """Dynamic shared memory of one tensor-core block of ``bm``-row tiles
    (builds the kernel if need be)."""
    return _library().gmm_wgmma_smem_bytes(bm)


def _check(name: str, t: torch.Tensor, dtype, ndim: int, device):
    if t.dtype != dtype:
        raise TypeError(f"gmm: {name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"gmm: {name} must have {ndim} axes, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"gmm: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"gmm: {name} must be contiguous")


def _checked(name: str, lhs: torch.Tensor, rhs: torch.Tensor,
             group_sizes: torch.Tensor) -> tuple[int, int, int, int]:
    """Checks what a launch of either library reads of lhs, rhs and the
    group sizes; returns (T, K, N, E)."""
    dev, dtype = lhs.device, lhs.dtype
    if dtype not in _DTYPES:
        raise TypeError(f"{name}: float32 or bfloat16 only, got {dtype}")
    _check("lhs", lhs, dtype, 2, dev)
    _check("rhs", rhs, dtype, 3, dev)
    _check("group_sizes", group_sizes, torch.int32, 1, dev)
    (T, K), (E, K2, N) = lhs.shape, rhs.shape
    if K2 != K:
        raise ValueError(f"{name}: lhs has K={K} columns, rhs K={K2} rows")
    if group_sizes.shape[0] != E:
        raise ValueError(f"{name}: group_sizes must have shape ({E},), got "
                         f"{tuple(group_sizes.shape)}")
    if min(T, N, E) <= 0:
        raise ValueError(f"{name}: empty shapes T={T} N={N} E={E}")
    return T, K, N, E


def gmm(lhs: torch.Tensor, rhs: torch.Tensor, group_sizes: torch.Tensor, *,
        out_dtype: torch.dtype | None = None,
        host_sizes: tuple[int, ...] | None = None) -> torch.Tensor:
    """Grouped matmul (see the module docstring): lhs (T, K) sorted by
    expert, rhs (E, K, N), group_sizes (E,) int32 -> (T, N) in
    ``out_dtype`` (default lhs.dtype).  ``host_sizes`` are the same sizes
    as host ints where the caller knows them (the MoE layer's capacity):
    the plain version and the dry-run read them instead of the tensor,
    the kernel never reads either on the host.  A CUDA call that
    autograd records goes through `GmmFn`."""
    if sites.recorder is not None:
        return sites.recorder.gmm(lhs, rhs, group_sizes, out_dtype=out_dtype,
                                  host_sizes=host_sizes)
    if lhs.device.type == "cpu":
        return gmm_plain(lhs, rhs, group_sizes, out_dtype=out_dtype,
                         host_sizes=host_sizes)
    if lhs.device.type != "cuda":
        raise ValueError(f"gmm: no kernel for device {lhs.device}")
    if torch.is_grad_enabled() and (lhs.requires_grad or rhs.requires_grad):
        return GmmFn.apply(lhs, rhs, group_sizes, out_dtype)
    dev, dtype = lhs.device, lhs.dtype
    out_dtype = out_dtype or dtype
    if dtype in _DTYPES and out_dtype not in (torch.float32, dtype):
        raise TypeError(f"gmm: out_dtype must be float32 or {dtype}, got "
                        f"{out_dtype}")
    T, K, N, E = _checked("gmm", lhs, rhs, group_sizes)
    lib = _library()
    out = torch.empty((T, N), dtype=out_dtype, device=dev)
    instance = route(lhs, rhs, out)
    bt = tc_tile(T, E) if instance == "wgmma" else row_tile(T, E)
    col_tiles, row_tiles = -(-N // 128), -(-T // bt) + E + 1
    if (row_tiles * col_tiles > _INT32_MAX if instance == "wgmma"
            else col_tiles > _MAX_COL_TILES or row_tiles > _INT32_MAX):
        raise ValueError(f"gmm: shapes T={T} K={K} N={N} E={E} exceed the "
                         f"kernel's grid")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if instance == "wgmma":
        err = lib.gmm_wgmma_launch(
            dev.index, _DTYPES[out_dtype], 1, bt, lhs.data_ptr(),
            rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), T, K, N,
            E, stream)
    else:
        err = lib.gmm_launch(
            dev.index, _DTYPES[dtype], _DTYPES[out_dtype], bt,
            lhs.data_ptr(), rhs.data_ptr(), group_sizes.data_ptr(),
            out.data_ptr(), T, K, N, E, stream)
    if err != 0:
        raise RuntimeError(f"gmm kernel launch failed ({instance}): "
                           + lib.gmm_error_string(err).decode())
    launch_counts["gmm"] += 1
    route_counts[instance] += 1
    return out


def gmm_backward(lhs: torch.Tensor, rhs: torch.Tensor,
                 group_sizes: torch.Tensor, dout: torch.Tensor, *,
                 need: tuple[bool, bool] = (True, True)
                 ) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """(dlhs, drhs) of `gmm` for the output gradient ``dout`` (T, N), in
    lhs's and rhs's dtypes.  On CUDA tensors it checks dtype, shape,
    device and contiguity (``dout`` made contiguous first: autograd may
    hand over a view) and launches the instance `bwd_route` names on the
    current stream for the gradients ``need`` asks for (None for the
    others; nothing at all, and no count, when it asks for neither), or
    raises; on CPU tensors, and only there, it runs
    `ref.gmm_backward_reference`."""
    if sites.recorder is not None:
        return sites.recorder.gmm_backward(lhs, rhs, group_sizes, dout,
                                           need=need)
    if lhs.device.type == "cpu":
        return gmm_backward_reference(lhs, rhs, group_sizes, dout)
    if lhs.device.type != "cuda":
        raise ValueError(f"gmm_backward: no kernel for device {lhs.device}")
    T, K, N, E = _checked("gmm_backward", lhs, rhs, group_sizes)
    dout = dout.contiguous()
    if dout.dtype not in (torch.float32, lhs.dtype):
        raise TypeError(f"gmm_backward: dout must be float32 or "
                        f"{lhs.dtype}, got {dout.dtype}")
    _check("dout", dout, dout.dtype, 2, lhs.device)
    if tuple(dout.shape) != (T, N):
        raise ValueError(f"gmm_backward: dout must have shape {(T, N)}, got "
                         f"{tuple(dout.shape)}")
    if not any(need):
        return None, None
    instance = bwd_route(lhs, rhs, dout)
    if instance == "wgmma":
        too_big = max(BWD_CLUSTER * dlhs_clusters(T, K, E),
                      drhs_tiles(E, K, N)) > _INT32_MAX
    else:
        bt = row_tile(T, E)
        too_big = max(-(-K // 128), -(-N // 128), E) > _MAX_COL_TILES
    if too_big:
        raise ValueError(f"gmm_backward: shapes T={T} K={K} N={N} E={E} "
                         f"exceed the kernel's grid")
    # the one rounding of the cotangent: bfloat16 for the tensor cores,
    # float32 for the SIMT instance (a no-op when it already is)
    dout = dout.to(torch.bfloat16 if instance == "wgmma" else torch.float32)
    dlhs = torch.empty_like(lhs) if need[0] else None
    drhs = torch.empty_like(rhs) if need[1] else None
    ptrs = (dout.data_ptr(), lhs.data_ptr(), rhs.data_ptr(),
            group_sizes.data_ptr(), None if dlhs is None else dlhs.data_ptr(),
            None if drhs is None else drhs.data_ptr())
    lib = _bwd_library()
    dev = lhs.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    if instance == "wgmma":
        err = lib.gmm_bwd_wgmma_launch(dev.index, 1, *ptrs, T, K, N, E,
                                       stream)
    else:
        err = lib.gmm_bwd_launch(dev.index, _DTYPES[lhs.dtype], bt, *ptrs, T,
                                 K, N, E, stream)
    if err != 0:
        raise RuntimeError(f"gmm_backward kernel launch failed ({instance}): "
                           + lib.gmm_bwd_error_string(err).decode())
    launch_counts["gmm_bwd"] += 1
    bwd_route_counts[instance] += 1
    return dlhs, drhs


class GmmFn(torch.autograd.Function):
    """`gmm` with a gradient: the forward is `gmm` (the routed kernel, or
    `gmm_plain` on CPU tensors), and it saves lhs, rhs and the group
    sizes; the backward is `gmm_backward` (the backward kernel, or
    `ref.gmm_backward_reference` on CPU tensors) for the gradients
    autograd asks for."""

    @staticmethod
    def forward(ctx, lhs, rhs, group_sizes, out_dtype):
        ctx.save_for_backward(lhs, rhs, group_sizes)
        return gmm(lhs, rhs, group_sizes, out_dtype=out_dtype)

    @staticmethod
    def backward(ctx, dout):
        lhs, rhs, group_sizes = ctx.saved_tensors
        need = tuple(ctx.needs_input_grad[:2])
        grads = gmm_backward(lhs, rhs, group_sizes, dout, need=need)
        return (*(g if n else None for g, n in zip(grads, need)), None, None)


def stream_floor(lhs: torch.Tensor, rhs: torch.Tensor,
                 group_sizes: torch.Tensor) -> torch.Tensor:
    """Launches the tensor-core instance with its products taken out: the
    same grid, TMA ring and barriers, the output stored as float32 zeros.
    Its time is the floor the design's loads put under `gmm`; it is a
    probe, counted nowhere.  Takes what `route` sends to ``"wgmma"``."""
    if lhs.device.type != "cuda":
        raise ValueError("stream_floor: a probe of the CUDA kernel")
    (T, K), (E, _, N) = lhs.shape, rhs.shape
    out = torch.empty((T, N), dtype=torch.float32, device=lhs.device)
    if route(lhs, rhs, out) != "wgmma" or not (
            lhs.is_contiguous() and rhs.is_contiguous()):
        raise ValueError("stream_floor: inputs the tensor-core instance "
                         "does not take")
    lib = _library()
    err = lib.gmm_wgmma_launch(
        lhs.device.index, 0, 0, tc_tile(T, E), lhs.data_ptr(),
        rhs.data_ptr(), group_sizes.data_ptr(), out.data_ptr(), T, K, N, E,
        torch.cuda.current_stream(lhs.device).cuda_stream)
    if err != 0:
        raise RuntimeError("stream-floor probe launch failed: "
                           + lib.gmm_error_string(err).decode())
    return out


def bwd_stream_floor(lhs: torch.Tensor, rhs: torch.Tensor,
                     group_sizes: torch.Tensor, dout: torch.Tensor,
                     which: str) -> torch.Tensor:
    """Launches the tensor-core backward's kernel of one gradient
    (``which``: "dlhs" or "drhs") with its products taken out: the same
    grid, TMA rings, multicasts and barriers, nothing stored (the
    returned tensor holds no values).  Its time is the floor the design's
    loads put under that gradient; it is a probe, counted nowhere.
    ``dout`` must be bfloat16 (no cast runs); takes what `bwd_route`
    sends to ``"wgmma"``."""
    if lhs.device.type != "cuda":
        raise ValueError("bwd_stream_floor: a probe of the CUDA kernel")
    if which not in ("dlhs", "drhs"):
        raise ValueError(f"bwd_stream_floor: which is dlhs or drhs, got "
                         f"{which!r}")
    T, K, N, E = _checked("bwd_stream_floor", lhs, rhs, group_sizes)
    if (dout.dtype != torch.bfloat16 or tuple(dout.shape) != (T, N)
            or not dout.is_contiguous()
            or bwd_route(lhs, rhs, dout) != "wgmma"):
        raise ValueError("bwd_stream_floor: inputs the tensor-core "
                         "instance does not take")
    out = torch.empty_like(lhs if which == "dlhs" else rhs)
    lib = _bwd_library()
    grads = (out.data_ptr(), None) if which == "dlhs" else (None,
                                                            out.data_ptr())
    err = lib.gmm_bwd_wgmma_launch(
        lhs.device.index, 0, dout.data_ptr(), lhs.data_ptr(), rhs.data_ptr(),
        group_sizes.data_ptr(), *grads, T, K, N, E,
        torch.cuda.current_stream(lhs.device).cuda_stream)
    if err != 0:
        raise RuntimeError("backward floor probe launch failed: "
                           + lib.gmm_bwd_error_string(err).decode())
    return out


__all__ = ["gmm", "gmm_plain", "gmm_reference", "expert_of_row",
           "gmm_backward", "gmm_backward_reference", "GmmFn",
           "tile_expert_map", "row_tile", "tc_tile", "route", "stream_floor",
           "bwd_route", "bwd_route_counts", "bwd_stream_floor",
           "dlhs_tile", "drhs_walk", "drhs_clusters", "wgmma_smem_bytes",
           "build",
           "build_backward", "launch_counts", "route_counts"]
