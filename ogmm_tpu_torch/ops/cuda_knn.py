"""Nearest neighbours of 3-D points: the CUDA kernels' wrappers and their
plain versions.

`nn1(src, tgt)` gives, for every point of src (B, N, 3), the squared
distance to the nearest point of tgt (B, M, 3), clamped at 1e-12, and that
point's index; among equal minima the first index wins. `knn(src, tgt, k)`
gives the indices of the k nearest points of tgt, in ascending distance,
ties to the lowest index. Distances take the fixed float32 order of
`square_distance3`, in the kernels as here, so kernel and plain version
pick the same indices bit for bit.

On a CUDA tensor a wrapper launches its kernel (`csrc/nn1.cu`, `csrc/knn.cu`;
M <= 4096 and k <= M, the TPU kernels' envelope); on a CPU tensor it runs
`nn1_reference` or `knn_reference`. The launches are pure functions of the
shapes: `nn1_plan` gives the 1-NN kernel's lanes a query and queries a thread,
`knn_plan` the kNN kernel's selection (the register lists at a compiled
length `KNN_KS` up to k = 32, `csrc/knn_wide.cuh` above), grid and shared
memory. Callers reach them through `ops.common.nn1` and `ops.common.knn`,
which choose the route from shapes.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import (KERNEL_MAX_M, select_smallest,
                                       square_distance3)
from ogmm_tpu_torch.ops.cuda_stream import _ptr, _sm_count


@torch.no_grad()
def nn1_reference(src: torch.Tensor, tgt: torch.Tensor):
    """Plain PyTorch version: (B, N, 3) x (B, M, 3) ->
    (min squared distance (B, N) float32, index (B, N) int64)."""
    d = square_distance3(src.float(), tgt.float())
    idx = d.argmin(dim=-1)
    return d.gather(-1, idx.unsqueeze(-1)).squeeze(-1), idx


# csrc/nn1.cu: threads of a block, the lanes a query it is compiled for,
# the queries a thread nn1_plan prefers, and the blocks an SM it aims at
NN1_THREADS = 256
NN1_LANES = (4, 8, 16)
NN1_PLAN_ROWS = 2
NN1_BLOCKS_AN_SM = 4


class Nn1Plan(NamedTuple):
    lanes: int     # adjacent threads of a warp a query
    rows: int      # queries a thread
    queries: int   # queries a block
    blocks: int    # the grid: query blocks x B


def nn1_plan_with(B: int, N: int, lanes: int, rows: int) -> Nn1Plan:
    """The 1-NN kernel's launch at `lanes` lanes a query and `rows` queries a
    thread: a block of NN1_THREADS / lanes * rows queries, each block the
    whole target of its cloud."""
    queries = NN1_THREADS // lanes * rows
    return Nn1Plan(lanes, rows, queries, -(-N // queries) * B)


@functools.lru_cache(maxsize=256)
def nn1_plan(B: int, N: int, n_sm: int) -> Nn1Plan:
    """The 1-NN kernel's launch as a pure function of the shape:
    NN1_PLAN_ROWS queries a thread and the fewest lanes a query (NN1_LANES)
    whose query blocks give the n_sm SMs NN1_BLOCKS_AN_SM blocks each; else
    the most lanes, with one query a thread where two would leave SMs
    without a block. (Measured on an H100, PERF.md §6: at the four shapes
    the paths launch each plan was within 3% of the fastest of every lanes
    and queries a thread; where the queries leave SMs idle, (4, 16, 2048),
    (1, 128, 717) and (1, 717, 717), a split of the target with a merge
    launch was slower between calls at all three and on the device at two.
    The compiled pairs are those this returns.)"""
    for lanes in NN1_LANES:
        plan = nn1_plan_with(B, N, lanes, NN1_PLAN_ROWS)
        if plan.blocks >= NN1_BLOCKS_AN_SM * n_sm:
            return plan
    plan = nn1_plan_with(B, N, NN1_LANES[-1], NN1_PLAN_ROWS)
    if plan.blocks >= n_sm:
        return plan
    return nn1_plan_with(B, N, NN1_LANES[-1], 1)


_NN1_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def _nn1_cuda(src, tgt, plan=None):
    B, N, C = src.shape
    M = tgt.shape[1]
    if C != 3 or tgt.shape != (B, M, 3):
        raise ValueError(f"nn1 kernel takes (B, N, 3) and (B, M, 3) points; "
                         f"got {tuple(src.shape)} and {tuple(tgt.shape)}")
    if not 1 <= M <= KERNEL_MAX_M or N < 1:
        raise ValueError(f"nn1 kernel takes 1 <= M <= {KERNEL_MAX_M} target "
                         f"points; got N={N}, M={M}")
    if plan is None:
        plan = nn1_plan(B, N, _sm_count(src.device.index or 0))
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    d = torch.empty(B, N, dtype=torch.float32, device=src.device)
    idx = torch.empty(B, N, dtype=torch.int64, device=src.device)
    code = dispatch.kernel_fn("nn1", "nn1_launch", _NN1_ARGS)(
        _ptr(src), _ptr(tgt), _ptr(d), _ptr(idx), B, N, M, plan.lanes, plan.rows,
        ctypes.c_void_p(dispatch.current_stream(src)))
    dispatch.check_launch(code, "nn1")
    dispatch.launch_counts["nn1"] += 1
    return d, idx


def nn1(src: torch.Tensor, tgt: torch.Tensor):
    """1-NN: (B, N, 3) x (B, M, 3) -> (min squared distance (B, N), index
    (B, N) int64). Launches the CUDA kernel for a CUDA tensor (the plan
    `nn1_plan` gives the shape), the plain version for a CPU tensor. Carries
    no gradient."""
    if src.is_cuda:
        return _nn1_cuda(src, tgt)
    return nn1_reference(src, tgt)


# csrc/knn.cu: the list lengths K it is compiled for (the longest, MAXK, the
# most neighbours of the register lists), the queries of a block (four lanes
# each), the entries of a lane's candidate buffer, the shared memory a block
# may use on an H100
KNN_KS = (1, 5, 20, 32)
LIST_MAX_K = KNN_KS[-1]
KNN_QUERIES, KNN_LANES, KNN_BUFFER = 64, 4, 32
SMEM_LIMIT = 232_448
# csrc/knn_wide.cuh, the selection above LIST_MAX_K: queries a block, warps
# a block where their buffers fit, a warp's least list length, and the
# dynamic shared memory a block may use beside its 96 static bytes
WIDE_QUERIES, WIDE_WARPS, WIDE_MIN_LIST = 32, 8, 32
WIDE_SMEM = SMEM_LIMIT - 3 * WIDE_WARPS * 4


def wide_list(k: int) -> int:
    """A warp's list in the wide selection: the power of two at or above k,
    at least WIDE_MIN_LIST (`csrc/knn_wide.cuh:wide_list`)."""
    p = WIDE_MIN_LIST
    while p < k:
        p *= 2
    return p


def wide_smem(M: int, k: int, warps: int) -> int:
    """The wide selection's dynamic shared memory (`wide_smem`): the cloud
    as (x, y, z, |t|^2), then each warp's keys (max(M, list)) and list."""
    return 16 * M + 4 * warps * (max(M, wide_list(k)) + wide_list(k))


def wide_warps(M: int, k: int) -> int:
    """Warps a block of the wide selection (`wide_warps`): WIDE_WARPS, halved
    until their buffers fit WIDE_SMEM."""
    w = WIDE_WARPS
    while w > 0 and wide_smem(M, k, w) > WIDE_SMEM:
        w //= 2
    return w


_KNN_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def knn_compiled_k(k: int) -> int:
    """The smallest compiled K at or above k: the kernel writes the first k
    of its K pairs, which are the k smallest in order."""
    return next(K for K in KNN_KS if K >= k)


def knn_plan(B: int, N: int, M: int, k: int) -> dict:
    """The kNN kernel's launch as a pure function of the shapes, mirroring
    `csrc/knn.cu:knn_launch`: up to k = LIST_MAX_K the compiled K, a block
    of KNN_QUERIES queries (a grid of query blocks x B), and its dynamic
    shared memory, the target as (x, y, z, |t|^2) and each lane's candidate
    buffer or, in the same bytes, the four lanes' lists of every query for
    the merge; above it the wide selection (`csrc/knn_wide.cuh`), whose K
    is a warp's list (`wide_list`, not read by the launch): a block of
    WIDE_QUERIES queries, `wide_warps` warps, `wide_smem` bytes."""
    if k > LIST_MAX_K:
        warps = wide_warps(M, k)
        return {"K": wide_list(k), "grid": (-(-N // WIDE_QUERIES), B), "threads": 32 * warps,
                "smem": wide_smem(M, k, warps)}
    K = knn_compiled_k(k)
    threads = KNN_QUERIES * KNN_LANES
    return {"K": K, "grid": (-(-N // KNN_QUERIES), B), "threads": threads,
            "smem": max(16 * M + 4 * KNN_BUFFER * threads, threads * K * 8)}


@torch.no_grad()
def knn_reference(src: torch.Tensor, tgt: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version: (B, N, 3) x (B, M, 3) -> int64 (B, N, k), k
    passes of argmin-and-mask over fixed-order float32 distances."""
    return select_smallest(square_distance3(src.float(), tgt.float()), k)


def _knn_cuda(src, tgt, k):
    B, N, C = src.shape
    M = tgt.shape[1]
    if C != 3 or tgt.shape != (B, M, 3):
        raise ValueError(f"knn kernel takes (B, N, 3) and (B, M, 3) points; "
                         f"got {tuple(src.shape)} and {tuple(tgt.shape)}")
    if not 1 <= M <= KERNEL_MAX_M or N < 1 or not 1 <= k <= M:
        raise ValueError(f"knn kernel takes 1 <= k <= M <= {KERNEL_MAX_M} "
                         f"target points; got N={N}, M={M}, k={k}")
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    idx = torch.empty(B, N, k, dtype=torch.int64, device=src.device)
    code = dispatch.kernel_fn("knn", "knn_launch", _KNN_ARGS)(
        _ptr(src), _ptr(tgt), _ptr(idx), B, N, M, k, knn_plan(B, N, M, k)["K"],
        ctypes.c_void_p(dispatch.current_stream(src)))
    dispatch.check_launch(code, "knn")
    dispatch.launch_counts["knn"] += 1
    return idx


def knn(src: torch.Tensor, tgt: torch.Tensor, k: int) -> torch.Tensor:
    """kNN: (B, N, 3) x (B, M, 3) -> int64 (B, N, k), ascending distance,
    ties to the lowest index. Launches the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor. Carries no gradient."""
    if src.is_cuda:
        return _knn_cuda(src, tgt, k)
    return knn_reference(src, tgt, k)
