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
M <= 4096, the TPU kernels' envelope, and k <= 32); on a CPU tensor it runs
`nn1_reference` or `knn_reference`. The kNN kernel is compiled for the list
lengths `KNN_KS`; `knn_plan` gives its launch for a shape. Callers reach
them through `ops.common.nn1` and `ops.common.knn`, which choose the route
from shapes.
"""
from __future__ import annotations

import ctypes

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import (KERNEL_MAX_M, KNN_KERNEL_MAX_K,
                                       select_smallest, square_distance3)


@torch.no_grad()
def nn1_reference(src: torch.Tensor, tgt: torch.Tensor):
    """Plain PyTorch version: (B, N, 3) x (B, M, 3) ->
    (min squared distance (B, N) float32, index (B, N) int64)."""
    d = square_distance3(src.float(), tgt.float())
    idx = d.argmin(dim=-1)
    return d.gather(-1, idx.unsqueeze(-1)).squeeze(-1), idx


def _nn1_cuda(src, tgt):
    B, N, C = src.shape
    M = tgt.shape[1]
    if C != 3 or tgt.shape != (B, M, 3):
        raise ValueError(f"nn1 kernel takes (B, N, 3) and (B, M, 3) points; "
                         f"got {tuple(src.shape)} and {tuple(tgt.shape)}")
    if not 1 <= M <= KERNEL_MAX_M or N < 1:
        raise ValueError(f"nn1 kernel takes 1 <= M <= {KERNEL_MAX_M} target "
                         f"points; got N={N}, M={M}")
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    d = torch.empty(B, N, dtype=torch.float32, device=src.device)
    idx = torch.empty(B, N, dtype=torch.int64, device=src.device)
    fn = dispatch.load_kernel("nn1").nn1_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    code = fn(*[ctypes.c_void_p(a.data_ptr()) for a in (src, tgt, d, idx)],
              B, N, M, ctypes.c_void_p(dispatch.current_stream(src)))
    dispatch.check_launch(code, "nn1")
    dispatch.launch_counts["nn1"] += 1
    return d, idx


def nn1(src: torch.Tensor, tgt: torch.Tensor):
    """1-NN: (B, N, 3) x (B, M, 3) -> (min squared distance (B, N), index
    (B, N) int64). Launches the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Carries no gradient."""
    if src.is_cuda:
        return _nn1_cuda(src, tgt)
    return nn1_reference(src, tgt)


# csrc/knn.cu: the list lengths K it is compiled for, the queries of a block
# (four lanes each), the entries of a lane's candidate buffer, the shared
# memory a block may use on an H100
KNN_KS = (1, 5, 20, 32)
KNN_QUERIES, KNN_LANES, KNN_BUFFER = 64, 4, 32
SMEM_LIMIT = 232_448


def knn_compiled_k(k: int) -> int:
    """The smallest compiled K at or above k: the kernel writes the first k
    of its K pairs, which are the k smallest in order."""
    return next(K for K in KNN_KS if K >= k)


def knn_plan(B: int, N: int, M: int, k: int) -> dict:
    """The kNN kernel's launch as a pure function of the shapes, mirroring
    `csrc/knn.cu:knn_launch`: the compiled K, a block of KNN_QUERIES queries
    (a grid of query blocks x B), and its dynamic shared memory, the target
    as (x, y, z, |t|^2) and each lane's candidate buffer or, in the same
    bytes, the four lanes' lists of every query for the merge."""
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
    if not 1 <= M <= KERNEL_MAX_M or N < 1 or not 1 <= k <= min(KNN_KERNEL_MAX_K, M):
        raise ValueError(f"knn kernel takes 1 <= M <= {KERNEL_MAX_M} target "
                         f"points and 1 <= k <= min({KNN_KERNEL_MAX_K}, M); "
                         f"got N={N}, M={M}, k={k}")
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    idx = torch.empty(B, N, k, dtype=torch.int64, device=src.device)
    fn = dispatch.load_kernel("knn").knn_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    code = fn(*[ctypes.c_void_p(a.data_ptr()) for a in (src, tgt, idx)],
              B, N, M, k, knn_plan(B, N, M, k)["K"],
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
