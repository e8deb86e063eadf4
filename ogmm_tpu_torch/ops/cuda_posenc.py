"""Position-encoding angle features: the CUDA kernel's wrapper and its plain
version.

`posenc_angles(points, k)` gives, for every point p of (B, N, 3) clouds,
cos(angle(p -> j-th nearest neighbour, p -> centroid)) for its k nearest
neighbours (ascending distance, ties to the lowest index, the point itself
first), from float32 coordinates; a coincident neighbour gives 0. The
centroid is the cloud's mean: the kernel sums it itself (in another order
than `mean`, within the checks' 1e-5). Neighbours are selected over the
fixed-order float32 distances of `square_distance3`, in the kernel as here.

On a CUDA tensor the wrapper launches `csrc/posenc_angles.cu` (N <= 1024,
k <= 32) with the launch `posenc_plan` picks; on a CPU tensor it runs
`posenc_angles_reference`. The position encoding reaches it when nothing
supplies the angles or a graph (`nn/attention.py:angle_route`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import (gather_neighbors, posenc_alpha,
                                       select_smallest, square_distance3)
from ogmm_tpu_torch.ops.cuda_dgcnn import KERNEL_MAX_N
from ogmm_tpu_torch.ops.cuda_knn import (KNN_LANES, KNN_QUERIES, LIST_MAX_K,
                                         knn_compiled_k)

# csrc/posenc_angles.cu: the lanes kernel's compiled list lengths
# (POSENC_LANES_KS), lanes a query (POSENC_LANES) and threads a block (PT);
# above the largest K the shared selection of the kNN kernel serves
LANES_KS = (1, 2, 5, 8)
LANES = 16
THREADS = 256
KERNEL_MAX_K = LIST_MAX_K     # both selections keep register lists

_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


class PosencPlan(NamedTuple):
    kernel: str     # "lanes" (posenc_lanes_kernel) or "shared" (knn_kernel)
    K: int          # compiled list length, >= k
    lanes: int      # lanes a query
    queries: int    # queries a block
    blocks: int     # blocks of the launch (B times the query blocks)


@functools.lru_cache(maxsize=None)
def posenc_plan(B: int, N: int, k: int) -> PosencPlan:
    """The launch as a pure function of the shapes: k <= 8 takes the lanes
    kernel at the smallest compiled K >= k, 16 lanes a query (on an H100
    0.0291 ms on the device at (24, 717, 5) against 0.0341 at 8 lanes,
    `scripts/torch_port_profile.py --probe posenc_angles`); a larger k takes
    the shared selection at the kNN kernel's compiled K."""
    if not 1 <= k <= min(KERNEL_MAX_K, N) or N > KERNEL_MAX_N:
        raise ValueError(f"posenc_angles kernel takes N <= {KERNEL_MAX_N} and "
                         f"1 <= k <= min({KERNEL_MAX_K}, N); got N={N}, k={k}")
    if k <= LANES_KS[-1]:
        queries = THREADS // LANES
        return PosencPlan("lanes", next(K for K in LANES_KS if K >= k), LANES,
                          queries, B * -(-N // queries))
    return PosencPlan("shared", knn_compiled_k(k), KNN_LANES, KNN_QUERIES,
                      B * -(-N // KNN_QUERIES))


@torch.no_grad()
def posenc_angles_reference(points: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Plain PyTorch version: (B, N, 3) -> (B, N, k) float32."""
    x = points.float()
    idx = select_smallest(square_distance3(x, x), k)
    return posenc_alpha(x, gather_neighbors(x, idx))


def _posenc_angles_cuda(points, k, idx=None):
    """The launch; `idx`, an int32 (B, N, k) tensor on the card, takes the
    neighbours the kernel selects (the checks compare them with the plain
    version's; the main path passes none)."""
    B, N, C = points.shape
    if C != 3:
        raise ValueError(f"posenc_angles kernel takes (B, N, 3) points; got "
                         f"{tuple(points.shape)}")
    plan = posenc_plan(B, N, k)
    x = points.float().contiguous()
    alpha = torch.empty(B, N, k, dtype=torch.float32, device=x.device)
    if idx is not None and (idx.shape != (B, N, k) or idx.dtype != torch.int32
                            or not idx.is_contiguous()):
        raise ValueError(f"idx takes the (B, N, k) = {(B, N, k)} int32 neighbours")
    code = dispatch.kernel_fn("posenc_angles", "posenc_angles_launch", _ARGS)(
        x.data_ptr(), alpha.data_ptr(), None if idx is None else idx.data_ptr(),
        B, N, k, plan.K, plan.lanes, dispatch.current_stream(x))
    dispatch.check_launch(code, "posenc_angles")
    dispatch.launch_counts["posenc_angles"] += 1
    return alpha


def posenc_angles(points: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Angle features (B, N, 3) -> (B, N, k) float32. Launches the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor. Carries no
    gradient (the angles are geometry, as in the JAX package)."""
    if points.is_cuda:
        return _posenc_angles_cuda(points, k)
    return posenc_angles_reference(points, k)
