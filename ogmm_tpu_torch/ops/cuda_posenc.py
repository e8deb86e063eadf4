"""Position-encoding angle features: the CUDA kernel's wrapper and its plain
version.

`posenc_angles(points, k)` gives, for every point p of (B, N, 3) clouds,
cos(angle(p -> j-th nearest neighbour, p -> centroid)) for its k nearest
neighbours (ascending distance, ties to the lowest index, the point itself
first), from float32 coordinates; a coincident neighbour gives 0. The
centroid is the cloud's mean, taken by the same PyTorch call for the kernel
(which is passed it, as the TPU kernel is) and the plain version. Neighbours are selected over the fixed-order
float32 distances of `square_distance3`, in the kernel as here.

On a CUDA tensor the wrapper launches `csrc/posenc_angles.cu` (N <= 1024,
k <= 32); on a CPU tensor it runs `posenc_angles_reference`. The position
encoding reaches it when nothing supplies the angles or a graph
(`nn/attention.py:angle_route`).
"""
from __future__ import annotations

import ctypes

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import (KNN_KERNEL_MAX_K, gather_neighbors,
                                       posenc_alpha, select_smallest,
                                       square_distance3)
from ogmm_tpu_torch.ops.cuda_dgcnn import KERNEL_MAX_N
# the kernel is the dense kNN's selection, compiled for the same list lengths
from ogmm_tpu_torch.ops.cuda_knn import knn_compiled_k

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)


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
    if not 1 <= k <= min(KNN_KERNEL_MAX_K, N) or N > KERNEL_MAX_N:
        raise ValueError(f"posenc_angles kernel takes N <= {KERNEL_MAX_N} and "
                         f"1 <= k <= min({KNN_KERNEL_MAX_K}, N); got N={N}, k={k}")
    x = points.float().contiguous()
    centroid = x.mean(dim=1, keepdim=True).contiguous()
    alpha = torch.empty(B, N, k, dtype=torch.float32, device=x.device)
    if idx is not None and (idx.shape != (B, N, k) or idx.dtype != torch.int32
                            or not idx.is_contiguous()):
        raise ValueError(f"idx takes the (B, N, k) = {(B, N, k)} int32 neighbours")
    code = dispatch.kernel_fn("posenc_angles", "posenc_angles_launch", _ARGS)(
        *[ctypes.c_void_p(None if a is None else a.data_ptr())
          for a in (x, centroid, alpha, idx)],
        B, N, k, knn_compiled_k(k), ctypes.c_void_p(dispatch.current_stream(x)))
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
