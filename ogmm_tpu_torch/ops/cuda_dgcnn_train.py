"""kNN graph + edge features + stage-1 product of the DGCNN training forward:
the CUDA kernel's wrapper and its plain version.

`graph_stage1(x, w1)` computes, for every point of (B, N, 3) clouds: its k
nearest neighbours (ascending, ties to the lowest index, by argmin-and-mask
over fixed-order float32 distances), the edge rows e = [nbr - q, q] with the
offset formed in float32 and then cast to the compute dtype, and the
pre-BatchNorm stage-1 activations z1 = e . w1 (float32 accumulation, one
rounding to the compute dtype); with `posenc_k` also the position-encoding
angles cos(angle(p -> nbr_j, p -> centroid)) of the first `posenc_k`
neighbours from float32 coordinates. Outputs:

  z1    (B, k, N, C1) compute dtype     e      (B, k, N, 6) compute dtype
  idx   (B, N, k) int32                 alpha  (B, N, posenc_k) float32 or None

On a CUDA tensor the wrapper launches `csrc/graph_stage1.cu` (1 <= k <= N
<= 1024, the JAX kernel's envelope, exactly k edge rows a point; above
k = 32 its selection is `csrc/knn_wide.cuh`'s); on a CPU tensor it runs
`graph_stage1_reference`, the port of the JAX package's jnp composition
(`ogmm_tpu/ops/dgcnn_train.py:_graph_stage1`).
"""
from __future__ import annotations

import ctypes

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import (gather_neighbors, graph_feature,
                                       posenc_alpha, select_smallest,
                                       square_distance3)
from ogmm_tpu_torch.ops.cuda_dgcnn import KERNEL_MAX_N
from ogmm_tpu_torch.ops.cuda_stream import _sm_count

KERNEL_C1 = 64           # stage-1 width the kernel is compiled for
# the edge pass (edge_stage1_kernel): threads of a block, the edge rows it
# takes at a time (eight threads a row), and the blocks an SM its grid gives
# (its registers hold three)
EDGE_THREADS, EDGE_ROWS = 256, 32
EDGE_BLOCKS_AN_SM = 3
_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 6 + (ctypes.c_void_p,)


def graph_takes(k: int, n: int) -> bool:
    """The envelope of the training graph's kernel, the JAX kernel's: any
    1 <= k <= n neighbours over clouds of n <= KERNEL_MAX_N points. (The
    backward kernels it feeds stop at k = 32: `ops/cuda_dgcnn_bwd.py:
    kernels_take`.)"""
    return 1 <= k <= n <= KERNEL_MAX_N


def edge_plan(B: int, k: int, N: int, n_sm: int) -> int:
    """Blocks of the edge pass's grid-stride loop over the B k N rows:
    EDGE_BLOCKS_AN_SM an SM, or fewer where the rows do not need them."""
    return min(EDGE_BLOCKS_AN_SM * n_sm, -(-B * k * N // EDGE_ROWS))


def graph_stage1_reference(x: torch.Tensor, w1: torch.Tensor, k: int = 20,
                           dtype: torch.dtype = torch.bfloat16,
                           posenc_k: int = 0):
    """Plain PyTorch version of the kernel; see the module docstring."""
    if posenc_k > k:
        raise ValueError(f"posenc_k={posenc_k} must be <= k={k}")
    x = x.float()
    idx = select_smallest(square_distance3(x, x), k)      # (B, N, k)
    e = graph_feature(x, k, idx).to(dtype).transpose(1, 2).contiguous()
    z1 = torch.matmul(e.float(), w1.to(dtype).float()).to(dtype)
    alpha = (posenc_alpha(x, gather_neighbors(x, idx[..., :posenc_k]))
             if posenc_k else None)
    return z1, e, idx.int(), alpha


def _graph_stage1_cuda(x, w1, k, dtype, posenc_k):
    B, N, _ = x.shape
    if not graph_takes(k, N):
        raise ValueError(f"graph_stage1 kernel takes 1 <= k <= N <= "
                         f"{KERNEL_MAX_N}; got k={k}, N={N}")
    if tuple(w1.shape) != (6, KERNEL_C1) or posenc_k > k:
        raise ValueError(f"graph_stage1 kernel takes w1 of shape "
                         f"(6, {KERNEL_C1}) and posenc_k <= k; got "
                         f"{tuple(w1.shape)}, posenc_k={posenc_k}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"graph_stage1 kernel: dtype {dtype} not supported")
    dev = x.device
    x = x.float().contiguous()
    w = w1.to(dtype).contiguous()
    z1 = torch.empty(B, k, N, KERNEL_C1, dtype=dtype, device=dev)
    e = torch.empty(B, k, N, 6, dtype=dtype, device=dev)
    idx = torch.empty(B, N, k, dtype=torch.int32, device=dev)
    alpha = torch.empty(B, N, max(posenc_k, 1), dtype=torch.float32, device=dev)
    blocks = edge_plan(B, k, N, _sm_count(dev.index or 0))
    code = dispatch.kernel_fn("graph_stage1", "graph_stage1_launch", _ARGS)(
        *[ctypes.c_void_p(a.data_ptr()) for a in (x, w, idx, alpha, z1, e)],
        B, N, k, posenc_k, int(dtype == torch.bfloat16), blocks,
        ctypes.c_void_p(dispatch.current_stream(x)))
    dispatch.check_launch(code, "graph_stage1")
    dispatch.launch_counts["graph_stage1"] += 1
    return z1, e, idx, (alpha if posenc_k else None)


def graph_stage1(x: torch.Tensor, w1: torch.Tensor, k: int = 20,
                 dtype: torch.dtype = torch.bfloat16, posenc_k: int = 0):
    """Fused kNN graph + edge features + stage-1 product: x (B, N, 3)
    float32, w1 (6, C1) float32 -> (z1, e, idx, alpha). Launches the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor. Carries no
    gradient (the custom VJP of ops/dgcnn_train.py owns the backward)."""
    if x.is_cuda:
        return _graph_stage1_cuda(x, w1, k, dtype, posenc_k)
    return graph_stage1_reference(x, w1, k, dtype, posenc_k)
