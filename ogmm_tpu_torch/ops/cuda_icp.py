"""Whole-loop point-to-point ICP: the CUDA kernel's wrapper and its plain
version.

`icp_fused(src, tgt, init_pose, thresh_sq, iters)` refines (B, 3|4, 4)
poses mapping src (B, N, 3) onto tgt (B, M, 3) by `iters` trips, the
function of the TPU kernel `ogmm_tpu/ops/pallas_icp.py:icp_pallas`: each trip
moves src by the pose, takes every moved point's nearest tgt point (first
index on ties) and the gate d < thresh_sq, and solves the weighted
Procrustes problem of the inliers on the original src (Horn's 4x4 matrix by
30 shifted power iterations, + 1e-5 I, the identity on a non-finite
covariance); a cloud without inliers keeps its pose. The moved points and
the distances are formed by elementwise float32 arithmetic in one fixed
order (`ops.common.square_distance3`), in the kernel as here, so the first
trip's correspondences agree bit for bit.

On a CUDA tensor the wrapper launches `csrc/icp.cu` (3-D points, M <= 4096:
tgt sits in shared memory; N up to what `icp_plan` fits), a thread block
cluster of blocks a cloud whose shape `icp_plan` writes once; on a CPU
tensor it runs `icp_fused_reference`, which ends each trip in the eager
loop's `core.procrustes.gated_update`. `ops.icp.icp_point_to_point` reaches
it with `use_kernel=True` where `kernel_takes` says so.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ogmm_tpu_torch.core.procrustes import gated_update
from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import KERNEL_MAX_M, index_points, square_distance3
from ogmm_tpu_torch.ops.cuda_stream import _sm_count


ICP_CLUSTERS = (8, 4, 2)   # blocks a cloud, largest first (8: portable)
ICP_MAX_CLUSTER = ICP_CLUSTERS[0]
ICP_MAX_THREADS = 1024
ICP_SMEM_MAX = 223 * 1024  # dynamic shared memory of a block (csrc/icp.cu)


class IcpPlan(NamedTuple):
    """The launch of `csrc/icp.cu`: `cluster` blocks a cloud (grid B *
    cluster), block r of a cluster owning src rows [r rows, min(N, (r + 1)
    rows)), `lanes` threads a row in the search, `threads` a block and
    `smem` bytes of dynamic shared memory (`icp_smem_bytes`)."""
    cluster: int
    rows: int
    lanes: int
    threads: int
    smem: int


def icp_smem_bytes(M: int, rows: int) -> int:
    """csrc/icp.cu's dynamic shared memory: tgt and the block's rows as
    float4 (16 bytes a point), the rows' inlier codes."""
    return 16 * M + 20 * rows


def _usable_sms(cluster: int, n_sm: int) -> int:
    """SMs that clusters of this size can fill at one block an SM: the
    occupancy calculator counts 30 clusters of 4 and 15 of 8 on an H100's
    132 SMs (120 SMs; 22 clusters of 5 and 39 of 3), 66 of 2 (all 132)."""
    return n_sm if cluster <= 2 else n_sm - n_sm // 11


def icp_plan(B: int, N: int, M: int, n_sm: int) -> IcpPlan:
    """The kernel's launch for B clouds of N src and M tgt points on n_sm
    SMs: the most blocks a cloud (8, 4 or 2) whose B clusters fit the card
    in one wave of one block an SM (4 at the refined request's B = 24 on
    132 SMs: 96 blocks), more where a block's rows would not fit its shared
    memory; 4 lanes a row (2 or 1 where the rows would need more than 1024
    threads). Raises where even 8 blocks a cloud cannot hold the rows."""
    cluster = next((c for c in ICP_CLUSTERS if B * c <= _usable_sms(c, n_sm)),
                   ICP_CLUSTERS[-1])
    while cluster < ICP_MAX_CLUSTER and \
            icp_smem_bytes(M, -(-N // cluster)) > ICP_SMEM_MAX:
        cluster *= 2
    if icp_smem_bytes(M, -(-N // cluster)) > ICP_SMEM_MAX:
        raise ValueError(f"icp kernel: {N} src rows in {ICP_MAX_CLUSTER} "
                         f"blocks do not fit shared memory beside M={M}")
    return icp_cluster_plan(cluster, N, M)


def icp_cluster_plan(cluster: int, N: int, M: int) -> IcpPlan:
    """The rest of the launch for a given cluster size: ceil(N / cluster)
    rows a block, 4 lanes a row (2 or 1 where the rows would need more than
    1024 threads), threads a multiple of 32."""
    rows = -(-N // cluster)
    lanes = next(l for l in (4, 2, 1) if rows * l <= ICP_MAX_THREADS or l == 1)
    threads = min(ICP_MAX_THREADS, 32 * math.ceil(rows * lanes / 32))
    return IcpPlan(cluster, rows, lanes, threads, icp_smem_bytes(M, rows))


def max_active_clusters(plan: IcpPlan) -> int:
    """How many clusters of this plan's blocks the card holds at once (the
    occupancy calculator; one wave while it is at least B)."""
    fn = dispatch.load_kernel("icp").icp_max_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = ctypes.c_int(0)
    dispatch.check_launch(fn(plan.cluster, plan.threads, plan.smem,
                             ctypes.byref(out)), "icp")
    return out.value


def kernel_takes(M: int, C: int, method: str, N: int) -> bool:
    """Whether the whole-loop kernel computes `icp_point_to_point` of N src
    points onto a target of M points of C coordinates: 3-D points, 1 <= M
    <= 4096 (the target in shared memory), the rows of 8 blocks within
    shared memory beside it (`icp_plan`) and the 'horn_pi' solve, the JAX
    kernel's."""
    return C == 3 and method == "horn_pi" and 1 <= M <= KERNEL_MAX_M and \
        icp_smem_bytes(M, -(-N // ICP_MAX_CLUSTER)) <= ICP_SMEM_MAX


def _moved(src: torch.Tensor, rot: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """src R^T + t by elementwise float32 arithmetic, coordinate i as
    ((s0 R[i, 0] + s1 R[i, 1]) + s2 R[i, 2]) + t[i]."""
    rt = rot.transpose(-1, -2).unsqueeze(1)                  # (B, 1, 3, 3)
    return ((src[..., 0:1] * rt[..., 0, :] + src[..., 1:2] * rt[..., 1, :])
            + src[..., 2:3] * rt[..., 2, :]) + t.unsqueeze(1)


@torch.no_grad()
def icp_fused_reference(src: torch.Tensor, tgt: torch.Tensor,
                        init_pose: torch.Tensor, thresh_sq: float,
                        iters: int = 30, return_first: bool = False):
    """Plain PyTorch version: (rot (B, 3, 3), trans (B, 3)), and with
    `return_first` the first trip's 1-NN indices (B, N) int64."""
    src, tgt = src.float(), tgt.float()
    rot = init_pose[..., :3, :3].float()
    t = init_pose[..., :3, 3].float()
    first = None
    for it in range(iters):
        d = square_distance3(_moved(src, rot, t), tgt)
        nn_i = d.argmin(dim=-1)
        nn_d = d.gather(-1, nn_i.unsqueeze(-1)).squeeze(-1)
        if it == 0:
            first = nn_i
        rot, t = gated_update(src, index_points(tgt, nn_i), nn_d, thresh_sq,
                              rot, t)
    if return_first:
        if first is None:
            raise ValueError("return_first needs iters >= 1")
        return rot, t, first
    return rot, t


def _icp_cuda(src, tgt, init_pose, thresh_sq, iters, return_first):
    B, N, C = src.shape
    M = tgt.shape[1]
    if C != 3 or tgt.shape != (B, M, 3) or init_pose.shape[0] != B or \
            init_pose.shape[-1] != 4 or init_pose.shape[-2] not in (3, 4):
        raise ValueError(f"icp kernel takes src (B, N, 3), tgt (B, M, 3) and "
                         f"a (B, 3|4, 4) pose; got {tuple(src.shape)}, "
                         f"{tuple(tgt.shape)}, {tuple(init_pose.shape)}")
    if not kernel_takes(M, C, "horn_pi", N) or N < 1:
        raise ValueError(f"icp kernel takes N >= 1 and 1 <= M <= "
                         f"{KERNEL_MAX_M} target points within its shared "
                         f"memory; got N={N}, M={M}")
    if iters < 0 or (return_first and iters < 1):
        raise ValueError(f"icp kernel takes iters >= 0 (>= 1 with "
                         f"return_first); got {iters}")
    if not init_pose.is_cuda:
        raise ValueError("icp kernel takes the pose on the points' device")
    plan = icp_plan(B, N, M, _sm_count(src.device.index or 0))
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    pose = init_pose[..., :3, :4].float().contiguous()
    out = torch.empty(B, 3, 4, dtype=torch.float32, device=src.device)
    first = torch.empty(B, N, dtype=torch.int32, device=src.device)
    fn = dispatch.load_kernel("icp").icp_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    code_ = fn(*[ctypes.c_void_p(a.data_ptr()) for a in (src, tgt, pose, out, first)],
               B, N, M, float(thresh_sq), iters, *plan,
               ctypes.c_void_p(dispatch.current_stream(src)))
    dispatch.check_launch(code_, "icp")
    dispatch.launch_counts["icp"] += 1
    rot, trans = out[..., :3], out[..., 3]
    if return_first:
        return rot, trans, first.long()
    return rot, trans


def icp_fused(src: torch.Tensor, tgt: torch.Tensor, init_pose: torch.Tensor,
              thresh_sq: float, iters: int = 30, return_first: bool = False):
    """Whole-loop ICP: (rot (B, 3, 3), trans (B, 3)) [, first trip's 1-NN
    (B, N) int64]. Launches the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Carries no gradient."""
    if src.is_cuda:
        return _icp_cuda(src, tgt, init_pose, thresh_sq, iters, return_first)
    return icp_fused_reference(src, tgt, init_pose, thresh_sq, iters,
                               return_first)
