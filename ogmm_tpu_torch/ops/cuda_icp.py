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
tgt sits in shared memory; any N); on a CPU tensor it runs
`icp_fused_reference`, which ends each trip in the eager loop's
`core.procrustes.gated_update`. `ops.icp.icp_point_to_point` reaches it
with `use_kernel=True` where `kernel_takes` says so.
"""
from __future__ import annotations

import ctypes

import torch

from ogmm_tpu_torch.core.procrustes import gated_update
from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import KERNEL_MAX_M, index_points, square_distance3


def kernel_takes(M: int, C: int, method: str) -> bool:
    """Whether the whole-loop kernel computes `icp_point_to_point` of a
    target of M points of C coordinates: 3-D points, 1 <= M <= 4096 (the
    target in shared memory) and the 'horn_pi' solve, the JAX kernel's."""
    return C == 3 and method == "horn_pi" and 1 <= M <= KERNEL_MAX_M


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
    if not kernel_takes(M, C, "horn_pi") or N < 1:
        raise ValueError(f"icp kernel takes N >= 1 and 1 <= M <= "
                         f"{KERNEL_MAX_M} target points; got N={N}, M={M}")
    if iters < 0 or (return_first and iters < 1):
        raise ValueError(f"icp kernel takes iters >= 0 (>= 1 with "
                         f"return_first); got {iters}")
    if not init_pose.is_cuda:
        raise ValueError("icp kernel takes the pose on the points' device")
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    pose = init_pose[..., :3, :4].float().contiguous()
    out = torch.empty(B, 3, 4, dtype=torch.float32, device=src.device)
    code = torch.empty(B, N, dtype=torch.int32, device=src.device)
    first = torch.empty(B, N, dtype=torch.int32, device=src.device)
    fn = dispatch.load_kernel("icp").icp_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int, ctypes.c_void_p])
    code_ = fn(*[ctypes.c_void_p(a.data_ptr()) for a in (src, tgt, pose, out, code, first)],
               B, N, M, float(thresh_sq), iters,
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
