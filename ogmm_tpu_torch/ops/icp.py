"""Batched point-to-point ICP refinement with a fixed trip count. The
nearest-neighbour search of a trip takes the route of
`ops.common.nn1_route(prefer_dense=True)`, as the JAX package's ICP does
(`ogmm_tpu/ops/icp.py:133-172`): one dense (B, N, M) distance matrix and an
argmin at M <= 1024, the 1-NN kernel at M <= 4096, and above (3-D points)
the spatial route: both clouds Morton-sorted once, and each trip the
streamed 1-NN over the sorted clouds with the tile-pair bounds of the moved
source and the inlier gate, so that tiles farther than the gate are skipped
(`ops.stream`). ICP is permutation-equivariant and only (R, t) leave the
loop, so nothing is mapped back.

With `use_kernel=True` the whole loop runs as one `icp` kernel launch
where `ops.cuda_icp.kernel_takes` says so (method 'horn_pi', M <= 4096,
the src rows within the kernel's shared memory),
the counterpart of the JAX package's `icp_pallas`; it forms its distances
in the fixed order of `square_distance3`. `nn.gmmreg.GMMReg` passes its
`loop_kernels` flag. Both loops end a trip in
`core.procrustes.gated_update`."""
from __future__ import annotations

import torch

from ogmm_tpu_torch.core.procrustes import gated_update
from ogmm_tpu_torch.ops import cuda_icp, cuda_stream, stream
from ogmm_tpu_torch.ops.common import index_points, matmul32, nn1, nn1_route


@torch.no_grad()
def icp_point_to_point(src: torch.Tensor, tgt: torch.Tensor,
                       init_pose: torch.Tensor, threshold: float,
                       max_iter: int = 30, method: str = "horn_pi",
                       use_kernel: bool = False):
    """Refine an initial rigid transform.

    src (B, N, 3), tgt (B, M, 3), init_pose (B, 3/4, 4) mapping src -> tgt;
    `threshold` gates correspondences by distance. A cloud without inliers
    in a trip keeps its previous transform. `use_kernel` runs the loop as
    one kernel launch within the kernel's envelope.
    Returns (rot (B, 3, 3), trans (B, 3))."""
    thresh_sq = threshold * threshold
    B, N, C = src.shape
    if use_kernel and cuda_icp.kernel_takes(tgt.shape[1], C, method, N):
        return cuda_icp.icp_fused(src, tgt, init_pose, thresh_sq, iters=max_iter)
    rot = init_pose[..., :3, :3]
    t = init_pose[..., :3, 3]
    spatial = nn1_route(B, N, tgt.shape[1], C, prefer_dense=True) == "stream"
    if spatial:
        src = index_points(src, stream.morton_order(src))
        tgt = index_points(tgt, stream.morton_order(tgt))
    for _ in range(max_iter):
        moved = matmul32(src, rot.transpose(-1, -2)) + t.unsqueeze(1)
        if spatial:
            nn_d, nn_i = cuda_stream.nn1_stream(
                moved, tgt, cull_lb=stream.pair_tile_bounds(moved, tgt),
                max_dist_sq=thresh_sq, diag_order=True,
                stretch=max(1, round(tgt.shape[1] / N)))
        else:
            nn_d, nn_i = nn1(moved, tgt, prefer_dense=True)
        rot, t = gated_update(src, index_points(tgt, nn_i), nn_d, thresh_sq,
                              rot, t, method)
    return rot, t
