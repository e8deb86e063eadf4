"""Batched point-to-point ICP refinement with a fixed trip count. The
nearest-neighbour search of a trip takes the route of
`ops.common.nn1_route(prefer_dense=True)`, as the JAX package's ICP does
(`ogmm_tpu/ops/icp.py:166-172`): one dense (B, N, M) distance matrix and an
argmin at M <= 1024, the 1-NN kernel at M <= 4096, the plain route above."""
from __future__ import annotations

import torch

from ogmm_tpu_torch.core.procrustes import rigid_transform
from ogmm_tpu_torch.ops.common import index_points, matmul32, nn1


@torch.no_grad()
def icp_point_to_point(src: torch.Tensor, tgt: torch.Tensor,
                       init_pose: torch.Tensor, threshold: float,
                       max_iter: int = 30, method: str = "horn_pi"):
    """Refine an initial rigid transform.

    src (B, N, 3), tgt (B, M, 3), init_pose (B, 3/4, 4) mapping src -> tgt;
    `threshold` gates correspondences by distance. A cloud without inliers
    in a trip keeps its previous transform.
    Returns (rot (B, 3, 3), trans (B, 3))."""
    thresh_sq = threshold * threshold
    rot = init_pose[..., :3, :3]
    t = init_pose[..., :3, 3]
    for _ in range(max_iter):
        moved = matmul32(src, rot.transpose(-1, -2)) + t.unsqueeze(1)
        nn_d, nn_i = nn1(moved, tgt, prefer_dense=True)
        corr = index_points(tgt, nn_i)
        w = (nn_d < thresh_sq).to(src.dtype)
        any_in = w.sum(dim=-1) > 0
        w = torch.where(any_in[:, None], w, torch.ones_like(w))
        rot_new, t_new = rigid_transform(src, corr, w, method=method)
        rot = torch.where(any_in[:, None, None], rot_new, rot)
        t = torch.where(any_in[:, None], t_new[..., 0], t)
    return rot, t
