"""Batched ICP refinement with a fixed trip count: point-to-point and
point-to-plane. The nearest-neighbour search of a trip takes the route of
`ops.common.nn1_route(prefer_dense=True)`, as the JAX package's ICP does
(`ogmm_tpu/ops/icp.py:133-172`): one dense (B, N, M) distance matrix and an
argmin at M <= 1024, the 1-NN kernel at M <= 4096, and above (3-D points)
the spatial route: both clouds Morton-sorted once, and each trip the
streamed 1-NN over the sorted clouds with the tile-pair bounds of the moved
source and the inlier gate, so that tiles farther than the gate are skipped
(`ops.stream`). ICP is permutation-equivariant and only (R, t) leave the
loop, so nothing is mapped back.

`use_grid=True` (opt-in, as in the JAX package) takes each trip's 1-NN from
a uniform grid over the target built once (`ops.grid_nn`): exact under the
inlier gate. It is plain tensor code, the JAX package's too; it conflicts
with `use_kernel` (ValueError), as the JAX package refuses it beside an
explicit `use_pallas`.

With `use_kernel=True` the point-to-point loop runs as one `icp` kernel
launch where `ops.cuda_icp.kernel_takes` says so (method 'horn_pi', M <=
4096, the src rows within the kernel's shared memory), the counterpart of
the JAX package's `icp_pallas`; it forms its distances in the fixed order
of `square_distance3`. `nn.gmmreg.GMMReg` passes its `loop_kernels` flag.
Both point-to-point loops end a trip in `core.procrustes.gated_update`.

With a point-sharding `group` (`parallel/sp.py`) src holds this process's
rows and tgt the whole target: each trip's 1-NN is local, and the inlier
counts and the moments (point-to-point) or the normal equations
(point-to-plane) are summed over the group. The whole-loop kernel holds one
whole cloud, so `use_kernel` with a group raises.

Point-to-plane (`icp_point_to_plane`) solves each trip's Gauss-Newton 6x6
system of the plane residuals over the gated inliers and applies the
Rodrigues update; the target's normals come from `estimate_normals_knn`
unless given.
"""
from __future__ import annotations

import torch

from ogmm_tpu_torch.core import se3
from ogmm_tpu_torch.core.procrustes import gated_update
from ogmm_tpu_torch.ops import cuda_icp, cuda_stream, stream
from ogmm_tpu_torch.ops.common import (gather_neighbors, index_points, knn,
                                       matmul32, nn1, nn1_route)
from ogmm_tpu_torch.ops.grid_nn import build_grid, nn1_radius
from ogmm_tpu_torch.parallel import comm


def _refuse_kernel_sharded(use_kernel: bool, group) -> None:
    if use_kernel and group is not None:
        raise ValueError("use_kernel=True is incompatible with a point-"
                         "sharding group: the whole-loop ICP kernel holds one "
                         "whole cloud and cannot sum across processes")


def _maybe_grid(tgt: torch.Tensor, threshold: float, use_grid: bool,
                use_kernel: bool):
    """The grid over the target with `threshold` cells where `use_grid`
    asks for it, else None. Its `max_occupancy` is not read here: a cell
    above `grid_cap` drops its later points from the candidates."""
    if not use_grid:
        return None
    if use_kernel:
        raise ValueError("use_grid=True conflicts with use_kernel=True: pass "
                         "one or the other")
    return build_grid(tgt, threshold)


def _spatial(src, tgt, *others):
    """Both clouds Morton-sorted (and the target's companions `others` with
    the target): the spatial route's inputs."""
    t_ord = stream.morton_order(tgt)
    return (index_points(src, stream.morton_order(src)), index_points(tgt, t_ord),
            *(index_points(o, t_ord) for o in others))


def _nn1_spatial(moved, tgt, thresh_sq):
    return cuda_stream.nn1_stream(
        moved, tgt, cull_lb=stream.pair_tile_bounds(moved, tgt),
        max_dist_sq=thresh_sq, diag_order=True,
        stretch=max(1, round(tgt.shape[1] / moved.shape[1])))


@torch.no_grad()
def icp_point_to_point(src: torch.Tensor, tgt: torch.Tensor,
                       init_pose: torch.Tensor, threshold: float,
                       max_iter: int = 30, method: str = "horn_pi",
                       use_kernel: bool = False, use_grid: bool = False,
                       grid_cap: int = 32, group=None):
    """Refine an initial rigid transform by point-to-point ICP.

    src (B, N, 3), tgt (B, M, 3), init_pose (B, 3/4, 4) mapping src -> tgt;
    `threshold` gates correspondences by distance. A cloud without inliers
    in a trip keeps its previous transform. `use_kernel` runs the loop as
    one kernel launch within the kernel's envelope; `use_grid` takes the
    1-NN from the grid of `ops.grid_nn` with `grid_cap` candidates a cell.
    `group` shards src's rows (see the module's docstring).
    Returns (rot (B, 3, 3), trans (B, 3))."""
    _refuse_kernel_sharded(use_kernel, group)
    thresh_sq = threshold * threshold
    B, N, C = src.shape
    grid = _maybe_grid(tgt, threshold, use_grid, use_kernel)
    if use_kernel and cuda_icp.kernel_takes(tgt.shape[1], C, method, N):
        return cuda_icp.icp_fused(src, tgt, init_pose, thresh_sq, iters=max_iter)
    rot = init_pose[..., :3, :3]
    t = init_pose[..., :3, 3]
    spatial = grid is None and \
        nn1_route(B, N, tgt.shape[1], C, prefer_dense=True) == "stream"
    if spatial:
        src, tgt = _spatial(src, tgt)
    for _ in range(max_iter):
        moved = matmul32(src, rot.transpose(-1, -2)) + t.unsqueeze(1)
        if grid is not None:
            nn_d, nn_i = nn1_radius(moved, grid, threshold, grid_cap)
        elif spatial:
            nn_d, nn_i = _nn1_spatial(moved, tgt, thresh_sq)
        else:
            nn_d, nn_i = nn1(moved, tgt, prefer_dense=True)
        rot, t = gated_update(src, index_points(tgt, nn_i), nn_d, thresh_sq,
                              rot, t, method, group)
    return rot, t


def _rodrigues(omega: torch.Tensor) -> torch.Tensor:
    """Batched exp map so(3) -> SO(3) of (B, 3) twists; below an angle of
    1e-8 the first-order map I + [omega]x."""
    theta = omega.norm(dim=-1, keepdim=True)                    # (B, 1)
    kx, ky, kz = (omega / theta.clamp_min(1e-12)).unbind(-1)
    zero = torch.zeros_like(kx)
    K = torch.stack([torch.stack([zero, -kz, ky], -1),
                     torch.stack([kz, zero, -kx], -1),
                     torch.stack([-ky, kx, zero], -1)], -2)     # (B, 3, 3)
    s = torch.sin(theta).unsqueeze(-1)
    c = torch.cos(theta).unsqueeze(-1)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand_as(K)
    R = eye + s * K + (1.0 - c) * matmul32(K, K)
    th = theta.unsqueeze(-1)
    return torch.where(th > 1e-8, R, eye + K * th)


# matrices a `torch.linalg.eigh` call: cuSOLVER's batched eigensolver
# refused a batch of 34,392 3x3 matrices (CUSOLVER_STATUS_INVALID_VALUE on an
# H100, torch 2.11 with CUDA 12.8) and took 17,208
EIGH_BATCH = 16384


@torch.no_grad()
def estimate_normals_knn(points: torch.Tensor, k: int = 16) -> torch.Tensor:
    """Unit normals (B, N, 3) of (B, N, 3) points: the eigenvector of the
    smallest eigenvalue of each point's k-NN covariance (float32, TF32 off;
    `torch.linalg.eigh`, ascending, EIGH_BATCH matrices a call). The kNN
    takes `ops.common.knn`'s route (the kernel at M <= 4096, the streamed
    kernel above), in original row order. The sign is arbitrary: the
    point-to-plane normal equations do not see it."""
    nbrs = gather_neighbors(points, knn(points, points, k))     # (B, N, k, 3)
    centered = nbrs - nbrs.mean(dim=2, keepdim=True)
    cov = matmul32(centered.transpose(-1, -2), centered)        # (B, N, 3, 3)
    vecs = [torch.linalg.eigh(c)[1][..., 0]
            for c in cov.reshape(-1, 3, 3).split(EIGH_BATCH)]
    return torch.cat(vecs).reshape(points.shape)


@torch.no_grad()
def icp_point_to_plane(src: torch.Tensor, tgt: torch.Tensor,
                       init_pose: torch.Tensor, threshold: float,
                       max_iter: int = 30,
                       tgt_normals: torch.Tensor | None = None,
                       normal_k: int = 16, use_kernel: bool = False,
                       use_grid: bool = False, grid_cap: int = 32,
                       group=None):
    """Point-to-plane ICP: each trip linearises the residual n.(R s + t - q)
    in a twist [omega; dt], forms the 6x6 normal equations over the gated
    inliers, solves (H + 1e-6 I) x = g and applies the Rodrigues update; a
    cloud without inliers keeps its pose. Normals from `tgt_normals`
    (B, M, 3) or `estimate_normals_knn(tgt, normal_k)`, computed in original
    order and permuted with the target on the spatial route.

    The solve is `torch.linalg.solve_ex` (LU, as `jnp.linalg.solve`, no
    error check): `torch.linalg.solve` reads its `info` on the host, a
    synchronisation every trip on the card. `use_kernel=True` takes each
    trip's 1-NN through the kernels at every M, as the JAX package's
    explicit `use_pallas=True` does: the `nn1` kernel also at M <= 1024, the
    streamed kernel on the unsorted clouds above 4096. `group` shards src's
    rows (see the module's docstring).
    Returns (rot (B, 3, 3), trans (B, 3))."""
    _refuse_kernel_sharded(use_kernel, group)
    thresh_sq = threshold * threshold
    B, N, C = src.shape
    rot = init_pose[..., :3, :3]
    t = init_pose[..., :3, 3]
    if tgt_normals is None:
        tgt_normals = estimate_normals_knn(tgt, normal_k)
    grid = _maybe_grid(tgt, threshold, use_grid, use_kernel)
    spatial = grid is None and not use_kernel and \
        nn1_route(B, N, tgt.shape[1], C, prefer_dense=True) == "stream"
    if spatial:
        src, tgt, tgt_normals = _spatial(src, tgt, tgt_normals)
    eye6 = 1e-6 * torch.eye(6, dtype=src.dtype, device=src.device)
    for _ in range(max_iter):
        moved = matmul32(src, rot.transpose(-1, -2)) + t.unsqueeze(1)
        if grid is not None:
            nn_d, nn_i = nn1_radius(moved, grid, threshold, grid_cap)
        elif spatial:
            nn_d, nn_i = _nn1_spatial(moved, tgt, thresh_sq)
        else:
            nn_d, nn_i = nn1(moved, tgt, prefer_dense=not use_kernel)
        q = index_points(tgt, nn_i)
        n = index_points(tgt_normals, nn_i)
        w = (nn_d < thresh_sq).to(src.dtype)
        any_in = comm.psum(w.sum(dim=-1), group) > 0
        w = torch.where(any_in[:, None], w, torch.ones_like(w))
        a = torch.cat([torch.linalg.cross(moved, n, dim=-1), n], dim=-1)
        b = -(n * (moved - q)).sum(-1)                          # (B, N)
        aw = a * w.unsqueeze(-1)
        H = comm.psum(matmul32(aw.transpose(1, 2), a), group) + eye6  # (B, 6, 6)
        g = comm.psum(matmul32(aw.transpose(1, 2), b.unsqueeze(-1)), group)
        x = torch.linalg.solve_ex(H, g)[0][..., 0]
        dR = _rodrigues(x[:, :3])
        rot_new = matmul32(dR, rot)
        t_new = matmul32(dR, t.unsqueeze(-1))[..., 0] + x[:, 3:]
        rot = torch.where(any_in[:, None, None], rot_new, rot)
        t = torch.where(any_in[:, None], t_new, t)
    return rot, t


def refine_registration(src, tgt, rot, trans, voxel_size: float,
                        max_iter: int = 30, pl: bool = False):
    """The original's test-time refinement: ICP with a gate of twice
    `voxel_size`, point-to-point or, with `pl=True`, point-to-plane.
    src/tgt (B, N, 3), rot (B, 3, 3), trans (B, 3) or (B, 3, 1).
    Returns the refined (rot (B, 3, 3), trans (B, 3))."""
    init = se3.integrate(rot, trans.reshape(rot.shape[0], 3, 1))
    icp = icp_point_to_plane if pl else icp_point_to_point
    return icp(src, tgt, init, threshold=2.0 * voxel_size, max_iter=max_iter)
