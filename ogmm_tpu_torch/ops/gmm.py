"""GMM moment estimation, the overlap-weighted Sinkhorn-EM clustering, the
Sinkhorn k-means and the anchor helpers of the JAX package's
`ops/gmm.py`."""
from __future__ import annotations

import torch

from ogmm_tpu_torch.ops import cuda_em
from ogmm_tpu_torch.ops.common import (index_points, index_points_sp,
                                       l2_normalize, matmul32, nn1, nn1_sp,
                                       square_distance)
from ogmm_tpu_torch.parallel import comm
from ogmm_tpu_torch.ops.cuda_em import sinkhorn_em
from ogmm_tpu_torch.ops.fps import farthest_point_sample
from ogmm_tpu_torch.ops.sinkhorn import sinkhorn

EM_VMEM_BYTES = 14 * 2 ** 20   # the JAX kernel's bound (ops/gmm.py:195-197)


def gmm_params(gamma: torch.Tensor, pts: torch.Tensor,
               return_sigma: bool = False, group=None):
    """Mixture weights and means (and isotropic covariances) from
    responsibilities: gamma (B, N, J), pts (B, N, D) ->
    pi (B, J), mu (B, J, D) [, sigma (B, J, D, D)]. With a point-sharding
    `group` gamma and pts hold this process's rows, every moment is summed
    over the group and N is the global count; the outputs are the same on
    every process."""
    N = gamma.shape[1] * comm.axis_size(group)
    D = pts.shape[-1]
    gsum = comm.psum(gamma.sum(dim=1), group)
    pi = gsum / N
    npi = pi * N + 1e-5
    mu_num = comm.psum(matmul32(gamma.transpose(1, 2), pts), group)
    mu = mu_num / npi.unsqueeze(-1)
    if not return_sigma:
        return pi, mu
    diff = pts.unsqueeze(2) - mu.unsqueeze(1)                # (B, N, J, D)
    var = comm.psum(((diff * diff).sum(-1) * gamma).sum(dim=1), group) / npi
    eye = torch.eye(D, dtype=pts.dtype, device=pts.device)
    return pi, mu, var[..., None, None] * eye


def og_params(pts: torch.Tensor, gamma: torch.Tensor,
              o_score: torch.Tensor | None = None,
              feature: torch.Tensor | None = None):
    """Overlap-guided GMM parameters with a non-overlap component: gamma
    (B, N, J) weighted by the overlap score (B, N) and a (1 - score) column
    appended. Returns pi (B, J[+1]), mu (B, J[+1], 3)[, the feature means]."""
    if o_score is not None:
        score = torch.cat([gamma * o_score.unsqueeze(-1),
                           (1.0 - o_score).unsqueeze(-1)], dim=-1)
    else:
        score = gamma
    pi, mu = gmm_params(score, pts)
    if feature is not None:
        return pi, mu, gmm_params(score, feature)[1]
    return pi, mu


def wkeans(x: torch.Tensor, num_clusters: int, dst: str = "feats",
           iters: int = 10):
    """Sinkhorn k-means over (B, N, C) coordinates (`dst='eu'`, squared
    distance) or features (else: rows l2-normalised, cost 2 - 2 cos),
    seeded by a centre-start FPS over x (the plain FPS loop for C != 3).
    Returns (gamma (B, N, J), pi (B, J), centroids (B, J, C))."""
    B, N, _ = x.shape
    centroids = index_points(x, farthest_point_sample(x, num_clusters,
                                                      is_center=True))
    gamma = x.new_zeros(B, N, num_clusters)
    pi = x.new_full((B, num_clusters), 1.0 / num_clusters)
    for _ in range(iters):
        if dst == "eu":
            cost = square_distance(x, centroids)
        else:
            x = l2_normalize(x)
            centroids = l2_normalize(centroids)
            cost = 2.0 - 2.0 * matmul32(x, centroids.transpose(-1, -2))
        gamma = N * sinkhorn(cost, max_iter=10)[0]
        pi, centroids = gmm_params(gamma, x)
    return gamma, pi, centroids


def em_route(N: int, K: int, group=None) -> str:
    """'kernel' or 'plain' for the EM of clouds of N points into K clusters:
    the JAX package's rule (`ogmm_tpu/ops/gmm.py:187-206`), its fused kernel
    while N max(K, 128) 4 B x 5 <= 14 MiB, else its jnp composition; the
    port's kernel also needs its own envelope (`cuda_em.kernel_takes`).
    Under a point-sharding `group` always the plain route: the kernel holds
    a whole cloud and cannot sum its moments over processes."""
    if group is not None:
        return "plain"
    if N * max(K, 128) * 4 * 5 <= EM_VMEM_BYTES and cuda_em.kernel_takes(N, K):
        return "kernel"
    return "plain"


@torch.no_grad()
def em_plain(xyz, o, node_xyz0, iters: int, tau: float, group=None):
    """The plain EM route, a port of the JAX package's `_em_jnp`: per trip
    the cost cdist / tau, ten log-domain Sinkhorn trips with the overlap as
    row marginal, NaN -> 0, rows divided by max(row sum, 1e-3), and the
    weighted means. (B,N,3), (B,N), (B,K,3) -> (gamma, pi, nodes). With a
    point-sharding `group` xyz and o hold this process's rows: the
    Sinkhorn's column update and the means sum over the group."""
    xyz, nodes = xyz.float(), node_xyz0.float()
    B, N, _ = xyz.shape
    K = nodes.shape[1]
    gamma = xyz.new_ones(B, N, K)
    pi = xyz.new_full((B, K), 1.0 / K)
    for _ in range(iters):
        cost = square_distance(xyz, nodes).sqrt().clamp_min(0.0) / tau
        gamma = sinkhorn(cost, p=o, q=None, max_iter=10, group=group)[0]
        gamma = torch.nan_to_num(gamma, nan=0.0)
        gamma = gamma / gamma.sum(dim=-1, keepdim=True).clamp_min(1e-3)
        pi, nodes = gmm_params(gamma, xyz, group=group)
    return gamma, pi, nodes


@torch.no_grad()
def _em(xyz, o, node_xyz0, iters, tau, em_kernel, group):
    if em_kernel is None:
        em_kernel = em_route(xyz.shape[1], node_xyz0.shape[1], group) == "kernel"
    if em_kernel:
        return sinkhorn_em(xyz, o, node_xyz0, iters=iters, sk_iters=10, tau=tau)
    return em_plain(xyz, o, node_xyz0, iters, tau, group)


def wkeans_plus(xyz: torch.Tensor, feats: torch.Tensor,
                o_scores: torch.Tensor, n_clusters: int, iters: int = 10,
                tau: float = 1.0, init_ids: torch.Tensor | None = None,
                use_kernel: bool = False,
                init_nodes: torch.Tensor | None = None,
                em_kernel: bool | None = None, group=None):
    """Overlap-weighted Sinkhorn-EM clustering.

    E-step: Sinkhorn on cdist(xyz, nodes)/tau with the normalised overlap
    scores as row marginal; M-step: weighted means. The EM carries no
    gradient (gamma, pi and the nodes come back detached); only the final
    node_feats moments do, through `feats`. `init_ids` overrides the
    centre-seeded FPS initialisation (see `fps_combined`); `use_kernel`
    runs that FPS as one kernel launch; `init_nodes` (B, K, 3) gives the
    initial centres themselves. `em_kernel` forces the EM's route (True:
    the `sinkhorn_em` kernel, False: the plain route; None: `em_route`).

    With a point-sharding `group` (`parallel/sp.py`) xyz, feats and
    o_scores hold this process's rows: the overlap normalisation, the EM's
    Sinkhorn columns and moments and the final node_feats sum over the
    group; gamma keeps the local rows and pi, node_xyz and node_feats are
    the same on every process. It needs `init_nodes` (an FPS of a block of
    rows is not the cloud's) and refuses a forced EM kernel, as the JAX
    package does (`ogmm_tpu/ops/gmm.py:163-170`).

    Returns (gamma (B,N,K), pi (B,K), node_xyz (B,K,3), node_feats (B,K,C)).
    """
    if group is not None and init_nodes is None:
        raise ValueError("wkeans_plus(group=...) needs init_nodes: the FPS "
                         "initialisation cannot run on a point shard")
    if group is not None and em_kernel:
        raise ValueError("wkeans_plus: em_kernel=True is incompatible with a "
                         "point-sharding group: the fused EM kernel holds a "
                         "whole cloud and cannot sum across processes")
    if init_nodes is None:
        ids = (init_ids if init_ids is not None
               else farthest_point_sample(xyz, n_clusters, is_center=True,
                                          use_kernel=use_kernel))
        init_nodes = index_points(xyz, ids)
    o = o_scores.detach()
    osum = comm.psum(o.sum(dim=-1, keepdim=True), group)
    o = o / osum.clamp_min(1e-4)
    gamma, pi, node_xyz = _em(xyz.detach(), o, init_nodes.detach(), iters,
                              tau, em_kernel, group)
    node_feats = gmm_params(gamma, feats, group=group)[1]
    return gamma, pi, node_xyz, node_feats


def get_local_corrs(xyz: torch.Tensor, xyz_mu: torch.Tensor,
                    feats: torch.Tensor, group=None) -> torch.Tensor:
    """Features of the point nearest to each cluster mean: xyz (B, N, 3),
    xyz_mu (B, J, 3), feats (B, N, C) -> (B, J, C). The 1-NN carries no
    gradient; the gather does. With a point-sharding `group` xyz and feats
    hold this process's rows: the 1-NN combines over the group (`nn1_sp`)
    and the owner's row is gathered (`index_points_sp`)."""
    if group is not None:
        idx = nn1_sp(xyz_mu.detach(), xyz.detach(), group)[1]
        return index_points_sp(feats, idx, group)
    idx = nn1(xyz_mu.detach(), xyz.detach())[1]
    return index_points(feats, idx)


def get_anchor_corrs(xyz: torch.Tensor, feats: torch.Tensor,
                     num_clusters: int, dst: str = "eu", iters: int = 10,
                     is_fast: bool = True,
                     generator: torch.Generator | None = None,
                     anchor_ids: torch.Tensor | None = None):
    """Anchors and their features. `is_fast`: FPS anchors (random start from
    `generator`, index 0 without one), or the `anchor_ids` given, and the
    features at them; else `wkeans` over xyz, the features' moments under
    its gamma, and each mean's nearest point as its id. Returns
    (feats_anchor (B, J, C): the features of the point nearest each anchor
    position, feats_pos (B, J, C), xyz_mu (B, J, 3), anchor_ids (B, J))."""
    if is_fast:
        if anchor_ids is None:
            anchor_ids = farthest_point_sample(xyz, num_clusters,
                                               generator=generator)
        xyz_mu = index_points(xyz, anchor_ids)
        feats_pos = index_points(feats, anchor_ids)
    else:
        gamma, _, xyz_mu = wkeans(xyz, num_clusters, dst, iters)
        feats_pos = gmm_params(gamma, feats)[1]
        anchor_ids = square_distance(xyz_mu, xyz).argmin(dim=-1)
    return get_local_corrs(xyz, xyz_mu, feats), feats_pos, xyz_mu, anchor_ids
