"""GMM moment estimation and the overlap-weighted Sinkhorn-EM clustering."""
from __future__ import annotations

import torch

from ogmm_tpu_torch.ops import cuda_em
from ogmm_tpu_torch.ops.common import (index_points, matmul32, nn1,
                                       square_distance)
from ogmm_tpu_torch.ops.cuda_em import sinkhorn_em
from ogmm_tpu_torch.ops.fps import farthest_point_sample
from ogmm_tpu_torch.ops.sinkhorn import sinkhorn

EM_VMEM_BYTES = 14 * 2 ** 20   # the JAX kernel's bound (ops/gmm.py:195-197)


def gmm_params(gamma: torch.Tensor, pts: torch.Tensor,
               return_sigma: bool = False):
    """Mixture weights and means (and isotropic covariances) from
    responsibilities: gamma (B, N, J), pts (B, N, D) ->
    pi (B, J), mu (B, J, D) [, sigma (B, J, D, D)]."""
    N = gamma.shape[1]
    D = pts.shape[-1]
    pi = gamma.sum(dim=1) / N
    npi = pi * N + 1e-5
    mu = matmul32(gamma.transpose(1, 2), pts) / npi.unsqueeze(-1)
    if not return_sigma:
        return pi, mu
    diff = pts.unsqueeze(2) - mu.unsqueeze(1)                # (B, N, J, D)
    var = ((diff * diff).sum(-1) * gamma).sum(dim=1) / npi   # (B, J)
    eye = torch.eye(D, dtype=pts.dtype, device=pts.device)
    return pi, mu, var[..., None, None] * eye


def em_route(N: int, K: int) -> str:
    """'kernel' or 'plain' for the EM of clouds of N points into K clusters:
    the JAX package's rule (`ogmm_tpu/ops/gmm.py:187-206`), its fused kernel
    while N max(K, 128) 4 B x 5 <= 14 MiB, else its jnp composition; the
    port's kernel also needs its own envelope (`cuda_em.kernel_takes`)."""
    if N * max(K, 128) * 4 * 5 <= EM_VMEM_BYTES and cuda_em.kernel_takes(N, K):
        return "kernel"
    return "plain"


@torch.no_grad()
def em_plain(xyz, o, node_xyz0, iters: int, tau: float):
    """The plain EM route, a port of the JAX package's `_em_jnp`: per trip
    the cost cdist / tau, ten log-domain Sinkhorn trips with the overlap as
    row marginal, NaN -> 0, rows divided by max(row sum, 1e-3), and the
    weighted means. (B,N,3), (B,N), (B,K,3) -> (gamma, pi, nodes)."""
    xyz, nodes = xyz.float(), node_xyz0.float()
    B, N, _ = xyz.shape
    K = nodes.shape[1]
    gamma = xyz.new_ones(B, N, K)
    pi = xyz.new_full((B, K), 1.0 / K)
    for _ in range(iters):
        cost = square_distance(xyz, nodes).sqrt().clamp_min(0.0) / tau
        gamma = sinkhorn(cost, p=o, q=None, max_iter=10)[0]
        gamma = torch.nan_to_num(gamma, nan=0.0)
        gamma = gamma / gamma.sum(dim=-1, keepdim=True).clamp_min(1e-3)
        pi, nodes = gmm_params(gamma, xyz)
    return gamma, pi, nodes


@torch.no_grad()
def _em(xyz, o, node_xyz0, iters, tau):
    if em_route(xyz.shape[1], node_xyz0.shape[1]) == "kernel":
        return sinkhorn_em(xyz, o, node_xyz0, iters=iters, sk_iters=10, tau=tau)
    return em_plain(xyz, o, node_xyz0, iters, tau)


def wkeans_plus(xyz: torch.Tensor, feats: torch.Tensor,
                o_scores: torch.Tensor, n_clusters: int, iters: int = 10,
                tau: float = 1.0, init_ids: torch.Tensor | None = None):
    """Overlap-weighted Sinkhorn-EM clustering.

    E-step: Sinkhorn on cdist(xyz, nodes)/tau with the normalised overlap
    scores as row marginal; M-step: weighted means. The EM carries no
    gradient (gamma, pi and the nodes come back detached); only the final
    node_feats moments do, through `feats`. `init_ids` overrides the
    centre-seeded FPS initialisation (see `fps_combined`).

    Returns (gamma (B,N,K), pi (B,K), node_xyz (B,K,3), node_feats (B,K,C)).
    """
    ids = (init_ids if init_ids is not None
           else farthest_point_sample(xyz, n_clusters, is_center=True))
    node_xyz0 = index_points(xyz, ids)
    o = o_scores.detach()
    o = o / o.sum(dim=-1, keepdim=True).clamp_min(1e-4)
    gamma, pi, node_xyz = _em(xyz.detach(), o, node_xyz0.detach(), iters, tau)
    node_feats = gmm_params(gamma, feats)[1]
    return gamma, pi, node_xyz, node_feats


def get_local_corrs(xyz: torch.Tensor, xyz_mu: torch.Tensor,
                    feats: torch.Tensor) -> torch.Tensor:
    """Features of the point nearest to each cluster mean: xyz (B, N, 3),
    xyz_mu (B, J, 3), feats (B, N, C) -> (B, J, C). The 1-NN carries no
    gradient; the gather does."""
    idx = nn1(xyz_mu.detach(), xyz.detach())[1]
    return index_points(feats, idx)
