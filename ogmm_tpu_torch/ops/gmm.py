"""GMM moment estimation and the overlap-weighted Sinkhorn-EM clustering."""
from __future__ import annotations

import torch

from ogmm_tpu_torch.ops.common import index_points, matmul32, nn1
from ogmm_tpu_torch.ops.cuda_em import sinkhorn_em
from ogmm_tpu_torch.ops.fps import farthest_point_sample


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


@torch.no_grad()
def _em(xyz, o, node_xyz0, iters, tau):
    return sinkhorn_em(xyz, o, node_xyz0, iters=iters, sk_iters=10, tau=tau)


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
