"""DeepGMR: per-point softmax clustering and a closed-form GMM alignment.

DGCNN features -> a K-way softmax clustering head -> GMM moments with
isotropic covariances (`ops.gmm.gmm_params`) -> the Sigma^-1-weighted
cross-covariance of the two mixtures -> Horn's rotation solve
(`core.procrustes.horn_rotation`) [-> the batched ICP], the JAX package's
`ogmm_tpu/nn/deepgmr.py`.

The backbone and the head take no compute type: they run in float32
whatever `cfg.dtype` says, as there. Src and tgt may differ in point count
(the `modelnetdv` geometry is 768 against 1536), so each cloud goes through
the backbone on its own, src first; in training every BatchNorm takes the
statistics of one cloud and updates its running statistics twice a step.

Kept quirk of the original: the translation returned without ICP is the
bottom row of the 4x4 transform (always zeros), `quirk_translation_row=True`;
False returns the column. With `refine` the ICP's translation is the column.
"""
from __future__ import annotations

import torch
from torch import nn

from ogmm_tpu_torch.configs import ModelConfig
from ogmm_tpu_torch.core.procrustes import horn_rotation
from ogmm_tpu_torch.nn.dgcnn import DGCNN
from ogmm_tpu_torch.nn.layers import ConvHead
from ogmm_tpu_torch.ops.common import matmul32
from ogmm_tpu_torch.ops.gmm import gmm_params
from ogmm_tpu_torch.ops.icp import icp_point_to_point


def cross_covariance(pi_s, mu_s, mu_t, sigma_t):
    """The Sigma^-1-weighted cross-covariance of two GMMs and their
    centroids, the first half of `gmm_register`: (ms (B, 3, 3), c_s, c_t
    (B, 1, 3)).

    Sigma^-1 is I / var. Where var is 0 or subnormal (a cluster no point
    belongs to) the JAX package's inverse on the CPU, whose LU flushes
    subnormals to zero, gives rows of NaN and inf, so that every weighted
    offset of that cluster is NaN; so here, and `nan_to_num` then sets
    every entry of ms to 0 before the 1e-4 is added, as there."""
    c_s = matmul32(pi_s.unsqueeze(1), mu_s)                  # (B, 1, 3)
    c_t = matmul32(pi_s.unsqueeze(1), mu_t)
    ds = mu_s - c_s
    dt = mu_t - c_t
    var = sigma_t[..., 0, 0]                                 # (B, K)
    regular = var >= torch.finfo(var.dtype).tiny
    inv = torch.where(regular, 1.0 / torch.where(regular, var, 1.0),
                      torch.full_like(var, float("nan")))
    dt_w = dt * inv.unsqueeze(-1)
    ms = matmul32((pi_s.unsqueeze(-1) * ds).transpose(1, 2), dt_w)
    return torch.nan_to_num(ms) + 1e-4, c_s, c_t


def gmm_register(pi_s, mu_s, mu_t, sigma_t):
    """Closed-form alignment of two GMMs: pi_s (B, K), mu_s and mu_t
    (B, K, 3), sigma_t (B, K, 3, 3) isotropic (var I, as `gmm_params` makes
    it) -> the (B, 4, 4) transform mapping the source mixture onto the
    target: Horn's rotation of `cross_covariance`, the translation between
    the centroids. Float32, TF32 off."""
    ms, c_s, c_t = cross_covariance(pi_s, mu_s, mu_t, sigma_t)
    rot = horn_rotation(ms)
    t = c_t.transpose(-1, -2) - matmul32(rot, c_s.transpose(-1, -2))
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=rot.dtype,
                          device=rot.device).expand(rot.shape[0], 1, 4)
    return torch.cat([torch.cat([rot, t], dim=-1), bottom], dim=-2)


class DeepGMR(nn.Module):
    """Call: (src (B, N, 3), tgt (B, M, 3)) -> (rot (B, 3, 3), trans (B, 3)).
    `refine=True` appends the batched point-to-point ICP at twice the
    overlap radius; `loop_kernels` runs it as one kernel launch within the
    kernel's envelope, as for GMMReg."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 loop_kernels: bool = False,
                 quirk_translation_row: bool = True):
        super().__init__()
        self.cfg = cfg
        self.loop_kernels = loop_kernels
        self.quirk_translation_row = quirk_translation_row
        self.backbone = DGCNN(cfg.emb_dims, cfg.gnn_k)
        self.cluster = ConvHead(cfg.emb_dims, cfg.n_clusters,
                                cfg.emb_dims // 2, deep=True)
        self.eval()

    def moments(self, cloud: torch.Tensor):
        """(gamma (B, N, K), pi (B, K), mu (B, K, 3), sigma (B, K, 3, 3))
        of one cloud."""
        gamma = torch.softmax(self.cluster(self.backbone(cloud)), dim=-1)
        return (gamma, *gmm_params(gamma, cloud, return_sigma=True))

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                refine: bool = False):
        src, tgt = src.float(), tgt.float()
        _, src_pi, src_mu, _ = self.moments(src)
        _, _, tgt_mu, tgt_sigma = self.moments(tgt)
        tsfm = gmm_register(src_pi, src_mu, tgt_mu, tgt_sigma)
        if refine:
            return icp_point_to_point(
                src, tgt, tsfm, threshold=2.0 * self.cfg.overlap_radius,
                max_iter=self.cfg.icp_iters, use_kernel=self.loop_kernels)
        rot = tsfm[:, :3, :3]
        trans = tsfm[:, 3, :3] if self.quirk_translation_row else tsfm[:, :3, 3]
        return rot, trans
