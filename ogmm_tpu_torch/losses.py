"""Training losses of GMMReg, channel-last, the definitions of the JAX
package's `ogmm_tpu/losses.py`.

`composite_loss` masks a non-finite auxiliary term to 0 instead of the
original's try/except fallback to the pose loss. `overlap_loss` is named BCE
in the original and computes a mean squared error; it is kept so.
"""
from __future__ import annotations

import numpy as np
import torch

from ogmm_tpu_torch.core import se3
from ogmm_tpu_torch.ops.common import (index_points, l2_normalize, matmul32,
                                       nn1, nn1_both)
from ogmm_tpu_torch.ops.gmm import get_local_corrs, gmm_params
from ogmm_tpu_torch.ops.sinkhorn import contrastsk


def dcp_loss(rot_pred, rot_gt, trans_pred, trans_gt):
    """MSE(R_pred^T R_gt, I) + MSE(t_pred, t_gt)."""
    B = rot_pred.shape[0]
    rr = matmul32(rot_pred.transpose(-1, -2), rot_gt)
    eye = torch.eye(3, dtype=rr.dtype, device=rr.device)
    return (((rr - eye) ** 2).mean()
            + ((trans_pred.reshape(B, 3) - trans_gt.reshape(B, 3)) ** 2).mean())


def _offdiag_index(n: int) -> np.ndarray:
    """(n, n-1) column indices of the off-diagonal entries of each row."""
    cols = np.arange(n - 1)[None, :].repeat(n, axis=0)
    return cols + (cols >= np.arange(n)[:, None])


def con_loss(x: torch.Tensor, y: torch.Tensor, tau: float = 0.01,
             normalize: bool = True) -> torch.Tensor:
    """NT-Xent contrastive loss between paired sets x, y (B, n, d): the
    positives are the (x_i, y_i) pairs, the negatives the off-diagonal
    entries of the xx, xy, yx and yy similarity blocks; cross-entropy with
    label 0 over 2n-1 logits."""
    B, n, _ = x.shape
    if normalize:
        x, y = l2_normalize(x), l2_normalize(y)
    s_xy = matmul32(x, y.transpose(1, 2)) / tau
    s_yx = s_xy.transpose(1, 2)
    s_xx = matmul32(x, x.transpose(1, 2)) / tau
    s_yy = matmul32(y, y.transpose(1, 2)) / tau
    off = torch.from_numpy(_offdiag_index(n)).to(x.device)
    off = off.unsqueeze(0).expand(B, n, n - 1)

    def take(s):
        return torch.gather(s, -1, off)                  # (B, n, n-1)

    pos = torch.cat([s_xy.diagonal(dim1=1, dim2=2),
                     s_yx.diagonal(dim1=1, dim2=2)], dim=1).unsqueeze(-1)
    neg = torch.cat([torch.cat([take(s_xx), take(s_xy)], dim=-1),
                     torch.cat([take(s_yx), take(s_yy)], dim=-1)], dim=1)
    logits = torch.cat([pos, neg], dim=-1)               # (B, 2n, 2n-1)
    return (torch.logsumexp(logits, dim=-1) - logits[..., 0]).mean()


def clu_loss(xyz, node_xyz, feats, gamma, tau: float = 0.1, group=None):
    """Clustering contrastive loss: gamma-weighted mean features of each
    cluster against the features of the point nearest its mean.
    xyz (B,N,3), node_xyz (B,K,3), feats (B,N,C), gamma (B,N,K); with a
    point-sharding `group` xyz, feats and gamma hold this process's rows
    and the moments and the nearest points come from the whole clouds."""
    feats_pos = gmm_params(gamma, feats, group=group)[1]
    feats_anchor = get_local_corrs(xyz, node_xyz, feats, group)
    return con_loss(feats_anchor, feats_pos, tau=tau)


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest scores of each row, largest first, ties to
    the lowest index (`jax.lax.top_k`; `torch.topk` promises no order among
    ties, and overlap labels are 0/1, so nearly everything ties)."""
    return torch.sort(scores, dim=-1, descending=True, stable=True)[1][..., :k]


def km_loss(pts: torch.Tensor, log_gamma: torch.Tensor,
            prob: torch.Tensor | None = None, top_k: int = 256):
    """Sinkhorn-target cross-entropy clustering loss (the original's KMLoss,
    off its main path): pts (B, N, D), log_gamma (B, N, K); with `prob`
    (B, N) only its top_k points (ties to the lowest index). The target is
    the row-normalised plan of `contrastsk` between the points and the
    softmax moments, without a gradient."""
    if prob is not None:
        ids = top_k_indices(prob, top_k)
        log_gamma = index_points(log_gamma, ids)
        pts = index_points(pts, ids)
    pi, mu = gmm_params(torch.softmax(log_gamma, dim=-1), pts)
    assign = contrastsk(pts, mu, p=pi, max_iter=25, dst="eu")[0]
    assign = (assign / assign.sum(dim=-1, keepdim=True).clamp_min(1e-4)).detach()
    return (-assign * torch.log_softmax(log_gamma, dim=-1)).sum(dim=1).mean()


def welsch_loss(src, tgt, tsfm, src_o=None, tgt_o=None, alpha: float = 1.0,
                top_k: int = 256):
    """Robust two-way nearest-neighbour distance over the top-k overlap
    points. src/tgt (B, N, 3), tsfm (B, 3/4, 4) applied to src. The 1-NN
    picks the index without a gradient; the distance to it is recomputed
    differentiably, which has the value and the gradient of a min over the
    distance matrix."""
    src = se3.transform(tsfm, src)
    top_k = min(top_k, src.shape[1], tgt.shape[1])
    if src_o is not None and tgt_o is not None:
        src_corr = index_points(src, top_k_indices(src_o, top_k))
        tgt_corr = index_points(tgt, top_k_indices(tgt_o, top_k))
    else:
        src_corr, tgt_corr = src, tgt
    i1 = nn1(src_corr.detach(), tgt.detach())[1]
    z1sq = ((src_corr - index_points(tgt, i1)) ** 2).sum(-1)
    i2 = nn1(tgt_corr.detach(), src.detach())[1]
    z2sq = ((tgt_corr - index_points(src, i2)) ** 2).sum(-1)
    a2 = alpha * alpha
    loss = 2.0 - torch.exp(-0.5 * z1sq / a2) - torch.exp(-0.5 * z2sq / a2)
    return loss.sum(dim=1).mean()


@torch.no_grad()
def overlap_labels_device(src, tgt, rot_gt, trans_gt, thresh: float = 0.05):
    """Ground-truth overlap masks on the device: a point overlaps iff a
    point of the other cloud, after the ground-truth alignment, lies within
    `thresh` (d^2 <= thresh^2). Returns (src_overlap (B, N), tgt_overlap
    (B, M)) float32 in {0, 1}, the true labels of both sides."""
    src_t = se3.rotate(rot_gt, src.float()) + trans_gt.float().unsqueeze(1)
    d_s, d_t = nn1_both(src_t, tgt.float())
    th2 = float(np.float32(thresh * thresh))
    return (d_s <= th2).float(), (d_t <= th2).float()


def overlap_loss(prediction, gt):
    """Overlap-score supervision: a mean squared error (named BCE in the
    original)."""
    return ((prediction - gt) ** 2).mean()


def composite_loss(rot, trans, clu, src_o, tgt_o, rot_gt, trans_gt,
                   src_overlap, tgt_overlap, src, tgt, *,
                   w_dcp=10.0, w_clu=1.0, w_overlap=1.0, w_welsch=0.01,
                   welsch_alpha=10.0, welsch_topk=512):
    """w_dcp * pose loss + (w_clu * clu + w_overlap * overlap + w_welsch *
    Welsch), the bracket set to 0 where it is not finite."""
    base = w_dcp * dcp_loss(rot, rot_gt, trans, trans_gt)
    o_pred = torch.nan_to_num(torch.cat([src_o, tgt_o], dim=-1)).clamp_min(0.0)
    o_gt = torch.nan_to_num(
        torch.cat([src_overlap, tgt_overlap], dim=-1)).clamp_min(0.0)
    tsfm = se3.integrate(rot, trans)
    extra = (w_clu * clu + w_overlap * overlap_loss(o_pred, o_gt)
             + w_welsch * welsch_loss(src, tgt, tsfm, src_overlap, tgt_overlap,
                                      alpha=welsch_alpha, top_k=welsch_topk))
    extra = torch.where(torch.isfinite(extra), extra, torch.zeros_like(extra))
    return torch.nan_to_num(base + extra)
