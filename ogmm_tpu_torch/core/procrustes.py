"""Weighted Procrustes rigid-transform solver, batched, on the device.

The 3x3 problem is solved through Horn's symmetric 4x4 matrix (largest
eigenvector = optimal quaternion), which always gives a proper rotation, by
`eigh` ('horn'), by shifted power iteration ('horn_pi', the ICP default), or
through an SVD with the reflection fix ('svd'). A non-finite covariance
gives the identity rotation. Points are (B, N, 3), weights (B, N). All
float32, TF32 off.
"""
from __future__ import annotations

import torch

from ogmm_tpu_torch.ops.common import matmul32 as _mm
from ogmm_tpu_torch.parallel import comm


def _horn_matrix(cov: torch.Tensor) -> torch.Tensor:
    sxx, sxy, sxz = cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2]
    syx, syy, syz = cov[..., 1, 0], cov[..., 1, 1], cov[..., 1, 2]
    szx, szy, szz = cov[..., 2, 0], cov[..., 2, 1], cov[..., 2, 2]
    k00 = sxx + syy + szz
    k01 = syz - szy
    k02 = szx - sxz
    k03 = sxy - syx
    k11 = sxx - syy - szz
    k12 = sxy + syx
    k13 = szx + sxz
    k22 = -sxx + syy - szz
    k23 = syz + szy
    k33 = -sxx - syy + szz
    return torch.stack([
        torch.stack([k00, k01, k02, k03], dim=-1),
        torch.stack([k01, k11, k12, k13], dim=-1),
        torch.stack([k02, k12, k22, k23], dim=-1),
        torch.stack([k03, k13, k23, k33], dim=-1)], dim=-2)


def _quat_rotation(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        w * w + x * x - y * y - z * z, 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), w * w - x * x + y * y - z * z, 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), w * w - x * x - y * y + z * z,
    ], dim=-1).reshape(*q.shape[:-1], 3, 3)


def _horn_quaternion(cov: torch.Tensor) -> torch.Tensor:
    """Optimal rotation for cov = sum_i w_i x_i y_i^T by a batched 4x4 eigh."""
    _, vecs = torch.linalg.eigh(_horn_matrix(cov))       # ascending
    return _quat_rotation(vecs[..., :, -1])


def horn_rotation(cov: torch.Tensor) -> torch.Tensor:
    """The optimal R in SO(3) maximising tr(R cov^T) for a batched
    (..., 3, 3) cross-covariance: Horn's quaternion eigen-solve, always a
    proper rotation (the JAX package's public alias)."""
    return _horn_quaternion(cov)


def _horn_quaternion_pi(cov: torch.Tensor, iters: int = 30) -> torch.Tensor:
    """The same by power iteration on K shifted by a Gershgorin bound."""
    K = _horn_matrix(cov)
    sigma = K.abs().sum(-1).amax(-1)
    Ks = K + (sigma[..., None, None] + 1e-6) * torch.eye(
        4, dtype=K.dtype, device=K.device)
    q = torch.tensor([1.0, 1e-3, 2e-3, 3e-3], dtype=K.dtype,
                     device=K.device).expand(K.shape[:-1])
    for _ in range(iters):
        q = (Ks * q.unsqueeze(-2)).sum(-1)               # 4x4 matvec, fp32
        q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-30)
    return _quat_rotation(q)


def _svd_rotation(cov: torch.Tensor) -> torch.Tensor:
    """cov = U S V^T, R = V diag(1, 1, sign) U^T."""
    u, _, vh = torch.linalg.svd(cov, full_matrices=False)
    v = vh.transpose(-1, -2)
    det = torch.linalg.det(_mm(v, u.transpose(-1, -2)))
    sign = torch.where(det > 0, 1.0, -1.0).to(cov.dtype)
    v = torch.cat([v[..., :, :2], v[..., :, 2:] * sign[..., None, None]],
                  dim=-1)
    return _mm(v, u.transpose(-1, -2))


def rigid_transform(src: torch.Tensor, src_corr: torch.Tensor,
                    weight: torch.Tensor, method: str = "horn", group=None):
    """Find (R, t) minimising sum_i w_i |R s_i + t - c_i|^2.

    src, src_corr (B, N, 3); weight (B, N) non-negative.
    Returns rot (B, 3, 3), trans (B, 3, 1) with R src + t ~= src_corr.
    With a point-sharding `group` the rows are this process's: the weighted
    sums and the covariance are summed over the group and the small solve
    runs on every process alike.
    """
    w = weight.unsqueeze(-1)
    if group is None:
        wsum = w.sum(dim=1, keepdim=True)
        src_sum = (src * w).sum(dim=1, keepdim=True)
        corr_sum = (src_corr * w).sum(dim=1, keepdim=True)
    else:
        wsum, src_sum, corr_sum = comm.psum(torch.cat(
            [w.sum(dim=1, keepdim=True), (src * w).sum(dim=1, keepdim=True),
             (src_corr * w).sum(dim=1, keepdim=True)], dim=-1),
            group).split([1, 3, 3], dim=-1)
    wsum = wsum.clamp_min(1e-12)
    src_mean = src_sum / wsum
    corr_mean = corr_sum / wsum
    src_c = src - src_mean
    corr_c = src_corr - corr_mean
    cov = comm.psum(_mm((src_c * w).transpose(1, 2), corr_c), group)  # (B, 3, 3)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    finite = torch.isfinite(cov).all(dim=-1, keepdim=True).all(
        dim=-2, keepdim=True)
    cov = torch.where(finite, cov, torch.zeros_like(cov)) + 1e-5 * eye
    if method == "horn":
        rot = _horn_quaternion(cov)
    elif method == "horn_pi":
        rot = _horn_quaternion_pi(cov)
    elif method == "svd":
        rot = _svd_rotation(cov)
    else:
        raise ValueError(f"unknown procrustes method {method!r}")
    rot = torch.where(finite, rot, eye.expand_as(rot))
    trans = corr_mean.transpose(-1, -2) - _mm(rot, src_mean.transpose(-1, -2))
    return rot, trans


def rigid_transform_3x4(src: torch.Tensor, src_corr: torch.Tensor,
                        weight: torch.Tensor, method: str = "horn") -> torch.Tensor:
    """As `rigid_transform`, but one (B, 3, 4) pose [R | t]."""
    rot, trans = rigid_transform(src, src_corr, weight, method)
    return torch.cat([rot, trans], dim=-1)


def gated_update(src: torch.Tensor, corr: torch.Tensor, nn_d: torch.Tensor,
                 thresh_sq: float, rot: torch.Tensor, trans: torch.Tensor,
                 method: str = "horn_pi", group=None):
    """One ICP trip's solve: the correspondences with squared distance
    nn_d (B, N) < thresh_sq weigh the Procrustes problem of src onto corr
    (all points, where a cloud has none); a cloud without inliers keeps
    (rot (B, 3, 3), trans (B, 3)). Returns the new (rot, trans). With a
    point-sharding `group` the inlier count and the moments are summed
    over the group's rows."""
    w = (nn_d < thresh_sq).to(src.dtype)
    any_in = comm.psum(w.sum(dim=-1), group) > 0
    w = torch.where(any_in[:, None], w, torch.ones_like(w))
    rot_new, t_new = rigid_transform(src, corr, w, method=method, group=group)
    rot = torch.where(any_in[:, None, None], rot_new, rot)
    return rot, torch.where(any_in[:, None], t_new[..., 0], trans)
