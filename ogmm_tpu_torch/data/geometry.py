"""Classical point-cloud geometry on the host (numpy and scipy), the port's
copy of the JAX package's `data/geometry.py`: what the original did through
Open3D, for the data pipeline and offline tools. The serving and training
paths do not use it (their refinement is `ops.icp`).

  estimate_normals       PCA of the radius / k-NN neighbourhood, oriented
  voxel_downsample       the mean of each voxel, and one point a voxel
  get_matching_indices,
  get_correspondences    radius pairs after the ground-truth transform
  compute_overlap_ratio  the two-way match ratio
  fpfh                   33-dim Fast Point Feature Histograms
  integrate_trans        (R, t) -> (4, 4)
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree


def estimate_normals(points: np.ndarray, radius: float = 0.06,
                     max_nn: int = 30,
                     orient_to: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-point unit normals by PCA of the local neighbourhood.

    Mirrors o3d estimate_normals(KDTreeSearchParamHybrid(radius, max_nn))
    (lib/o3dutils.py:56-59): for each point take up to max_nn neighbours
    within `radius`, normal = eigenvector of the smallest eigenvalue of the
    local covariance. Orientation: towards `orient_to` (camera) if given,
    else sign-fixed to the +z hemisphere (deterministic).
    """
    pts = np.asarray(points[:, :3], np.float64)
    n = len(pts)
    tree = cKDTree(pts)
    dist, idx = tree.query(pts, k=min(max_nn, n),
                           distance_upper_bound=radius)
    normals = np.zeros((n, 3))
    for i in range(n):
        nbr = idx[i][np.isfinite(dist[i])]
        if len(nbr) < 3:
            normals[i] = [0.0, 0.0, 1.0]
            continue
        q = pts[nbr] - pts[nbr].mean(axis=0)
        cov = q.T @ q
        w, v = np.linalg.eigh(cov)
        normals[i] = v[:, 0]
    if orient_to is not None:
        flip = np.einsum('nd,nd->n', normals,
                         np.asarray(orient_to, np.float64) - pts) < 0
    else:
        flip = normals[:, 2] < 0
    normals[flip] *= -1.0
    norms = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(norms, 1e-12)).astype(np.float32)


def voxel_downsample(points: np.ndarray, voxel_size: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Average points within each voxel (o3d voxel_down_sample semantics,
    lib/o3dutils.py:66). Returns (downsampled (M,3...), index of one
    representative original point per voxel)."""
    pts = np.asarray(points)
    keys = np.floor(pts[:, :3] / voxel_size).astype(np.int64)
    # lexicographic voxel id
    _, inverse, counts = np.unique(keys, axis=0, return_inverse=True,
                                   return_counts=True)
    sums = np.zeros((len(counts), pts.shape[1]), np.float64)
    np.add.at(sums, inverse, pts)
    centers = (sums / counts[:, None]).astype(pts.dtype)
    rep = np.zeros(len(counts), np.int64)
    rep[inverse[::-1]] = np.arange(len(pts))[::-1]   # first point per voxel
    return centers, rep


def get_matching_indices(source: np.ndarray, target: np.ndarray,
                         trans: np.ndarray, search_voxel_size: float,
                         k: Optional[int] = None) -> List[Tuple[int, int]]:
    """Pairs (i, j) with |T(source_i) - target_j| < search_voxel_size
    (lib/o3dutils.py:96-109). `k` caps matches per source point."""
    from ogmm_tpu_torch.data.datautils import transform
    src_t = transform(trans, source[:, :3])
    tree = cKDTree(target[:, :3])
    neigh = tree.query_ball_point(src_t, search_voxel_size)
    out = []
    for i, js in enumerate(neigh):
        js = sorted(js, key=lambda j: np.sum((target[j, :3] - src_t[i]) ** 2))
        if k is not None:
            js = js[:k]
        out.extend((i, j) for j in js)
    return out


def get_correspondences(src: np.ndarray, tgt: np.ndarray, trans: np.ndarray,
                        search_voxel_size: float,
                        k: Optional[int] = None) -> np.ndarray:
    """(P, 2) int array of radius correspondences (lib/o3dutils.py:123-135)."""
    pairs = get_matching_indices(src, tgt, trans, search_voxel_size, k)
    if not pairs:
        return np.zeros((0, 2), np.int64)
    return np.asarray(pairs, np.int64)


def compute_overlap_ratio(src: np.ndarray, tgt: np.ndarray,
                          trans: np.ndarray, voxel_size: float) -> float:
    """min-normalised two-way match ratio (lib/o3dutils.py:112-120)."""
    matches01 = get_matching_indices(src, tgt, trans, voxel_size, k=1)
    from ogmm_tpu_torch.data.datautils import se3_inv
    t44 = trans
    if trans.shape[-2:] != (4, 4):
        t44 = np.eye(4)
        t44[:3, :3] = trans[:3, :3]
        t44[:3, 3] = trans[:3, 3].flatten()
    inv = np.eye(4)
    inv[:3] = se3_inv(t44[None])[0]
    matches10 = get_matching_indices(tgt, src, inv, voxel_size, k=1)
    r01 = len(matches01) / max(len(src), 1)
    r10 = len(matches10) / max(len(tgt), 1)
    return max(r01, r10)


def fpfh(points: np.ndarray, normals: Optional[np.ndarray] = None,
         radius: float = 0.125, max_nn: int = 100) -> np.ndarray:
    """Fast Point Feature Histograms, 33-dim per point.

    The o3d compute_fpfh_feature equivalent for the reference's (off-train-
    path) feature pipeline (lib/o3dutils.py:64-76): SPFH = 11-bin histograms
    of the Darboux-frame angles (alpha, phi, theta) over radius neighbours,
    then FPFH_i = SPFH_i + mean_j SPFH_j / ||p_i - p_j||.
    """
    pts = np.asarray(points[:, :3], np.float64)
    n = len(pts)
    if normals is None:
        normals = estimate_normals(pts, radius=radius / 2.0 + 1e-9, max_nn=30)
    nrm = np.asarray(normals, np.float64)
    tree = cKDTree(pts)
    neigh = tree.query_ball_point(pts, radius)

    def spfh_one(i):
        js = [j for j in neigh[i] if j != i][:max_nn]
        hist = np.zeros(33)
        if not js:
            return hist
        p, np_i = pts[i], nrm[i]
        d = pts[js] - p                                   # (m, 3)
        dist = np.linalg.norm(d, axis=1)
        good = dist > 1e-12
        d, dist = d[good] / dist[good][:, None], dist[good]
        js = np.asarray(js)[good]
        u = np.broadcast_to(np_i, d.shape)
        v = np.cross(d, u)
        w = np.cross(u, v)
        nj = nrm[js]
        alpha = np.einsum('md,md->m', v, nj)              # [-1, 1]
        phi = np.einsum('md,md->m', u, d)                 # [-1, 1]
        theta = np.arctan2(np.einsum('md,md->m', w, nj),
                           np.einsum('md,md->m', u, nj))  # [-pi, pi]
        for k_, (val, lo, hi) in enumerate(
                ((alpha, -1.0, 1.0), (phi, -1.0, 1.0),
                 (theta, -np.pi, np.pi))):
            b = np.clip(((val - lo) / (hi - lo) * 11).astype(int), 0, 10)
            np.add.at(hist, k_ * 11 + b, 100.0 / len(val))
        return hist

    spfh = np.stack([spfh_one(i) for i in range(n)])
    out = spfh.copy()
    for i in range(n):
        js = [j for j in neigh[i] if j != i][:max_nn]
        if not js:
            continue
        d = np.linalg.norm(pts[js] - pts[i], axis=1)
        good = d > 1e-12
        if not np.any(good):
            continue
        w = 1.0 / d[good]
        out[i] += (spfh[np.asarray(js)[good]] * w[:, None]).sum(0) / len(w)
    return out.astype(np.float32)


def integrate_trans(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """(3,3)+(3,) -> (4,4); the batched device form is `core.se3.integrate`."""
    T = np.eye(4, dtype=np.asarray(R).dtype)
    T[:3, :3] = R
    T[:3, 3] = np.asarray(t).reshape(3)
    return T
