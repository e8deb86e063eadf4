"""Host-side numpy helpers of the data pipeline: SE(3) on arrays, random
directions and poses, jitter, the pose quaternion of a sample, the
ModelNet40 HDF5 reader, and for the ModelNet variants and the indoor
datasets the half-space crop of a pair, FPS of one cloud, ground-truth
overlap labels and 1-NN (the last three through the host library,
`ogmm_tpu_torch/native`), and the rotation-invariant RRI features.

A copy of the parts of the JAX package's `ogmm_tpu/data/datautils.py` that
the `modelnet`/`synthetic`, `modelnetcp`/`modelnetdv` (and `ModelNetGMR`),
`7scene` and `icl_nuim` routes use, with the same global-`np.random` (or
`rng`) draws, so that both packages give the same samples from the same
seed.
"""
from __future__ import annotations

import glob
import os
from typing import List, Tuple

import numpy as np

from ogmm_tpu_torch import native


def so3_transform(rot: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    return np.einsum('...ij,...bj->...bi', rot, xyz)


def se3_transform(pose: np.ndarray, xyz: np.ndarray) -> np.ndarray:
    rot, trans = pose[..., :3, :3], pose[..., :3, 3:4]
    return np.einsum('...ij,...bj->...bi', rot, xyz) + np.swapaxes(trans, -1, -2)


def se3_init(rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    return np.concatenate([rot, trans], axis=-1)


def se3_inv(pose: np.ndarray) -> np.ndarray:
    rot, trans = pose[..., :3, :3], pose[..., :3, 3:4]
    irot = np.swapaxes(rot, -1, -2)
    return se3_init(irot, -irot @ trans)


def np_mat2quat(pose: np.ndarray) -> np.ndarray:
    """(3/4, 4) -> 7-vector [qw, qx, qy, qz, tx, ty, tz], qw >= 0."""
    from scipy.spatial.transform import Rotation
    q = Rotation.from_matrix(pose[:3, :3]).as_quat()    # (x, y, z, w)
    q = np.array([q[3], q[0], q[1], q[2]])
    if q[0] < 0:
        q = -q
    return np.concatenate([q, pose[:3, 3]], axis=0).astype(np.float32)


def transform(g: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a ([B,] 3/4, 4) pose to ([B,] N, 3) points."""
    rot = g[..., :3, :3]
    trans = g[..., :3, 3]
    return pts[..., :3] @ np.swapaxes(rot, -1, -2) + trans[..., None, :]


def uniform2sphere(rng: np.random.RandomState | None = None):
    """A uniform direction on the unit sphere, from `rng` or the global
    np.random."""
    r = rng if rng is not None else np.random
    phi = r.uniform(0.0, 2 * np.pi)
    theta = np.arccos(r.uniform(-1.0, 1.0))
    return np.stack([np.sin(theta) * np.cos(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(theta)], axis=-1)


def random_rotation(max_angle: float, rng=None) -> np.ndarray:
    """A rotation by a uniform angle below max_angle about a random axis
    (Rodrigues)."""
    r = rng if rng is not None else np.random
    axis = r.randn(3)
    axis /= np.linalg.norm(axis)
    angle = r.rand() * max_angle
    A = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * A + (1 - np.cos(angle)) * A @ A


def random_translation(max_dist: float, rng=None) -> np.ndarray:
    """(3, 1): a random direction times a uniform length below max_dist."""
    r = rng if rng is not None else np.random
    t = r.randn(3)
    t /= np.linalg.norm(t)
    t *= r.rand() * max_dist
    return t[:, None]


def random_pose(max_angle: float, max_trans: float, rng=None) -> np.ndarray:
    """(4, 4) random rigid pose."""
    R = random_rotation(max_angle, rng)
    t = random_translation(max_trans, rng)
    return np.concatenate([np.concatenate([R, t], 1), [[0, 0, 0, 1]]], 0)


def jitter_pcd(pcd: np.ndarray, sigma=0.01, clip=0.05, rng=None) -> np.ndarray:
    """Gaussian jitter of std sigma, clipped at +-clip, from `rng` or the
    global np.random."""
    r = rng if rng is not None else np.random
    return pcd + np.clip(sigma * r.randn(*pcd.shape), -clip, clip)


def farthest_point_sample(point: np.ndarray, npoint: int, is_idx=False,
                          rng=None):
    """Sequential FPS of one (N, C) cloud from a random start (one draw of
    `rng` or the global np.random); the points, and their int32 ids with
    `is_idx`."""
    r = rng if rng is not None else np.random
    farthest = int(r.randint(0, point.shape[0]))
    centroids = native.fps_indices(point, npoint, farthest)
    sampled = point[centroids]
    return (sampled, centroids.astype(np.int32)) if is_idx else sampled


class RandomCropPair:
    """Half-space crop of a src/tgt pair, each keeping p_keep of its points
    on one side of a plane through its centroid with a random normal; no
    correspondence bookkeeping (the real-data sets use it)."""

    def __init__(self, p_keep: List[float] | None = None):
        self.p_keep = np.array([0.7, 0.7] if p_keep is None else p_keep,
                               dtype=np.float32)

    @staticmethod
    def crop(points: np.ndarray, p_keep: float, rng=None) -> np.ndarray:
        rand_xyz = uniform2sphere(rng)
        centered = points[:, :3] - points[:, :3].mean(axis=0)
        dist = centered @ rand_xyz
        if p_keep == 0.5:
            mask = dist > 0
        else:
            mask = dist > np.percentile(dist, (1.0 - p_keep) * 100)
        return points[mask]

    def __call__(self, src, tgt, seed=None):
        if np.all(self.p_keep == 1.0):
            return src, tgt
        if seed is not None:
            np.random.seed(seed)
        src = self.crop(src, float(self.p_keep[0]))
        if len(self.p_keep) > 1:
            tgt = self.crop(tgt, float(self.p_keep[1]))
        return src, tgt


def overlap_labels(src: np.ndarray, tgt: np.ndarray, transf: np.ndarray,
                   thresh: float = 0.05) -> Tuple[np.ndarray, np.ndarray]:
    """Ground-truth overlap masks (float64): a point overlaps if a point of
    the other cloud, src moved by `transf`, lies within `thresh` (the radius
    search of the host library)."""
    src_t = transform(transf, src[:, :3])
    src_label, tgt_label = native.radius_overlap(src_t, tgt, thresh)
    return src_label.astype(np.float64), tgt_label.astype(np.float64)


def nearest_neighbor(src: np.ndarray, dst: np.ndarray):
    """1-NN (distances, indices) of src in dst, by the host library."""
    return native.nearest_neighbor(src, dst)


def load_modelnet_h5(partition: str, root: str):
    """Read <root>/modelnet40_ply_hdf5_2048/ply_data_{partition}*.h5 ->
    (data (S, 2048, 6) xyz + normals float32, labels (S, 1) int64). Needs
    h5py, imported here so that the synthetic source does not."""
    import h5py
    all_data, all_label = [], []
    pattern = os.path.join(root, 'modelnet40_ply_hdf5_2048',
                           f'ply_data_{partition}*.h5')
    for h5_name in sorted(glob.glob(pattern)):
        with h5py.File(h5_name, 'r') as f:
            data = np.concatenate([f['data'][:], f['normal'][:]],
                                  axis=-1).astype('float32')
            label = f['label'][:].astype('int64')
        all_data.append(data)
        all_label.append(label)
    if not all_data:
        raise FileNotFoundError(f"no ModelNet40 h5 files under {pattern}")
    return np.concatenate(all_data, 0), np.concatenate(all_label, 0)


def knn_idx(pts: np.ndarray, k: int) -> np.ndarray:
    """Each point's k nearest neighbours, itself left out, by scipy's
    cKDTree: (N, 3) -> (N, k)."""
    from scipy.spatial import cKDTree
    _, nbr = cKDTree(pts).query(pts, k=k + 1)
    return nbr[:, 1:]                 # column 0 is the query point itself


def get_rri(pts: np.ndarray, k: int) -> np.ndarray:
    """Rotation-invariant relative-position features, (N, 3) -> (N, 4k):
    for each point p and each of its neighbours q_j, [|p|, |q_j|, theta_j,
    phi_j] with theta_j the angle between p and q_j and phi_j the azimuthal
    gap around the p axis from q_j to its nearest other neighbour (the
    transverse components t_j = q_j - cos(theta_j) p, with the full p, as
    in the original)."""
    nbrs = pts[knn_idx(pts, k)]                          # (N, k, 3)
    r_p = np.linalg.norm(pts, axis=-1)                   # (N,)
    r_q = np.linalg.norm(nbrs, axis=-1)                  # (N, k)
    p_hat = pts / r_p[:, None]
    q_hat = nbrs / r_q[..., None]
    cos_theta = np.clip(np.einsum('nkc,nc->nk', q_hat, p_hat), -1.0, 1.0)
    theta = np.arccos(cos_theta)
    # psi_ab = atan2(p_hat . (t_b x t_a), t_b . t_a), wrapped to [0, 2 pi)
    t = nbrs - cos_theta[..., None] * pts[:, None, :]    # (N, k, 3)
    sin_psi = np.einsum('nabc,nc->nab',
                        np.cross(t[:, None, :, :], t[:, :, None, :]), p_hat)
    cos_psi = np.einsum('nac,nbc->nab', t, t)
    psi = np.arctan2(sin_psi, cos_psi) % (2.0 * np.pi)
    # psi[a, a] == 0, so the gap to the nearest other neighbour is each
    # row's second-smallest entry
    phi = np.partition(psi, 1, axis=-1)[:, :, 1]
    feats = np.stack([np.broadcast_to(r_p[:, None], r_q.shape),
                      r_q, theta, phi], axis=-1)         # (N, k, 4)
    return feats.reshape(len(pts), 4 * k)
