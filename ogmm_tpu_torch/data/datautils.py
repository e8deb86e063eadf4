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
seed; and its public helpers beside them: the 4x4 and 3x4 pose helpers
(`to_tsfm`, `identity`, `inverse`, `from_xyzquat`), the ground-truth
correspondences (`get_inner_labels`, `mutual_selection`), the 3DMatch
trajectory files (`read_trajectory`, `write_trajectory`) and the file
helpers (`read_txt`, `ensure_dir`, `sorted_alphanum`, `get_file_list`,
`get_file_list_specific`, `get_folder_list`).
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


def to_tsfm(rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """The 4x4 pose of rot (3, 3) and trans (3 values, any shape)."""
    tsfm = np.eye(4)
    tsfm[:3, :3] = rot
    tsfm[:3, 3] = trans.flatten()
    return tsfm


def identity() -> np.ndarray:
    """The (3, 4) identity pose."""
    return np.eye(3, 4)


def inverse(rot: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """The inverse of the pose (rot ([B,] 3, 3), trans ([B,] 3)) as a
    ([B,] 3, 4) matrix [R^T | -R^T t]."""
    irot = np.swapaxes(rot, -1, -2)
    return np.concatenate([irot, irot @ -trans[..., None]], axis=-1)


def from_xyzquat(xyzquat: np.ndarray) -> np.ndarray:
    """The 4x4 pose of [x, y, z, qx, qy, qz, qw], with the trajectory files'
    convention: the translation is the rotated negative offset, R (-xyz)."""
    from scipy.spatial.transform import Rotation
    xyzquat = np.asarray(xyzquat, dtype=np.float64)
    rot = Rotation.from_quat(xyzquat[3:])
    trans = rot.apply(-xyzquat[:3])
    tsfm = np.concatenate([rot.as_matrix(), trans[:, None]], axis=1)
    return np.concatenate([tsfm, [[0.0, 0.0, 0.0, 1.0]]], axis=0)


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


def get_inner_labels(src: np.ndarray, tgt: np.ndarray, transf: np.ndarray,
                     thresh: float = 0.05, label_type: int = 3):
    """Ground-truth correspondence matrix and inlier flags of src (N, 3+)
    moved by `transf` against tgt (M, 3+), by the 1-NN both ways:
      1  mutual nearest pairs within thresh;
      2  every nearest pair within thresh, from both sides;
      3  the mutual pairs, then a greedy one-to-one fill of the rows still
         free in row order (a row takes its nearest column if that is free)
         and of the columns still free in column order, then a second
         mutual pass among the rows and columns left, at 2 thresh. The fill
         order decides which of two rows claiming one column wins.
    Returns (perm_mat (N, M), inlier_src (N, 1), inlier_tgt (M, 1)),
    float64."""
    n, m = src.shape[0], tgt.shape[0]
    perm = np.zeros((n, m))
    src_t = transform(transf, src[:, :3])
    tgt_p = tgt[:, :3]
    d_se, i_se = nearest_neighbor(src_t, tgt_p)     # src -> tgt
    d_te, i_te = nearest_neighbor(tgt_p, src_t)     # tgt -> src
    mutual = (i_te[i_se] == np.arange(n)) & (d_se < thresh)

    if label_type == 1:
        perm[np.flatnonzero(mutual), i_se[mutual]] = 1
    elif label_type == 2:
        row_ok = d_se < thresh
        perm[np.flatnonzero(row_ok), i_se[row_ok]] = 1
        col_ok = d_te < thresh
        perm[i_te[col_ok], np.flatnonzero(col_ok)] = 1
    elif label_type == 3:
        perm[np.flatnonzero(mutual), i_se[mutual]] = 1
        row_used = perm.sum(axis=1) > 0
        col_used = perm.sum(axis=0) > 0
        for r in np.flatnonzero(~row_used & (d_se < thresh)):
            c = i_se[r]
            if not col_used[c]:
                perm[r, c] = 1
                row_used[r] = col_used[c] = True
        for c in np.flatnonzero(~col_used & (d_te < thresh)):
            r = i_te[c]
            if not row_used[r]:
                perm[r, c] = 1
                row_used[r] = col_used[c] = True
        out_r = np.flatnonzero(~row_used)
        out_c = np.flatnonzero(~col_used)
        if out_r.size and out_c.size:
            d_se2, i_se2 = nearest_neighbor(src_t[out_r], tgt_p[out_c])
            _, i_te2 = nearest_neighbor(tgt_p[out_c], src_t[out_r])
            mut2 = (i_te2[i_se2] == np.arange(out_r.size)) & (d_se2 < 2 * thresh)
            perm[out_r[mut2], out_c[i_se2[mut2]]] = 1
    else:
        raise ValueError(f"label_type must be 1/2/3, got {label_type}")

    inlier_src = (perm.sum(axis=1, keepdims=True) > 0).astype(np.float64)
    inlier_tgt = (perm.sum(axis=0, keepdims=True).T > 0).astype(np.float64)
    return perm, inlier_src, inlier_tgt


def mutual_selection(score_mat: np.ndarray) -> np.ndarray:
    """Boolean mask of the entries that are the argmax of both their row and
    their column, (B, N, M) -> (B, N, M); a 2-D input gains a batch axis."""
    score_mat = np.asarray(score_mat)
    if score_mat.ndim == 2:
        score_mat = score_mat[None]
    rows = np.zeros_like(score_mat, dtype=bool)
    cols = np.zeros_like(score_mat, dtype=bool)
    np.put_along_axis(rows, score_mat.argmax(axis=2)[..., None], True, axis=2)
    np.put_along_axis(cols, score_mat.argmax(axis=1)[:, None, :], True, axis=1)
    return rows & cols


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


# ------------------------------------------------------------------- files

def read_txt(path: str):
    """The lines of a text file, stripped."""
    with open(path) as f:
        return [x.strip() for x in f.readlines()]


def ensure_dir(path: str) -> None:
    os.makedirs(path, mode=0o755, exist_ok=True)


def sorted_alphanum(file_list):
    """Sorted with digit runs compared as numbers: frame-2 < frame-10."""
    import re

    def alphanum_key(key):
        return [int(c) if c.isdigit() else c
                for c in re.split(r'([0-9]+)', key)]

    return sorted(file_list, key=alphanum_key)


def get_file_list(path: str, extension: str | None = None):
    """The files of a directory (with `extension`, if given), their paths
    sorted by `sorted_alphanum`."""
    names = [f for f in os.listdir(path)
             if os.path.isfile(os.path.join(path, f))]
    if extension is not None:
        names = [f for f in names if os.path.splitext(f)[1] == extension]
    return sorted_alphanum([os.path.join(path, f) for f in names])


def get_file_list_specific(path: str, color_depth: str,
                           extension: str | None = None):
    """The files whose name holds `color_depth` and ends in `extension`,
    sorted; with extension=None every file, unsorted and unfiltered (the
    original's behaviour, kept)."""
    names = [f for f in os.listdir(path)
             if os.path.isfile(os.path.join(path, f))]
    if extension is None:
        return [os.path.join(path, f) for f in names]
    names = [f for f in names
             if color_depth in f and os.path.splitext(f)[1] == extension]
    return sorted_alphanum([os.path.join(path, f) for f in names])


def get_folder_list(path: str):
    """The subdirectories of a directory, sorted by `sorted_alphanum`."""
    return sorted_alphanum([os.path.join(path, f) for f in os.listdir(path)
                            if os.path.isdir(os.path.join(path, f))])


def read_trajectory(filename: str, dim: int = 4):
    """A 3DMatch / Redwood trajectory (`.log`) file: [(metadata ints,
    (dim, dim) pose)], one per record."""
    traj = []
    with open(filename, 'r') as f:
        metastr = f.readline()
        while metastr:
            metadata = list(map(int, metastr.split()))
            mat = np.zeros((dim, dim))
            for i in range(dim):
                mat[i, :] = np.fromstring(f.readline(), dtype=float, sep=' \t')
            traj.append((metadata, mat))
            metastr = f.readline()
    return traj


def write_trajectory(traj: np.ndarray, metadata: np.ndarray, filename: str,
                     dim: int = 4):
    """Write the records of traj (T, dim, dim) whose metadata row (T, 3)
    has a non-zero third entry, in the format `read_trajectory` reads."""
    with open(filename, 'w') as f:
        for idx in range(traj.shape[0]):
            if metadata[idx][2]:
                p = traj[idx].tolist()
                f.write('\t'.join(map(str, metadata[idx])) + '\n')
                f.write('\n'.join(
                    '\t'.join(map('{0:.12f}'.format, p[i])) for i in range(dim)))
                f.write('\n')
