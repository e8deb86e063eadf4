"""Host-side numpy helpers of the ModelNet pipeline: SE(3) on arrays, a
random direction, the pose quaternion of a sample, and the ModelNet40 HDF5
reader.

A copy of the parts of the JAX package's `ogmm_tpu/data/datautils.py` that
the `modelnet`/`synthetic` route uses, with the same global-`np.random`
draws, so that both packages give the same samples from the same seed.
"""
from __future__ import annotations

import glob
import os

import numpy as np


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


def uniform2sphere():
    """A uniform direction on the unit sphere, from the global np.random."""
    phi = np.random.uniform(0.0, 2 * np.pi)
    theta = np.arccos(np.random.uniform(-1.0, 1.0))
    return np.stack([np.sin(theta) * np.cos(phi),
                     np.sin(theta) * np.sin(phi),
                     np.cos(theta)], axis=-1)


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
