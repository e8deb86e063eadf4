"""The ModelNet40 source of the port: the h5 clouds or a synthetic stand-in,
the unseen-category split, and the train/test augmentation chains.

A copy of what the JAX package's `ogmm_tpu/data/modelnet.py` gives the
`modelnet` and `synthetic` datasets (`get_transforms`, `synthetic_clouds`,
`SyntheticPointClouds`, `ModelNetHdf`), with the same draws from the global
`np.random`, so that both packages give the same samples from the same seed.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ogmm_tpu_torch.data import transforms as T
from ogmm_tpu_torch.data.datautils import load_modelnet_h5, np_mat2quat


def get_transforms(noise_type: str, rot_mag: float = 45.0,
                   trans_mag: float = 0.5, num_points: int = 1024,
                   partial_p_keep: Optional[List[float]] = None):
    """(train, test) transform chains of a noise regime: clean, jitter or
    crop (the crop resamples after the rigid perturbation). The test chain
    is the train chain seeded per sample from its index."""
    partial_p_keep = partial_p_keep if partial_p_keep is not None else [0.7, 0.7]

    def chain():
        se3 = T.RandomTransformSE3_euler(rot_mag=rot_mag, trans_mag=trans_mag)
        if noise_type == "clean":
            return [T.Resampler(num_points), T.SplitSourceRef(), se3,
                    T.ShufflePoints()]
        if noise_type == "jitter":
            return [T.Resampler(num_points), T.SplitSourceRef(), se3,
                    T.RandomJitter(), T.ShufflePoints()]
        if noise_type == "crop":
            return [T.SplitSourceRef(), T.RandomCrop(partial_p_keep), se3,
                    T.Resampler(num_points), T.RandomJitter(), T.ShufflePoints()]
        raise NotImplementedError(noise_type)

    return T.Compose(chain()), T.Compose([T.SetDeterministic()] + chain())


def synthetic_clouds(n_shapes: int, n_raw: int = 2048, seed: int = 0):
    """Structured random shapes standing in for ModelNet40 meshes: gaussian
    blob mixtures, box surfaces and cylinders in turn, centred and scaled
    into the unit cube, with pseudo-normals. Returns (data (S, n_raw, 6)
    float32, labels (S, 1) int64)."""
    rng = np.random.RandomState(seed)
    data = np.zeros((n_shapes, n_raw, 6), dtype=np.float32)
    labels = (np.arange(n_shapes) % 40).astype(np.int64)[:, None]
    for s in range(n_shapes):
        kind = s % 3
        if kind == 0:
            centers = rng.randn(4, 3) * 0.5
            pts = np.concatenate([
                c + 0.25 * rng.randn(n_raw // 4, 3) for c in centers], 0)
        elif kind == 1:
            face = rng.randint(0, 6, n_raw)
            pts = rng.uniform(-1, 1, (n_raw, 3))
            pts[np.arange(n_raw), face % 3] = np.where(face < 3, 1.0, -1.0)
        else:
            theta = rng.uniform(0, 2 * np.pi, n_raw)
            z = rng.uniform(-1, 1, n_raw)
            pts = np.stack([np.cos(theta), np.sin(theta), z], -1)
        pts = pts[:n_raw]
        pts = pts - pts.mean(0)
        pts = pts / np.abs(pts).max()
        normals = pts / np.maximum(np.linalg.norm(pts, axis=1, keepdims=True), 1e-6)
        data[s, :, :3] = pts
        data[s, :, 3:] = normals
    return data, labels


class SyntheticPointClouds:
    """In-memory (data, label) source with the ModelNetHdf array contract."""

    def __init__(self, n_shapes: int = 64, n_raw: int = 2048, seed: int = 0):
        self.data, self.label = synthetic_clouds(n_shapes, n_raw, seed)


def _load_source(root: str, partition: str):
    """The h5 files under `root`, or synthetic shapes when root is
    'synthetic[:S]' (S shapes, default 64; seed 0 train, 1 test)."""
    if root.startswith("synthetic"):
        n_shapes = int(root.split(":")[1]) if ":" in root else 64
        src = SyntheticPointClouds(n_shapes=n_shapes,
                                   seed=0 if partition == "train" else 1)
        return src.data, src.label
    return load_modelnet_h5(partition, root)


class ModelNetHdf:
    """ModelNet40 clouds with the unseen split: the test partition of an
    unseen run keeps labels >= 20, every other combination labels < 20. An
    item takes a random 1024-point permutation of the cloud through
    `transform` and returns the loader's dict of float32 arrays."""

    def __init__(self, root: str, unseen: bool = False, transform=None,
                 partition: str = 'train'):
        data, label = _load_source(root, partition)
        label = label.squeeze()
        keep = (label >= 20) if (unseen and partition == 'test') else (label < 20)
        self.data = data[keep]
        self.label = label[keep]
        self._transform = transform

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item: int):
        points = np.random.permutation(self.data[item, :, :])[:1024]
        sample = {'points': points, 'label': self.label[item],
                  'idx': np.array(item, dtype=np.int32)}
        if self._transform:
            sample = self._transform(sample)
        return {
            'src_xyz': sample['points_src'][:, :3].astype('float32'),
            'tgt_xyz': sample['points_ref'][:, :3].astype('float32'),
            'tgt_raw': sample['points_raw'][:, :3].astype('float32'),
            'src_overlap': np.asarray(sample['src_overlap']).astype('float32'),
            'tgt_overlap': np.asarray(sample['ref_overlap']).astype('float32'),
            'transform_gt': sample['transform_gt'].astype('float32'),
            'pose_gt': np_mat2quat(sample['transform_gt'].astype('float32')),
            'idx': np.asarray(item, dtype=np.int32),
        }
