"""The ModelNet40 source of the port: the h5 clouds or a synthetic stand-in,
the unseen-category split, the train/test augmentation chains, and the
three variants of the original's other protocols:

  ModelNetCP   a crop pair with KD-tree overlap labels (`modelnetcp`)
  ModelNetDV   density variation: src FPS'd to 768 points against a tgt of
               1536 (`modelnetdv`, DeepGMR's geometry)
  ModelNetGMR  DeepGMR's protocol: a 55% crop pair with RRI features

A copy of the JAX package's `ogmm_tpu/data/modelnet.py`, with the same
draws from the global `np.random`, so that both packages give the same
samples from the same seed. The variants' test split reseeds np.random per
item after its permutations.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ogmm_tpu_torch.data import transforms as T
from ogmm_tpu_torch.data.datautils import (RandomCropPair,
                                           farthest_point_sample, get_rri,
                                           jitter_pcd, load_modelnet_h5,
                                           np_mat2quat, overlap_labels,
                                           random_pose)


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


def _split(root: str, partition: str, unseen: bool):
    """(data, labels) of a partition: the test partition of an unseen run
    keeps labels >= 20, every other combination labels < 20."""
    data, label = _load_source(root, partition)
    label = label.squeeze()
    keep = (label >= 20) if (unseen and partition == 'test') else (label < 20)
    return data[keep], label[keep]


def _pose_pair(src, tgt, tsfm, partition, max_trans):
    """The variants' rigid motion: in training both clouds move by a random
    pose (any angle, translation below max_trans), tgt then by tsfm; at
    test only tgt moves, by tsfm."""
    if partition == 'train':
        pose1 = random_pose(np.pi, max_trans)
        pose2 = tsfm @ pose1
        return (src @ pose1[:3, :3].T + pose1[:3, 3],
                tgt @ pose2[:3, :3].T + pose2[:3, 3])
    return src, tgt @ tsfm[:3, :3].T + tsfm[:3, 3]


class ModelNetHdf:
    """ModelNet40 clouds with the unseen split (`_split`). An item takes a
    random 1024-point permutation of the cloud through `transform` and
    returns the loader's dict of float32 arrays."""

    def __init__(self, root: str, unseen: bool = False, transform=None,
                 partition: str = 'train'):
        self.data, self.label = _split(root, partition, unseen)
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


class ModelNetCP:
    """Crop-pair variant with KD-tree overlap labels: src and tgt are two
    permutations of n_points of a cloud, src cropped to partial[0] of its
    points (tgt too, given a second proportion), tgt moved by a random pose
    whose angle is below rot_mag read as radians (the original's reading:
    45 allows any rotation), both jittered unless noise_type is 'clean'. A
    dict item."""

    def __init__(self, root: str, n_points: int, rot_mag: float = 45.0,
                 trans_mag: float = 0.5, unseen: bool = True,
                 partial: List[float] = (0.7,), noise_type: str = 'crop',
                 partition: str = 'train'):
        self.data, self.label = _split(root, partition, unseen)
        self.num_points = n_points
        self.partition = partition
        self.max_angle = rot_mag
        self.max_trans = trans_mag
        self.crop = RandomCropPair(p_keep=list(partial)[:1])
        self.noisy = noise_type

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item: int):
        points = self.data[item]
        src = np.random.permutation(points[:, :3])[:self.num_points]
        tgt = np.random.permutation(points[:, :3])[:self.num_points]
        if self.partition != 'train':
            np.random.seed(item)
        src, tgt = self.crop(src, tgt)
        tsfm = random_pose(self.max_angle, self.max_trans / 2)
        src, tgt = _pose_pair(src, tgt, tsfm, self.partition, self.max_trans)
        if self.noisy != 'clean':
            src = jitter_pcd(src)
            tgt = jitter_pcd(tgt)
        src_label, tgt_label = overlap_labels(src, tgt, tsfm)
        return {
            'src_xyz': src[:, :3].astype('float32'),
            'tgt_xyz': tgt[:, :3].astype('float32'),
            'tgt_raw': points[:, :3].astype('float32'),
            'src_overlap': src_label.astype('float32'),
            'tgt_overlap': tgt_label.astype('float32'),
            'transform_gt': tsfm.astype('float32'),
            'pose_gt': np_mat2quat(tsfm.astype('float32')),
            'idx': np.asarray(item, dtype=np.int32),
        }


class ModelNetDV:
    """Density-variation variant: a pair of permutations of num_points,
    each cropped to 0.75, src FPS'd to num_subsampled_points (768) while
    tgt keeps its 1536; tgt moved by a random pose within pi / rot_factor.
    A list item [src, tgt, tsfm (4, 4)]."""

    def __init__(self, root: str, num_points: int = 2048,
                 num_subsampled_points: int = 768, partition: str = 'train',
                 gaussian_noise: bool = False, unseen: bool = False,
                 rot_factor: float = 4.0):
        self.data, self.label = _split(root, partition, unseen)
        self.num_points = num_points
        self.num_subsampled_points = num_subsampled_points
        self.partition = partition
        self.max_angle = np.pi / rot_factor
        self.max_trans = 0.5
        self.noisy = gaussian_noise
        self.subsampled = num_points != num_subsampled_points
        self.crop = RandomCropPair(p_keep=[0.75, 0.75])

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, item: int):
        points = self.data[item][:self.num_points]
        src = np.random.permutation(points[:, :3])[:self.num_points]
        tgt = np.random.permutation(points[:, :3])[:self.num_points]
        if self.partition != 'train':
            np.random.seed(item)
        if self.subsampled:
            src, tgt = self.crop(src, tgt)
            if self.num_subsampled_points < src.shape[0]:
                src = farthest_point_sample(src, self.num_subsampled_points)
            if self.num_subsampled_points < tgt.shape[0] // 2:
                tgt = farthest_point_sample(tgt,
                                            2 * self.num_subsampled_points)
        tsfm = random_pose(self.max_angle, self.max_trans / 2)
        src, tgt = _pose_pair(src, tgt, tsfm, self.partition, self.max_trans)
        if self.noisy:
            src = jitter_pcd(src)
            tgt = jitter_pcd(tgt)
        return [src.astype('float32'), tgt.astype('float32'),
                tsfm.astype('float32')]


class ModelNetGMR:
    """DeepGMR's protocol: a pair of permutations of num_points, each
    cropped to 0.55 and FPS'd to num_subsampled_points, tgt moved by a
    random pose within pi / rot_factor, each cloud followed by its RRI
    features over k neighbours of its centred points. A tuple item (src
    (N, 3 + 4k), tgt (N, 3 + 4k), tsfm (4, 4))."""

    def __init__(self, root: str, num_points: int,
                 num_subsampled_points: int = 768, partition: str = 'train',
                 gaussian_noise: bool = False, unseen: bool = False,
                 rot_factor: float = 4.0, k: int = 20):
        self.data, self.label = _split(root, partition, unseen)
        self.num_subsampled_points = num_subsampled_points
        self.partition = partition
        self.n_points = num_points
        self.subsampled = num_points != num_subsampled_points
        self.crop = RandomCropPair(p_keep=[0.55, 0.55])
        self.max_angle = np.pi / rot_factor
        self.max_trans = 0.5
        self.noisy = gaussian_noise
        self.k = k

    def __len__(self):
        return self.data.shape[0]

    def __getitem__(self, index: int):
        if self.partition != 'train':
            np.random.seed(index)
        points = self.data[index]
        src = np.random.permutation(points[:, :3])[:self.n_points]
        tgt = np.random.permutation(points[:, :3])[:self.n_points]
        if self.subsampled:
            src, tgt = self.crop(src, tgt)
            if self.num_subsampled_points < src.shape[0]:
                src = farthest_point_sample(src, self.num_subsampled_points)
                tgt = farthest_point_sample(tgt, self.num_subsampled_points)
        tsfm = random_pose(self.max_angle, self.max_trans / 2)
        src, tgt = _pose_pair(src, tgt, tsfm, self.partition, self.max_trans)
        if self.noisy:
            src = jitter_pcd(src)
            tgt = jitter_pcd(tgt)
        src = np.concatenate([src, get_rri(src - src.mean(0), self.k)], axis=1)
        tgt = np.concatenate([tgt, get_rri(tgt - tgt.mean(0), self.k)], axis=1)
        return (src.astype('float32'), tgt.astype('float32'),
                tsfm.astype('float32'))
