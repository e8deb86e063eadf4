"""The indoor datasets: 7-Scenes (.ply fragments) and ICL-NUIM (the h5 file
DeepGMR ships), a copy of the JAX package's `ogmm_tpu/data/realdata.py`
with the same `np.random` draws, so that both packages give the same items
from the same seed.

A quirk of the original is kept: both emit `tgt_overlap = src_overlap`;
`fix_tgt_overlap=True` gives the target's own labels. `compute_overlap=False`
emits zero labels for a trainer that makes them on the device
(`TrainConfig.device_overlap`); each class's `overlap_thresh` is the radius
of its host labels, which the loader holds `TrainConfig.overlap_thresh` to.
"""
from __future__ import annotations

import copy
import glob
import os
from typing import List

import numpy as np

from ogmm_tpu_torch.data.datautils import (RandomCropPair,
                                           farthest_point_sample, np_mat2quat,
                                           overlap_labels, random_pose)
from ogmm_tpu_torch.data.mesh import plyread


def glob_dataset(root: str, class_to_idx: dict, patterns: List[str]):
    """[(path, class index)] of the files ${root}/${class}/${pattern}, the
    classes in sorted order, each class's files sorted."""
    root = os.path.expanduser(root)
    samples = []
    for target in sorted(os.listdir(root)):
        d = os.path.join(root, target)
        if not os.path.isdir(d):
            continue
        target_idx = class_to_idx.get(target)
        if target_idx is None:
            continue
        for ptn in patterns:
            for path in sorted(glob.glob(os.path.join(d, ptn))):
                samples.append((path, target_idx))
    return samples


def _subsample(src, tgt, n_sub):
    """FPS each cloud to n_sub points unless the crop left exactly that."""
    if src.shape[0] != n_sub:
        src = farthest_point_sample(src, n_sub)
    if tgt.shape[0] != n_sub:
        tgt = farthest_point_sample(tgt, n_sub)
    return src, tgt


def _item(ds, index, src, tgt, tsfm, raw, thresh):
    if ds.compute_overlap:
        src_overlap, tgt_overlap = overlap_labels(src, tgt, tsfm, thresh=thresh)
        if not ds.fix_tgt_overlap:
            tgt_overlap = src_overlap        # the original's quirk
    else:
        src_overlap = np.zeros(src.shape[0])
        tgt_overlap = np.zeros(tgt.shape[0])
    return {
        'src_xyz': src.astype('float32'),
        'tgt_xyz': tgt.astype('float32'),
        'tgt_raw': raw.astype('float32'),
        'src_overlap': src_overlap.astype('float32'),
        'tgt_overlap': tgt_overlap.astype('float32'),
        'transform_gt': tsfm.astype('float32'),
        'pose_gt': np_mat2quat(tsfm.astype('float32')),
        'idx': np.asarray(index, dtype=np.int32),
    }


class Scene7:
    """7-Scenes fragments under <root>/7scene/<scene>/*.ply: office for the
    test split, the other six scenes for training. An item is a fragment
    (its first n_points points) against a copy moved by a random pose (up
    to 45 degrees, 0.5 translation), both cropped to p_keep and sampled to
    partial[0] * n_points points by FPS."""

    overlap_thresh = 0.05          # the radius of the host labels

    def __init__(self, root: str, n_points: int = 50000,
                 partial: List[float] = (0.7, 0.7), partition: str = 'test',
                 fix_tgt_overlap: bool = False,
                 compute_overlap: bool = True):
        if partition == "test":
            classes = ["7-scenes-office"]
        else:
            classes = ["7-scenes-chess", "7-scenes-fire", "7-scenes-heads",
                       "7-scenes-pumpkin", "7-scenes-redkitchen",
                       "7-scenes-stairs"]
        classes.sort()
        class_to_idx = {c: i for i, c in enumerate(classes)}
        rootdir = os.path.join(root, '7scene')
        self.samples = glob_dataset(rootdir, class_to_idx, ['*.ply'])
        if not self.samples:
            raise RuntimeError(f"Empty: rootdir={rootdir}")
        self.partition = partition
        self.rot_factor = 4.0
        self.max_trans = 0.5
        self.crop = RandomCropPair(p_keep=list(partial))
        self.n_points = n_points
        self.partial = list(partial)
        self.fix_tgt_overlap = fix_tgt_overlap
        self.compute_overlap = compute_overlap

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int):
        path, _ = self.samples[index]
        points = np.asarray(plyread(path).vertex_array)[:self.n_points].astype('float32')
        if points.shape[0] > self.n_points:
            src = np.random.permutation(points)[:self.n_points]
            tgt = np.random.permutation(points)[:self.n_points]
        else:
            src = copy.deepcopy(points)
            tgt = copy.deepcopy(points)
        tsfm = random_pose(np.pi / self.rot_factor, self.max_trans)
        tgt = tgt @ tsfm[:3, :3].T + tsfm[:3, 3]
        src, tgt = self.crop(src, tgt)
        src, tgt = _subsample(src, tgt, int(self.partial[0] * self.n_points))
        return _item(self, index, src, tgt, tsfm, points, self.overlap_thresh)


class IclNuim:
    """ICL-NUIM depth scans from <root>/icl_nuim/<partition>/icl_nuim.h5:
    the test split holds source, target and transform, the training split
    pairs each scan of `points` with itself. Every item seeds the global
    np.random with its index; the pair is cropped, sampled by FPS, and the
    target moved by a random pose. Needs h5py, imported here only."""

    overlap_thresh = 0.075         # the radius of the host labels

    def __init__(self, root: str, n_points: int = 50000,
                 partial: List[float] = (0.7, 0.7), partition: str = 'test',
                 fix_tgt_overlap: bool = False,
                 compute_overlap: bool = True):
        import h5py
        d_path = os.path.join(root, 'icl_nuim', partition, 'icl_nuim.h5')
        with h5py.File(d_path, 'r') as f:
            if partition == 'test':
                self.source = f['source'][...]
                self.target = f['target'][...]
                self.transform = f['transform'][...]
            else:
                self.source = f['points'][...]
                self.target = None
                self.transform = None
        self.max_angle = 45.0 / 180 * np.pi
        self.max_trans = 0.5
        self.crop = RandomCropPair(p_keep=list(partial))
        self.n_points = n_points
        self.partial = list(partial)
        self.partition = partition
        self.fix_tgt_overlap = fix_tgt_overlap
        self.compute_overlap = compute_overlap

    def __len__(self):
        return self.source.shape[0]

    def __getitem__(self, index: int):
        np.random.seed(index)
        if self.partition == 'test':
            tsfm0 = self.transform[index]
            src = self.source[index][:self.n_points]
            src = src @ tsfm0[:3, :3].T + tsfm0[:3, 3]
            tgt = self.target[index][:self.n_points]
        else:
            src = np.random.permutation(self.source[index])[:self.n_points]
            tgt = np.random.permutation(
                copy.deepcopy(self.source[index]))[:self.n_points]
        src, tgt = self.crop(src, tgt)
        src, tgt = _subsample(src, tgt, int(self.partial[0] * self.n_points))
        tsfm = random_pose(self.max_angle, self.max_trans)
        tgt = tgt @ tsfm[:3, :3].T + tsfm[:3, 3]
        return _item(self, index, src, tgt, tsfm, self.source[index],
                     self.overlap_thresh)
