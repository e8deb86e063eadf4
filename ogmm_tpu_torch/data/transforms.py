"""The sample-dict augmentations of the ModelNet pipeline.

A copy of the chain the JAX package's `ogmm_tpu/data/transforms.py` builds
for `get_transforms`: each transform takes and returns a sample dict. The
'crop' chain is SplitSourceRef -> RandomCrop -> RandomTransformSE3_euler ->
Resampler -> RandomJitter -> ShufflePoints. Every draw comes from the global
`np.random` in the same order as there, and for the test split
`SetDeterministic` makes each transform seed it from the sample's index, so
that the port and the JAX package give the same samples bit for bit.
`RandomTransformSE3` (the axis-angle perturbation the Euler variant
derives from) and `FixedResampler` (tile to k points, no draws) are the JAX
package's other public transforms.

Kept on purpose, as there:
  * Resampler takes 717 points per cloud when the crop has two proportions.
  * RandomCrop crops both clouds with the first proportion.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ogmm_tpu_torch.data.datautils import (se3_inv, se3_transform,
                                           so3_transform, uniform2sphere)

PREDATOR_N = 717


class SetDeterministic:
    """Flag the sample so that later transforms seed from sample['idx']."""

    def __call__(self, sample: Dict) -> Dict:
        sample['deterministic'] = True
        return sample


class SplitSourceRef:
    """Clone 'points' into points_src / points_ref with identity
    correspondences."""

    def __call__(self, sample: Dict) -> Dict:
        sample['points_raw'] = sample.pop('points')
        sample['points_src'] = sample['points_raw'].copy()
        sample['points_ref'] = sample['points_raw'].copy()
        n = sample['points_raw'].shape[0]
        sample['correspondences'] = np.tile(np.arange(n), (2, 1))
        return sample


class RandomTransformSE3:
    """Random rigid perturbation of the source by axis-angle sampling: a
    rotation drawn uniformly from SO(3) (scipy's `special_ortho_group`) with
    its angle scaled by rot_mag / 180, a translation U[-trans_mag,
    trans_mag]; with `random_mag` both magnitudes scaled by one U[0, 1)
    draw first. Every draw comes from the global `np.random` RandomState
    (seeded per sample under `SetDeterministic`). `transform_gt` maps the
    perturbed source onto the reference."""

    def __init__(self, rot_mag: float = 180.0, trans_mag: float = 1.0,
                 random_mag: bool = False):
        self._rot_mag = rot_mag
        self._trans_mag = trans_mag
        self._random_mag = random_mag

    def _magnitudes(self):
        if self._random_mag:
            att = np.random.random()
            return att * self._rot_mag, att * self._trans_mag
        return self._rot_mag, self._trans_mag

    def generate_transform(self) -> np.ndarray:
        from scipy.spatial.transform import Rotation
        from scipy.stats import special_ortho_group
        rot_mag, trans_mag = self._magnitudes()
        rand_rot = special_ortho_group.rvs(3)
        axis_angle = Rotation.as_rotvec(Rotation.from_matrix(rand_rot))
        axis_angle *= rot_mag / 180.0
        rand_rot = Rotation.from_rotvec(axis_angle).as_matrix()
        rand_trans = np.random.uniform(-trans_mag, trans_mag, 3)
        return np.concatenate((rand_rot, rand_trans[:, None]),
                              axis=1).astype(np.float32)

    @staticmethod
    def apply_transform(p0: np.ndarray, mat: np.ndarray):
        p1 = se3_transform(mat, p0[:, :3])
        if p0.shape[1] == 6:
            p1 = np.concatenate((p1, so3_transform(mat[:3, :3], p0[:, 3:6])),
                                axis=-1)
        return p1, se3_inv(mat), mat

    def __call__(self, sample: Dict) -> Dict:
        if sample.get('deterministic'):
            np.random.seed(sample['idx'])
        mat = self.generate_transform()
        if 'points' in sample:
            sample['points'], _, _ = self.apply_transform(sample['points'], mat)
        else:
            src_t, gt, _ = self.apply_transform(sample['points_src'], mat)
            sample['transform_gt'] = gt
            sample['points_src'] = src_t
        return sample


class RandomTransformSE3_euler(RandomTransformSE3):
    """The Euler-angle variant: angles U[0, pi mag / 180] about x, y and z,
    R = Rx Ry Rz, translation U[-trans_mag, trans_mag] (after the
    `random_mag` draw, where asked)."""

    def generate_transform(self) -> np.ndarray:
        rot_mag, trans_mag = self._magnitudes()
        ax = np.random.uniform() * np.pi * rot_mag / 180.0
        ay = np.random.uniform() * np.pi * rot_mag / 180.0
        az = np.random.uniform() * np.pi * rot_mag / 180.0
        cx, cy, cz = np.cos(ax), np.cos(ay), np.cos(az)
        sx, sy, sz = np.sin(ax), np.sin(ay), np.sin(az)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        t_ab = np.random.uniform(-trans_mag, trans_mag, 3)
        return np.concatenate((Rx @ Ry @ Rz, t_ab[:, None]),
                              axis=1).astype(np.float32)


class Resampler:
    """Resample each cloud to exactly `num` points (717 each with a
    two-proportion crop), remapping the correspondences and overlaps."""

    def __init__(self, num: int = 1024):
        self.num = num

    @staticmethod
    def _resample(points: np.ndarray, k: int):
        n = points.shape[0]
        if k <= n:
            idx = np.random.choice(n, k, replace=False)
        else:
            idx = np.concatenate([np.random.choice(n, n, replace=False),
                                  np.random.choice(n, k - n, replace=True)])
        return points[idx, :], idx

    def __call__(self, sample: Dict) -> Dict:
        if sample.get('deterministic'):
            np.random.seed(sample['idx'])
        if 'points' in sample:
            sample['points'], _ = self._resample(sample['points'], self.num)
            return sample

        if 'crop_proportion' not in sample:
            src_size, ref_size = self.num, self.num
        elif len(sample['crop_proportion']) == 1:
            src_size = math.ceil(sample['crop_proportion'][0] * self.num)
            ref_size = self.num
        elif len(sample['crop_proportion']) == 2:
            src_size = ref_size = PREDATOR_N
        else:
            raise ValueError('Crop proportion must have 1 or 2 elements')

        points_src, src_idx = self._resample(sample['points_src'], src_size)
        points_ref, ref_idx = self._resample(sample['points_ref'], ref_size)
        src_map = np.full(sample['points_src'].shape[0], -1)
        ref_map = np.full(sample['points_ref'].shape[0], -1)
        src_map[src_idx] = np.arange(src_size)
        ref_map[ref_idx] = np.arange(ref_size)
        corr = np.stack([src_map[sample['correspondences'][0]],
                         ref_map[sample['correspondences'][1]]])
        sample['correspondences'] = corr[:, np.all(corr >= 0, axis=0)]
        sample['points_src'] = points_src
        sample['points_ref'] = points_ref
        sample['src_overlap'] = sample['src_overlap'][src_idx]
        sample['ref_overlap'] = sample['ref_overlap'][ref_idx]
        return sample


class FixedResampler(Resampler):
    """Deterministic resampling to k points: the cloud tiled k // n times,
    then its first k % n points (no draws, no indices)."""

    @staticmethod
    def _resample(points: np.ndarray, k: int):
        multiple, remainder = k // points.shape[0], k % points.shape[0]
        resampled = np.concatenate(
            (np.tile(points, (multiple, 1)), points[:remainder, :]), axis=0)
        return resampled, None


class RandomJitter:
    """Gaussian noise on xyz, sigma 0.01 clipped at 0.05."""

    def __init__(self, scale: float = 0.01, clip: float = 0.05):
        self.scale = scale
        self.clip = clip

    def _jitter(self, pts: np.ndarray) -> np.ndarray:
        noise = np.clip(
            np.random.normal(0.0, self.scale, size=(pts.shape[0], 3)),
            -self.clip, self.clip)
        pts = pts.copy()
        pts[:, :3] += noise
        return pts

    def __call__(self, sample: Dict) -> Dict:
        sample['points_src'] = self._jitter(sample['points_src'])
        sample['points_ref'] = self._jitter(sample['points_ref'])
        return sample


class RandomCrop:
    """Half-space crop of both clouds keeping the fraction p_keep[0], with
    the overlap masks and correspondences that follow from it."""

    def __init__(self, p_keep: List[float] | None = None):
        self.p_keep = np.array([0.7, 0.7] if p_keep is None else p_keep,
                               dtype=np.float32)

    @staticmethod
    def crop(points: np.ndarray, p_keep: float):
        rand_xyz = uniform2sphere()
        centered = points[:, :3] - points[:, :3].mean(axis=0)
        dist = centered @ rand_xyz
        if p_keep == 0.5:
            mask = dist > 0
        else:
            mask = dist > np.percentile(dist, (1.0 - p_keep) * 100)
        return points[mask, :], mask

    def __call__(self, sample: Dict) -> Dict:
        sample['crop_proportion'] = self.p_keep
        if np.all(self.p_keep == 1.0):
            return sample
        if sample.get('deterministic'):
            np.random.seed(sample['idx'])

        points_src, src_mask = self.crop(sample['points_src'],
                                         float(self.p_keep[0]))
        if len(self.p_keep) == 1:
            points_ref = sample['points_ref']
            ref_mask = np.ones(points_ref.shape[0], dtype=bool)
        else:
            points_ref, ref_mask = self.crop(sample['points_ref'],
                                             float(self.p_keep[0]))

        corr = sample['correspondences']
        src_overlap = np.zeros(sample['points_src'].shape[0], dtype=bool)
        src_overlap[corr[0][ref_mask[corr[1]]]] = 1
        src_overlap = src_overlap[src_mask]
        ref_overlap = np.zeros(sample['points_ref'].shape[0], dtype=bool)
        ref_overlap[corr[1][src_mask[corr[0]]]] = 1
        ref_overlap = ref_overlap[ref_mask]

        src_map = np.full(sample['points_src'].shape[0], -1)
        src_map[src_mask] = np.arange(src_mask.sum())
        ref_map = np.full(sample['points_ref'].shape[0], -1)
        ref_map[ref_mask] = np.arange(ref_mask.sum())
        corr = np.stack([src_map[corr[0]], ref_map[corr[1]]])
        sample['correspondences'] = corr[:, np.all(corr >= 0, axis=0)]
        sample['points_src'] = points_src
        sample['points_ref'] = points_ref
        sample['src_overlap'] = src_overlap
        sample['ref_overlap'] = ref_overlap
        return sample


class ShufflePoints:
    """Random permutation of both clouds, remapping the correspondences and
    overlaps (scalar 0.0 overlaps where the sample has none)."""

    def __call__(self, sample: Dict) -> Dict:
        ref_perm = np.random.permutation(sample['points_ref'].shape[0])
        src_perm = np.random.permutation(sample['points_src'].shape[0])
        sample['points_ref'] = sample['points_ref'][ref_perm, :]
        sample['points_src'] = sample['points_src'][src_perm, :]
        try:
            sample['ref_overlap'] = sample['ref_overlap'][ref_perm]
            sample['src_overlap'] = sample['src_overlap'][src_perm]
        except (KeyError, IndexError):
            sample['ref_overlap'] = np.array(0.0)
            sample['src_overlap'] = np.array(0.0)
        ref_map = np.full(sample['points_ref'].shape[0], -1)
        ref_map[ref_perm] = np.arange(sample['points_ref'].shape[0])
        src_map = np.full(sample['points_src'].shape[0], -1)
        src_map[src_perm] = np.arange(sample['points_src'].shape[0])
        sample['correspondences'] = np.stack([
            src_map[sample['correspondences'][0]],
            ref_map[sample['correspondences'][1]]])
        return sample


class Compose:
    """Apply transforms in order."""

    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample):
        for t in self.transforms:
            sample = t(sample)
        return sample
