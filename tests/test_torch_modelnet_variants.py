"""The port's ModelNet variants (`ModelNetCP`, `ModelNetDV`, `ModelNetGMR`),
their host helpers (`jitter_pcd`, `knn_idx`, `get_rri`), `ListAsDict` and
the `modelnetcp` / `modelnetdv` loaders against the JAX package's
`ogmm_tpu/data` on the synthetic source. Both draw from the global
`np.random`: each comparison seeds it the same before each side, and the
loaders run with one worker (their test split serialises its items anyway).
Items are compared bit for bit: both sides run the same numpy calls and
the same host library."""
import dataclasses

import numpy as np
import pytest

from ogmm_tpu import configs as jconfigs
from ogmm_tpu.data import datautils as jdu
from ogmm_tpu.data import loader as jloader
from ogmm_tpu.data import modelnet as jmn
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch.data import datautils as tdu
from ogmm_tpu_torch.data import loader as tloader
from ogmm_tpu_torch.data import modelnet as tmn

ROOT = "synthetic:24"
VARIANTS = {
    "ModelNetCP": dict(n_points=64),
    "ModelNetDV": dict(),                               # 2048 -> 768 / 1536
    "ModelNetGMR": dict(num_points=256, num_subsampled_points=64, k=8),
}


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("partition", ["train", "test"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_items_match_jax(name, partition):
    kw = dict(VARIANTS[name], partition=partition, unseen=True)
    jds = getattr(jmn, name)(ROOT, **kw)
    tds = getattr(tmn, name)(ROOT, **kw)
    assert len(tds) == len(jds) == (20 if partition == "train" else 4)
    np.testing.assert_array_equal(tds.label, jds.label)
    for item in range(3):
        np.random.seed(10 + item)
        want = jds[item]
        np.random.seed(10 + item)
        got = tds[item]
        _same(got, want)


def test_density_variation_geometry():
    """modelnetdv's geometry: a src of 768 points against a tgt of 1536,
    the 4x4 transform, tgt = src's cloud moved by it at test."""
    src, tgt, tsfm = tmn.ModelNetDV(ROOT, partition="test", unseen=True)[0]
    assert src.shape == (768, 3) and tgt.shape == (1536, 3)
    assert tsfm.shape == (4, 4)
    np.testing.assert_allclose(tsfm[:3, :3] @ tsfm[:3, :3].T, np.eye(3),
                               atol=1e-5)
    item = tloader.ListAsDict(tmn.ModelNetDV(ROOT, partition="test",
                                             unseen=True))[0]
    assert item["transform_gt"].shape == (3, 4)
    np.testing.assert_array_equal(item["src_overlap"], np.ones(768, np.float32))
    np.testing.assert_array_equal(item["tgt_overlap"], np.ones(1536, np.float32))
    # the test split reseeds per item: the same item twice is the same
    again = tloader.ListAsDict(tmn.ModelNetDV(ROOT, partition="test",
                                              unseen=True))[0]
    _same(item, again)


def test_crop_pair_labels():
    """ModelNetCP crops src only (one proportion): N != M, and its overlap
    labels are 0/1 of each cloud's length."""
    item = tmn.ModelNetCP(ROOT, n_points=64, partition="test")[1]
    assert item["src_xyz"].shape == (45, 3) and item["tgt_xyz"].shape == (64, 3)
    assert item["src_overlap"].shape == (45,) and item["tgt_overlap"].shape == (64,)
    assert set(np.unique(item["src_overlap"])) <= {0.0, 1.0}


@pytest.mark.parametrize("k", [4, 20])
def test_rri_features_match_jax(k):
    pts = (np.random.RandomState(k).randn(200, 3) * 0.4).astype(np.float64)
    got, want = tdu.get_rri(pts, k), jdu.get_rri(pts, k)
    assert got.shape == (200, 4 * k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tdu.knn_idx(pts, k), jdu.knn_idx(pts, k))
    # invariant under a rotation of the cloud (float64, to round-off)
    from scipy.spatial.transform import Rotation
    rot = Rotation.from_rotvec([0.3, -1.1, 0.7]).as_matrix()
    np.testing.assert_allclose(tdu.get_rri(pts @ rot.T, k), got, atol=1e-8)


def test_jitter_matches_jax():
    pts = np.random.RandomState(0).randn(100, 3)
    np.random.seed(5)
    want = jdu.jitter_pcd(pts)
    np.random.seed(5)
    got = tdu.jitter_pcd(pts)
    np.testing.assert_array_equal(got, want)
    assert np.abs(got - pts).max() <= 0.05
    rng = np.random.RandomState(3)
    np.testing.assert_array_equal(
        tdu.jitter_pcd(pts, rng=np.random.RandomState(3)),
        jdu.jitter_pcd(pts, rng=rng))


@pytest.mark.parametrize("dataset", ["modelnetcp", "modelnetdv"])
def test_loaders_match_jax(dataset):
    def cfg(mod):
        c = mod.mnet()
        return c.replace(
            data=dataclasses.replace(c.data, dataset=dataset, root=ROOT,
                                     num_workers=1, n_points=64),
            train=dataclasses.replace(c.train, batch_size=8,
                                      test_batch_size=4, seed=3))
    (jtr, jte), (ttr, tte) = (jloader.data_loader(cfg(jconfigs)),
                              tloader.data_loader(cfg(tconfigs)))
    assert (len(jtr), len(jte)) == (len(ttr), len(tte)) == (2, 1)
    assert tte.serialize_items
    for j, t_, seed in ((jtr, ttr, 0), (jte, tte, 1)):
        np.random.seed(seed)
        want = list(j)
        np.random.seed(seed)
        got = list(t_)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    batch = got[0]
    if dataset == "modelnetdv":
        assert batch["src_xyz"].shape == (4, 768, 3)
        assert batch["tgt_xyz"].shape == (4, 1536, 3)
    else:
        assert batch["src_xyz"].shape == (4, 45, 3)
        assert batch["tgt_xyz"].shape == (4, 64, 3)
