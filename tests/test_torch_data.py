"""The port's ModelNet pipeline (`ogmm_tpu_torch/data/`) against the JAX
package's (`ogmm_tpu/data/`): the same seed gives the same samples, batches
and loaders bit for bit, and the ModelNet40 .h5 reader reads the same
arrays."""
import dataclasses

import numpy as np
import pytest

from ogmm_tpu import configs as jconfigs
from ogmm_tpu.data import loader as jloader
from ogmm_tpu.data import modelnet as jmodelnet
from ogmm_tpu.data.datautils import load_modelnet_h5 as jload_h5
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch.data import loader as tloader
from ogmm_tpu_torch.data import modelnet as tmodelnet
from ogmm_tpu_torch.data.datautils import load_modelnet_h5 as tload_h5


def _datasets(root, partition, unseen=False, noise="crop"):
    out = []
    for mod in (jmodelnet, tmodelnet):
        train_tf, test_tf = mod.get_transforms(noise, 45.0, 0.5, 717,
                                               [0.7, 0.7])
        out.append(mod.ModelNetHdf(
            root, unseen=unseen, partition=partition,
            transform=train_tf if partition == "train" else test_tf))
    return out


def _items(ds, seed):
    np.random.seed(seed)
    return [ds[i] for i in range(len(ds))]


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("partition", ["train", "test"])
def test_modelnet_crop_samples_are_bit_identical(partition):
    jds, tds = _datasets("synthetic:8", partition)
    assert len(jds) == len(tds) == 8
    jitems, titems = _items(jds, 7), _items(tds, 7)
    for a, b in zip(jitems, titems):
        _assert_same(a, b)
    b = titems[0]
    assert b["src_xyz"].shape == (717, 3) and b["tgt_xyz"].shape == (717, 3)
    assert b["transform_gt"].shape == (3, 4) and b["pose_gt"].shape == (7,)
    # the cropped clouds overlap in part: labels are neither all 0 nor all 1
    assert 0.0 < b["src_overlap"].mean() < 1.0


def test_modelnet_unseen_split_and_test_determinism():
    jds, tds = _datasets("synthetic:24", "test", unseen=True)
    assert len(jds) == len(tds) == 4
    np.testing.assert_array_equal(jds.label, tds.label)
    assert (tds.label >= 20).all()
    # the test chain seeds every transform from the item's index: the same
    # item twice, whatever was drawn before, apart from the cloud's order
    np.random.seed(0)
    first = tds[2]
    np.random.seed(1)
    tds[0]
    again = tds[2]
    np.testing.assert_array_equal(first["transform_gt"], again["transform_gt"])


@pytest.mark.parametrize("noise", ["jitter", "clean"])
def test_other_noise_regimes_match(noise):
    jds, tds = _datasets("synthetic:8", "train", noise=noise)
    for a, b in zip(_items(jds, 3), _items(tds, 3)):
        _assert_same(a, b)
    # no crop: no overlap labels, the scalar 0 of the original's fallback
    assert b["src_overlap"].shape == () and b["src_xyz"].shape == (717, 3)


def test_prefetch_loader_batches_match_with_one_worker():
    jds, tds = _datasets("synthetic:8", "train")
    kw = dict(batch_size=3, shuffle=True, drop_last=True, num_workers=1,
              seed=5)
    jl, tl = jloader.PrefetchLoader(jds, **kw), tloader.PrefetchLoader(tds, **kw)
    assert len(jl) == len(tl) == 2
    np.random.seed(11)
    jb = [b for _ in range(2) for b in jl]       # two epochs
    np.random.seed(11)
    tb = [b for _ in range(2) for b in tl]
    assert len(tb) == 4 and tb[0]["src_xyz"].shape == (3, 717, 3)
    for a, b in zip(jb, tb):
        _assert_same(a, b)
    # epoch 2 takes another order
    assert not np.array_equal(tb[0]["idx"], tb[2]["idx"])


def test_data_loader_synthetic_matches():
    jc = jconfigs.mnet()
    jc = jc.replace(data=dataclasses.replace(jc.data, dataset="synthetic",
                                             root="synthetic:24", num_workers=1),
                    train=dataclasses.replace(jc.train, batch_size=4,
                                              test_batch_size=4, seed=3))
    tc = tconfigs.mnet()
    tc = tc.replace(data=dataclasses.replace(tc.data, dataset="synthetic",
                                             root="synthetic:24", num_workers=1),
                    train=dataclasses.replace(tc.train, batch_size=4,
                                              test_batch_size=4, seed=3))
    (jtr, jte), (ttr, tte) = jloader.data_loader(jc), tloader.data_loader(tc)
    assert (len(jtr), len(jte)) == (len(ttr), len(tte)) == (5, 1)
    # a whole epoch each, one after the other: a suspended loader's worker
    # would go on drawing from the global generator
    np.random.seed(0)
    ja = list(jtr)
    np.random.seed(0)
    ta = list(ttr)
    assert len(ta) == 5 and ta[0]["src_xyz"].shape == (4, 717, 3)
    for a, b in zip(ja, ta):
        _assert_same(a, b)
    # the test chain seeds its transforms per item; the item's first
    # permutation draws from the state before it
    np.random.seed(1)
    ja = list(jte)
    np.random.seed(1)
    for a, b in zip(ja, list(tte)):
        _assert_same(a, b)


@pytest.mark.parametrize("name,cls", [("modelnetcp", "ModelNetCP"),
                                      ("modelnetdv", "ModelNetDV")])
def test_data_loader_builds_the_variants(name, cls):
    """The variants the loader used to refuse: their datasets (the list
    items of ModelNetDV through ListAsDict), the test split serialised as
    it seeds np.random per item (tests/test_torch_modelnet_variants.py holds
    their items and batches against the JAX package's)."""
    cfg = tconfigs.mnet()
    cfg = cfg.replace(data=dataclasses.replace(cfg.data, dataset=name,
                                               root="synthetic:24"))
    train, test = tloader.data_loader(cfg)
    for loader in (train, test):
        ds = loader.dataset
        if name == "modelnetdv":
            assert isinstance(ds, tloader.ListAsDict)
            ds = ds.dataset
        assert type(ds).__name__ == cls
    assert test.serialize_items and not train.serialize_items
    assert (len(train.dataset), len(test.dataset)) == (20, 4)


def test_data_loader_refuses_datasets_of_later_slices():
    cfg = tconfigs.mnet()
    with pytest.raises(ValueError, match="unknown dataset"):
        tloader.data_loader(cfg.replace(
            data=dataclasses.replace(cfg.data, dataset="shapenet")))


def test_modelnet_h5_reader_matches(tmp_path):
    h5py = pytest.importorskip("h5py")
    rs = np.random.RandomState(0)
    d = tmp_path / "modelnet40_ply_hdf5_2048"
    d.mkdir()
    for part, labels in (("train", [3, 25]), ("test", [21, 4])):
        with h5py.File(d / f"ply_data_{part}0.h5", "w") as f:
            f["data"] = rs.randn(2, 2048, 3).astype(np.float32)
            f["normal"] = rs.randn(2, 2048, 3).astype(np.float32)
            f["label"] = np.array(labels, np.uint8)[:, None]
    for part in ("train", "test"):
        jd, jl = jload_h5(part, str(tmp_path))
        td, tl = tload_h5(part, str(tmp_path))
        assert td.shape == (2, 2048, 6) and td.dtype == np.float32
        assert tl.shape == (2, 1) and tl.dtype == np.int64
        np.testing.assert_array_equal(jd, td)
        np.testing.assert_array_equal(jl, tl)
    # the dataset on the files: one shape a partition after the unseen split
    jds, tds = _datasets(str(tmp_path), "test", unseen=True)
    assert len(tds) == 1 and tds.label.tolist() == [21]
    for a, b in zip(_items(jds, 2), _items(tds, 2)):
        _assert_same(a, b)
    with pytest.raises(FileNotFoundError):
        tload_h5("train", str(tmp_path / "missing"))
