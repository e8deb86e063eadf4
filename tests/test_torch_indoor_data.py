"""The port's indoor data pipeline against the JAX package's, on files the
tests write (no 7-Scenes or ICL-NUIM scans are in the repository):

  * the host library (`ogmm_tpu_torch/native`) against the JAX package's
    `native`: identical labels, indices, distances and FPS ids; and against
    its own plain scipy/numpy versions on data without ties;
  * `plyread` on binary and ASCII .ply files;
  * `Scene7` (.ply fragments) and `IclNuim` (.h5, test and training splits):
    identical items from the same `np.random` seed, with and without
    `compute_overlap` and `fix_tgt_overlap`;
  * `data_loader(configs.indoor(...))`: identical batches with one worker,
    and `_check_overlap_thresh` raising where the JAX loader raises;
  * `python -m ogmm_tpu_torch.train --preset indoor --dataset 7scene` on the
    CPU at narrow widths: two steps, an eval batch, a checkpoint."""
import dataclasses

import numpy as np
import pytest

from ogmm_tpu import configs as jconfigs
from ogmm_tpu import native as jnative
from ogmm_tpu.data import loader as jloader
from ogmm_tpu.data import mesh as jmesh
from ogmm_tpu.data import realdata as jrealdata
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch import native as tnative
from ogmm_tpu_torch.data import loader as tloader
from ogmm_tpu_torch.data import mesh as tmesh
from ogmm_tpu_torch.data import realdata as trealdata

N_RAW = 700
SCENES = ("7-scenes-office", "7-scenes-chess", "7-scenes-fire",
          "7-scenes-heads", "7-scenes-pumpkin", "7-scenes-redkitchen",
          "7-scenes-stairs")


def _room(rs, n):
    """An indoor-like fragment: a floor and a wall, 3 mm noise."""
    floor = np.concatenate([rs.rand(n // 2, 2) * 2.0, np.zeros((n // 2, 1))], 1)
    m = n - n // 2
    wall = np.stack([rs.rand(m) * 2.0, np.zeros(m), rs.rand(m) * 1.5], 1)
    pts = np.concatenate([floor, wall]) + rs.randn(n, 3) * 0.003
    return pts[rs.permutation(n)].astype(np.float32)


def _write_ply(path, verts, ascii_=False):
    """x, y, z as float, then a uchar colour the readers must skip."""
    head = ["ply", f"format {'ascii' if ascii_ else 'binary_little_endian'} 1.0",
            "comment written by a test", f"element vertex {len(verts)}",
            "property float x", "property float y", "property float z",
            "property uchar red", "end_header"]
    rgb = np.arange(len(verts)) % 256
    with open(path, "wb") as f:
        f.write(("\n".join(head) + "\n").encode())
        if ascii_:
            for (x, y, z), c in zip(verts, rgb):
                f.write(f"{float(x)!r} {float(y)!r} {float(z)!r} {c}\n".encode())
        else:
            rec = np.zeros(len(verts), dtype=[("x", "<f4"), ("y", "<f4"),
                                              ("z", "<f4"), ("red", "u1")])
            rec["x"], rec["y"], rec["z"], rec["red"] = (*verts.T, rgb)
            f.write(rec.tobytes())


@pytest.fixture(scope="module")
def scene7_root(tmp_path_factory):
    """Two fragments a scene, binary; the office's second one ASCII."""
    root = tmp_path_factory.mktemp("indoor")
    rs = np.random.RandomState(0)
    for scene in SCENES:
        d = root / "7scene" / scene
        d.mkdir(parents=True)
        for i in range(2):
            _write_ply(d / f"frag_{i:03d}.ply", _room(rs, N_RAW),
                       ascii_=(scene == "7-scenes-office" and i == 1))
    return str(root)


def _write_iclnuim(root, partition, n_items=4):
    h5py = pytest.importorskip("h5py")
    rs = np.random.RandomState(1 if partition == "test" else 2)
    d = root / "icl_nuim" / partition
    d.mkdir(parents=True, exist_ok=True)
    with h5py.File(d / "icl_nuim.h5", "w") as f:
        pts = np.stack([_room(rs, N_RAW) for _ in range(n_items)])
        if partition == "test":
            f["source"] = pts
            f["target"] = pts[:, rs.permutation(N_RAW)]
            a = rs.uniform(-0.3, 0.3, n_items)
            tsfm = np.tile(np.eye(4, dtype=np.float32), (n_items, 1, 1))
            tsfm[:, 0, 0] = tsfm[:, 1, 1] = np.cos(a)
            tsfm[:, 0, 1], tsfm[:, 1, 0] = -np.sin(a), np.sin(a)
            tsfm[:, :3, 3] = rs.uniform(-0.2, 0.2, (n_items, 3))
            f["transform"] = tsfm
        else:
            f["points"] = pts


@pytest.fixture(scope="module")
def icl_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("icl")
    for part in ("test", "train"):
        _write_iclnuim(root, part)
    return str(root)


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# ------------------------------------------------------------- host library

@pytest.mark.parametrize("n,m", [(500, 400), (3000, 2500), (1, 7)])
def test_host_library_matches_the_jax_packages(n, m):
    rs = np.random.RandomState(n)
    a = _room(rs, n) if n > 1 else rs.rand(n, 3).astype(np.float32)
    b = _room(rs, m)
    for thresh in (0.01, 0.05, 0.2):
        for got, want in zip(tnative.radius_overlap(a, b, thresh),
                             jnative.radius_overlap(a, b, thresh)):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    for got, want in zip(tnative.nearest_neighbor(a, b),
                         jnative.nearest_neighbor(a, b)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for start in (0, m // 2, m - 1):
        np.testing.assert_array_equal(tnative.fps_indices(b, min(64, m), start),
                                      jnative.fps_indices(b, min(64, m), start))


def test_host_library_matches_its_plain_versions():
    # random points: no two distances tie
    rs = np.random.RandomState(3)
    a = rs.rand(800, 3).astype(np.float32)
    b = rs.rand(900, 3).astype(np.float32)
    for got, want in zip(tnative.radius_overlap(a, b, 0.04),
                         tnative.radius_overlap_plain(a, b, 0.04)):
        np.testing.assert_array_equal(got, want)
    (d, i), (pd, pi) = tnative.nearest_neighbor(a, b), tnative.nearest_neighbor_plain(a, b)
    np.testing.assert_array_equal(i, pi)
    np.testing.assert_allclose(d, pd, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(tnative.fps_indices(b, 64, 5),
                                  tnative.fps_indices_plain(b, 64, 5))


def test_host_library_is_built_under_the_build_directory():
    path = tnative.lib_path()
    tnative.radius_overlap(np.zeros((1, 3), np.float32),
                           np.zeros((1, 3), np.float32), 0.1)
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "ogmm_tpu_torch"
    assert not list(tnative.SOURCE.parent.glob("*.so"))


def test_host_library_build_failure_raises(monkeypatch, tmp_path):
    # a source g++ cannot compile: the error names the compiler's message
    bad = tmp_path / "host_ops.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build()


# ------------------------------------------------------------------ readers

def test_plyread_matches_binary_and_ascii(scene7_root, tmp_path):
    rs = np.random.RandomState(4)
    verts = rs.randn(50, 3).astype(np.float32)
    for ascii_ in (False, True):
        path = str(tmp_path / f"c{int(ascii_)}.ply")
        _write_ply(path, verts, ascii_=ascii_)
        got, want = tmesh.plyread(path), jmesh.plyread(path)
        assert got.vertex_array.dtype == want.vertex_array.dtype == np.float64
        np.testing.assert_array_equal(got.vertex_array, want.vertex_array)
        np.testing.assert_array_equal(got.vertex_array, verts.astype(np.float64))
    np.testing.assert_array_equal(
        tmesh.Mesh2Points()(tmesh.meshread(path)),
        jmesh.Mesh2Points()(jmesh.meshread(path)))


def test_off_and_obj_readers_match(tmp_path):
    off = tmp_path / "a.off"
    off.write_text("OFF4 2 0\n0 0 0\n1 0 0\n0 1 0\n0 0 1\n3 0 1 2\n3 0 2 3\n")
    obj = tmp_path / "a.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    for path in (off, obj):
        got, want = tmesh.meshread(str(path)), jmesh.meshread(str(path))
        np.testing.assert_array_equal(got.vertex_array, want.vertex_array)
        assert got.faces == want.faces


# ----------------------------------------------------------------- datasets

@pytest.mark.parametrize("partition", ["test", "train"])
@pytest.mark.parametrize("partial", [(0.7, 0.7), (0.6, 0.7)])
@pytest.mark.parametrize("overlap", [(True, False), (True, True), (False, False)])
def test_scene7_items_match(scene7_root, partition, partial, overlap):
    # partial (0.6, 0.7) leaves the target more points than 0.6 n_points:
    # FPS samples it down; n_points 600 of the 700 a file
    compute, fix = overlap
    kw = dict(n_points=600, partial=list(partial), partition=partition,
              fix_tgt_overlap=fix, compute_overlap=compute)
    j = jrealdata.Scene7(scene7_root, **kw)
    t = trealdata.Scene7(scene7_root, **kw)
    assert len(j) == len(t) == (2 if partition == "test" else 12)
    assert t.samples == j.samples
    np.random.seed(11)
    want = [j[i] for i in range(len(j))]
    np.random.seed(11)
    got = [t[i] for i in range(len(t))]
    for a, b in zip(got, want):
        _assert_same(a, b)
    n_sub = int(partial[0] * 600)
    assert got[0]["src_xyz"].shape == got[0]["tgt_xyz"].shape == (n_sub, 3)
    if compute:
        assert 0 < got[0]["src_overlap"].mean() <= 1
        assert fix or np.array_equal(got[0]["src_overlap"], got[0]["tgt_overlap"])


@pytest.mark.parametrize("partition", ["test", "train"])
@pytest.mark.parametrize("overlap", [(True, False), (True, True), (False, False)])
def test_iclnuim_items_match(icl_root, partition, overlap):
    compute, fix = overlap
    kw = dict(n_points=500, partial=[0.7, 0.7], partition=partition,
              fix_tgt_overlap=fix, compute_overlap=compute)
    j = jrealdata.IclNuim(icl_root, **kw)
    t = trealdata.IclNuim(icl_root, **kw)
    assert len(j) == len(t) == 4
    for i in (2, 0, 3):                 # each item seeds np.random itself
        _assert_same(t[i], j[i])
    assert t.overlap_thresh == j.overlap_thresh == 0.075


def test_glob_dataset_matches(scene7_root):
    classes = {c: i for i, c in enumerate(sorted(SCENES[1:]))}
    root = scene7_root + "/7scene"
    assert trealdata.glob_dataset(root, classes, ["*.ply"]) == \
        jrealdata.glob_dataset(root, classes, ["*.ply"])


# ------------------------------------------------------------------ loaders

def _loader_configs(name, root, **train):
    out = []
    for cfgs in (jconfigs, tconfigs):
        c = cfgs.indoor()
        c = c.replace(data=dataclasses.replace(c.data, dataset=name, root=root,
                                               n_points=500, num_workers=1),
                      train=dataclasses.replace(c.train, batch_size=2,
                                                test_batch_size=1, **train))
        out.append(c)
    return out


@pytest.mark.parametrize("name", ["7scene", "icl_nuim"])
@pytest.mark.parametrize("device_overlap", [False, True])
def test_data_loader_batches_match(scene7_root, icl_root, name, device_overlap):
    root = scene7_root if name == "7scene" else icl_root
    thresh = 0.075 if name == "icl_nuim" else 0.05
    jc, tc = _loader_configs(name, root, device_overlap=device_overlap,
                             overlap_thresh=thresh)
    jtr, jte = jloader.data_loader(jc)
    ttr, tte = tloader.data_loader(tc)
    assert (len(jtr), len(jte)) == (len(ttr), len(tte))
    assert tte.serialize_items == jte.serialize_items
    for jl, tl in ((jtr, ttr), (jte, tte)):
        # a whole epoch each, one after the other
        np.random.seed(5)
        want = list(jl)
        np.random.seed(5)
        got = list(tl)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            _assert_same(a, b)
        if device_overlap:
            assert not got[0]["src_overlap"].any()


@pytest.mark.parametrize("name", ["7scene", "icl_nuim"])
@pytest.mark.parametrize("device_overlap", [False, True])
@pytest.mark.parametrize("thresh", [0.05, 0.075, 0.1])
def test_overlap_radius_check_matches(scene7_root, icl_root, name,
                                      device_overlap, thresh):
    root = scene7_root if name == "7scene" else icl_root
    jc, tc = _loader_configs(name, root, device_overlap=device_overlap,
                             overlap_thresh=thresh)
    try:
        jloader.data_loader(jc)
        raised = False
    except ValueError:
        raised = True
    if raised:
        with pytest.raises(ValueError, match="overlap_thresh"):
            tloader.data_loader(tc)
    else:
        tloader.data_loader(tc)
    want = device_overlap and thresh != (0.075 if name == "icl_nuim" else 0.05)
    assert raised == want


# ---------------------------------------------------------------------- CLI

def test_cli_trains_the_indoor_preset_on_7scene(scene7_root, tmp_path):
    from ogmm_tpu_torch.train import cli
    trainer = cli.main(["--device", "cpu", "--preset", "indoor",
                        "--dataset", "7scene", "--root", scene7_root,
                        "--emb_dims", "32", "--n_points", "600",
                        "--batch_size", "2", "--test_batch_size", "1",
                        "--epochs", "1", "--steps_per_epoch", "2",
                        "--model_path", str(tmp_path / "run")])
    cfg = trainer.cfg
    assert (cfg.model.n_clusters, cfg.model.overlap_radius) == (16, 0.0375)
    assert cfg.data.dataset == "7scene" and cfg.data.n_points == 600
    assert trainer.state.step == 2
    rec = trainer.history[-1]
    assert np.isfinite(rec["train"]["loss"]) and np.isfinite(rec["val"]["loss"])
    models = tmp_path / "run" / "checkpoints" / "GMMReg" / "models"
    assert (models / "optim_model.pt").exists()


@pytest.mark.parametrize("dataset,thresh", [("7scene", 0.05), ("icl_nuim", 0.075)])
def test_cli_device_overlap_takes_the_datasets_radius(dataset, thresh):
    from ogmm_tpu_torch.train import cli
    cfg = cli.build_config(cli.parse_args(
        ["--preset", "indoor", "--dataset", dataset, "--device_overlap"]))
    assert cfg.train.device_overlap and cfg.train.overlap_thresh == thresh
    assert cfg.train.batch_size == 8 and cfg.model.n_clusters == 16
