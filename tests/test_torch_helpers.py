"""The public helpers of the port against the JAX package's, on the CPU:
`ops.common.cos_distance` and `cdist`, `core.procrustes.rigid_transform_3x4`,
the transforms `RandomTransformSE3` (and the Euler variant built on it) and
`FixedResampler` draw for draw from one seeded `np.random` RandomState, the
pose, correspondence, trajectory and file helpers of `data/datautils.py`
(`get_inner_labels` in its three label regimes on clouds with near-ties,
exactly), `native.available`, `train.checkpoint.load_weights` and
`train.state.build_model`. The JAX functions run as they are; nothing here
needs the original code's checkout."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ogmm_tpu import native as jnative
from ogmm_tpu.core import procrustes as jprocrustes
from ogmm_tpu.data import datautils as jdu
from ogmm_tpu.data import transforms as jtf
from ogmm_tpu.ops import common as jcommon
from ogmm_tpu_torch import api, configs, native
from ogmm_tpu_torch import ops as tops
from ogmm_tpu_torch.core import procrustes, rigid_transform_3x4
from ogmm_tpu_torch.data import datautils as du
from ogmm_tpu_torch.data import transforms as tf
from ogmm_tpu_torch.train import checkpoint, state

from torch_port_util import n, t


# --------------------------------------------------------------- array ops

@pytest.mark.parametrize("seed", [0, 1])
def test_cos_distance_and_cdist_match_jax(seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 37, 16).astype(np.float32)
    y = rs.randn(2, 29, 16).astype(np.float32)
    x[0, 3] = 0.0                       # a zero row: the 1e-12 norm floor
    np.testing.assert_allclose(n(tops.cos_distance(t(x), t(y))),
                               n(jcommon.cos_distance(jnp.asarray(x), jnp.asarray(y))),
                               rtol=0, atol=2e-6)
    p, q = (rs.randn(2, 41, 3) * 0.5).astype(np.float32), \
        (rs.randn(2, 33, 3) * 0.5).astype(np.float32)
    q[1, 4] = p[1, 7]                   # a coincident pair: the 1e-12 clamp
    got = tops.cdist(t(p), t(q))
    assert got.dtype == torch.float32 and got.shape == (2, 41, 33)
    np.testing.assert_allclose(n(got), n(jcommon.cdist(jnp.asarray(p), jnp.asarray(q))),
                               rtol=1e-6, atol=2e-6)
    assert "cdist" in tops.__all__ and "cos_distance" in tops.__all__


@pytest.mark.parametrize("method", ["horn", "horn_pi", "svd"])
def test_rigid_transform_3x4_matches_jax(method):
    rs = np.random.RandomState(3)
    src = rs.randn(4, 64, 3).astype(np.float32)
    rot = Rotation.from_rotvec(rs.uniform(-0.6, 0.6, (4, 3))).as_matrix()
    corr = (src @ rot.transpose(0, 2, 1) + rs.randn(4, 1, 3) * 0.2
            + rs.randn(4, 64, 3) * 0.01).astype(np.float32)
    w = rs.rand(4, 64).astype(np.float32)
    got = rigid_transform_3x4(t(src), t(corr), t(w), method)
    assert got.shape == (4, 3, 4)
    rot_t, trans_t = procrustes.rigid_transform(t(src), t(corr), t(w), method)
    assert torch.equal(got, torch.cat([rot_t, trans_t], -1))
    want = jprocrustes.rigid_transform_3x4(jnp.asarray(src), jnp.asarray(corr),
                                           jnp.asarray(w), method)
    np.testing.assert_allclose(n(got), n(want), atol=2e-5)


# -------------------------------------------------------------- transforms

def _draws(make, call, seed):
    """call(make()) after np.random.seed(seed): its result and the global
    RandomState's state after it (the same draws leave the same state)."""
    np.random.seed(seed)
    out = call(make())
    return out, np.random.get_state()[1].copy()


def _sample(seed, key):
    rs = np.random.RandomState(seed)
    pts = rs.randn(50, 6).astype(np.float32)
    if key == "points":
        return {"points": pts, "idx": 4}
    return {"points_src": pts, "points_ref": pts.copy(), "idx": 4}


@pytest.mark.parametrize("random_mag", [False, True])
@pytest.mark.parametrize("euler", [False, True])
def test_random_transform_se3_draws_as_jax(random_mag, euler):
    name = "RandomTransformSE3_euler" if euler else "RandomTransformSE3"
    for seed in (0, 11):
        kw = dict(rot_mag=45.0, trans_mag=0.5, random_mag=random_mag)
        want, want_state = _draws(lambda: getattr(jtf, name)(**kw),
                                  lambda tr: tr.generate_transform(), seed)
        got, got_state = _draws(lambda: getattr(tf, name)(**kw),
                                lambda tr: tr.generate_transform(), seed)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got_state, want_state)
    # the sample paths: 'points' in place, or the source and transform_gt;
    # a deterministic sample seeds from its index
    for key in ("points", "points_src"):
        for det in (False, True):
            def run(mod):
                s = _sample(5, key)
                if det:
                    s["deterministic"] = True
                return getattr(mod, name)(rot_mag=45.0)(s)
            want, _ = _draws(lambda: jtf, run, 9)
            got, _ = _draws(lambda: tf, run, 9)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    assert issubclass(tf.RandomTransformSE3_euler, tf.RandomTransformSE3)


@pytest.mark.parametrize("k", [7, 50, 123])
def test_fixed_resampler_matches_jax(k):
    pts = np.random.RandomState(k).randn(50, 3).astype(np.float32)
    got, gidx = tf.FixedResampler._resample(pts, k)
    want, widx = jtf.FixedResampler._resample(pts, k)
    assert gidx is None and widx is None and got.shape == (k, 3)
    np.testing.assert_array_equal(got, want)
    # the sample path, no draws
    want_s, want_state = _draws(lambda: jtf.FixedResampler(k),
                                lambda r: r({"points": pts.copy()}), 2)
    got_s, got_state = _draws(lambda: tf.FixedResampler(k),
                              lambda r: r({"points": pts.copy()}), 2)
    np.testing.assert_array_equal(got_s["points"], want_s["points"])
    np.testing.assert_array_equal(got_state, want_state)
    assert issubclass(tf.FixedResampler, tf.Resampler)


# ---------------------------------------------------------------- datautils

def test_pose_helpers_match_jax():
    rs = np.random.RandomState(4)
    rot = Rotation.from_rotvec(rs.randn(5, 3) * 0.4).as_matrix()
    trans = rs.randn(5, 3)
    np.testing.assert_array_equal(du.to_tsfm(rot[0], trans[0]),
                                  jdu.to_tsfm(rot[0], trans[0]))
    np.testing.assert_array_equal(du.to_tsfm(rot[1], trans[1][:, None]),
                                  jdu.to_tsfm(rot[1], trans[1][:, None]))
    np.testing.assert_array_equal(du.identity(), jdu.identity())
    np.testing.assert_array_equal(du.inverse(rot, trans), jdu.inverse(rot, trans))
    np.testing.assert_array_equal(du.inverse(rot[2], trans[2]),
                                  jdu.inverse(rot[2], trans[2]))
    for i in range(3):
        xyzquat = np.concatenate([rs.randn(3), Rotation.random(
            random_state=i).as_quat()])
        np.testing.assert_array_equal(du.from_xyzquat(xyzquat),
                                      jdu.from_xyzquat(xyzquat))


@pytest.mark.parametrize("shape", [(3, 8, 8), (2, 9, 5), (6, 7)])
def test_mutual_selection_matches_jax(shape):
    rs = np.random.RandomState(len(shape))
    s = rs.rand(*shape)
    s[..., 0, :2] = 0.999               # a tie in a row: the first column wins
    got = du.mutual_selection(s)
    np.testing.assert_array_equal(got, jdu.mutual_selection(s))
    assert got.dtype == bool and got.ndim == 3


def _near_tie_pair(seed):
    """Clouds where the label regimes differ: pairs of source points within
    thresh of one target point at distances a hair apart (one column, two
    claiming rows), target points whose nearest source is already taken,
    leftovers between thresh and 2 thresh for regime 3's second pass, and
    far outliers; the pose moves src onto tgt's frame."""
    rs = np.random.RandomState(seed)
    rot = Rotation.from_rotvec(rs.uniform(-0.3, 0.3, 3)).as_matrix()
    trans = rs.uniform(-0.1, 0.1, 3)
    base = rs.uniform(-1, 1, (40, 3))
    ties = []
    for p in base[:10]:
        d = rs.randn(3)
        d /= np.linalg.norm(d)
        ties += [p + 0.02 * d, p - (0.02 + 1e-9) * d]
    mid = base[20:30] + 0.07 * rs.randn(10, 3) / np.sqrt(3)
    src_w = np.concatenate([base[:10], np.array(ties), base[10:20], mid,
                            rs.uniform(3, 4, (5, 3))])
    tgt_w = np.concatenate([base[:20], base[20:30], base[10:15] + 0.01,
                            rs.uniform(-5, -4, (4, 3))])
    perm = rs.permutation(len(src_w))
    src_w = src_w[perm]
    # src in its own frame: tgt = R src + t
    src = (src_w - trans) @ rot
    pose = np.concatenate([rot, trans[:, None]], axis=1)
    return src, tgt_w[rs.permutation(len(tgt_w))], pose


@pytest.mark.parametrize("label_type", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_get_inner_labels_matches_jax(seed, label_type):
    src, tgt, pose = _near_tie_pair(seed)
    got = du.get_inner_labels(src, tgt, pose, thresh=0.05, label_type=label_type)
    want = jdu.get_inner_labels(src, tgt, pose, thresh=0.05, label_type=label_type)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the regimes differ on these clouds: 1 holds the mutual pairs only, 2
    # more than one entry in some column, 3 is one-to-one and fills more
    # than 1 does
    perm = got[0]
    if label_type == 1:
        assert perm.sum(0).max() == 1 and perm.sum(1).max() == 1
    if label_type == 2:
        assert perm.sum(0).max() > 1
    if label_type == 3:
        assert perm.sum(0).max() == 1 and perm.sum(1).max() == 1
        mutual = du.get_inner_labels(src, tgt, pose, 0.05, label_type=1)[0]
        assert perm.sum() > mutual.sum()


def test_get_inner_labels_fill_order_matches_jax():
    # two free rows share a nearest column: only the first in row order
    # claims it; a free column then takes nothing, and the second pass at 2
    # thresh pairs the leftovers
    src = np.array([[0.0, 0, 0], [0.011, 0, 0], [5.0, 5, 5], [2.0, 2, 2]])
    tgt = np.array([[0.005, 0, 0], [9.0, 9, 9], [2.07, 2, 2]])
    pose = np.eye(3, 4)
    got = du.get_inner_labels(src, tgt, pose, thresh=0.05, label_type=3)
    want = jdu.get_inner_labels(src, tgt, pose, thresh=0.05, label_type=3)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0][0, 0] == 1 and got[0][1].sum() == 0 and got[0][3, 2] == 1
    with pytest.raises(ValueError):
        du.get_inner_labels(src, tgt, pose, label_type=4)


def test_trajectory_round_trip(tmp_path):
    rs = np.random.RandomState(6)
    traj = np.stack([du.to_tsfm(Rotation.random(random_state=i).as_matrix(),
                                rs.randn(3)) for i in range(5)])
    meta = np.array([[0, 1, 1], [0, 2, 0], [1, 2, 3], [2, 4, 1], [3, 4, 0]])
    mine, theirs = tmp_path / "port.log", tmp_path / "jax.log"
    du.write_trajectory(traj, meta, str(mine))
    jdu.write_trajectory(traj, meta, str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    got, want = du.read_trajectory(str(mine)), jdu.read_trajectory(str(theirs))
    assert len(got) == len(want) == 3          # the records with metadata[2] != 0
    for (gm, gp), (wm, wp), i in zip(got, want, (0, 2, 3)):
        assert gm == wm == meta[i].tolist()
        np.testing.assert_array_equal(gp, wp)
        np.testing.assert_allclose(gp, traj[i], atol=1e-12)


def test_file_helpers_match_jax(tmp_path):
    d = tmp_path / "seq"
    d.mkdir()
    for name in ["frame-10.ply", "frame-2.ply", "frame-2.txt", "b.ply",
                 "depth-1.png", "color-1.png", "color-12.png", "color-3.png"]:
        (d / name).write_text("x")
    for sub in ["scene-10", "scene-9", "a"]:
        (d / sub).mkdir()
    (tmp_path / "list.txt").write_text(" one \ntwo\n\n  three")
    p = str(d)
    assert du.read_txt(str(tmp_path / "list.txt")) == \
        jdu.read_txt(str(tmp_path / "list.txt"))
    names = ["f-10", "f-2", "f-1a", "g", "f-02"]
    assert du.sorted_alphanum(names) == jdu.sorted_alphanum(names)
    for ext in (None, ".ply", ".png"):
        assert du.get_file_list(p, ext) == jdu.get_file_list(p, ext)
        assert sorted(du.get_file_list_specific(p, "color", ext)) == \
            sorted(jdu.get_file_list_specific(p, "color", ext))
        if ext is not None:
            assert du.get_file_list_specific(p, "color", ext) == \
                jdu.get_file_list_specific(p, "color", ext)
    assert du.get_folder_list(p) == jdu.get_folder_list(p)
    made = tmp_path / "x" / "y"
    du.ensure_dir(str(made))
    du.ensure_dir(str(made))
    assert made.is_dir() and oct(os.stat(made).st_mode & 0o777) == oct(
        0o755 & ~_umask())


def _umask():
    mask = os.umask(0)
    os.umask(mask)
    return mask


# ------------------------------------------------------ the other counterparts

def test_native_available_matches_jax():
    assert native.available() is True
    assert jnative.available() == native.available()


def test_checkpoint_load_weights_reads_export_weights(tmp_path):
    cfg = configs.mnet(model=configs.ModelConfig(
        emb_dims=32, n_clusters=8, km_clusters=8, num_heads=2, gnn_k=6))
    model = state.build_model(cfg)
    api.init_weights(model, torch.Generator().manual_seed(3))
    path = str(tmp_path / "w.npz")
    checkpoint.export_weights(model, path, cfg)
    sd, got_cfg = checkpoint.load_weights(path)
    assert got_cfg == cfg
    want = model.state_dict()
    assert sorted(sd) == sorted(want)
    for k in want:
        assert torch.equal(sd[k].to(want[k].dtype), want[k]), k
    assert state.build_model is api.build_model
