"""Checkpoints of the original PyTorch code imported into the port
(`ogmm_tpu_torch/compat.py`, `api.registrar_from_torch_checkpoint`), and
the host geometry (`ogmm_tpu_torch/data/geometry.py`), against the JAX
package on the CPU.

No checkout of the original is needed: the test builds a state_dict in the
original's key layout by inverting the JAX package's converter on a seeded
JAX init, and first asserts that the JAX converter gives that tree back
exactly."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu import compat as jcompat
from ogmm_tpu import configs as jconfigs
from ogmm_tpu.api import Registrar as JRegistrar
from ogmm_tpu.data import geometry as jgeo
from ogmm_tpu.nn.deepgmr import DeepGMR as JDeepGMR
from ogmm_tpu.nn.gmmreg import GMMReg as JGMMReg
from ogmm_tpu_torch import compat
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch.api import registrar_from_torch_checkpoint
from ogmm_tpu_torch.data import geometry
from ogmm_tpu_torch.weights import convert_variables

from torch_port_util import clouds, n, randomise_stats, to_plain

SMALL = dict(emb_dims=64, n_clusters=16, km_clusters=16, em_iters=1)


@functools.lru_cache(maxsize=None)
def _jax_variables(model_name):
    cls = JGMMReg if model_name == "GMMReg" else JDeepGMR
    jm = cls(cfg=jconfigs.ModelConfig(**SMALL))
    x = jnp.asarray(clouds(0, B=1, N=96))
    init = jax.jit(lambda a: jm.init({"params": jax.random.PRNGKey(0)}, a, a,
                                     train=False))
    return to_plain(randomise_stats(init(x), 0))


# ------------------------- the original's layout, from the JAX tree

def _conv(kernel, ndim=3):
    """Dense kernel (in, out) -> the original's 1x1 conv weight."""
    w = np.ascontiguousarray(kernel.T)
    return w.reshape(*w.shape, *([1] * (ndim - 2)))


def _put_dense(sd, name, entry, ndim=3):
    sd[f"{name}.weight"] = _conv(entry["kernel"], ndim)
    if "bias" in entry:
        sd[f"{name}.bias"] = entry["bias"]


def _put_bn(sd, name, p, s):
    sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]
    sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = s["mean"], s["var"]


def _put_dgcnn(sd, prefix, p, s):
    for i in range(1, 6):
        sd[f"{prefix}.conv{i}.weight"] = _conv(p[f"w{i}"], 4 if i < 5 else 3)
        sd[f"{prefix}.bn{i}.weight"] = p[f"bn{i}_scale"]
        sd[f"{prefix}.bn{i}.bias"] = p[f"bn{i}_bias"]
        sd[f"{prefix}.bn{i}.running_mean"] = s[f"bn{i}_mean"]
        sd[f"{prefix}.bn{i}.running_var"] = s[f"bn{i}_var"]


def _put_head(sd, prefix, p, s, deep):
    layers = [(0, "Dense_0", "BN_0"), (3, "Dense_1", "BN_1" if deep else None)]
    if deep:
        layers.append((6, "Dense_2", None))
    for idx, dname, bname in layers:
        _put_dense(sd, f"{prefix}.net.{idx}", p[dname])
        if bname is not None:
            _put_bn(sd, f"{prefix}.net.{idx + 1}", p[bname]["BatchNorm_0"],
                    s[bname]["BatchNorm_0"])


def original_gmmreg_state_dict(v, num_heads=4, emb=64):
    """The inverse of `ogmm_tpu/compat.py:convert_gmmreg_state_dict`."""
    P, S = v["params"], v["batch_stats"]
    sd = {}
    _put_dgcnn(sd, "emd", P["DGCNN_0"], S["DGCNN_0"])
    pe_p, pe_s = P["PositionEncoding_0"], S["PositionEncoding_0"]
    for i, name in enumerate(("pos.conv_dis.0", "pos.conv_dis.3",
                              "pos.conv_ang1.0", "pos.conv_ang2.0")):
        _put_dense(sd, name, pe_p[f"Dense_{i}"])
        head, last = name.rsplit(".", 1)
        _put_bn(sd, f"{head}.{int(last) + 1}", pe_p[f"BN_{i}"]["BatchNorm_0"],
                pe_s[f"BN_{i}"]["BatchNorm_0"])
    # the fuse conv the original's forward never applies
    sd["pos.conv.0.weight"] = np.ones((emb, 2 * emb, 1), np.float32)
    inv = np.argsort(jcompat._head_perm(emb, num_heads))
    for i, name in enumerate(("sattn1", "cattn", "sattn2")):
        tb = P[f"TransformerBlock_{i}"]
        mha = tb["MultiHeadAttention_0"]
        for j in range(3):
            e = mha[f"Dense_{j}"]
            _put_dense(sd, f"{name}.attn.proj.{j}",
                       {"kernel": e["kernel"][:, inv], "bias": e["bias"][inv]})
        e = mha["Dense_3"]
        _put_dense(sd, f"{name}.attn.merge",
                   {"kernel": e["kernel"][inv, :], "bias": e["bias"]})
        _put_dense(sd, f"{name}.mlp.0", tb["PointMLP_0"]["Dense_0"])
        _put_dense(sd, f"{name}.mlp.3", tb["PointMLP_0"]["Dense_1"])
    for i, (name, deep) in enumerate((("conv1", True), ("conv2", True),
                                      ("proj", False), ("overlap", True))):
        _put_head(sd, name, P[f"ConvHead_{i}"], S.get(f"ConvHead_{i}", {}), deep)
    return sd


def original_deepgmr_state_dict(v):
    P, S = v["params"], v["batch_stats"]
    sd = {}
    _put_dgcnn(sd, "backbone", P["DGCNN_0"], S["DGCNN_0"])
    _put_head(sd, "cluster", P["ConvHead_0"], S["ConvHead_0"], True)
    return sd


def _assert_trees_equal(a, b, path=""):
    assert set(a) == set(b), (path, set(a) ^ set(b))
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"{path}/{k}")


CASES = {
    "GMMReg": (original_gmmreg_state_dict,
               lambda sd: jcompat.convert_gmmreg_state_dict(sd, 4, 64),
               lambda sd: compat.convert_gmmreg_state_dict(sd, 4, 64)),
    "DeepGMR": (original_deepgmr_state_dict, jcompat.convert_deepgmr_state_dict,
                compat.convert_deepgmr_state_dict),
}


@pytest.mark.parametrize("model_name", ["GMMReg", "DeepGMR"])
def test_converter_matches_the_jax_package(model_name, tmp_path):
    v = _jax_variables(model_name)
    make, jconvert, tconvert = CASES[model_name]
    sd = make(v)
    # the inverse is right: the JAX package's converter gives the tree back
    jp, js = jconvert(sd)
    _assert_trees_equal({"params": jp, "batch_stats": js}, v)
    # the port's converter gives the same tree, and the state_dict of that
    # tree through weights.convert_variables, bit for bit
    tp, ts = tconvert(sd)
    _assert_trees_equal({"params": tp, "batch_stats": ts}, v)
    path = str(tmp_path / "original.pt")
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in sd.items()}, path)
    got = compat.load_torch_checkpoint(path, 4, 64, model_name=model_name)
    want = convert_variables(v, model_name)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("model_name", ["GMMReg", "DeepGMR"])
def test_original_checkpoint_serves_like_the_jax_registrar(model_name, tmp_path):
    v = _jax_variables(model_name)
    sd = CASES[model_name][0](v)
    path = str(tmp_path / "original.pt")
    torch.save({k: torch.from_numpy(np.array(a)) for k, a in sd.items()}, path)
    tcfg = tconfigs.mnet(model=tconfigs.ModelConfig(**SMALL),
                         model_name=model_name)
    reg = registrar_from_torch_checkpoint(path, tcfg, device="cpu")
    jcfg = jconfigs.mnet(model=jconfigs.ModelConfig(**SMALL),
                         model_name=model_name)
    jvars = jcompat.convert_gmmreg_state_dict(sd, 4, 64) \
        if model_name == "GMMReg" else jcompat.convert_deepgmr_state_dict(sd)
    jreg = JRegistrar(jcfg, variables={"params": jvars[0], "batch_stats": jvars[1]})
    rs = np.random.RandomState(3)
    src = clouds(3, B=2, N=96)
    tgt = (src @ np.linalg.qr(rs.randn(3, 3))[0].astype(np.float32).T
           + 0.1).astype(np.float32)
    jr, jt, jso, jto = jreg(src, tgt, refine=False)
    tr, tt, tso, tto = reg(src, tgt, refine=False)
    if model_name == "GMMReg":
        # as test_torch_model.py's one-EM-trip forward
        np.testing.assert_allclose(n(tso), n(jso), atol=1e-4)
        np.testing.assert_allclose(n(tto), n(jto), atol=1e-4)
    # the pose through a softmax at temperature 0.05 (GMMReg) or a
    # closed-form GMM alignment (DeepGMR) of float32 moments
    np.testing.assert_allclose(n(tr), n(jr), atol=2e-3)
    np.testing.assert_allclose(n(tt), n(jt), atol=2e-3)


def test_missing_key_raises():
    sd = original_deepgmr_state_dict(_jax_variables("DeepGMR"))
    del sd["cluster.net.3.weight"]
    with pytest.raises(KeyError, match="cluster.net.3.weight"):
        compat.convert_deepgmr_state_dict(sd)
    sd = original_gmmreg_state_dict(_jax_variables("GMMReg"))
    del sd["cattn.attn.merge.weight"]
    with pytest.raises(KeyError, match="merge.weight"):
        compat.convert_gmmreg_state_dict(sd, 4, 64)


def test_numpy_state_dict():
    sd = {"a": torch.arange(3.0), "b": np.ones(2)}
    got = compat.numpy_state_dict(sd)
    assert all(isinstance(v, np.ndarray) for v in got.values())
    np.testing.assert_array_equal(got["a"], [0.0, 1.0, 2.0])


# ----------------------------------------------------------- geometry

def _scan(rs, n_pts=600):
    u = rs.rand(n_pts, 2)
    z = 0.2 * np.sin(4 * u[:, :1]) * np.cos(3 * u[:, 1:])
    return (np.concatenate([u, z], 1) + 0.003 * rs.randn(n_pts, 3)).astype(np.float32)


def _pose(rs):
    from scipy.spatial.transform import Rotation
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rs.uniform(-0.2, 0.2, 3)).as_matrix()
    T[:3, 3] = rs.uniform(-0.05, 0.05, 3)
    return T


@pytest.mark.parametrize("orient", [False, True])
def test_estimate_normals_matches_jax(orient):
    x = _scan(np.random.RandomState(0))
    kw = {"orient_to": np.array([0.5, 0.5, 2.0])} if orient else {}
    # the same numpy/scipy code: identical normals, signs included
    np.testing.assert_array_equal(geometry.estimate_normals(x, **kw),
                                  jgeo.estimate_normals(x, **kw))


def test_voxel_downsample_matches_jax():
    x = _scan(np.random.RandomState(1))
    for a, b in zip(geometry.voxel_downsample(x, 0.05),
                    jgeo.voxel_downsample(x, 0.05)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("k", [None, 1, 3])
def test_matching_and_overlap_match_jax(k):
    rs = np.random.RandomState(2)
    src = _scan(rs)
    T = _pose(rs)
    tgt = (src[:400] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    tgt = np.concatenate([tgt, _scan(rs, 200) + 2.0])
    got = geometry.get_matching_indices(src, tgt, T, 0.03, k)
    assert got == jgeo.get_matching_indices(src, tgt, T, 0.03, k)
    np.testing.assert_array_equal(geometry.get_correspondences(src, tgt, T, 0.03, k),
                                  jgeo.get_correspondences(src, tgt, T, 0.03, k))
    for trans in (T, T[:3]):
        assert geometry.compute_overlap_ratio(src, tgt, trans, 0.03) == \
            jgeo.compute_overlap_ratio(src, tgt, trans, 0.03)
    assert geometry.get_correspondences(src, tgt + 50.0, T, 0.03).shape == (0, 2)


def test_fpfh_and_integrate_trans_match_jax():
    x = _scan(np.random.RandomState(3), 300)
    # the same float64 numpy code; float32 out (stated bound 1e-5)
    np.testing.assert_allclose(geometry.fpfh(x, radius=0.15),
                               jgeo.fpfh(x, radius=0.15), atol=1e-5)
    R, t_ = _pose(np.random.RandomState(4))[:3, :3], np.array([0.1, 0.2, 0.3])
    np.testing.assert_array_equal(geometry.integrate_trans(R, t_),
                                  jgeo.integrate_trans(R, t_))
