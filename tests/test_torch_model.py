"""The port's network modules, the whole eval forward, ICP, the weight
converter and the Registrar against the JAX package on the CPU.

Weights come from the JAX package's own init from a seed, with the BatchNorm
statistics randomised, and are carried over by `ogmm_tpu_torch.weights`."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu import configs as jconfigs
from ogmm_tpu.core import se3 as jse3
from ogmm_tpu.nn.attention import PositionEncoding as JPosEnc
from ogmm_tpu.nn.attention import TransformerBlock as JBlock
from ogmm_tpu.nn.gmmreg import GMMReg as JGMMReg
from ogmm_tpu.nn.gmmreg import gmm_svd as jgmm_svd
from ogmm_tpu.nn.layers import ConvHead as JConvHead
from ogmm_tpu.nn.layers import instance_norm as jinstance_norm
from ogmm_tpu.ops.icp import icp_point_to_point as jicp
from ogmm_tpu.train.checkpoint import export_weights
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch.api import Registrar
from ogmm_tpu_torch.core import se3 as tse3
from ogmm_tpu_torch.nn.gmmreg import GMMReg as TGMMReg
from ogmm_tpu_torch.nn.gmmreg import gmm_svd as tgmm_svd
from ogmm_tpu_torch.nn.layers import instance_norm as tinstance_norm
from ogmm_tpu_torch.ops.icp import icp_point_to_point as ticp
from ogmm_tpu_torch.weights import convert_variables, load_weights

from torch_port_util import clouds, n, randomise_stats, t, to_plain

SMALL = dict(emb_dims=64, n_clusters=16, km_clusters=16)


def _pair_of_clouds(seed, B=2, N=96):
    """A cloud and a rotated, shifted, permuted copy of it."""
    rs = np.random.RandomState(seed)
    src = clouds(seed, B=B, N=N)
    from scipy.spatial.transform import Rotation
    rot = Rotation.from_rotvec(rs.uniform(-0.4, 0.4, (B, 3))).as_matrix()
    tr = rs.uniform(-0.2, 0.2, (B, 3))
    tgt = np.einsum("bij,bnj->bni", rot, src) + tr[:, None]
    return src, tgt[:, rs.permutation(N)].astype(np.float32), \
        rot.astype(np.float32), tr.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _variables():
    """One seeded init of the JAX model (parameters depend on the widths
    only, not on the options the tests vary), BatchNorm statistics
    randomised."""
    jm = JGMMReg(cfg=jconfigs.ModelConfig(**SMALL, em_iters=1))
    x = jnp.asarray(clouds(0, B=1, N=96))
    init = jax.jit(lambda a: jm.init({"params": jax.random.PRNGKey(0)}, a, a,
                                     train=False))
    return randomise_stats(init(x), 0)


def _models(**over):
    v = _variables()
    jm = JGMMReg(cfg=jconfigs.ModelConfig(**{**SMALL, **over}))
    tm = TGMMReg(tconfigs.ModelConfig(**{**SMALL, **over}))
    tm.load_state_dict(convert_variables(to_plain(v)), strict=True)
    return jm, v, tm


def _angle_deg(a, b):
    c = (np.einsum("bij,bij->b", a, b) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


# ------------------------------------------------------------- sub-modules

def _submodule(jm, v, name):
    return {"params": v["params"][name],
            "batch_stats": v.get("batch_stats", {}).get(name, {})}


def test_instance_norm_matches_jax():
    x = np.random.RandomState(0).randn(2, 50, 8).astype(np.float32) * 3 + 1
    np.testing.assert_allclose(n(tinstance_norm(t(x))),
                               n(jinstance_norm(jnp.asarray(x))), atol=2e-6)


@pytest.mark.parametrize("flax_name,attr,deep,out,hid", [
    ("ConvHead_0", "conv1", True, 64, 128), ("ConvHead_2", "proj", False, 1, 32)])
def test_conv_head_matches_jax(flax_name, attr, deep, out, hid):
    _, v, tm = _models()
    x = np.random.RandomState(1).randn(2, 40, 64).astype(np.float32)
    want = JConvHead(out, hid, deep=deep).apply(
        _submodule(None, v, flax_name), jnp.asarray(x), train=False)
    np.testing.assert_allclose(n(getattr(tm, attr)(t(x))), n(want),
                               rtol=1e-5, atol=1e-5)


def test_position_encoding_matches_jax():
    _, v, tm = _models()
    x = clouds(2)
    want = JPosEnc(64).apply(_submodule(None, v, "PositionEncoding_0"),
                             jnp.asarray(x), 5, False)
    np.testing.assert_allclose(n(tm.pos_enc(t(x), 5)), n(want),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,tol", [(None, 2e-5), ("bfloat16", 0.06)])
def test_transformer_block_matches_jax(dtype, tol):
    over = {"dtype": dtype} if dtype else {}
    _, v, tm = _models(**over)
    rs = np.random.RandomState(3)
    src = rs.randn(2, 60, 64).astype(np.float32)
    anc = rs.randn(2, 16, 64).astype(np.float32)
    want = JBlock(64, 4, dtype).apply(
        {"params": v["params"]["TransformerBlock_1"]},
        jnp.asarray(src), jnp.asarray(anc), False)
    got = tm.cattn(t(src), t(anc))
    # bf16: 8 mantissa bits through five products and an InstanceNorm
    np.testing.assert_allclose(n(got), n(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("is_sk", [False, True])
def test_gmm_svd_matches_jax(is_sk):
    rs = np.random.RandomState(4)
    sn, tn = clouds(4, N=16), clouds(5, N=16)
    sd = rs.randn(2, 16, 32).astype(np.float32)
    td = rs.randn(2, 16, 32).astype(np.float32)
    pi = np.full((2, 16), 1 / 16, np.float32)
    want = jgmm_svd(*(jnp.asarray(a) for a in (sn, tn, sd, td, pi, pi)), is_sk=is_sk)
    got = tgmm_svd(*(t(a) for a in (sn, tn, sd, td, pi, pi)), is_sk=is_sk)
    # softmax at temperature 0.05 / 30 Sinkhorn trips amplify float32
    # round-off of the cosine similarities
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(n(g), n(w), atol=2e-4)


# ------------------------------------------------------------- the forward

def test_forward_one_em_trip_matches_jax_fp32():
    """Everything compared tightly: with one EM trip no drift builds up."""
    jm, v, tm = _models(em_iters=1)
    src, tgt, _, _ = _pair_of_clouds(6)
    jr, jt, jso, jto, jclu = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt),
                                      train=False)
    with torch.no_grad():
        tr, tt, tso, tto, tclu = tm(t(src), t(tgt))
    np.testing.assert_allclose(n(tso), n(jso), atol=1e-4)
    np.testing.assert_allclose(n(tto), n(jto), atol=1e-4)
    # the solve sees cluster features through a softmax at temperature 0.05
    np.testing.assert_allclose(n(tr), n(jr), atol=2e-3)
    np.testing.assert_allclose(n(tt), n(jt), atol=2e-3)
    # the clustering loss, a contrastive loss at temperature 0.1
    np.testing.assert_allclose(n(tclu), n(jclu), rtol=1e-3)


def _one_trip_at_gnn_k(gnn_k, seed):
    jm, v, tm = _models(em_iters=1, gnn_k=gnn_k)
    src, tgt, _, _ = _pair_of_clouds(seed)
    jr, jt, jso, jto, jclu = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt),
                                      train=False)
    with torch.no_grad():
        tr, tt, tso, tto, tclu = tm(t(src), t(tgt))
    assert tm.dgcnn.k == gnn_k
    np.testing.assert_allclose(n(tso), n(jso), atol=1e-4)
    np.testing.assert_allclose(n(tto), n(jto), atol=1e-4)
    np.testing.assert_allclose(n(tr), n(jr), atol=2e-3)
    np.testing.assert_allclose(n(tt), n(jt), atol=2e-3)
    np.testing.assert_allclose(n(tclu), n(jclu), rtol=1e-3)


def test_forward_one_em_trip_matches_jax_fp32_at_gnn_k12():
    """A graph of 12 neighbours (gnn_k=12, the fused route on the card)
    through the whole eval forward, tightly as at one EM trip above."""
    _one_trip_at_gnn_k(12, 16)


def test_forward_one_em_trip_matches_jax_fp32_at_gnn_k40():
    """The DGCNN authors' k = 40 (the fused route on the card: the wide
    selection and the stage chain in chunks of 32 and 8), as at k = 12."""
    _one_trip_at_gnn_k(40, 17)


def test_forward_ten_em_trips_matches_jax_fp32():
    """Overlap scores do not pass through the EM and stay tight; the pose
    does, so it is held to a bar in degrees that allows for the EM's drift
    between the two schedules."""
    jm, v, tm = _models()
    src, tgt, _, _ = _pair_of_clouds(7)
    jr, jt, jso, jto, _ = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt), train=False)
    with torch.no_grad():
        tr, tt, tso, tto, _ = tm(t(src), t(tgt))
    np.testing.assert_allclose(n(tso), n(jso), atol=1e-4)
    np.testing.assert_allclose(n(tto), n(jto), atol=1e-4)
    assert _angle_deg(n(tr), n(jr)).max() < 2.0
    np.testing.assert_allclose(n(tt), n(jt), atol=0.05)
    np.testing.assert_allclose(n(tr @ tr.transpose(1, 2)),
                               np.broadcast_to(np.eye(3), (2, 3, 3)), atol=1e-5)


def test_forward_bf16_body_matches_jax():
    jm, v, tm = _models(dtype="bfloat16", em_iters=1)
    src, tgt, _, _ = _pair_of_clouds(8)
    _, _, jso, jto, _ = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt), train=False)
    with torch.no_grad():
        tr, tt, tso, tto, _ = tm(t(src), t(tgt))
    assert tso.dtype == torch.float32 and tr.dtype == torch.float32
    # sigmoid outputs after ~25 bf16 layers; the two frameworks round at
    # other places
    assert np.abs(n(tso) - n(jso)).max() < 0.08
    assert np.abs(n(tto) - n(jto)).mean() < 0.02
    assert torch.isfinite(tr).all() and torch.isfinite(tt).all()


def test_forward_full_width_cloud():
    jm, v, tm = _models(em_iters=1)
    src, tgt, _, _ = _pair_of_clouds(9, B=1, N=717)
    _, _, jso, jto, _ = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt), train=False)
    with torch.no_grad():
        _, _, tso, tto, _ = tm(t(src), t(tgt))
    np.testing.assert_allclose(n(tso), n(jso), atol=2e-4)
    np.testing.assert_allclose(n(tto), n(jto), atol=2e-4)


def test_forward_separate_anchor_and_cluster_counts():
    jm, v, tm = _models(km_clusters=8, em_iters=1)
    src, tgt, _, _ = _pair_of_clouds(10)
    _, _, jso, _, _ = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt), train=False)
    with torch.no_grad():
        _, _, tso, _, _ = tm(t(src), t(tgt))
    np.testing.assert_allclose(n(tso), n(jso), atol=1e-4)


def test_forward_rejects_what_is_not_ported():
    _, _, tm = _models()
    x = t(clouds(11))
    with pytest.raises(ValueError, match="equal point counts"):
        tm(x, x[:, :50])
    with pytest.raises(ValueError, match="equal point counts"):
        tm.train()(x, x[:, :50])
    with pytest.raises(ValueError, match="pos_k"):
        TGMMReg(tconfigs.ModelConfig(pos_k=0))


# --------------------------------------------------------------------- ICP

@pytest.mark.parametrize("method", ["horn_pi", "horn"])
def test_icp_matches_jax_and_recovers_the_pose(method):
    src, tgt, rot, tr = _pair_of_clouds(12, B=3, N=128)
    rs = np.random.RandomState(12)
    from scipy.spatial.transform import Rotation
    drot = Rotation.from_rotvec(rs.uniform(-0.05, 0.05, (3, 3))).as_matrix()
    init = np.asarray(jse3.integrate(jnp.asarray((drot @ rot).astype(np.float32)),
                                     jnp.asarray(tr)))
    jr, jt = jicp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(init), 0.07,
                  max_iter=30, method=method, use_pallas=False)
    tr_, tt_ = ticp(t(src), t(tgt), t(init), 0.07, max_iter=30, method=method)
    np.testing.assert_allclose(n(tr_), n(jr), atol=1e-4)
    np.testing.assert_allclose(n(tt_), n(jt), atol=1e-4)
    assert _angle_deg(n(tr_), rot).max() < 0.1


def test_icp_without_inliers_keeps_the_pose():
    src = clouds(13, B=2, N=32)
    init = np.asarray(tse3.identity_pose((2,)))
    rot, tr = ticp(t(src), t(src + 100.0), t(init), 0.07, max_iter=3)
    np.testing.assert_array_equal(n(rot), init[:, :3, :3])
    np.testing.assert_array_equal(n(tr), 0)


# ----------------------------------------------------- weights and the API

def test_exported_npz_round_trip(tmp_path):
    jm, v, tm = _models(dtype="bfloat16")
    cfg = jconfigs.Config(model=jm.cfg, data=jconfigs.DataConfig(n_points=96))
    path = str(tmp_path / "w.npz")
    export_weights(to_plain(v), path, cfg)
    state, saved = load_weights(path)
    assert saved.model == tm.cfg
    want = tm.state_dict()
    assert set(state) == set(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    reg = Registrar.from_weights(path, device="cpu")
    src, tgt, _, _ = _pair_of_clouds(14)
    out = reg(src, tgt, refine=False)
    with torch.no_grad():
        ref = tm(t(src), t(tgt))
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_converter_layouts():
    _, v, tm = _models()
    state = convert_variables(to_plain(v))
    k = np.asarray(v["params"]["ConvHead_1"]["Dense_0"]["kernel"])
    assert state["conv2.dense0.weight"].shape == (128, 66)
    np.testing.assert_array_equal(n(state["conv2.dense0.weight"]), k.T)
    np.testing.assert_array_equal(
        n(state["pos_enc.bn2.running_var"]),
        np.asarray(v["batch_stats"]["PositionEncoding_0"]["BN_2"]["BatchNorm_0"]["var"]))
    np.testing.assert_array_equal(n(state["dgcnn.w4"]),
                                  np.asarray(v["params"]["DGCNN_0"]["w4"]))
    with pytest.raises(KeyError):
        convert_variables({"params": {"Mystery_0": {"kernel": np.zeros((2, 2))}}})


@pytest.mark.parametrize("preset", ["mnet", "serve", "indoor"])
def test_configs_translate_or_raise(preset):
    jcfg = getattr(jconfigs, preset)()
    d = jconfigs.config_to_dict(jcfg)
    got = tconfigs.config_from_dict(d)
    for f in dataclasses.fields(tconfigs.ModelConfig):
        assert getattr(got.model, f.name) == getattr(jcfg.model, f.name)


@pytest.mark.parametrize("option,value", [("recompute_anchors", True),
                                          ("stack_train", True),
                                          ("remat", True),
                                          ("stack_eval", False)])
def test_model_options_round_trip(option, value):
    """A JAX config with the option's non-default value builds a port
    config and a GMMReg that carry it, and the port's dictionary gives it
    back to the JAX package unchanged; an unknown option raises."""
    d = jconfigs.config_to_dict(jconfigs.mnet())
    d["model"][option] = value
    cfg = tconfigs.config_from_dict(d)
    assert getattr(cfg.model, option) == value
    assert getattr(TGMMReg(cfg.model).cfg, option) == value
    back = jconfigs.config_from_dict(tconfigs.config_to_dict(cfg))
    assert getattr(back.model, option) == value
    assert back.model == jconfigs.config_from_dict(d).model
    d["model"]["no_such_option"] = value
    with pytest.raises(ValueError, match="no_such_option"):
        tconfigs.config_from_dict(d)


@pytest.mark.parametrize("option", ["dgcnn_fused_edges", "dgcnn_vspace",
                                    "overlap_stream"])
@pytest.mark.parametrize("value", [None, False, True])
def test_the_indoor_options_translate(option, value):
    d = jconfigs.config_to_dict(jconfigs.indoor())
    d["model"][option] = value
    assert getattr(tconfigs.config_from_dict(d).model, option) is value


def test_presets_and_model_names():
    assert tconfigs.mnet().model == tconfigs.ModelConfig()
    # the indoor preset's model is the JAX package's, field by field
    jm, tm = jconfigs.indoor().model, tconfigs.indoor().model
    for f in dataclasses.fields(tconfigs.ModelConfig):
        assert getattr(tm, f.name) == getattr(jm, f.name), f.name
    assert (tm.n_clusters, tm.km_clusters, tm.overlap_radius) == (16, 16, 0.0375)
    # a DeepGMR config round-trips, both ways, with its model name
    jd = jconfigs.config_to_dict(jconfigs.mnet().replace(model_name="DeepGMR"))
    got = tconfigs.config_from_dict(jd)
    assert got.model_name == "DeepGMR" and got.model == tconfigs.ModelConfig()
    assert tconfigs.config_from_dict(tconfigs.config_to_dict(got)) == got
    back = jconfigs.config_from_dict(tconfigs.config_to_dict(got))
    assert back.model_name == "DeepGMR" and back.model == jconfigs.ModelConfig()
    with pytest.raises(ValueError, match="unknown model"):
        tconfigs.config_from_dict({"model_name": "PointNetLK"})
    with pytest.raises(ValueError, match="unknown model option"):
        tconfigs.config_from_dict({"model": {"no_such": 1}})


def test_registrar_seeded_and_refines():
    cfg = tconfigs.mnet(model=tconfigs.ModelConfig(**SMALL))
    src, tgt, rot, tr = _pair_of_clouds(16)
    a = Registrar(cfg, seed=3, device="cpu")
    b = Registrar(cfg, seed=3, device="cpu")
    ra, ta, so, to = a(src, tgt, refine=True)
    rb, tb, _, _ = b(src, tgt, refine=True)
    assert torch.equal(ra, rb) and torch.equal(ta, tb)
    assert torch.equal(so, b(src, tgt, refine=False)[2])
    assert so.shape == (2, 96) and (so >= 0).all() and (so <= 1).all()
    moved = a.transform(ra, ta, src)
    assert moved.shape == (2, 96, 3) and torch.isfinite(moved).all()
    c = Registrar(cfg, seed=4, device="cpu")
    assert not torch.equal(c(src, tgt, refine=False)[2], a(src, tgt, refine=False)[2])
