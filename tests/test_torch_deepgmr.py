"""DeepGMR in the port (`ogmm_tpu_torch/nn/deepgmr.py`, its Registrar, train
step, weights and CLI) against the JAX package's `ogmm_tpu/nn/deepgmr.py` on
the CPU, at emb 32 or 64, K=8 clusters, k=8 neighbours, B=2 pairs of a src
of N=48 points against a tgt of M=96: the `modelnetdv` geometry (768 against
1536) at a small size.

Weights come from the JAX package's init with randomised BatchNorm
statistics, carried over by `ogmm_tpu_torch.weights`. At random weights the
clustering head gives nearly uniform responsibilities, so every mixture mean
sits near its cloud's centroid and Horn's eigenvector is only as well posed
as the eigen gap of its 4x4 matrix: the moments and the cross-covariance are
compared tightly, the rotation only with the relative gap (largest minus
second eigenvalue, over the largest magnitude) stated and asserted, and also
with the head's last Dense scaled by 8 so that the clusters are distinct.

The JAX train-step gradients are taken eagerly (the JAX DeepGMR has no
custom-VJP DGCNN on the CPU; jitted there, the gradient of its unfused DGCNN
is ~40% off, tests/test_torch_large_n.py)."""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from ogmm_tpu import configs as jconfigs
from ogmm_tpu.api import Registrar as JRegistrar
from ogmm_tpu.core.procrustes import horn_rotation as jhorn
from ogmm_tpu.losses import dcp_loss as jdcp_loss
from ogmm_tpu.nn.deepgmr import DeepGMR as JDeepGMR
from ogmm_tpu.nn.deepgmr import gmm_register as jgmm_register
from ogmm_tpu.nn.dgcnn import DGCNN as JDGCNN
from ogmm_tpu.nn.layers import ConvHead as JConvHead
from ogmm_tpu.ops.gmm import gmm_params as jgmm_params
from ogmm_tpu.train.checkpoint import export_weights as jexport_weights
from ogmm_tpu.train.checkpoint import load_weights as jload_weights
from ogmm_tpu.train.state import TrainState as JTrainState
from ogmm_tpu.train.trainer import make_eval_step as jmake_eval_step
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch.api import Registrar
from ogmm_tpu_torch.core.procrustes import _horn_matrix, horn_rotation
from ogmm_tpu_torch.nn import DeepGMR, gmm_register
from ogmm_tpu_torch.nn.deepgmr import cross_covariance
from ogmm_tpu_torch.ops import cuda_icp
from ogmm_tpu_torch.train import (create_train_state, export_weights,
                                  make_eval_step, make_train_step, train_loss)
from ogmm_tpu_torch.weights import (convert_variables, flat_variables,
                                    flatten_variables, load_weights)

from torch_port_util import clouds, n, randomise_stats, t, to_plain

SMALL = dict(emb_dims=64, n_clusters=8, gnn_k=8)
B, N, M = 2, 48, 96
# the relative eigen gap of Horn's matrix that a rotation comparison needs:
# float32 round-off of ~1e-7 in ms moves the eigenvector by about that over
# the gap, so at a gap of 0.05 the rotations agree to a few 1e-6
MIN_GAP = 0.05
LIM_ROT = 2e-5


def _pair(seed=0):
    """src (B, N, 3), and tgt (B, M, 3): a rotated, shifted copy of src and
    M - N other points, permuted; the rotation and the translation."""
    rs = np.random.RandomState(seed)
    src = clouds(seed, B=B, N=N)
    rot = Rotation.from_rotvec(rs.uniform(-0.5, 0.5, (B, 3))).as_matrix()
    tr = rs.uniform(-0.2, 0.2, (B, 3))
    tgt = np.concatenate([np.einsum("bij,bnj->bni", rot, src) + tr[:, None],
                          clouds(seed + 100, B=B, N=M - N)], axis=1)
    tgt = tgt[:, rs.permutation(M)]
    return (src, tgt.astype(np.float32), rot.astype(np.float32),
            tr.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _variables(emb=64, scale=1.0):
    """The JAX init of DeepGMR at emb, BatchNorm statistics randomised, the
    clustering head's last Dense kernel times `scale`; plain numpy."""
    jm = JDeepGMR(cfg=jconfigs.ModelConfig(**{**SMALL, "emb_dims": emb}))
    src, tgt, _, _ = _pair()
    v = jax.jit(lambda a, b: jm.init({"params": jax.random.PRNGKey(0)}, a, b,
                                     train=False))(jnp.asarray(src),
                                                   jnp.asarray(tgt))
    v = to_plain(randomise_stats(v, 0))
    head = v["params"]["ConvHead_0"]["Dense_2"]
    head["kernel"] = (head["kernel"] * scale).astype(np.float32)
    return v


def _models(emb=64, scale=1.0, quirk_translation_row=True):
    """(JAX model, its variables, the port's model on them)."""
    cfg, quirk = {**SMALL, "emb_dims": emb}, quirk_translation_row
    v = _variables(emb, scale)
    jm = JDeepGMR(cfg=jconfigs.ModelConfig(**cfg), quirk_translation_row=quirk)
    tm = DeepGMR(tconfigs.ModelConfig(**cfg), quirk_translation_row=quirk)
    tm.load_state_dict(convert_variables(v, "DeepGMR"), strict=True)
    return jm, v, tm


def _jax_moments(v, x, emb=64):
    """gamma, pi, mu, sigma of one cloud through the JAX package's DGCNN,
    ConvHead and gmm_params on DeepGMR's variables (jitted: a forward)."""
    def fn(v, x):
        def sub(name):
            return {"params": v["params"][name],
                    "batch_stats": v["batch_stats"][name]}
        f = JDGCNN(emb, SMALL["gnn_k"]).apply(sub("DGCNN_0"), x, False)
        logits = JConvHead(SMALL["n_clusters"], emb // 2, deep=True).apply(
            sub("ConvHead_0"), f, False)
        gamma = jax.nn.softmax(logits, axis=-1)
        return (gamma, *jgmm_params(gamma, x, return_sigma=True))
    return jax.jit(fn)(v, jnp.asarray(x))


def _jax_ms(pi_s, mu_s, mu_t, sigma_t):
    """ms of the JAX package's `gmm_register` (ogmm_tpu/nn/deepgmr.py:38-44,
    the same jnp calls), which it does not return."""
    c_s = jnp.einsum('bk,bkd->bd', pi_s, mu_s)[:, None, :]
    c_t = jnp.einsum('bk,bkd->bd', pi_s, mu_t)[:, None, :]
    dt_w = jnp.einsum('bkj,bkji->bki', mu_t - c_t, jnp.linalg.inv(sigma_t))
    ms = jnp.einsum('bki,bkj->bij', pi_s[..., None] * (mu_s - c_s), dt_w,
                    precision=jax.lax.Precision.HIGHEST)
    return jnp.nan_to_num(ms) + 1e-4


def _gap(ms):
    ev = np.linalg.eigvalsh(n(_horn_matrix(t(ms))).astype(np.float64))
    return (ev[:, -1] - ev[:, -2]) / np.abs(ev).max(axis=-1)


def _objective(rot, ms):
    """tr(R ms^T), which Horn's rotation maximises."""
    return np.einsum("bij,bij->b", np.asarray(rot, np.float64),
                     np.asarray(ms, np.float64))


# ------------------------------------------------------------ the solve

def test_horn_rotation_matches_jax():
    rs = np.random.RandomState(1)
    x = rs.randn(16, 30, 3)
    rot = Rotation.from_rotvec(rs.uniform(-2, 2, (16, 3))).as_matrix()
    cov = np.einsum("bni,bnj->bij", x, np.einsum("bij,bnj->bni", rot, x)
                    + 0.001 * rs.randn(16, 30, 3)).astype(np.float32)
    got, want = horn_rotation(t(cov)), jhorn(jnp.asarray(cov))
    assert _gap(cov).min() > MIN_GAP
    np.testing.assert_allclose(n(got), n(want), atol=LIM_ROT)
    np.testing.assert_allclose(n(got), rot, atol=1e-3)      # noise 0.001
    np.testing.assert_allclose(np.linalg.det(n(got)), 1.0, atol=1e-5)


def _mixtures(rs, B_=4, K=8):
    pi = rs.dirichlet(np.ones(K), B_).astype(np.float32)
    mu_s = (rs.randn(B_, K, 3) * 0.4).astype(np.float32)
    rot = Rotation.from_rotvec(rs.uniform(-0.6, 0.6, (B_, 3))).as_matrix()
    mu_t = (np.einsum("bij,bkj->bki", rot, mu_s) + rs.uniform(-0.2, 0.2, (B_, 1, 3))
            + 0.02 * rs.randn(B_, K, 3)).astype(np.float32)
    var = rs.uniform(0.01, 0.1, (B_, K)).astype(np.float32)
    return pi, mu_s, mu_t, var


@pytest.mark.parametrize("case", ["regular", "empty", "subnormal"])
def test_gmm_register_matches_jax(case):
    """An empty target cluster (var 0) or one of subnormal var makes every
    entry of the JAX ms NaN, then 1e-4: the port gives the same ms bit for
    bit. That ms has a double largest eigenvalue, so the rotation is any
    maximiser of tr(R ms^T): held to JAX's maximum, not to its choice."""
    pi, mu_s, mu_t, var = _mixtures(np.random.RandomState(2))
    bad = {"regular": None, "empty": 0.0, "subnormal": 1e-40}[case]
    if bad is not None:
        var[1, 3] = bad
    sigma = (var[..., None, None] * np.eye(3, dtype=np.float32)).astype(np.float32)
    args_t = [t(a) for a in (pi, mu_s, mu_t, sigma)]
    args_j = [jnp.asarray(a) for a in (pi, mu_s, mu_t, sigma)]
    ms, _, _ = cross_covariance(*args_t)
    want_ms = n(_jax_ms(*args_j))
    np.testing.assert_allclose(n(ms), want_ms, rtol=1e-5, atol=1e-8)
    got, want = n(gmm_register(*args_t)), n(jgmm_register(*args_j))
    ok = np.ones(len(pi), bool)
    if bad is not None:
        np.testing.assert_array_equal(n(ms)[1], np.float32(1e-4))
        ok[1] = False
        np.testing.assert_allclose(_objective(got[1:2, :3, :3], want_ms[1:2]),
                                   _objective(want[1:2, :3, :3], want_ms[1:2]),
                                   rtol=1e-6)
        r = got[1, :3, :3]
        np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    assert _gap(n(ms)[ok]).min() > MIN_GAP
    np.testing.assert_allclose(got[ok], want[ok], atol=LIM_ROT)
    np.testing.assert_array_equal(got[:, 3], np.tile([0, 0, 0, 1], (len(pi), 1)))


# ---------------------------------------------------------- the forward

@pytest.mark.parametrize("emb", [32, 64])
def test_eval_moments_match_jax(emb):
    """emb 64 takes the fused DGCNN route (the dgcnn_eval kernel's plain
    version here), emb 32 the unfused one; both against the JAX package's
    jnp DGCNN."""
    _, v, tm = _models(emb)
    src, tgt, _, _ = _pair(1)
    with torch.no_grad():
        got = [tm.moments(t(x)) for x in (src, tgt)]
    want = [_jax_moments(v, x, emb) for x in (src, tgt)]
    for g, w in zip(got, want):
        for name, a, b in zip(("gamma", "pi", "mu", "sigma"), g, w):
            np.testing.assert_allclose(n(a), n(b), rtol=1e-5, atol=1e-7,
                                       err_msg=name)
    ms = cross_covariance(got[0][1], got[0][2], got[1][2], got[1][3])[0]
    want_ms = _jax_ms(want[0][1], want[0][2], want[1][2], want[1][3])
    np.testing.assert_allclose(n(ms), n(want_ms), rtol=1e-4, atol=1e-9)


@pytest.mark.parametrize("scale", [1.0, 8.0])
@pytest.mark.parametrize("quirk", [True, False])
def test_eval_forward_matches_jax(quirk, scale):
    """The rotation with the gap asserted; the translation is the zero
    bottom row with the quirk, the column without."""
    jm, v, tm = _models(scale=scale, quirk_translation_row=quirk)
    src, tgt, _, _ = _pair(2)
    jr, jt = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(
        v, jnp.asarray(src), jnp.asarray(tgt))
    with torch.no_grad():
        tr, tt = tm(t(src), t(tgt))
        (_, pi, mu, _), (_, _, mu_t, sg) = tm.moments(t(src)), tm.moments(t(tgt))
        assert _gap(cross_covariance(pi, mu, mu_t, sg)[0]).min() > MIN_GAP
    np.testing.assert_allclose(n(tr), n(jr), atol=LIM_ROT)
    if quirk:
        np.testing.assert_array_equal(n(tt), 0.0)
        np.testing.assert_array_equal(n(jt), 0.0)
    else:
        np.testing.assert_allclose(n(tt), n(jt), atol=LIM_ROT)


@pytest.mark.parametrize("loop_kernels", [False, True])
def test_refined_forward_matches_jax(loop_kernels):
    """With ICP (30 trips at twice the overlap radius; the whole-loop
    route's plain version with loop_kernels): the same correspondences
    each trip, the moments summed in other orders."""
    jm, v, _ = _models(scale=8.0)
    tm = DeepGMR(tconfigs.ModelConfig(**SMALL), loop_kernels=loop_kernels)
    tm.load_state_dict(convert_variables(v, "DeepGMR"), strict=True)
    src, tgt, rot, _ = _pair(3)
    jr, jt = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False,
                                              is_test=True))(
        v, jnp.asarray(src), jnp.asarray(tgt))
    with torch.no_grad():
        tr, tt = tm(t(src), t(tgt), refine=True)
    np.testing.assert_allclose(n(tr), n(jr), atol=1e-4)
    np.testing.assert_allclose(n(tt), n(jt), atol=1e-4)


def test_the_body_ignores_the_compute_type():
    """The JAX DeepGMR gives its DGCNN and head no dtype: float32 whatever
    cfg.dtype says."""
    m = DeepGMR(tconfigs.ModelConfig(**SMALL, dtype="bfloat16"))
    assert m.backbone.compute_dtype == torch.float32
    assert m.cluster.dense0.compute_dtype == torch.float32


# ------------------------------------------------------------ training

@pytest.fixture(scope="module")
def jax_step():
    """One eager JAX DeepGMR train step (dcp_loss) from the init's weights:
    loss, gradients and running statistics."""
    jm, v, _ = _models()
    src, tgt, rot, tr = _pair(4)

    def loss_fn(params):
        (r, tt), mut = jm.apply({"params": params,
                                 "batch_stats": v["batch_stats"]},
                                jnp.asarray(src), jnp.asarray(tgt), train=True,
                                mutable=["batch_stats"])
        return jdcp_loss(r, jnp.asarray(rot), tt, jnp.asarray(tr)), mut

    (loss, mut), grads = jax.value_and_grad(loss_fn, has_aux=True)(v["params"])
    batch = {"src_xyz": src, "tgt_xyz": tgt,
             "src_overlap": np.ones((B, N), np.float32),
             "tgt_overlap": np.ones((B, M), np.float32),
             "transform_gt": np.concatenate([rot, tr[:, :, None]], axis=-1)}
    return dict(v=v, batch=batch, loss=float(loss),
                grads=flatten_variables({"params": to_plain(grads)}),
                stats=flatten_variables({"batch_stats": to_plain(
                    mut["batch_stats"])}))


def _cfg(**model):
    return tconfigs.mnet(model=tconfigs.ModelConfig(**SMALL, **model),
                         model_name="DeepGMR")


def _state(v, cfg=None):
    return create_train_state(cfg or _cfg(), steps_per_epoch=10, device="cpu",
                              state_dict=convert_variables(v, "DeepGMR"))


def test_one_train_step_matches_eager_jax(jax_step):
    d = jax_step
    state = _state(d["v"])
    # the gap of the step's Horn matrix (training forward: batch statistics,
    # on a copy so that the running statistics stay)
    probe = copy.deepcopy(state.model).train()
    with torch.no_grad():
        (_, pi, mu, _), (_, _, mu_t, sg) = (
            probe.moments(t(d["batch"]["src_xyz"])),
            probe.moments(t(d["batch"]["tgt_xyz"])))
    assert _gap(cross_covariance(pi, mu, mu_t, sg)[0]).min() > MIN_GAP
    loss, (_, trans, clu, _) = train_loss(state, _cfg(), d["batch"])
    loss.backward()
    assert clu.item() == 0.0 and torch.equal(trans, torch.zeros(B, 3))
    # float32 round-off of two DGCNN passes, a softmax and Horn's eigh
    # (measured ~5e-8 relative)
    np.testing.assert_allclose(loss.item(), d["loss"], rtol=1e-5)
    grads = flat_variables({k: p.grad for k, p in
                            state.model.named_parameters()}, "DeepGMR")
    assert set(grads) == set(d["grads"])
    # the biases of the Dense layers right before a BatchNorm have zero
    # gradient in exact arithmetic: held below 1e-6 of the largest gradient;
    # every other one to 2e-5 relative (measured ~3e-6)
    scale = max(np.linalg.norm(g) for g in d["grads"].values())
    bad = {}
    for k in grads:
        if np.linalg.norm(d["grads"][k]) < 1e-6 * scale:
            err = np.linalg.norm(n(grads[k])) / scale
            ok = err < 1e-6
        else:
            err = (np.linalg.norm(n(grads[k]) - d["grads"][k])
                   / np.linalg.norm(d["grads"][k]))
            ok = err < 2e-5
        if not ok:
            bad[k] = err
    assert not bad, bad
    # every BatchNorm updated once per cloud, src then tgt
    stats = {k: a for k, a in flat_variables(state.model.state_dict(),
                                             "DeepGMR").items()
             if k.startswith("batch_stats/")}
    assert set(stats) == set(d["stats"])
    for k in stats:
        np.testing.assert_allclose(stats[k], d["stats"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_train_and_eval_steps(jax_step):
    """The step's metric suite at N != M and the eval step with ICP against
    the JAX package's eval step (jitted: a forward, no DGCNN gradient)."""
    d = jax_step
    cfg = _cfg()
    state = _state(d["v"])
    before = {k: a.clone() for k, a in state.model.state_dict().items()}
    metrics = make_train_step(cfg)(state, d["batch"])
    assert state.step == 1
    assert all(torch.isfinite(a).all() for a in metrics.values()), metrics
    np.testing.assert_array_equal(n(metrics["clu_loss"]), 0.0)
    moved = [k for k, a in state.model.state_dict().items()
             if not torch.equal(a, before[k])]
    assert len(moved) == len(before)

    state = _state(d["v"])
    got = make_eval_step(cfg)(state, d["batch"])
    jcfg = jconfigs.mnet().replace(model=jconfigs.ModelConfig(**SMALL),
                                   model_name="DeepGMR")
    jm = JDeepGMR(cfg=jcfg.model)
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=d["v"]["params"],
                         batch_stats=d["v"]["batch_stats"], opt_state=(),
                         rng=jax.random.PRNGKey(0))
    want = jmake_eval_step(jm, jcfg)(jstate, {k: jnp.asarray(a) for k, a
                                               in d["batch"].items()})
    assert set(got) == set(want)
    for k in want:
        # the refined pose to 1e-4 (30 ICP trips), the metrics of it: Euler
        # angles in degrees, distances, the recall
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-3,
                                   atol=1e-3, err_msg=k)


# ------------------------------------------------- weights, API and CLI

def _jcfg(**model):
    return jconfigs.mnet().replace(
        model=jconfigs.ModelConfig(**SMALL, **model), model_name="DeepGMR",
        data=jconfigs.DataConfig(n_points=N))


@pytest.mark.parametrize("refine", [False, True])
def test_registrar_matches_jax(refine):
    v = _variables(64, 8.0)
    jreg = JRegistrar(_jcfg(), variables=v)
    reg = Registrar(_cfg(), state_dict=convert_variables(v, "DeepGMR"),
                    device="cpu")
    src, tgt, _, _ = _pair(5)
    got, want = reg(src, tgt, refine=refine), jreg(src, tgt, refine=refine)
    assert [tuple(a.shape) for a in got] == [(B, 3, 3), (B, 3), (B, N), (B, M)]
    np.testing.assert_allclose(n(got[0]), n(want[0]), atol=1e-4)
    np.testing.assert_allclose(n(got[1]), n(want[1]), atol=1e-4)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(n(a), n(b))


def test_registrar_seeded_init_covers_deepgmr():
    cfg = _cfg()
    a = Registrar(cfg, seed=3, device="cpu").model.state_dict()
    b = Registrar(cfg, seed=3, device="cpu").model.state_dict()
    c = Registrar(cfg, seed=4, device="cpu").model.state_dict()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    # every matrix of the backbone and the head is drawn from the seed
    drawn = [k for k in a if k.endswith(("weight", "w1", "w2", "w3", "w4", "w5"))
             and a[k].dim() == 2]
    assert len(drawn) == 8
    for k in drawn:
        assert not torch.equal(a[k], c[k]), k
        fan_in = a[k].shape[1] if k.endswith("weight") else a[k].shape[0]
        assert abs(a[k].std().item() * fan_in ** 0.5 - 1.0) < 0.25, k


def test_registrar_loop_kernels_reach_the_icp(monkeypatch):
    calls = []
    real = cuda_icp.icp_fused

    def counted(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)
    monkeypatch.setattr(cuda_icp, "icp_fused", counted)
    src, tgt, _, _ = _pair(6)
    Registrar(_cfg(), seed=0, device="cpu")(src, tgt, refine=True)
    assert calls == []
    reg = Registrar(_cfg(), seed=0, device="cpu", loop_kernels=True)
    assert reg.model.loop_kernels
    reg(src, tgt, refine=True)
    assert calls == [(B, N, 3)]


def test_jax_exported_weights_load_and_export_back(tmp_path):
    v = _variables(64, 8.0)
    path = str(tmp_path / "jax.npz")
    jexport_weights(v, path, _jcfg())
    state, saved = load_weights(path)
    assert saved.model_name == "DeepGMR" and saved.model == _cfg().model
    reg = Registrar.from_weights(path, device="cpu")
    assert isinstance(reg.model, DeepGMR)
    src, tgt, _, _ = _pair(7)
    for refine in (False, True):
        got = reg(src, tgt, refine=refine)
        want = JRegistrar.from_weights(path)(src, tgt, refine=refine)
        np.testing.assert_allclose(n(got[0]), n(want[0]), atol=1e-4)
        np.testing.assert_allclose(n(got[1]), n(want[1]), atol=1e-4)
    # the port's export reads back in the JAX package, array for array
    out = str(tmp_path / "port.npz")
    export_weights(reg.model, out, reg.cfg)
    back, cfg = jload_weights(out)
    assert cfg.model_name == "DeepGMR"
    flat = flatten_variables(to_plain(back))
    assert set(flat) == set(flatten_variables(v))
    for k, a in flatten_variables(v).items():
        np.testing.assert_array_equal(flat[k], a, err_msg=k)
    state2, _ = load_weights(out)
    for k in state:
        assert torch.equal(state[k], state2[k]), k


def test_cli_trains_deepgmr_on_modelnetdv_and_serves_its_export(tmp_path):
    from ogmm_tpu_torch.train import cli
    npz = tmp_path / "w.npz"
    trainer = cli.main(["--device", "cpu", "--model", "DeepGMR",
                        "--dataset", "modelnetdv", "--root", "synthetic:24",
                        "--emb_dims", "32", "--n_clusters", "8",
                        "--gnn_k", "8", "--batch_size", "4",
                        "--test_batch_size", "4", "--epochs", "1",
                        "--steps_per_epoch", "2",
                        "--model_path", str(tmp_path / "run"),
                        "--export_weights", str(npz)])
    assert trainer.cfg.model_name == "DeepGMR" and trainer.state.step == 2
    assert isinstance(trainer.state.model, DeepGMR)
    rec = trainer.history[-1]
    assert np.isfinite(rec["train"]["loss"]) and np.isfinite(rec["val"]["loss"])
    assert rec["train"]["clu_loss"] == 0.0
    assert (tmp_path / "run" / "checkpoints" / "DeepGMR" / "models"
            / "optim_model.pt").exists()
    reg = Registrar.from_weights(str(npz), device="cpu")
    assert reg.cfg.model_name == "DeepGMR" and reg.cfg.data.dataset == "modelnetdv"
    best = trainer.state.model.state_dict()
    for k, a in reg.model.state_dict().items():
        assert torch.equal(a, best[k]), k
    rs = np.random.RandomState(8)
    src = rs.randn(2, 768, 3).astype(np.float32) * 0.3
    tgt = rs.randn(2, 1536, 3).astype(np.float32) * 0.3
    rot, trans, so, to = reg(src, tgt, refine=True)
    assert torch.isfinite(rot).all() and torch.isfinite(trans).all()
    assert so.shape == (2, 768) and to.shape == (2, 1536)
