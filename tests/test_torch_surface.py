"""The rest of the model surface against the JAX package on the CPU: the
GMM helpers (`contrastsk`, `og_params`, `wkeans`, `get_anchor_corrs`),
`km_loss`, the two error metrics, the `serve` preset, the four model
options (`recompute_anchors`, `stack_eval`, `stack_train`, `remat`), the
checkpoint directory's config record, `Registrar.from_checkpoint` and
`Registrar.export_weights`.

Inputs are made with numpy from a seed; weights are the JAX package's init
with randomised BatchNorm statistics, carried over by
`ogmm_tpu_torch.weights`."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu import configs as jconfigs
from ogmm_tpu.api import Registrar as JRegistrar
from ogmm_tpu.core.metrics import rotation_error as jrotation_error
from ogmm_tpu.core.metrics import translation_error as jtranslation_error
from ogmm_tpu.losses import composite_loss as jcomposite
from ogmm_tpu.losses import km_loss as jkm_loss
from ogmm_tpu.nn.gmmreg import GMMReg as JGMMReg
from ogmm_tpu.ops.gmm import get_anchor_corrs as jget_anchor_corrs
from ogmm_tpu.ops.gmm import og_params as jog_params
from ogmm_tpu.ops.gmm import wkeans as jwkeans
from ogmm_tpu.ops.sinkhorn import contrastsk as jcontrastsk
from ogmm_tpu.train.checkpoint import load_weights as jload_weights
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch.api import Registrar
from ogmm_tpu_torch.core.metrics import rotation_error, translation_error
from ogmm_tpu_torch.losses import km_loss
from ogmm_tpu_torch.nn.gmmreg import GMMReg as TGMMReg
from ogmm_tpu_torch.ops.fps import farthest_point_sample
from ogmm_tpu_torch.ops.gmm import get_anchor_corrs, og_params, wkeans
from ogmm_tpu_torch.ops.sinkhorn import contrastsk
from ogmm_tpu_torch.train import (CheckpointManager, create_train_state, cli,
                                  train_loss)
from ogmm_tpu_torch.weights import convert_variables, flat_variables

from torch_port_util import clouds, n, randomise_stats, t, to_plain

SMALL = dict(emb_dims=64, n_clusters=16, km_clusters=16)


def _rel(a, b):
    return np.linalg.norm(n(a) - n(b)) / (np.linalg.norm(n(b)) + 1e-30)


# ---------------------------------------------------------- GMM helpers

@pytest.mark.parametrize("dst,D", [("eu", 3), ("feats", 16)])
def test_contrastsk_matches_jax(dst, D):
    rs = np.random.RandomState(0)
    x = (rs.randn(2, 40, D) * 0.3).astype(np.float32)
    y = (rs.randn(2, 8, D) * 0.3).astype(np.float32)
    p = rs.rand(2, 8).astype(np.float32)
    p /= p.sum(-1, keepdims=True)
    jg, jl = jcontrastsk(jnp.asarray(x), jnp.asarray(y), p=jnp.asarray(p), dst=dst)
    tg, tl = contrastsk(t(x), t(y), p=t(p), dst=dst)
    # 30 trips at epsilon 1e-3: the potentials' float32 round-off is
    # amplified by 1/epsilon = 1000 in the exponent, ~1e-4 of an entry
    np.testing.assert_allclose(n(tg), n(jg), rtol=5e-4, atol=1e-6 * n(jg).max())
    np.testing.assert_allclose(n(tl), n(jl), rtol=1e-4)


@pytest.mark.parametrize("o_score", [False, True])
@pytest.mark.parametrize("feature", [False, True])
def test_og_params_matches_jax(o_score, feature):
    rs = np.random.RandomState(1)
    pts = clouds(1, N=50)
    gamma = rs.rand(2, 50, 8).astype(np.float32)
    o = rs.rand(2, 50).astype(np.float32) if o_score else None
    f = rs.randn(2, 50, 16).astype(np.float32) if feature else None
    opt = lambda a, cv: None if a is None else cv(a)
    want = jog_params(jnp.asarray(pts), jnp.asarray(gamma),
                      opt(o, jnp.asarray), opt(f, jnp.asarray))
    got = og_params(t(pts), t(gamma), opt(o, t), opt(f, t))
    assert len(got) == len(want) == (3 if feature else 2)
    assert got[0].shape[-1] == (9 if o_score else 8)
    for g, w in zip(got, want):
        # float32 moments over 50 points
        np.testing.assert_allclose(n(g), n(w), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dst,D", [("eu", 3), ("feats", 16)])
def test_wkeans_matches_jax(dst, D):
    x = (np.random.RandomState(2).randn(2, 60, D) * 0.3).astype(np.float32)
    jg, jp, jc = jwkeans(jnp.asarray(x), 8, dst=dst)
    tg, tp, tc = wkeans(t(x), 8, dst=dst)
    # both seed at the same centre FPS (the plain loop over 16-D features)
    ids = farthest_point_sample(t(x), 8, is_center=True)
    from ogmm_tpu.ops.fps import farthest_point_sample as jfps
    np.testing.assert_array_equal(n(ids), n(jfps(jnp.asarray(x), 8, is_center=True)))
    # ten k-means trips of ten Sinkhorn trips each at epsilon 1e-2 (gamma
    # scaled by N = 60): float32 round-off of the two frameworks
    np.testing.assert_allclose(n(tg), n(jg), atol=1e-4)
    np.testing.assert_allclose(n(tp), n(jp), atol=2e-6)
    np.testing.assert_allclose(n(tc), n(jc), atol=2e-5)


@pytest.mark.parametrize("is_fast,given", [(True, False), (True, True),
                                           (False, False)])
def test_get_anchor_corrs_matches_jax(is_fast, given):
    rs = np.random.RandomState(3)
    xyz = clouds(3, N=64)
    feats = rs.randn(2, 64, 16).astype(np.float32)
    ids = rs.randint(0, 64, (2, 8)) if given else None
    want = jget_anchor_corrs(jnp.asarray(xyz), jnp.asarray(feats), 8,
                             is_fast=is_fast,
                             anchor_ids=None if ids is None else jnp.asarray(ids))
    got = get_anchor_corrs(t(xyz), t(feats), 8, is_fast=is_fast,
                           anchor_ids=None if ids is None else torch.from_numpy(ids))
    # the anchors (FPS from index 0 without a key or generator, the ids
    # given, or each k-means mean's nearest point) are the same points
    np.testing.assert_array_equal(n(got[3]), n(want[3]))
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(n(g), n(w), atol=2e-5)


@pytest.mark.parametrize("with_prob", [False, True])
def test_km_loss_and_its_gradient_match_jax(with_prob):
    rs = np.random.RandomState(4)
    pts = clouds(4, N=64)
    lg = rs.randn(2, 64, 8).astype(np.float32)
    # 0/1 probabilities: the top-k meets ties and takes the lowest indices
    prob = (rs.rand(2, 64) < 0.6).astype(np.float32) if with_prob else None
    kw = {} if prob is None else {"top_k": 32}

    def jloss(p, g):
        return jkm_loss(p, g, None if prob is None else jnp.asarray(prob), **kw)

    jl, (jgp, jgg) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(pts), jnp.asarray(lg))
    tp = t(pts).requires_grad_()
    tg = t(lg).requires_grad_()
    tl = km_loss(tp, tg, None if prob is None else t(prob), **kw)
    tl.backward()
    # 25 Sinkhorn trips at epsilon 1e-3 make the (stopped) target: ~1e-5
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-4)
    np.testing.assert_allclose(n(tg.grad), n(jgg), atol=1e-5)
    # the points reach the loss only through the stopped target
    assert tp.grad is None and not np.any(n(jgp))


def test_error_metrics_match_jax():
    from scipy.spatial.transform import Rotation
    rs = np.random.RandomState(5)
    r1 = Rotation.from_rotvec(rs.uniform(-2, 2, (6, 3))).as_matrix().astype(np.float32)
    r2 = Rotation.from_rotvec(rs.uniform(-2, 2, (6, 3))).as_matrix().astype(np.float32)
    r2[0] = r1[0]                                        # the clipped cosine
    t1, t2 = rs.randn(2, 6, 3).astype(np.float32)
    # degrees from an arccos of float32 traces; a few ulps of the norm
    np.testing.assert_allclose(n(rotation_error(t(r1), t(r2))),
                               n(jrotation_error(jnp.asarray(r1), jnp.asarray(r2))),
                               atol=1e-3)
    np.testing.assert_allclose(n(translation_error(t(t1), t(t2))),
                               n(jtranslation_error(jnp.asarray(t1), jnp.asarray(t2))),
                               rtol=1e-6)


# ------------------------------------------------------------ configs

def test_serve_preset_round_trips_through_both_packages():
    tc, jc = tconfigs.serve(), jconfigs.serve()
    assert (tc.model.em_iters, tc.model.dtype, tc.model.icp_iters) == (6, "bfloat16", 30)
    back = jconfigs.config_from_dict(json.loads(json.dumps(tconfigs.config_to_dict(tc))))
    assert back.model == jc.model and back.model_name == jc.model_name
    got = tconfigs.config_from_dict(json.loads(json.dumps(jconfigs.config_to_dict(jc))))
    assert got == tc
    assert tconfigs.serve(model_name="DeepGMR").model == tc.model


# ------------------------------------------------------- model options

@functools.lru_cache(maxsize=None)
def _variables():
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


def _pair(seed, B=2, N=96):
    from scipy.spatial.transform import Rotation
    rs = np.random.RandomState(seed)
    src = clouds(seed, B=B, N=N)
    rot = Rotation.from_rotvec(rs.uniform(-0.4, 0.4, (B, 3))).as_matrix()
    tgt = np.einsum("bij,bnj->bni", rot, src) + rs.uniform(-0.2, 0.2, (B, 1, 3))
    return src, tgt[:, rs.permutation(N)].astype(np.float32)


@pytest.mark.parametrize("option,value", [("recompute_anchors", True),
                                          ("stack_eval", False)])
def test_eval_forward_with_option_matches_jax(option, value):
    """The JAX forward with the same option; without an 'anchors' rng and a
    generator every anchor FPS starts at index 0 on both sides."""
    jm, v, tm = _models(em_iters=1, **{option: value})
    src, tgt = _pair(6)
    jr, jt, jso, jto, jclu = jm.apply(v, jnp.asarray(src), jnp.asarray(tgt),
                                      train=False)
    with torch.no_grad():
        tr, tt, tso, tto, tclu = tm(t(src), t(tgt))
    # as test_torch_model.py's one-EM-trip forward
    np.testing.assert_allclose(n(tso), n(jso), atol=1e-4)
    np.testing.assert_allclose(n(tto), n(jto), atol=1e-4)
    np.testing.assert_allclose(n(tr), n(jr), atol=2e-3)
    np.testing.assert_allclose(n(tt), n(jt), atol=2e-3)
    np.testing.assert_allclose(n(tclu), n(jclu), rtol=1e-3)


def test_recompute_anchors_draws_one_start_a_stage():
    """With a generator each stage's FPS starts from its own (2B,) draw, in
    stage order; the clustering then runs its own centre FPS."""
    _, _, tm = _models(recompute_anchors=True)
    both = t(np.concatenate(_pair(7), axis=0))
    ids, center = tm._fps(both, torch.Generator().manual_seed(3))
    assert center is None and len(ids) == 3
    g = torch.Generator().manual_seed(3)
    for stage in ids:
        assert torch.equal(stage, farthest_point_sample(both, 16, generator=g))
    assert not torch.equal(ids[0], ids[1])
    ids0, _ = tm._fps(both, None)
    assert all(torch.equal(i, ids0[0]) for i in ids0)


TINY = dict(emb_dims=32, n_clusters=8, km_clusters=8, num_heads=2, gnn_k=8,
            pos_k=4, em_iters=2, sinkhorn_iters=3, icp_iters=2)
B_T, N_T = 4, 48


def _batch(seed=0):
    from scipy.spatial.transform import Rotation
    rs = np.random.RandomState(seed)
    src = (rs.randn(B_T, N_T, 3) * 0.3).astype(np.float32)
    R = Rotation.from_euler("zyx", rs.uniform(-30, 30, (B_T, 3)),
                            degrees=True).as_matrix().astype(np.float32)
    tr = (0.2 * rs.randn(B_T, 3)).astype(np.float32)
    tgt = (np.einsum("bij,bnj->bni", R, src) + tr[:, None]).astype(np.float32)
    gt = np.concatenate([R, tr[:, :, None]], axis=-1).astype(np.float32)
    return {"src_xyz": src, "tgt_xyz": tgt,
            "src_overlap": (rs.rand(B_T, N_T) < 0.8).astype(np.float32),
            "tgt_overlap": (rs.rand(B_T, N_T) < 0.8).astype(np.float32),
            "transform_gt": gt}


def _train_cfgs(**model):
    tr = dict(n_keypoints=16)
    jc = jconfigs.mnet()
    jc = jc.replace(model=dataclasses.replace(jc.model, **TINY, **model,
                                              dgcnn_fused_train=True),
                    train=dataclasses.replace(jc.train, **tr))
    tc = tconfigs.mnet(model=tconfigs.ModelConfig(**TINY, **model))
    return jc, tc.replace(train=dataclasses.replace(tc.train, **tr))


def test_stack_train_step_matches_jax():
    """One stacked train step (stack_train=True: every BatchNorm takes the
    statistics of src and tgt at once and updates once) against
    `jax.value_and_grad` of the JAX model with the same option: loss,
    gradients and new running statistics, as test_torch_train.py holds the
    per-cloud step."""
    jc, tc = _train_cfgs(stack_train=True)
    model = JGMMReg(cfg=jc.model)
    batch = _batch()
    src, tgt = jnp.asarray(batch["src_xyz"]), jnp.asarray(batch["tgt_xyz"])
    v = jax.jit(lambda a, b: model.init({"params": jax.random.PRNGKey(0)},
                                        a, b, train=False))(src, tgt)
    v = randomise_stats(v, 0)
    g = jnp.asarray(batch["transform_gt"])
    tr = jc.train

    def loss_fn(params):
        out, mut = model.apply({"params": params,
                                "batch_stats": v["batch_stats"]},
                               src, tgt, train=True, mutable=["batch_stats"])
        rot, trans, so, to, clu = out
        loss = jcomposite(rot, trans, clu, so, to, g[..., :3, :3],
                          g[..., :3, 3], jnp.asarray(batch["src_overlap"]),
                          jnp.asarray(batch["tgt_overlap"]), src, tgt,
                          w_dcp=tr.w_dcp, w_clu=tr.w_clu, w_overlap=tr.w_overlap,
                          w_welsch=tr.w_welsch, welsch_alpha=tr.mu,
                          welsch_topk=tr.n_keypoints)
        return loss, mut["batch_stats"]

    (jl, jstats), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    from ogmm_tpu_torch.weights import flatten_variables
    want_g = flatten_variables({"params": to_plain(jgrads)})
    want_s = flatten_variables({"batch_stats": to_plain(jstats)})

    state = create_train_state(tc, steps_per_epoch=10, device="cpu",
                               state_dict=convert_variables(to_plain(v)))
    state.generator = None                   # anchors from index 0, as JAX
    loss, _ = train_loss(state, tc, batch)
    loss.backward()
    # the tolerances of test_torch_train.py's per-cloud step
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    grads = flat_variables({k: p.grad for k, p in state.model.named_parameters()})
    assert set(grads) == set(want_g)
    scale = max(np.linalg.norm(x) for x in want_g.values())
    bad = {}
    for k in grads:
        if np.linalg.norm(want_g[k]) < 1e-6 * scale:
            err = np.linalg.norm(grads[k]) / scale
            ok = err < 1e-6
        else:
            err = _rel(grads[k], want_g[k])
            ok = err < 2e-4
        if not ok:
            bad[k] = err
    assert not bad, bad
    stats = {k: x for k, x in flat_variables(state.model.state_dict()).items()
             if k.startswith("batch_stats/")}
    assert set(stats) == set(want_s)
    for k in stats:
        np.testing.assert_allclose(stats[k], want_s[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("stack_train", [False, True])
def test_remat_step_equals_the_step_without_it(stack_train):
    """remat=True recomputes the blocks' and heads' activations in the
    backward: the loss and every running statistic bit-equal to the step
    without it (each BatchNorm moved once), the gradients within 1e-6
    relative (the recompute's products may sum in another order)."""
    _, tc = _train_cfgs(stack_train=stack_train)
    _, tr = _train_cfgs(stack_train=stack_train, remat=True)
    batch = _batch(1)
    out = []
    for cfg in (tc, tr):
        state = create_train_state(cfg, steps_per_epoch=10, seed=2, device="cpu")
        state.generator = None
        calls = []
        # a pre-hook: the recompute stops once it has what the backward
        # needs, before conv1's last product returns
        state.model.conv1.register_forward_pre_hook(lambda *a: calls.append(1))
        loss, _ = train_loss(state, cfg, batch)
        forward_calls = len(calls)
        loss.backward()
        out.append((loss.item(), forward_calls, len(calls),
                    {k: p.grad.clone() for k, p in state.model.named_parameters()},
                    {k: b.clone() for k, b in state.model.named_buffers()}))
    (l0, f0, c0, g0, b0), (l1, f1, c1, g1, b1) = out
    assert l0 == l1
    # conv1 runs once a cloud (twice a step per cloud, once stacked); with
    # remat the backward runs each call again
    assert f0 == f1 == (1 if stack_train else 2) and c0 == f0 and c1 == 2 * f1
    for k in g0:
        assert _rel(g1[k], g0[k]) <= 1e-6 or \
            torch.linalg.norm(g1[k] - g0[k]) <= 1e-12, k
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k


# ------------------------------------------------- checkpoints and export

def _cli(tmp_path, *extra):
    return cli.main(["--device", "cpu", "--dataset", "synthetic",
                     "--root", "synthetic:24", "--n_points", "64",
                     "--emb_dims", "32", "--n_clusters", "8", "--km_clusters",
                     "8", "--num_heads", "2", "--gnn_k", "8",
                     "--batch_size", "8", "--test_batch_size", "4",
                     "--epochs", "1", "--steps_per_epoch", "1",
                     "--model_path", str(tmp_path / "run"), *extra])


def test_from_checkpoint_serves_the_trainers_model(tmp_path):
    trainer = _cli(tmp_path)
    root = str(tmp_path / "run")
    reg = Registrar.from_checkpoint(root, device="cpu")
    assert reg.cfg == trainer.cfg
    own = Registrar(trainer.cfg, state_dict=trainer.state.model.state_dict(),
                    device="cpu")
    src, tgt = _pair(8, N=64)
    for a, b in zip(reg(src, tgt), own(src, tgt)):
        assert torch.equal(a, b)
    # a cfg that differs in its model section raises; override_config takes it
    other = trainer.cfg.replace(model=dataclasses.replace(trainer.cfg.model,
                                                          icp_iters=3))
    with pytest.raises(ValueError, match="model"):
        Registrar.from_checkpoint(root, cfg=other, device="cpu")
    forced = Registrar.from_checkpoint(root, cfg=other, override_config=True,
                                       device="cpu")
    assert forced.cfg.model.icp_iters == 3
    wider = trainer.cfg.replace(model=dataclasses.replace(trainer.cfg.model,
                                                          emb_dims=64))
    with pytest.raises(ValueError, match="model"):
        Registrar.from_checkpoint(root, cfg=wider, device="cpu")
    # a mistyped path raises and creates nothing
    missing = tmp_path / "nothing_here"
    with pytest.raises(FileNotFoundError):
        Registrar.from_checkpoint(str(missing), device="cpu")
    assert not missing.exists()
    with pytest.raises(FileNotFoundError):
        Registrar.from_checkpoint(root, name="model_0099", device="cpu")


def test_checkpoint_directory_refuses_another_model_config(tmp_path):
    cfg = tconfigs.mnet(model=tconfigs.ModelConfig(emb_dims=32))
    mgr = CheckpointManager(str(tmp_path), cfg)
    assert mgr.load_config() == cfg
    # a changed train section updates the record
    more = cfg.replace(train=dataclasses.replace(cfg.train, lr=3e-4))
    CheckpointManager(str(tmp_path), more)
    assert mgr.load_config() == more
    # a changed model section or model name raises and leaves the record
    with pytest.raises(ValueError, match="refusing"):
        CheckpointManager(str(tmp_path), more.replace(
            model=dataclasses.replace(cfg.model, emb_dims=64)))
    with pytest.raises(ValueError, match="refusing"):
        mgr.save_config(more.replace(model_name="DeepGMR"))
    assert mgr.load_config() == more
    # the read-only probe creates no directory
    probe = tmp_path / "elsewhere"
    assert CheckpointManager.read_config_at(str(probe)) is None
    assert not probe.exists()


def test_exported_weights_serve_in_the_jax_package(tmp_path):
    jm, v, tm = _models(em_iters=1)
    cfg = tconfigs.mnet(model=tm.cfg)
    reg = Registrar(cfg, state_dict=tm.state_dict(), device="cpu")
    path = str(tmp_path / "w.npz")
    reg.export_weights(path)
    back = Registrar.from_weights(path, device="cpu")
    for k, x in reg.model.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], x), k
    variables, saved = jload_weights(path)
    assert saved.model == jconfigs.ModelConfig(**SMALL, em_iters=1)
    jreg = JRegistrar(saved, variables=variables)
    src, tgt = _pair(9)
    _, _, jso, jto = jreg(src, tgt, refine=False)
    _, _, tso, tto = reg(src, tgt, refine=False)
    # as the one-EM-trip forward against JAX
    np.testing.assert_allclose(n(tso), n(jso), atol=1e-4)
    np.testing.assert_allclose(n(tto), n(jto), atol=1e-4)
