"""The port's training step, optimizer, eval step and checkpoints against the
JAX package on the CPU.

One train step from the same weights and batch: the loss, every gradient and
every updated running statistic against `jax.value_and_grad` of the
composite loss through `model.apply(train=True, mutable=['batch_stats'])`
without an 'anchors' rng (both sides start the anchor FPS at index 0). The
JAX model forces its custom-VJP DGCNN (`dgcnn_fused_train=True`), the path
it takes by default on the accelerator and the one the port runs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ogmm_tpu import configs as jconfigs
from ogmm_tpu.losses import composite_loss as jcomposite
from ogmm_tpu.nn.gmmreg import GMMReg as JGMMReg
from ogmm_tpu.train.checkpoint import load_weights as jload_weights
from ogmm_tpu.train.state import TrainState as JTrainState
from ogmm_tpu.train.state import make_optimizer as jmake_optimizer
from ogmm_tpu.train.trainer import make_eval_step as jmake_eval_step
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch.train import (CheckpointManager, Trainer,
                                  create_train_state, export_weights,
                                  make_eval_step, make_optimizer,
                                  make_train_step, restore_checkpoint,
                                  save_checkpoint, train_loss)
from ogmm_tpu_torch.weights import convert_variables, flat_variables

from torch_port_util import n, randomise_stats, to_plain

TINY_MODEL = dict(emb_dims=32, n_clusters=8, km_clusters=8, num_heads=2,
                  gnn_k=8, pos_k=4, em_iters=2, sinkhorn_iters=3, icp_iters=2)
B, N = 4, 48


def _cfgs(model=None, **train):
    tr = dict(n_keypoints=16, **train)
    tiny = {**TINY_MODEL, **(model or {})}
    jc = jconfigs.mnet()
    jc = jc.replace(model=dataclasses.replace(jc.model, **tiny,
                                              dgcnn_fused_train=True),
                    train=dataclasses.replace(jc.train, **tr))
    tc = tconfigs.mnet(model=tconfigs.ModelConfig(**tiny))
    tc = tc.replace(train=dataclasses.replace(tc.train, **tr))
    return jc, tc


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    from scipy.spatial.transform import Rotation
    src = (rs.randn(B, N, 3) * 0.3).astype(np.float32)
    R = Rotation.from_euler("zyx", rs.uniform(-30, 30, (B, 3)),
                            degrees=True).as_matrix().astype(np.float32)
    tr = (0.2 * rs.randn(B, 3)).astype(np.float32)
    tgt = (np.einsum("bij,bnj->bni", R, src) + tr[:, None]).astype(np.float32)
    gt = np.concatenate([R, tr[:, :, None]], axis=-1).astype(np.float32)
    # 0/1 labels, so that the Welsch top-k meets ties
    return {"src_xyz": src, "tgt_xyz": tgt,
            "src_overlap": (rs.rand(B, N) < 0.8).astype(np.float32),
            "tgt_overlap": (rs.rand(B, N) < 0.8).astype(np.float32),
            "transform_gt": gt}


@pytest.fixture(scope="module")
def jax_step():
    """One seeded JAX init (BatchNorm statistics randomised) and the JAX
    loss, gradients and new running statistics of one step."""
    return _jax_step()


def _jax_step(**model):
    jc, tc = _cfgs(model)
    model = JGMMReg(cfg=jc.model)
    batch = _batch()
    src, tgt = jnp.asarray(batch["src_xyz"]), jnp.asarray(batch["tgt_xyz"])
    v = jax.jit(lambda a, b: model.init({"params": jax.random.PRNGKey(0)},
                                        a, b, train=False))(src, tgt)
    v = randomise_stats(v, 0)
    g = jnp.asarray(batch["transform_gt"])
    t = jc.train

    def loss_fn(params):
        out, mut = model.apply({"params": params,
                                "batch_stats": v["batch_stats"]},
                               src, tgt, train=True, mutable=["batch_stats"])
        rot, trans, so, to, clu = out
        loss = jcomposite(rot, trans, clu, so, to, g[..., :3, :3],
                          g[..., :3, 3], jnp.asarray(batch["src_overlap"]),
                          jnp.asarray(batch["tgt_overlap"]), src, tgt,
                          w_dcp=t.w_dcp, w_clu=t.w_clu, w_overlap=t.w_overlap,
                          w_welsch=t.w_welsch, welsch_alpha=t.mu,
                          welsch_topk=t.n_keypoints)
        return loss, mut["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        v["params"])
    return dict(jc=jc, tc=tc, model=model, variables=to_plain(v), batch=batch,
                loss=float(loss), grads=flat_variables_jax(grads, "params"),
                stats=flat_variables_jax(stats, "batch_stats"))


def flat_variables_jax(tree, coll):
    from ogmm_tpu_torch.weights import flatten_variables
    return flatten_variables({coll: to_plain(tree)})


def _port_state(d, **kw):
    return create_train_state(d["tc"], steps_per_epoch=10, device="cpu",
                              state_dict=convert_variables(d["variables"]),
                              **kw)


def _rel(a, b):
    return np.linalg.norm(n(a) - n(b)) / (np.linalg.norm(n(b)) + 1e-30)


def test_one_train_step_matches_jax_value_and_grad(jax_step):
    _check_one_step(jax_step)


def test_one_train_step_matches_jax_at_gnn_k40():
    # the DGCNN authors' k = 40: graph_stage1 (on the card its wide
    # selection) writes 40 edge rows a point, the backward is the plain one
    _check_one_step(_jax_step(gnn_k=40))


def _check_one_step(d):
    state = _port_state(d)
    state.generator = None                   # anchors from index 0, as JAX
    loss, _ = train_loss(state, d["tc"], d["batch"])
    loss.backward()
    # two EM trips and a softmax at temperature 0.05 over cluster features:
    # float32 round-off of the two frameworks grows to ~1e-4 relative
    np.testing.assert_allclose(loss.item(), d["loss"], rtol=1e-4)
    grads = flat_variables({k: p.grad for k, p in
                            state.model.named_parameters()})
    assert set(grads) == set(d["grads"])
    # gradients that are zero in exact arithmetic (a bias right before a
    # batch or instance norm, the key bias of a softmax) are round-off on
    # both sides: held below 1e-6 of the largest gradient; every other one
    # to 2e-4 relative (measured ~2e-5)
    scale = max(np.linalg.norm(g) for g in d["grads"].values())
    bad = {}
    for k in grads:
        if np.linalg.norm(d["grads"][k]) < 1e-6 * scale:
            err = np.linalg.norm(grads[k]) / scale
            ok = err < 1e-6
        else:
            err = _rel(grads[k], d["grads"][k])
            ok = err < 2e-4
        if not ok:
            bad[k] = err
    assert not bad, bad
    # every running statistic after one step: each BatchNorm updated once
    # per cloud (src then tgt)
    stats = {k: v for k, v in flat_variables(state.model.state_dict()).items()
             if k.startswith("batch_stats/")}
    assert set(stats) == set(d["stats"])
    for k in stats:
        np.testing.assert_allclose(stats[k], d["stats"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


def test_adam_and_milestones_match_optax():
    """Feed both optimizers the same gradients over six updates across two
    milestones (epochs 1 and 2 at 2 steps an epoch): the same parameters."""
    _, tc = _cfgs(lr=1e-2, weight_decay=0.1, lr_milestones=(1, 2))
    jc = jconfigs.mnet()
    jc = jc.replace(train=dataclasses.replace(
        jc.train, lr=1e-2, weight_decay=0.1, lr_milestones=(1, 2)))
    rs = np.random.RandomState(4)
    p0 = {"a": rs.randn(5, 3).astype(np.float32), "b": rs.randn(7).astype(np.float32)}
    tx = jmake_optimizer(jc, steps_per_epoch=2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, sched = make_optimizer(list(tp.values()), tc, steps_per_epoch=2)
    lrs = []
    for _ in range(6):
        g = {k: rs.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        lrs.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
        for k in p0:
            np.testing.assert_allclose(n(tp[k]), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_allclose(lrs, [1e-2, 1e-2, 1e-3, 1e-3, 1e-4, 1e-4],
                               rtol=1e-6)


def test_loss_descends_and_the_light_step(jax_step):
    d = jax_step
    state = _port_state(d, seed=3)
    step = make_train_step(d["tc"])
    losses = [step(state, d["batch"])["loss"][0].item() for _ in range(4)]
    assert losses[-1] < losses[0], losses
    assert state.step == 4
    light = make_train_step(d["tc"], with_metrics=False)
    before = state.model.dgcnn.w1.detach().clone()
    m = light(state, d["batch"])
    assert set(m) == {"loss", "clu_loss"} and m["loss"].shape == (B,)
    assert not torch.equal(before, state.model.dgcnn.w1)
    full = step(state, d["batch"])
    assert {"r_mae", "pcab_dist", "n_correct", "loss"} <= set(full)
    assert all(torch.isfinite(v).all() for v in full.values())


def test_eval_step_matches_jax(jax_step):
    d = jax_step
    jc, tc = d["jc"], d["tc"]
    v = d["variables"]
    jstate = JTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                         batch_stats=v["batch_stats"], opt_state=None,
                         rng=jax.random.PRNGKey(0))
    batch = {k: jnp.asarray(a) for k, a in d["batch"].items()}
    want = jmake_eval_step(d["model"], jc)(jstate, batch)
    state = _port_state(d)
    got = make_eval_step(tc)(state, d["batch"])
    assert state.model.training             # the eval step restores the mode
    assert set(got) == set(want)
    np.testing.assert_allclose(n(got["loss"]), n(want["loss"]), rtol=1e-3)
    # metrics after two EM trips and two ICP trips: degrees to 0.05,
    # squared distances to 1e-4; the clipped chamfer takes square roots of
    # squared distances near 0 (an exact copy aligned), where float32
    # round-off of ~1e-8 becomes ~1e-4
    for k in want:
        tol = {"clip_chamfer_dist": 5e-4}.get(k, 1e-4)
        if k.startswith("r_") or k == "err_r_deg":
            tol = 0.05
        np.testing.assert_allclose(n(got[k]), n(want[k]), atol=tol, rtol=1e-3,
                                   err_msg=k)


def test_checkpoint_round_trip(jax_step, tmp_path):
    d = jax_step
    tc = d["tc"]
    step = make_train_step(tc)
    a = _port_state(d, seed=5)
    step(a, d["batch"])
    path = str(tmp_path / "ck.pt")
    save_checkpoint(path, a, tc)
    b = _port_state(d, seed=6)
    assert restore_checkpoint(path, b) == tc
    assert b.step == a.step == 1
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    ma, mb = step(a, d["batch"]), step(b, d["batch"])
    assert torch.equal(ma["loss"], mb["loss"])
    for (ka, va), (_, vb) in zip(a.model.state_dict().items(),
                                 b.model.state_dict().items()):
        assert torch.equal(va, vb), ka
    mgr = CheckpointManager(str(tmp_path), tc)
    assert not mgr.has_best()
    mgr.save_best(a, 0)
    assert mgr.has_best() and mgr.restore(b) == tc


def test_trainer_fit_tracks_the_best_pcab(jax_step, tmp_path):
    d = jax_step
    tc = d["tc"].replace(train=dataclasses.replace(d["tc"].train, epochs=2,
                                                   metrics_every=2,
                                                   save_every=1))
    mgr = CheckpointManager(str(tmp_path), tc)
    trainer = Trainer(tc, _port_state(d, seed=7), checkpointer=mgr)
    hist = trainer.fit([d["batch"], _batch(1)], [d["batch"]])
    assert len(hist) == 2 and all("val" in h for h in hist)
    assert np.isfinite(hist[-1]["train"]["loss"])
    assert "r_mae" in hist[0]["train"]          # metric strides sampled
    assert trainer.best["pcab_dist"] == min(h["val"]["pcab_dist"] for h in hist)
    assert mgr.has_best()
    assert (tmp_path / "checkpoints/GMMReg/models/model_0002.pt").exists()


def test_export_weights_loads_into_the_jax_package(jax_step, tmp_path):
    """Port weights after a train step -> the JAX package's .npz -> its
    loader -> its eval forward equals the port's."""
    d = jax_step
    state = _port_state(d, seed=8)
    make_train_step(d["tc"])(state, d["batch"])
    path = str(tmp_path / "w.npz")
    export_weights(state.model, path, d["tc"])
    variables, cfg = jload_weights(path)
    assert cfg is not None and cfg.model.emb_dims == TINY_MODEL["emb_dims"]
    assert cfg.train.n_keypoints == 16
    jm = JGMMReg(cfg=dataclasses.replace(cfg.model, em_iters=1))
    src, tgt = d["batch"]["src_xyz"], d["batch"]["tgt_xyz"]
    _, _, jso, jto, jclu = jax.jit(lambda v, a, b: jm.apply(v, a, b, train=False))(
        variables, jnp.asarray(src), jnp.asarray(tgt))
    model = state.model
    model.cfg = dataclasses.replace(model.cfg, em_iters=1)
    model.eval()
    with torch.no_grad():
        _, _, tso, tto, tclu = model(torch.from_numpy(src), torch.from_numpy(tgt))
    np.testing.assert_allclose(n(tso), n(jso), atol=1e-4)
    np.testing.assert_allclose(n(tto), n(jto), atol=1e-4)
    np.testing.assert_allclose(n(tclu), n(jclu), rtol=1e-3)
