"""Data-parallel training of the port over `torch.distributed` on the CPU:
the step at world 2 and 4 (gloo ranks of `parallel.launch.run_ranks`, a
global batch of 8 pairs) against the JAX single-device step on the global
batch (the port's weights and statistics carried across) and against the
port's own single-process step; the per-process batch slicing against the
JAX package's; `init_distributed` on a single process; `--multihost`
through the CLI at world 2.

The global BatchNorm statistics are what makes the step equal to the
single-process one: per-process statistics (torch DDP's default) would give
another loss and other running statistics. Ranks are spawned once per
world size in a module fixture (`tests/torch_dist_cases.py:dp_cases`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu import configs as jconfigs
from ogmm_tpu.losses import composite_loss as jcomposite
from ogmm_tpu.nn.gmmreg import GMMReg as JGMMReg
from ogmm_tpu.train.distributed import \
    shard_batch_for_process as jshard_batch_for_process
from ogmm_tpu_torch.parallel.launch import run_ranks
from ogmm_tpu_torch.train.distributed import (assemble_global_batch,
                                              init_distributed,
                                              shard_batch_for_process)
from ogmm_tpu_torch.weights import (convert_variables, flat_variables,
                                    flatten_variables)

import torch_dist_cases as cases
from torch_port_util import randomise_stats, to_plain

B, N = 8, 48
WORLDS = (2, 4)
LR = 1e-4                       # the recipe's Adam learning rate
TINY = ["--emb_dims", "32", "--n_clusters", "8", "--km_clusters", "8",
        "--num_heads", "2", "--gnn_k", "8"]


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    from scipy.spatial.transform import Rotation
    src = (rs.randn(B, N, 3) * 0.3).astype(np.float32)
    R = Rotation.from_euler("zyx", rs.uniform(-30, 30, (B, 3)),
                            degrees=True).as_matrix().astype(np.float32)
    tr = (0.2 * rs.randn(B, 3)).astype(np.float32)
    tgt = (np.einsum("bij,bnj->bni", R, src) + tr[:, None]).astype(np.float32)
    gt = np.concatenate([R, tr[:, :, None]], axis=-1).astype(np.float32)
    return {"src_xyz": src, "tgt_xyz": tgt,
            "src_overlap": (rs.rand(B, N) < 0.8).astype(np.float32),
            "tgt_overlap": (rs.rand(B, N) < 0.8).astype(np.float32),
            "transform_gt": gt}


@pytest.fixture(scope="module")
def jax_step():
    """One seeded JAX init (BatchNorm statistics randomised) and the JAX
    loss, gradients and new running statistics of one step on the global
    batch (the custom-VJP DGCNN, the port's default route)."""
    jc = jconfigs.mnet()
    jc = jc.replace(model=dataclasses.replace(jc.model, **cases.DP_MODEL,
                                              dgcnn_fused_train=True),
                    train=dataclasses.replace(jc.train, **cases.DP_TRAIN))
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
    state = {k: x.numpy() for k, x in
             convert_variables(to_plain(v)).items()}
    flat = lambda tree, coll: flatten_variables({coll: to_plain(tree)})
    return dict(batch=batch, state=state, loss=float(loss),
                grads=flat(grads, "params"), stats=flat(stats, "batch_stats"))


@pytest.fixture(scope="module")
def single(jax_step):
    """The port's single-process step of each case the ranks run."""
    s, b = jax_step["state"], jax_step["batch"]
    return {"fused": cases.dp_step(s, b, None),
            "unfused": cases.dp_step(s, b, None, dgcnn_fused_train=False),
            "generator": cases.dp_step(s, b, None, seed=5,
                                       with_generator=True)}


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def ranks(request, jax_step, tmp_path_factory):
    world = request.param
    path = tmp_path_factory.mktemp(f"cli_world{world}")
    argv = ["--multihost", "--device", "cpu", "--dataset", "synthetic",
            "--root", "synthetic:24", "--n_points", "64", *TINY,
            "--batch_size", "8", "--test_batch_size", "4", "--epochs", "1",
            "--steps_per_epoch", "2", "--model_path", str(path)]
    res = run_ranks(cases.dp_cases, world, args=(
        jax_step["state"], jax_step["batch"], argv), timeout=300)
    return world, res, path


def _flat(arrays):
    """The port's named arrays under the JAX package's flat names."""
    return flat_variables({k: torch.from_numpy(v) for k, v in arrays.items()})


def _grads_close(got, want, rel):
    """Gradients zero in exact arithmetic (a bias before a batch or
    instance norm, attention's key bias) are round-off on both sides: held
    below 1e-6 of the largest gradient; every other one to `rel`."""
    assert set(got) == set(want)
    scale = max(np.linalg.norm(g) for g in want.values())
    bad = {}
    for k in got:
        if np.linalg.norm(want[k]) < 1e-6 * scale:
            err = np.linalg.norm(got[k]) / scale
            ok = err < 1e-6
        else:
            err = (np.linalg.norm(got[k] - want[k])
                   / np.linalg.norm(want[k]))
            ok = err < rel
        if not ok:
            bad[k] = err
    assert not bad, bad


def test_step_matches_jax_single_device_step(ranks, jax_step, single):
    """Loss, every gradient and every running statistic of the port's step
    at world W against the JAX step on the global batch. Loss and
    statistics at tests/test_torch_train.py's limits. The gradients: at
    this batch the port's single-process step is itself up to 7.5e-3 off
    JAX's in the overlap heads' small gradients (elements within round-off
    of a ReLU kink take other branches: ROADMAP.md C, "Kinks"; 2e-4
    elsewhere), so each gradient of the step at world W is held within
    the single-process step's own distance from JAX plus 1e-3, and all of
    them together within 1e-3."""
    _, res, _ = ranks
    metrics, grads, sd = res[0]["fused"]
    np.testing.assert_allclose(metrics["loss"][0], jax_step["loss"], rtol=1e-4)
    assert metrics["loss"].shape == (B,)
    got, want = _flat(grads), jax_step["grads"]
    own = _flat(single["fused"][1])
    assert set(got) == set(want)
    scale = max(np.linalg.norm(g) for g in want.values())
    rel = lambda a, k: np.linalg.norm(a[k] - want[k]) / np.linalg.norm(want[k])
    bad = {}
    for k in got:
        if np.linalg.norm(want[k]) < 1e-6 * scale:
            if np.linalg.norm(got[k]) >= 1e-6 * scale:
                bad[k] = np.linalg.norm(got[k]) / scale
        elif rel(got, k) > rel(own, k) + 1e-3:
            bad[k] = (rel(got, k), rel(own, k))
    assert not bad, bad
    cat = lambda d: np.concatenate([d[k].ravel() for k in sorted(want)])
    assert np.linalg.norm(cat(got) - cat(want)) < 1e-3 * np.linalg.norm(cat(want))
    stats = {k: v for k, v in _flat(sd).items()
             if k.startswith("batch_stats/")}
    assert set(stats) == set(jax_step["stats"])
    for k in stats:
        np.testing.assert_allclose(stats[k], jax_step["stats"][k], rtol=1e-4,
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("case", ["fused", "unfused", "generator"])
def test_step_matches_single_process_step(ranks, single, case):
    """The port's step at world W against its single-process step on the
    same global batch, for the custom-VJP DGCNN, the unfused DGCNN (the
    autograd BatchNorm) and random FPS starts from a seeded generator:
    the loss to 1e-5; the per-sample pose metrics to 1e-4 relative and
    2e-3 absolute (the pose passes the cluster features through a softmax
    at temperature 0.05, which turns the round-off of two-pass global
    moments against one pass into ~8e-4 degrees); all gradients together
    to 1e-3 relative (measured 5e-5 to 7e-5) and each to 1e-2 (the overlap
    heads' small gradients flip a ReLU branch on round-off: 5e-3 measured
    at world 4, the kink where the port's and JAX's single-process steps
    part too); the running statistics to 1e-5; the parameters after one
    Adam step within 2.5 times the learning rate (Adam's first step moves
    a parameter by +-lr whatever its gradient's size, so a round-off
    gradient may move either way)."""
    _, res, _ = ranks
    metrics, grads, sd = res[0][case]
    want_m, want_g, want_sd = single[case]
    assert set(metrics) == set(want_m)
    for k in ("loss", "clu_loss"):
        np.testing.assert_allclose(metrics[k], want_m[k], rtol=1e-5, err_msg=k)
    for k in metrics:
        assert metrics[k].shape == want_m[k].shape, k
        np.testing.assert_allclose(metrics[k], want_m[k], rtol=1e-4, atol=2e-3,
                                   err_msg=k)
    _grads_close(grads, want_g, 1e-2)
    cat = lambda d: np.concatenate([d[k].ravel() for k in sorted(want_g)])
    assert (np.linalg.norm(cat(grads) - cat(want_g))
            < 1e-3 * np.linalg.norm(cat(want_g)))
    for k in sd:
        if k.endswith(("_mean", "_var")):
            np.testing.assert_allclose(sd[k], want_sd[k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(sd[k], want_sd[k], atol=2.5 * LR,
                                       err_msg=k)


@pytest.mark.parametrize("case", ["fused", "unfused", "generator"])
def test_ranks_hold_bit_equal_parameters_and_statistics(ranks, case):
    _, res, _ = ranks
    sd0 = res[0][case][2]
    for r in res[1:]:
        for k, v in r[case][2].items():
            np.testing.assert_array_equal(v, sd0[k], err_msg=k)


def test_backward_kernels_refuse_the_group(ranks):
    """`BWD_KERNELS` on under W > 1 raises; the plain backward never runs
    in its place silently."""
    _, res, _ = ranks
    got = res[0]["bwd_kernels"]
    assert got is not None and got[0] == "ValueError" \
        and "BWD_KERNELS" in got[1], got


def test_cli_multihost_trains_and_rank0_alone_writes(ranks):
    """`--multihost` under W spawned CPU ranks: two steps and an eval
    batch on every rank (at W = 4 one eval row a rank), the same parameters
    on every rank, the checkpointer on rank 0 only, and its files there."""
    world, res, path = ranks
    clis = [r["cli"] for r in res]
    assert [c["writer"] for c in clis] == [True] + [False] * (world - 1)
    assert all(c["step"] == 2 for c in clis)
    assert np.isfinite(clis[0]["loss"]) and np.isfinite(clis[0]["val_loss"])
    for c in clis[1:]:
        assert c["loss"] == clis[0]["loss"]
        for k, v in c["params"].items():
            np.testing.assert_array_equal(v, clis[0]["params"][k], err_msg=k)
    models = path / "checkpoints" / "GMMReg" / "models"
    assert (models / "optim_model.pt").exists()
    assert (path / "GMMReg" / "train.log").exists()


@pytest.mark.parametrize("n", [2, 4])
def test_shard_batch_for_process_matches_jax(n):
    batch = {k: np.arange(8 * 3).reshape(8, 3) + i
             for i, k in enumerate(("src_xyz", "tgt_xyz"))}
    for idx in range(n):
        got = shard_batch_for_process(batch, 8, process_count=n,
                                      process_index=idx)
        want = jshard_batch_for_process(batch, 8, process_count=n,
                                        process_index=idx)
        for k in batch:
            np.testing.assert_array_equal(got[k], want[k])
        local = assemble_global_batch(batch, "cpu", n, idx)
        np.testing.assert_array_equal(local["src_xyz"].numpy(),
                                      want["src_xyz"].astype(np.float32))


def test_assemble_global_batch_refuses_an_uneven_batch():
    batch = {"src_xyz": np.zeros((6, 3))}
    with pytest.raises(ValueError, match="equal"):
        assemble_global_batch(batch, "cpu", process_count=4, process_index=0)


def test_init_distributed_is_a_no_op_on_a_single_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_init_distributed_joins_a_group_of_one(tmp_path):
    """The explicit form (the JAX signature's overrides, a file:// init
    method): gloo where the CPU is asked for."""
    dist = torch.distributed
    try:
        assert init_distributed(f"file://{tmp_path}/rdzv", 1, 0,
                                device="cpu", timeout_s=60) is True
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        assert init_distributed() is True           # already initialised
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
