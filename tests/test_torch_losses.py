"""The port's losses, overlap labels and metrics against the JAX package on
the CPU, on the same numpy inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ogmm_tpu import losses as jl
from ogmm_tpu.core import metrics as jmet
from ogmm_tpu_torch import losses as tl
from ogmm_tpu_torch.core import metrics as tmet

from torch_port_util import clouds, n, t


def _rot(rs, B, mag=0.5):
    from scipy.spatial.transform import Rotation
    return Rotation.from_rotvec(rs.uniform(-mag, mag, (B, 3))).as_matrix() \
        .astype(np.float32)


def _pose_pair(seed, B=3, N=64):
    """src, a rigid copy as tgt (partly replaced), and the ground truth."""
    rs = np.random.RandomState(seed)
    src = clouds(seed, B=B, N=N)
    rot, tr = _rot(rs, B), rs.uniform(-0.2, 0.2, (B, 3)).astype(np.float32)
    tgt = np.einsum("bij,bnj->bni", rot, src) + tr[:, None]
    tgt[:, : N // 4] += 1.0                      # a quarter without overlap
    return src, tgt.astype(np.float32), rot, tr


def test_dcp_loss_matches_jax():
    rs = np.random.RandomState(1)
    r1, r2 = _rot(rs, 4), _rot(rs, 4)
    t1, t2 = rs.randn(4, 3).astype(np.float32), rs.randn(4, 3).astype(np.float32)
    want = jl.dcp_loss(*(jnp.asarray(a) for a in (r1, r2, t1, t2)))
    got = tl.dcp_loss(*(t(a) for a in (r1, r2, t1, t2)))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-6)


@pytest.mark.parametrize("tau,nk", [(0.01, 12), (0.1, 5)])
def test_con_loss_matches_jax(tau, nk):
    rs = np.random.RandomState(2)
    x = rs.randn(2, nk, 16).astype(np.float32)
    y = rs.randn(2, nk, 16).astype(np.float32)
    want = jl.con_loss(jnp.asarray(x), jnp.asarray(y), tau=tau)
    got = tl.con_loss(t(x), t(y), tau=tau)
    # logits up to 1/tau = 100: float32 round-off of a logsumexp there
    np.testing.assert_allclose(n(got), n(want), rtol=2e-5)


def test_clu_loss_and_its_gradient_match_jax():
    rs = np.random.RandomState(3)
    xyz = clouds(3, B=2, N=50)
    nodes = clouds(4, B=2, N=8)
    feats = rs.randn(2, 50, 16).astype(np.float32)
    gamma = rs.rand(2, 50, 8).astype(np.float32)
    gamma /= gamma.sum(-1, keepdims=True)
    f = lambda fe: jl.clu_loss(jnp.asarray(xyz), jnp.asarray(nodes), fe,
                               jnp.asarray(gamma), tau=0.1)
    want, jg = jax.value_and_grad(f)(jnp.asarray(feats))
    ft = t(feats).requires_grad_(True)
    got = tl.clu_loss(t(xyz), t(nodes), ft, t(gamma), tau=0.1)
    got.backward()
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5)
    np.testing.assert_allclose(n(ft.grad), n(jg), rtol=1e-4, atol=1e-6)


def test_top_k_keeps_the_lowest_indices_among_ties():
    labels = np.array([[0, 1, 1, 0, 1, 1, 0, 1]], np.float32)
    want = jax.lax.top_k(jnp.asarray(labels), 3)[1]
    got = tl.top_k_indices(t(labels), 3)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    assert n(got).tolist() == [[1, 2, 4]]


@pytest.mark.parametrize("labels", ["tied", "random", "none"])
def test_welsch_loss_and_its_gradient_match_jax(labels):
    src, tgt, rot, tr = _pose_pair(5, B=2, N=64)
    rs = np.random.RandomState(5)
    if labels == "tied":        # 0/1 labels: nearly every entry ties
        so = (rs.rand(2, 64) < 0.7).astype(np.float32)
        to = (rs.rand(2, 64) < 0.7).astype(np.float32)
    else:
        so, to = rs.rand(2, 64).astype(np.float32), rs.rand(2, 64).astype(np.float32)
    lab = (None, None) if labels == "none" else (so, to)
    pose = np.concatenate([rot, tr[:, :, None]], -1)

    def f(p):
        return jl.welsch_loss(jnp.asarray(src), jnp.asarray(tgt), p,
                              *(None if a is None else jnp.asarray(a) for a in lab),
                              alpha=0.3, top_k=24)
    want, jg = jax.value_and_grad(f)(jnp.asarray(pose))
    pt = t(pose).requires_grad_(True)
    got = tl.welsch_loss(t(src), t(tgt), pt,
                         *(None if a is None else t(a) for a in lab),
                         alpha=0.3, top_k=24)
    got.backward()
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5)
    np.testing.assert_allclose(n(pt.grad), n(jg), rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("thresh", [0.05, 0.2])
def test_overlap_labels_device_matches_jax(thresh):
    src, tgt, rot, tr = _pose_pair(6)
    want = jl.overlap_labels_device(*(jnp.asarray(a) for a in (src, tgt, rot, tr)),
                                    thresh=thresh)
    got = tl.overlap_labels_device(*(t(a) for a in (src, tgt, rot, tr)),
                                   thresh=thresh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(n(g), n(w))
    assert 0 < n(got[0]).mean() < 1 and 0 < n(got[1]).mean() < 1


def test_overlap_loss_matches_jax():
    rs = np.random.RandomState(7)
    a, b = rs.rand(3, 40).astype(np.float32), rs.rand(3, 40).astype(np.float32)
    np.testing.assert_allclose(n(tl.overlap_loss(t(a), t(b))),
                               n(jl.overlap_loss(jnp.asarray(a), jnp.asarray(b))),
                               rtol=1e-6)


@pytest.mark.parametrize("clu", [0.7, float("nan")])
def test_composite_loss_and_its_gradients_match_jax(clu):
    src, tgt, rot_gt, tr_gt = _pose_pair(8, B=2, N=48)
    rs = np.random.RandomState(8)
    rot, tr = _rot(rs, 2, 0.2) @ rot_gt, tr_gt + 0.05 * rs.randn(2, 3).astype(np.float32)
    so_p, to_p = rs.rand(2, 48).astype(np.float32), rs.rand(2, 48).astype(np.float32)
    so, to = (rs.rand(2, 48) < 0.8).astype(np.float32), (rs.rand(2, 48) < 0.8).astype(np.float32)
    kw = dict(welsch_topk=20)

    def f(r, tt, c, a, b):
        return jl.composite_loss(r, tt, c, a, b, jnp.asarray(rot_gt),
                                 jnp.asarray(tr_gt), jnp.asarray(so),
                                 jnp.asarray(to), jnp.asarray(src),
                                 jnp.asarray(tgt), **kw)
    args = [rot.astype(np.float32), tr.astype(np.float32), np.float32(clu), so_p, to_p]
    want, jg = jax.value_and_grad(f, argnums=(0, 1, 3, 4))(
        *(jnp.asarray(a) for a in args))
    targs = [t(a).requires_grad_(True) for a in args]
    got = tl.composite_loss(targs[0], targs[1], targs[2], targs[3], targs[4],
                            t(rot_gt), t(tr_gt), t(so), t(to), t(src), t(tgt), **kw)
    got.backward()
    assert np.isfinite(n(got))
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5)
    for i, g in zip((0, 1, 3, 4), jg):
        np.testing.assert_allclose(n(targs[i].grad), n(g), rtol=1e-3, atol=1e-6)


def test_dcp_metrics_and_summary_match_jax():
    src, tgt, rot_gt, tr_gt = _pose_pair(9, B=4, N=64)
    rs = np.random.RandomState(9)
    rot = (_rot(rs, 4, 0.05) @ rot_gt).astype(np.float32)
    tr = (tr_gt + 0.02 * rs.randn(4, 3)).astype(np.float32)
    want = jmet.dcp_metrics(*(jnp.asarray(a) for a in (src, tgt, rot_gt, tr_gt,
                                                       rot, tr)))
    got = tmet.dcp_metrics(*(t(a) for a in (src, tgt, rot_gt, tr_gt, rot, tr)))
    assert set(got) == set(want)
    for k in want:
        # angles through arccos near 1 and euler conversions: degrees to
        # 1e-3; distances to float32 round-off
        np.testing.assert_allclose(n(got[k]), n(want[k]), rtol=1e-3, atol=2e-4,
                                   err_msg=k)
    js = jmet.summarize_metrics({k: np.asarray(v) for k, v in want.items()})
    ts = tmet.summarize_metrics({k: n(v) for k, v in want.items()})
    assert js == ts
    assert set(ts) >= {"r_rmse", "err_r_deg_mean", "err_t_rmse", "n_correct"}
