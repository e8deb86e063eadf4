"""The port's Sinkhorn-EM (plain version on the CPU) against the JAX package:
the jnp composition `_em_jnp` and the Pallas kernel in interpret mode.

EM with eps = 1e-2 gives near-hard assignments, so two valid implementations
drift apart after about 4 trips: one trip is compared tightly, ten trips on
what the model consumes (pi, nodes) loosely."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu.ops.common import index_points as jindex
from ogmm_tpu.ops.fps import farthest_point_sample as jfps
from ogmm_tpu.ops.gmm import _em_jnp
from ogmm_tpu.ops.gmm import wkeans_plus as jwkeans_plus
from ogmm_tpu.ops.pallas_em import sinkhorn_em as jsinkhorn_em
from ogmm_tpu_torch.ops.cuda_em import sinkhorn_em, sinkhorn_em_reference
from ogmm_tpu_torch.ops.gmm import em_plain, em_route, wkeans_plus

from torch_port_util import clouds, n, t


def _inputs(seed, B=2, N=96, K=16):
    rs = np.random.RandomState(seed)
    xyz = clouds(seed, B=B, N=N)
    o = rs.rand(B, N).astype(np.float32)
    o /= o.sum(-1, keepdims=True)
    ids = jfps(jnp.asarray(xyz), K, is_center=True)
    return xyz, o, np.asarray(jindex(jnp.asarray(xyz), ids))


def test_one_trip_matches_pallas_kernel_interpreted():
    xyz, o, n0 = _inputs(0)
    want = jsinkhorn_em(jnp.asarray(xyz), jnp.asarray(o), jnp.asarray(n0),
                        iters=1, interpret=True)
    got = sinkhorn_em(t(xyz), t(o), t(n0), iters=1)
    # same schedule on both sides; exp of arguments scaled by 1/eps = 100
    # turns one float32 ulp of the cost into 1e-5 relative
    for g, w, tol in zip(got, want, (2e-5, 1e-6, 1e-5)):
        np.testing.assert_allclose(n(g), n(w), atol=tol)


def test_one_trip_matches_jnp_composition():
    xyz, o, n0 = _inputs(1)
    want = _em_jnp(jnp.asarray(xyz), jnp.asarray(o), jnp.asarray(n0), 1, 1.0)
    got = sinkhorn_em(t(xyz), t(o), t(n0), iters=1)
    # the jnp composition stays in the log domain for all Sinkhorn trips, the
    # kernel schedule leaves it after the first: 1e-4 on gamma entries
    for g, w, tol in zip(got, want, (2e-4, 1e-5, 1e-4)):
        np.testing.assert_allclose(n(g), n(w), atol=tol)


def test_ten_trips_consumed_outputs():
    xyz, o, n0 = _inputs(2)
    want = jsinkhorn_em(jnp.asarray(xyz), jnp.asarray(o), jnp.asarray(n0),
                        iters=10, interpret=True)
    gamma, pi, nodes = sinkhorn_em(t(xyz), t(o), t(n0), iters=10)
    assert torch.isfinite(gamma).all()
    # chaotic drift allowed for: cluster weights to 1e-3, centres to 1e-2 of
    # a cloud of extent ~1, on average much closer
    np.testing.assert_allclose(n(pi), n(want[1]), atol=1e-3)
    np.testing.assert_allclose(n(nodes), n(want[2]), atol=1e-2)
    assert np.abs(n(nodes) - n(want[2])).mean() < 1e-3
    assert np.abs(n(gamma) - n(want[0])).mean() < 1e-3


def test_full_width_cloud_one_trip():
    xyz, o, n0 = _inputs(3, B=1, N=717, K=128)
    want = _em_jnp(jnp.asarray(xyz), jnp.asarray(o), jnp.asarray(n0), 1, 1.0)
    got = sinkhorn_em(t(xyz), t(o), t(n0), iters=1)
    for g, w, tol in zip(got, want, (2e-4, 1e-5, 1e-4)):
        np.testing.assert_allclose(n(g), n(w), atol=tol)


def test_rows_and_marginals():
    xyz, o, n0 = _inputs(4)
    gamma, pi, nodes = sinkhorn_em_reference(t(xyz), t(o), t(n0), iters=3)
    rows = gamma.sum(-1)
    assert (rows <= 1 + 1e-5).all()         # the 1e-3 clamp only shrinks rows
    np.testing.assert_allclose(n(pi), n(gamma.mean(1)), atol=1e-7)
    assert nodes.shape == (2, 16, 3)


@pytest.mark.parametrize("iters", [1])
def test_wkeans_plus_matches_jax(iters):
    rs = np.random.RandomState(5)
    xyz = clouds(5)
    feats = rs.randn(2, 96, 32).astype(np.float32)
    scores = rs.rand(2, 96).astype(np.float32)
    want = jwkeans_plus(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(scores),
                        16, iters=iters, use_pallas=False)
    got = wkeans_plus(t(xyz), t(feats), t(scores), 16, iters=iters)
    for g, w, tol in zip(got, want, (2e-4, 1e-5, 1e-4, 1e-3)):
        np.testing.assert_allclose(n(g), n(w), atol=tol)


def test_wkeans_plus_gradient_flows_through_feats_only():
    rs = np.random.RandomState(6)
    xyz = t(clouds(6)).requires_grad_()
    feats = t(rs.randn(2, 96, 8).astype(np.float32)).requires_grad_()
    scores = t(rs.rand(2, 96).astype(np.float32)).requires_grad_()
    out = wkeans_plus(xyz, feats, scores, 16, iters=2)
    out[3].sum().backward()
    assert feats.grad is not None and xyz.grad is None and scores.grad is None
    assert not out[0].requires_grad and not out[2].requires_grad


def test_plain_route_matches_jnp_composition():
    """The plain EM route (above the kernel's envelope) is the port of
    `_em_jnp`: the same log-domain schedule, compared as tightly as the
    kernel is against its own Pallas counterpart."""
    xyz, o, n0 = _inputs(7)
    want = _em_jnp(jnp.asarray(xyz), jnp.asarray(o), jnp.asarray(n0), 1, 1.0)
    got = em_plain(t(xyz), t(o), t(n0), 1, 1.0)
    for g, w, tol in zip(got, want, (2e-5, 1e-6, 1e-5)):
        np.testing.assert_allclose(n(g), n(w), atol=tol)


def test_wkeans_plus_above_the_kernel_envelope_matches_jax():
    # a (3353, 128) plan does not fit the kernel's shared memory: both
    # packages take their plain route here (the JAX kernel would still run)
    N, K = 3353, 128
    assert em_route(N, K) == "plain"
    rs = np.random.RandomState(8)
    xyz = clouds(8, B=1, N=N)
    feats = rs.randn(1, N, 16).astype(np.float32)
    scores = rs.rand(1, N).astype(np.float32)
    want = jwkeans_plus(jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(scores),
                        K, iters=1, use_pallas=False)
    got = wkeans_plus(t(xyz), t(feats), t(scores), K, iters=1)
    for g, w, tol in zip(got, want, (2e-4, 1e-5, 1e-4, 1e-3)):
        np.testing.assert_allclose(n(g), n(w), atol=tol)
