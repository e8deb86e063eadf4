"""Point-to-plane ICP, the normals it estimates, the grid 1-NN and the grid
ICPs of the port against the JAX package on the CPU.

The clouds are noisy height fields (a smooth surface: each point's
neighbourhood is flat, so its normal is well defined) and rigid copies of
them, moved a few degrees off. Three sizes take the three 1-NN routes of an
ICP trip: N = M = 128 the dense matrix, 1,500 the `nn1` kernel's envelope
(its plain version here), 4,500 the spatial route (Morton-sorted clouds,
the streamed 1-NN's plain version with the gate). The JAX package runs its
plain routes (the dense matrix at every size here)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu.core import se3 as jse3
from ogmm_tpu.ops.grid_nn import build_grid as jbuild_grid
from ogmm_tpu.ops.grid_nn import nn1_radius as jnn1_radius
from ogmm_tpu.ops.icp import estimate_normals_knn as jnormals
from ogmm_tpu.ops.icp import icp_point_to_plane as jplane
from ogmm_tpu.ops.icp import icp_point_to_point as jpoint
from ogmm_tpu.ops.icp import refine_registration as jrefine
from ogmm_tpu_torch.core import se3 as tse3
from ogmm_tpu_torch.ops.common import knn, nn1_route
from ogmm_tpu_torch.ops.grid_nn import build_grid, nn1_radius
from ogmm_tpu_torch.ops.icp import (_rodrigues, estimate_normals_knn,
                                    icp_point_to_plane, icp_point_to_point,
                                    refine_registration)

from torch_port_util import assert_same_up_to_ties, n, t

VOXEL = 0.035                    # the gate is 2 voxels, as in a request


def surface(rs, B, N):
    """Noisy height fields over a square sized for ~4,500 points a unit
    square (the spacing stays below the gate at every N)."""
    side = np.sqrt(N / 4500.0)
    u = rs.rand(B, N, 2) * side
    z = 0.3 * np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    return (np.concatenate([u, z], -1) + 0.002 * rs.randn(B, N, 3)).astype(np.float32)


def _rot(rs, B, deg):
    from scipy.spatial.transform import Rotation
    v = rs.randn(B, 3)
    v *= np.radians(deg) / np.linalg.norm(v, axis=1, keepdims=True)
    return Rotation.from_rotvec(v).as_matrix().astype(np.float32)


def _problem(seed, B, N):
    """src, tgt = R src + t (permuted), the true (R, t) and a start 2 degrees
    and 0.01 off it."""
    rs = np.random.RandomState(seed)
    src = surface(rs, B, N)
    rot = _rot(rs, B, 20.0)
    tr = rs.uniform(-0.2, 0.2, (B, 3)).astype(np.float32)
    tgt = (np.einsum("bij,bnj->bni", rot, src) + tr[:, None])
    tgt = tgt[:, rs.permutation(N)].astype(np.float32)
    rot0 = np.einsum("bij,bjk->bik", _rot(rs, B, 2.0), rot).astype(np.float32)
    tr0 = (tr + rs.uniform(-0.01, 0.01, (B, 3))).astype(np.float32)
    return src, tgt, rot, tr, rot0, tr0


def _angle_deg(a, b):
    c = (np.einsum("bij,bij->b", n(a), n(b)) - 1) / 2
    return np.degrees(np.arccos(np.clip(c, -1, 1)))


SIZES = [(3, 128), (1, 1500), (1, 4500)]     # dense, kernel, spatial routes


def test_the_sizes_take_the_three_routes():
    routes = [nn1_route(B, N, N, 3, prefer_dense=True) for B, N in SIZES]
    assert routes == ["dense", "kernel", "stream"]


def test_rodrigues_is_the_exponential_map():
    rs = np.random.RandomState(0)
    w = rs.randn(5, 3).astype(np.float32) * 0.3
    w[0] = 0.0                                          # the small-angle branch
    w[1] = 1e-9
    got = n(_rodrigues(t(w)))
    want = np.stack([_expm(v) for v in w.astype(np.float64)])
    # float32 sin/cos of angles up to ~0.8
    np.testing.assert_allclose(got, want, atol=2e-6)


def _expm(v):
    from scipy.linalg import expm
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return expm(K)


@pytest.mark.parametrize("B,N", [(2, 300), (1, 4500)])
def test_normals_match_jax(B, N):
    x = surface(np.random.RandomState(1), B, N)
    got = n(estimate_normals_knn(t(x), k=16))
    want = n(jnormals(jnp.asarray(x), k=16))
    # the normal is the eigenvector of the smallest eigenvalue: well defined
    # (to 1e-5) only where that eigenvalue stands apart from the next one;
    # the surfaces are built so that it does, and that is asserted first
    idx = n(knn(t(x), t(x), 16))
    nb = np.take_along_axis(x[:, None].astype(np.float64),
                            idx[..., None], axis=2)           # (B, N, 16, 3)
    c = nb - nb.mean(axis=2, keepdims=True)
    ev, vecs = np.linalg.eigh(np.einsum("bnki,bnkj->bnij", c, c))
    gap = (ev[..., 1] - ev[..., 0]) / ev[..., 2]
    assert gap.min() > 0.05, gap.min()
    # against float64 on the port's own neighbourhoods: every row
    dot64 = np.abs((got * vecs[..., 0]).sum(-1))
    assert dot64.min() >= 1 - 1e-5, dot64.min()
    # against the JAX package: both form float32 distances as
    # |p|^2 + |q|^2 - 2 p.q, whose cancellation leaves ~1e-7 of |p|^2, in
    # other orders; a near-tie at the 16th neighbour may go either way, and
    # that row's covariance then sums another point (2 rows of 4,500 here)
    dot = np.abs((got * want).sum(-1))
    assert (dot >= 1 - 1e-5).mean() >= 0.999, np.sort(dot.ravel())[:5]
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_normals_in_eigh_chunks(monkeypatch):
    """The covariances go to eigh EIGH_BATCH at a time (cuSOLVER's batched
    solver refuses a large batch): chunks give the same normals."""
    from ogmm_tpu_torch.ops import icp
    x = t(surface(np.random.RandomState(8), 2, 300))
    whole = estimate_normals_knn(x)
    monkeypatch.setattr(icp, "EIGH_BATCH", 97)
    assert torch.equal(estimate_normals_knn(x), whole)


@pytest.mark.parametrize("pl", [False, True])
@pytest.mark.parametrize("B,N", SIZES)
def test_refine_registration_matches_jax(B, N, pl):
    src, tgt, rot, tr, rot0, tr0 = _problem(2, B, N)
    jr, jt = jrefine(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(rot0),
                     jnp.asarray(tr0), VOXEL, pl=pl)
    tr_, tt_ = refine_registration(t(src), t(tgt), t(rot0), t(tr0), VOXEL, pl=pl)
    # 30 trips: moments or normal equations summed in other orders (the
    # spatial route also visits the clouds in Morton order)
    np.testing.assert_allclose(n(tr_), n(jr), atol=1e-4)
    np.testing.assert_allclose(n(tt_), n(jt), atol=1e-4)
    # both recover the true pose from 2 degrees off
    assert _angle_deg(tr_, rot).max() < 0.05
    assert np.abs(n(tt_) - tr).max() < 1e-3


def test_point_to_plane_keeps_the_pose_of_a_cloud_without_inliers():
    src, tgt, rot, tr, rot0, tr0 = _problem(3, 3, 128)
    tgt[1] += 100.0                                      # nothing within the gate
    init = tse3.integrate(t(rot0), t(tr0))
    jinit = jse3.integrate(jnp.asarray(rot0), jnp.asarray(tr0))
    jr, jt = jplane(jnp.asarray(src), jnp.asarray(tgt), jinit, 2 * VOXEL)
    tr_, tt_ = icp_point_to_plane(t(src), t(tgt), init, 2 * VOXEL)
    np.testing.assert_array_equal(n(tr_)[1], rot0[1])
    np.testing.assert_array_equal(n(tt_)[1], tr0[1])
    np.testing.assert_allclose(n(tr_), n(jr), atol=1e-4)
    np.testing.assert_allclose(n(tt_), n(jt), atol=1e-4)


def test_point_to_plane_through_the_kernel_route():
    """use_kernel=True takes the nn1 kernel's route also at M <= 1024 (its
    plain version here): the same correspondences as the dense matrix, up to
    float32 ties, so the same poses."""
    src, tgt, _, _, rot0, tr0 = _problem(4, 3, 128)
    init = tse3.integrate(t(rot0), t(tr0))
    a = icp_point_to_plane(t(src), t(tgt), init, 2 * VOXEL)
    b = icp_point_to_plane(t(src), t(tgt), init, 2 * VOXEL, use_kernel=True)
    for x, y in zip(a, b):
        np.testing.assert_allclose(n(x), n(y), atol=1e-5)


# ------------------------------------------------------------------- grid

def test_grid_nn_matches_jax():
    rs = np.random.RandomState(5)
    tgt = surface(rs, 2, 2000)
    tgt[:, :40] = tgt[:, :1]            # one cell holding 40 points > cap 16
    q = surface(rs, 2, 700)
    q[:, :50] += 5.0                    # far from every cell: +inf
    q[:, 50:60] = tgt[:, :10]           # on the crowded cell
    cell, cap = 2 * VOXEL, 16
    jg = jbuild_grid(jnp.asarray(tgt), cell=cell)
    g = build_grid(t(tgt), cell)
    np.testing.assert_array_equal(n(g.cid_sorted), n(jg.cid_sorted))
    np.testing.assert_array_equal(n(g.ids_sorted), n(jg.ids_sorted))
    np.testing.assert_array_equal(n(g.max_occupancy), n(jg.max_occupancy))
    assert n(g.max_occupancy).min() >= 40 > cap
    jd, ji = jnn1_radius(jnp.asarray(q), jg, cell=cell, cap=cap)
    d, i = nn1_radius(t(q), g, cell, cap)
    assert np.isinf(n(d)[:, :50]).all() and np.isinf(n(jd)[:, :50]).all()
    # the same squared distances up to the rounding of the sum: the JAX
    # package's CPU build sums the three squares with fused multiply-adds
    # (20% of them one or two float32 ulps apart)
    np.testing.assert_allclose(n(d), n(jd), rtol=3e-7, atol=0)
    assert_same_up_to_ties(n(i)[..., None], n(ji)[..., None], q, tgt)


@pytest.mark.parametrize("pl", [False, True])
def test_grid_icp_matches_jax(pl):
    src, tgt, rot, tr, rot0, tr0 = _problem(6, 1, 4500)
    init = tse3.integrate(t(rot0), t(tr0))
    jinit = jse3.integrate(jnp.asarray(rot0), jnp.asarray(tr0))
    jicp, ticp = (jplane, icp_point_to_plane) if pl else (jpoint, icp_point_to_point)
    jr, jt = jicp(jnp.asarray(src), jnp.asarray(tgt), jinit, 2 * VOXEL,
                  use_grid=True)
    gr, gt = ticp(t(src), t(tgt), init, 2 * VOXEL, use_grid=True)
    sr, st = ticp(t(src), t(tgt), init, 2 * VOXEL)     # the spatial route
    # exact under the gate: the same correspondences as the other routes,
    # up to ties; 30 trips of sums in other orders
    for r_, t_ in ((jr, jt), (sr, st)):
        np.testing.assert_allclose(n(gr), n(r_), atol=1e-4)
        np.testing.assert_allclose(n(gt), n(t_), atol=1e-4)
    assert _angle_deg(gr, rot).max() < 0.05


@pytest.mark.parametrize("icp", [icp_point_to_point, icp_point_to_plane])
def test_grid_with_the_kernel_raises(icp):
    src, tgt, _, _, rot0, tr0 = _problem(7, 1, 64)
    init = tse3.integrate(t(rot0), t(tr0))
    with pytest.raises(ValueError, match="use_grid"):
        icp(t(src), t(tgt), init, 2 * VOXEL, use_grid=True, use_kernel=True)
