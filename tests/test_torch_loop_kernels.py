"""The plain versions of the whole-loop and fused kernels (`icp`, `fps`,
`pointmlp`) and the switches that route the serving path through them,
against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode (`icp_pallas`,
`fps_pallas`, `pointmlp_eval_pallas`), as its own tests do, or its plain
routes. On a CPU tensor each wrapper of the port runs its plain version, so
the switches (`use_kernel` of FPS and ICP, `PointMLP.fuse_eval`, and
`GMMReg(loop_kernels=True)`, which sets them all) drive here the functions
the kernels compute on the card."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

import ogmm_tpu.ops.pallas_mlp as jpallas_mlp
from ogmm_tpu import configs as jconfigs
from ogmm_tpu.core import se3 as jse3
from ogmm_tpu.nn.gmmreg import GMMReg as JGMMReg
from ogmm_tpu.nn.layers import PointMLP as JPointMLP
from ogmm_tpu.ops.dispatch import pallas_override
from ogmm_tpu.ops.fps import fps_combined as jfps_combined
from ogmm_tpu.ops.icp import icp_point_to_point as jicp
from ogmm_tpu.ops.pallas_fps import fps_pallas
from ogmm_tpu.ops.pallas_icp import icp_pallas
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch.nn.gmmreg import GMMReg as TGMMReg
from ogmm_tpu_torch.nn.layers import PointMLP as TPointMLP
from ogmm_tpu_torch.ops import cuda_fps, cuda_icp, cuda_mlp
from ogmm_tpu_torch.ops import fps as tfps
from ogmm_tpu_torch.ops import icp as ticp
from ogmm_tpu_torch.weights import convert_variables

from torch_port_util import clouds, n, randomise_stats, t, to_plain

# ---------------------------------------------------------------------- ICP


def _icp_case(seed, B=3, N=96, M=None, far=()):
    """src, tgt (a rotated, shifted, permuted copy of src, cut or padded to M
    points with extra points) and an init pose a few degrees off; the clouds
    in `far` get a target 100 away: no inlier in any trip."""
    rs = np.random.RandomState(seed)
    M = N if M is None else M
    src = rs.randn(B, N, 3).astype(np.float32) * 0.3
    rot = Rotation.from_rotvec(rs.uniform(-.5, .5, (B, 3))).as_matrix().astype(np.float32)
    tr = rs.uniform(-.4, .4, (B, 3)).astype(np.float32)
    tgt = (src @ rot.transpose(0, 2, 1) + tr[:, None, :])[:, rs.permutation(N)]
    if M > N:
        extra = rs.randn(B, M - N, 3).astype(np.float32) * 0.3 + 1.0
        tgt = np.concatenate([tgt, extra], axis=1)
    tgt = np.ascontiguousarray(tgt[:, :M]).astype(np.float32)
    for b in far:
        tgt[b] += 100.0
    drot = Rotation.from_rotvec(rs.uniform(-.1, .1, (B, 3))).as_matrix().astype(np.float32)
    init = np.asarray(jse3.integrate(jnp.asarray(drot @ rot), jnp.asarray(tr)))
    return src, tgt, init


@pytest.mark.parametrize("N,M,far", [(96, 96, ()), (80, 110, ()), (96, 70, ()),
                                     (96, 96, (1,))],
                         ids=["square", "M>N", "M<N", "no-inliers"])
def test_icp_plain_matches_icp_pallas(N, M, far):
    """20 trips at thr 0.07 against the Pallas kernel in interpret mode, at
    the tolerance of the JAX package's own test (tests/test_icp.py:184-187);
    a cloud without inliers keeps its init pose exactly."""
    src, tgt, init = _icp_case(17, N=N, M=M, far=far)
    thr = 0.07
    r_p, t_p = icp_pallas(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(init),
                          thr * thr, iters=20, interpret=True)
    r, tt, first = cuda_icp.icp_fused(t(src), t(tgt), t(init), thr * thr,
                                      iters=20, return_first=True)
    np.testing.assert_allclose(n(r), np.asarray(r_p), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(tt), np.asarray(t_p), rtol=1e-5, atol=1e-5)
    assert first.shape == (3, N) and first.dtype == torch.int64
    for b in far:
        np.testing.assert_array_equal(n(r)[b], init[b, :3, :3])
        np.testing.assert_array_equal(n(tt)[b], init[b, :3, 3])


def test_icp_switch_matches_the_jax_scan(monkeypatch):
    """`icp_point_to_point` with use_kernel on (the kernel's function)
    against the JAX scan on its plain route, 30 trips."""
    src, tgt, init = _icp_case(12, B=3, N=128)
    jr, jt = jicp(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(init), 0.07,
                  max_iter=30, method="horn_pi", use_pallas=False)
    calls = []
    monkeypatch.setattr(cuda_icp, "icp_fused",
                        lambda *a, **kw: calls.append(1) or
                        cuda_icp.icp_fused_reference(*a, **kw))
    r, tt = ticp.icp_point_to_point(t(src), t(tgt), t(init), 0.07, max_iter=30,
                                    use_kernel=True)
    assert calls == [1]
    np.testing.assert_allclose(n(r), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(n(tt), np.asarray(jt), atol=1e-4)


def test_icp_first_trip_takes_the_first_nearest_point():
    """The first trip's indices are nearest points (float64 distances of the
    chosen points are the row minima) and a tie goes to the first index:
    what the card's check holds the kernel to bit for bit."""
    src, tgt, init = _icp_case(3, B=2, N=64)
    tgt[:, 10] = tgt[:, 3]                   # a duplicated target point
    _, _, first = cuda_icp.icp_fused_reference(t(src), t(tgt), t(init), 0.0049,
                                               iters=1, return_first=True)
    moved = src.astype(np.float64) @ init[:, :3, :3].transpose(0, 2, 1) \
        + init[:, None, :3, 3]
    d = ((moved[:, :, None] - tgt[:, None].astype(np.float64)) ** 2).sum(-1)
    chosen = np.take_along_axis(d, n(first)[..., None], axis=-1)[..., 0]
    np.testing.assert_allclose(chosen, d.min(-1), rtol=1e-5, atol=1e-7)
    assert (n(first) == 3).any() and not (n(first) == 10).any()


# ---------------------------------------------------------------------- FPS


@pytest.mark.parametrize("B,N,npoint", [(3, 120, 16), (2, 90, 12)])
def test_fps_plain_matches_fps_pallas(B, N, npoint):
    """The centre and the start variants: identical ids."""
    x = clouds(B * N, B=B, N=N, scale=1.0)
    want = fps_pallas(jnp.asarray(x), npoint, is_center=True, interpret=True)
    got = tfps.farthest_point_sample(t(x), npoint, is_center=True, use_kernel=True)
    np.testing.assert_array_equal(n(got), np.asarray(want))
    start = np.random.RandomState(N).randint(0, N, B).astype(np.int32)
    want = fps_pallas(jnp.asarray(x), npoint, is_center=False,
                      start=jnp.asarray(start), interpret=True)
    got = cuda_fps.fps(t(x), npoint, torch.full((B, N), 1e10),
                       torch.from_numpy(start).long())
    np.testing.assert_array_equal(n(got), np.asarray(want))


def test_fps_switch_matches_jax_fps_combined(monkeypatch):
    """fps_combined with use_kernel on: one call of the kernel's function
    for the 2B rows, ids identical to JAX's fps_combined, ties included."""
    x = clouds(21, B=3, N=128)
    x[:, 40] = x[:, 7]                       # duplicated points: tied distances
    ja, jc = jfps_combined(jnp.asarray(x), 16)
    calls = []
    monkeypatch.setattr(cuda_fps, "fps", lambda *a: calls.append(a[0].shape)
                        or cuda_fps.fps_reference(*a))
    ta, tc = tfps.fps_combined(t(x), 16, use_kernel=True)
    assert calls == [(6, 128, 3)]
    np.testing.assert_array_equal(n(ta), np.asarray(ja))
    np.testing.assert_array_equal(n(tc), np.asarray(jc))


# ----------------------------------------------------------------- PointMLP


def _mlp_pair(dtype, seed):
    """A JAX PointMLP((128, 64)) with random biases and the port's, its
    weights carried by `ogmm_tpu_torch.weights`; an input of 90 points."""
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 90, 64).astype(np.float32)
    v = JPointMLP((128, 64), dtype=dtype).init(jax.random.PRNGKey(seed),
                                               jnp.asarray(x))
    v = jax.tree_util.tree_map_with_path(
        lambda p, a: jnp.asarray(rs.randn(*a.shape).astype(np.float32) * 0.5)
        if str(p[-1].key) == "bias" else a, v)
    state = convert_variables({"params": {"TransformerBlock_0": {
        "PointMLP_0": to_plain(v)["params"]}}})
    tm = TPointMLP(64, (128, 64), tconfigs.torch_dtype(dtype), fuse_eval=True)
    tm.load_state_dict({k.removeprefix("sattn1.mlp."): a for k, a in state.items()},
                       strict=True)
    return x, v, tm.eval()


@pytest.mark.parametrize("dtype,tol", [(None, 1e-5), ("bfloat16", 2e-2)])
def test_pointmlp_plain_matches_pallas_and_fused_jax(dtype, tol):
    """pointmlp_eval_reference and PointMLP(fuse_eval=True) against
    pointmlp_eval_pallas in interpret mode and JAX's PointMLP(fuse_eval=True),
    at the limits of tests/test_models.py:269 and :304."""
    x, v, tm = _mlp_pair(dtype, 0 if dtype is None else 1)
    dt = jnp.dtype(dtype) if dtype else jnp.float32
    p = v["params"]
    want = jpallas_mlp.pointmlp_eval_pallas(
        jnp.asarray(x).astype(dt), p["Dense_0"]["kernel"], p["Dense_0"]["bias"],
        p["Dense_1"]["kernel"], p["Dense_1"]["bias"], dtype=dt, interpret=True)
    orig = jpallas_mlp.pointmlp_eval_pallas
    try:
        jpallas_mlp.pointmlp_eval_pallas = functools.partial(orig, interpret=True)
        with pallas_override(True):
            want_layer = JPointMLP((128, 64), dtype=dtype, fuse_eval=True).apply(
                v, jnp.asarray(x), train=False)
    finally:
        jpallas_mlp.pointmlp_eval_pallas = orig
    tdt = tconfigs.torch_dtype(dtype)
    got = cuda_mlp.pointmlp_eval_reference(
        t(x), tm.dense0.weight, tm.dense0.bias, tm.dense1.weight,
        tm.dense1.bias, tdt)
    with torch.no_grad():
        got_layer = tm(t(x).to(tdt))
    assert got.dtype == got_layer.dtype == tdt
    for g in (got, got_layer):
        for w in (want, want_layer):
            np.testing.assert_allclose(n(g), n(w), rtol=tol, atol=tol)
    # the fused route and the layer-by-layer chain of the port agree too
    tm.fuse_eval = False
    with torch.no_grad():
        chain = tm(t(x).to(tdt))
    np.testing.assert_allclose(n(got_layer), n(chain), rtol=tol, atol=tol)


def test_pointmlp_fused_route_calls_the_kernel_once(monkeypatch):
    """In eval with fuse_eval, one call of the kernel's function; in
    training, or three layers, the layer chain."""
    calls = []
    monkeypatch.setattr(cuda_mlp, "pointmlp_eval", lambda *a: calls.append(1)
                        or cuda_mlp.pointmlp_eval_reference(*a))
    x = torch.randn(2, 30, 64)
    for layers, train, want in (((128, 64), False, 1), ((128, 64), True, 0),
                                ((64, 64, 64), False, 0)):
        calls.clear()
        m = TPointMLP(64, layers, fuse_eval=True).train(train)
        m(x)
        assert len(calls) == want, (layers, train)


# ------------------------------------------------------ the whole forward

SMALL = dict(emb_dims=64, n_clusters=16, km_clusters=16, em_iters=1)


@functools.lru_cache(maxsize=None)
def _jax_request():
    """The JAX refined forward (B=2, N=96, emb 64, K=16, one EM trip) on its
    plain routes, and its variables carried to the port."""
    jm = JGMMReg(cfg=jconfigs.ModelConfig(**SMALL))
    rs = np.random.RandomState(5)
    src = clouds(5, B=2, N=96)
    rot = Rotation.from_rotvec(rs.uniform(-0.4, 0.4, (2, 3))).as_matrix()
    tgt = (np.einsum("bij,bnj->bni", rot, src)
           + rs.uniform(-0.2, 0.2, (2, 1, 3)))[:, rs.permutation(96)]
    tgt = tgt.astype(np.float32)
    v = randomise_stats(jm.init({"params": jax.random.PRNGKey(0)},
                                jnp.asarray(src), jnp.asarray(tgt),
                                train=False), 0)
    with pallas_override(False):
        out = [np.asarray(o) for o in jm.apply(v, jnp.asarray(src),
                                               jnp.asarray(tgt), train=False,
                                               is_test=True)]
    return convert_variables(to_plain(v)), src, tgt, out


def _port_forward(state, src, tgt, switches):
    tm = TGMMReg(tconfigs.ModelConfig(**SMALL), loop_kernels=switches)
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        return tm.eval()(t(src), t(tgt), refine=True)


def test_refined_forward_with_every_switch_matches_jax(monkeypatch):
    """The refined request with `loop_kernels`: FPS, ICP and the three
    attention blocks' MLPs through the kernels' functions, each reached once (FPS, ICP) or three times
    (the MLPs), against the JAX forward, at the limits of the port's forward
    test (tests/test_torch_model.py:149-153), and against the port with the
    switches off."""
    state, src, tgt, (jr, jt, jso, jto, _) = _jax_request()
    calls = {"fps": 0, "icp": 0, "pointmlp": 0}

    def counted(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(cuda_fps, "fps", counted("fps", cuda_fps.fps_reference))
    monkeypatch.setattr(cuda_icp, "icp_fused",
                        counted("icp", cuda_icp.icp_fused_reference))
    monkeypatch.setattr(cuda_mlp, "pointmlp_eval",
                        counted("pointmlp", cuda_mlp.pointmlp_eval_reference))
    rot, trans, so, to, _ = _port_forward(state, src, tgt, True)
    assert calls == {"fps": 1, "icp": 1, "pointmlp": 3}
    np.testing.assert_allclose(n(so), jso, atol=1e-4)
    np.testing.assert_allclose(n(to), jto, atol=1e-4)
    np.testing.assert_allclose(n(rot), jr, atol=2e-3)
    np.testing.assert_allclose(n(trans), jt, atol=2e-3)
    off = _port_forward(state, src, tgt, False)
    assert calls == {"fps": 1, "icp": 1, "pointmlp": 3}
    np.testing.assert_allclose(n(so), n(off[2]), atol=1e-5)
    np.testing.assert_allclose(n(rot), n(off[0]), atol=2e-3)
