"""The DGCNN backward kernels' plain versions (`ops/cuda_dgcnn_bwd.py`) and
the port's backward with `BWD_KERNELS` on, against the JAX package on the
CPU: each plain version against its Pallas kernel in interpret mode (tiles
of 32 over N = 90 points, so the last tile is padded), the whole custom
autograd function against `dgcnn_train_fused` with `_BWD_PALLAS` on, and
the switch-on backward against the switch-off one, with ReLU(0) and max-over-k
ties."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ogmm_tpu.ops.dgcnn_train as jdt
import ogmm_tpu.ops.pallas_dgcnn_train as pt
from ogmm_tpu.ops.dispatch import pallas_override
from ogmm_tpu_torch.ops import cuda_dgcnn_bwd as bwd_mod
from ogmm_tpu_torch.ops import dgcnn_train as tdt
from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import (bwd_edge, bwd_edge_reference,
                                              bwd_reduce, bwd_reduce_reference,
                                              bwd_stage, bwd_stage_reference)

from torch_port_util import n

B, K, N, TILE = 2, 8, 90, 32          # 32 + 32 + 26: the last tile padded
DIMS = [(6, 64), (64, 64), (64, 128), (128, 256), (512, 64)]

# float32: the same arithmetic in another summation order; bf16: the Pallas
# kernels' own bars against their jnp reference (tests/test_dgcnn_train_fused.py)
TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
       "bfloat16": dict(rtol=0.05, atol=0.02)}


def _close(a, b, dtype, what):
    a, b = n(a), n(b)
    tol = TOL[dtype]
    np.testing.assert_allclose(a, b, rtol=tol["rtol"],
                               atol=tol["atol"] * (np.abs(b).max() + 1e-12),
                               err_msg=what)


def _cast(a, dtype):
    """numpy float32 -> (torch, jax) arrays in the compute dtype, rounded
    the same way on both sides."""
    tt = torch.from_numpy(np.ascontiguousarray(a)).to(getattr(torch, dtype))
    return tt, jnp.asarray(a).astype(jnp.dtype(dtype))


def _stage_inputs(rs, C, dtype):
    """z (B, K, N, C) with its own batch moments, a tap cotangent and BN
    parameters, as (torch, jax) pairs."""
    z = (rs.randn(B, K, N, C) * 0.7 + rs.randn(C) * 0.2).astype(np.float32)
    zt, zj = _cast(z, dtype)
    z32 = n(zt)
    mean = z32.mean(axis=(0, 1, 2)).astype(np.float32)
    var = z32.var(axis=(0, 1, 2)).astype(np.float32)
    gamma = rs.uniform(0.5, 1.5, C).astype(np.float32)
    beta = (rs.randn(C) * 0.1).astype(np.float32)
    dtap = _cast((rs.randn(B, N, C) * 0.1).astype(np.float32), dtype)
    f32 = [(torch.from_numpy(a), jnp.asarray(a)) for a in (mean, var, gamma, beta)]
    return [(zt, zj), dtap, *f32]


def _w(rs, cin, c):
    w = (rs.randn(cin, c) / np.sqrt(cin)).astype(np.float32)
    return torch.from_numpy(w), jnp.asarray(w)


def _split(pairs):
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_reduce_reference_matches_pallas_interpret(dtype):
    rs = np.random.RandomState(1)
    ti, ji = _split(_stage_inputs(rs, 256, dtype))
    got = bwd_reduce_reference(*ti)
    assert got.shape == (2, 256) and got.dtype == torch.float32
    want = pt.bwd_reduce_pallas(*ji, tile_n=TILE, dtype=jnp.dtype(dtype),
                                interpret=True)
    _close(got, want, dtype, "S of stage 4")
    assert torch.equal(bwd_reduce(*ti), got)      # a CPU tensor: the plain version


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_reduce_is_the_sum_over_each_columns_argmax_row(dtype):
    # the premise of the reduce kernel (csrc/dgcnn_bwd.cu:reduce_kernel):
    # without a cotangent from above only the first max-over-k row of each
    # column adds to S1 and S2, gathered here with torch ops; columns with
    # tied maxima, with every y < 0, with every y == 0 and with y == 0 on a
    # later row only
    rs = np.random.RandomState(7)
    b, k, npts, c = 2, 20, 40, 64
    z = torch.from_numpy(rs.randn(b, k, npts, c).astype(np.float32)).to(dtype)
    z[:, 5] = z[:, 2]                                    # tied rows
    zf = z.float()
    mean, var = zf.mean((0, 1, 2)), zf.var((0, 1, 2), unbiased=False)
    gamma = torch.from_numpy(rs.uniform(0.5, 1.5, c).astype(np.float32))
    beta = torch.from_numpy((rs.randn(c) * 0.1).astype(np.float32))
    beta[0] = -100.0                                     # every y < 0
    beta[1] = 0.0
    m1 = mean[1].to(dtype)
    z[0, :, 3, 1] = m1                                   # every y == 0
    z[0, :, 4, 1] = m1 - 1.0                             # y < 0, then y == 0
    z[0, 7, 4, 1] = m1
    z[1, 0, 6, 1] = m1                                   # row 0 y == 0, rest < 0
    z[1, 1:, 6, 1] = m1 - 1.0
    dtap = torch.from_numpy((rs.randn(b, npts, c) * 0.1).astype(np.float32)).to(dtype)
    got = bwd_reduce_reference(z, dtap, mean, var, gamma, beta)

    y = bwd_mod.bn_apply(z, mean, var, gamma, beta)
    h = torch.relu(y)
    am = h.argmax(dim=1, keepdim=True)                   # the first maximum
    y_am, z_am = y.gather(1, am)[:, 0], z.gather(1, am)[:, 0]
    dy = bwd_mod.relu_vjp(dtap, y_am).float()
    zhat = (z_am.float() - mean) * torch.rsqrt(var + bwd_mod.EPS)
    want = torch.stack([dy.sum((0, 1)), (dy * zhat).sum((0, 1))])
    # float32 sums of the same terms in another order
    np.testing.assert_allclose(n(got), n(want), rtol=0,
                               atol=1e-5 * want.abs().max().item())
    # the columns the test meant to build are there
    top = h.amax(dim=1, keepdim=True)
    assert ((h == top).sum(1) > 1).any() and (y[..., 0] < 0).all()
    assert (y[0, :, 3, 1] == 0).all() and am[0, 0, 3, 1] == 0
    assert (y[0, :, 4, 1] <= 0).all() and y[0, 7, 4, 1] == 0 and y[0, 0, 4, 1] < 0
    assert y[1, 0, 6, 1] == 0 and (y[1, 1:, 6, 1] < 0).all()
    assert dy[0, 3, 1] == 0.5 * dtap[0, 3, 1].float() and dy[0, 4, 1] == 0
    assert dy[1, 6, 1] == 0.5 * dtap[1, 6, 1].float() and (dy[..., 0] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,cin,cn", [(256, 128, 0), (128, 64, 256), (64, 64, 128)])
def test_bwd_stage_reference_matches_pallas_interpret(dtype, C, cin, cn):
    rs = np.random.RandomState(C + cn)
    cur = _stage_inputs(rs, C, dtype)
    prev = _stage_inputs(rs, cin, dtype)
    s12 = (rs.randn(2, C) * 3).astype(np.float32)
    args = cur + [(torch.from_numpy(s12), jnp.asarray(s12)), _w(rs, cin, C)]
    args += [prev[0], *prev[2:], prev[1]]
    ti, ji = _split(args)
    tkw, jkw = {}, {}
    if cn:
        dzn = _cast((rs.randn(B, K, N, cn) * 0.05).astype(np.float32), dtype)
        wn = _w(rs, C, cn)
        tkw = dict(dznext=dzn[0], wnext=wn[0])
        jkw = dict(dznext=dzn[1], wnext=wn[1])
    dz, dw, sp = bwd_stage_reference(*ti, **tkw)
    assert dz.shape == (B, K, N, C) and dz.dtype == getattr(torch, dtype)
    assert dw.shape == (cin, C) and sp.shape == (2, cin)
    jdz, jdw, jsp = pt.bwd_stage_pallas(*ji, **jkw, tile_n=TILE,
                                        dtype=jnp.dtype(dtype), interpret=True)
    _close(dz, jdz, dtype, "dz")
    _close(dw, jdw, dtype, "dW")
    _close(sp, jsp, dtype, "S of the stage below")
    for a, b in zip(bwd_stage(*ti, **tkw), (dz, dw, sp)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_edge_reference_matches_pallas_interpret(dtype):
    rs = np.random.RandomState(5)
    args = _stage_inputs(rs, 64, dtype)
    s12 = (rs.randn(2, 64) * 3).astype(np.float32)
    args.append((torch.from_numpy(s12), jnp.asarray(s12)))
    args.append(_cast((rs.randn(B, K, N, 64) * 0.05).astype(np.float32), dtype))
    args.append(_w(rs, 64, 64))
    args.append(_cast(rs.randn(B, K, N, 6).astype(np.float32) * 0.3, dtype))
    args.append(_w(rs, 6, 64))
    idx = rs.randint(0, N, (B, N, K)).astype(np.int32)
    args.append((torch.from_numpy(idx), jnp.asarray(idx)))
    ti, ji = _split(args)
    dw, dq, dscat = bwd_edge_reference(*ti)
    assert dw.shape == (6, 64) and dq.shape == dscat.shape == (B, N, 3)
    jdw, jdq, jdscat = pt.bwd_edge_pallas(*ji, tile_n=TILE,
                                          dtype=jnp.dtype(dtype), interpret=True)
    _close(dw, jdw, dtype, "dW1")
    _close(dq, jdq, dtype, "dq")
    _close(dscat, jdscat, dtype, "dscat")
    for a, b in zip(bwd_edge(*ti), (dw, dq, dscat)):
        assert torch.equal(a, b)


# --------------------------------------------------------- the whole backward

def _params(seed, dead_channels=False):
    rs = np.random.RandomState(seed)
    ws = [(rs.randn(*d) / np.sqrt(d[0])).astype(np.float32) for d in DIMS]
    gs = [(1 + 0.1 * rs.randn(d[1])).astype(np.float32) for d in DIMS]
    bs = [(0.05 * rs.randn(d[1])).astype(np.float32) for d in DIMS]
    if dead_channels:
        # scale 0 and bias 0: the BN output is exactly 0 on the channel, so
        # the ReLU sees 0 (half cotangent) and the max over k ties
        for g, b in zip(gs, bs):
            g[:3] = 0.0
            b[:3] = 0.0
    x = (rs.randn(B, N, 3) * 0.4).astype(np.float32)
    wvec = rs.randn(B, N, DIMS[-1][1]).astype(np.float32)
    return x, ws, gs, bs, wvec


def _port_grads(x, ws, gs, bs, wvec, dtype, kernels, k=K):
    ps = [torch.tensor(a, requires_grad=True) for a in ws + gs + bs]
    xt = torch.tensor(x, requires_grad=True)
    saved = tdt.BWD_KERNELS
    tdt.BWD_KERNELS = kernels
    try:
        out, _, _ = tdt.dgcnn_train(xt, ps[:5], ps[5:10], ps[10:], k=k,
                                    dtype=getattr(torch, dtype))
        loss = (out.float() * torch.from_numpy(wvec)).sum()
        loss.backward()
    finally:
        tdt.BWD_KERNELS = saved
    return loss, [p.grad for p in ps] + [xt.grad]


def _jax_grads(monkeypatch, x, ws, gs, bs, wvec, dtype, k=K):
    for name in ("graph_stage1_pallas", "bwd_reduce_pallas",
                 "bwd_stage_pallas", "bwd_edge_pallas"):
        monkeypatch.setattr(pt, name, functools.partial(
            getattr(pt, name), interpret=True, tile_n=TILE))
    monkeypatch.setattr(jdt, "_BWD_PALLAS", True)

    def loss(params, xx):
        out, _, _ = jdt.dgcnn_train_fused(xx, params[:5], params[5:10],
                                          params[10:], k=k, dtype=dtype)
        return (out.astype(jnp.float32) * wvec).sum()

    with pallas_override(True):
        val, (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1))(
            [jnp.asarray(a) for a in ws + gs + bs], jnp.asarray(x))
    return val, list(gp) + [gx]


NAMES = ([f"w{i}" for i in range(1, 6)] + [f"bn{i}_scale" for i in range(1, 6)]
         + [f"bn{i}_bias" for i in range(1, 6)] + ["x"])


@pytest.mark.parametrize("k", [K, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_with_kernels_matches_jax_bwd_pallas(monkeypatch, dtype, k):
    # the kernels' route (on the CPU their plain versions) at k = 8 and at
    # k = 5, which the kernels take in the row class of 8
    assert tdt.bwd_kernels_take(k, N)
    x, ws, gs, bs, wvec = _params(11)
    tval, tg = _port_grads(x, ws, gs, bs, wvec, dtype, kernels=True, k=k)
    jval, jg = _jax_grads(monkeypatch, x, ws, gs, bs, wvec, dtype, k=k)
    np.testing.assert_allclose(n(tval), n(jval), rtol=TOL[dtype]["rtol"])
    for name, a, b in zip(NAMES, tg, jg):
        _close(a, b, dtype, name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["plain", "relu_at_zero", "max_ties"])
def test_backward_with_kernels_matches_without(dtype, variant):
    x, ws, gs, bs, wvec = _params(12, dead_channels=variant == "relu_at_zero")
    if variant == "max_ties":
        x[:, 10:20] = x[:, 20:30]       # coincident points: tied edge rows
    on_val, on = _port_grads(x, ws, gs, bs, wvec, dtype, kernels=True)
    off_val, off = _port_grads(x, ws, gs, bs, wvec, dtype, kernels=False)
    assert torch.equal(on_val, off_val)               # the same forward
    for name, a, b in zip(NAMES, on, off):
        if dtype == "float32":
            # the same float32 arithmetic; the S sums and the extra product
            # are formed separately on the two routes
            np.testing.assert_allclose(n(a), n(b), rtol=1e-4,
                                       atol=1e-4 * float(b.abs().max()),
                                       err_msg=name)
        else:
            # the same bf16 roundings in the same places, but the switch-off
            # route forms stage i's extra cotangent once where the kernel
            # route forms it twice (once for the sums below): identical values
            assert torch.equal(a, b), name
