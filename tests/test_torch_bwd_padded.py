"""The padded tile of the DGCNN backward kernels (`csrc/dgcnn_bwd.cu`),
emulated in plain PyTorch on the CPU.

A launch of row class KP (`cuda_dgcnn_bwd.row_class`) takes a graph of
k <= KP neighbours: its tiles hold KP rows a point, and the rows j >= k are
padding. TMA fills them with zeros (the bf16 kernels, the float32 edge
kernel; the float32 stage kernel's bulk copies leave them unloaded), and
every kernel then masks them:

  argmax  the first maximum of max(y, 0) over the rows j < k only, each of
          a column's lanes (`column_lanes`) keeping a running maximum of its
          rows j = lanes i + l, the lanes combined by a butterfly (the larger
          value, the lower j on a tie: `group_argmax`)
  dz_i    inv gamma (dy - S1/m - zhat S2/m) with m = B k N, written as 0 on
          the padded rows before any product reads it; only rows j < k
          stored
  below   h_{i-1} written as 0 on the padded rows; dy_{i-1} summed over the
          rows j < k only
  edge    e zero on the padded rows; dq summed over j < k; de[:3] of the
          rows j < k scattered

The emulation runs the plain versions' operations on the padded tensors and
holds every output against `bwd_reduce_reference`, `bwd_stage_reference`
and `bwd_edge_reference` on the unpadded ones at k in 1, 5, 12, 25, 32,
bf16 and float32; and on a case built so that an unmasked padded row would
win the argmax (every real row's h = 0 on some channels, beta > 0, where a
row of z = 0 gives h > 0), it shows that the same emulation without the
masks is wrong."""
import numpy as np
import pytest
import torch

from ogmm_tpu_torch.ops import cuda_dgcnn_bwd as bwd
from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import (bn_apply, bwd_edge_reference,
                                              bwd_reduce_reference,
                                              bwd_stage_reference, edge_vjp,
                                              mm32, relu_vjp)

from torch_port_util import n

B, N = 2, 40
KS = (1, 5, 12, 25, 32)
# chip_smoke.py's limits of the kernels against their plain versions, as a
# share of max|plain|: float32 sums in another order; bf16 dz within two
# ulps, the bf16 route's float32 sums of bf16 products
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2.0 ** -6, 2e-2)}


def _pad(t, kp):
    """(B, k, N, C) -> (B, kp, N, C), the rows past k zero (TMA's fill)."""
    B_, k, N_, C = t.shape
    return torch.cat([t, t.new_zeros(B_, kp - k, N_, C)], dim=1)


def lanes_argmax(h, k, lanes):
    """The kernels' argmax over dim 1 of (B, kp, N, C): lane l of a column
    keeps the running first maximum from -1 of its rows j = lanes i + l,
    j < k; the lanes are combined by a butterfly, the larger value and the
    lower j on a tie."""
    kp = h.shape[1]
    best, am = [], []
    for lane in range(lanes):
        b = torch.full_like(h[:, 0], -1.0)
        a = torch.zeros_like(h[:, 0], dtype=torch.long)
        for j in range(lane, kp, lanes):
            if j >= k:
                continue
            take = h[:, j] > b
            b = torch.where(take, h[:, j], b)
            a = torch.where(take, torch.full_like(a, j), a)
        best.append(b)
        am.append(a)
    o = 1
    while o < lanes:
        nb, na = [], []
        for lane in range(lanes):
            ob, oa = best[lane ^ o], am[lane ^ o]
            take = (ob > best[lane]) | ((ob == best[lane]) & (oa < am[lane]))
            nb.append(torch.where(take, ob, best[lane]))
            na.append(torch.where(take, oa, am[lane]))
        best, am, o = nb, na, 2 * o
    return am[0]


def _onehot_tap(dtap, am, kp):
    """max-VJP through the argmax rows: (B, N, C) onto (B, kp, N, C)."""
    out = torch.zeros(dtap.shape[0], kp, *dtap.shape[1:], dtype=dtap.dtype)
    return out.scatter_(1, am.unsqueeze(1), dtap.unsqueeze(1))


def _column(z, dtap, mean, var, gamma, beta, k, lanes, extra=None, mask=True):
    """y, the first argmax and dy of a stage over a padded tile; without
    `mask` the padded rows take part in the argmax as real ones."""
    kp = z.shape[1]
    y = bn_apply(z, mean, var, gamma, beta)
    am = lanes_argmax(torch.relu(y), k if mask else kp, lanes)
    dh = _onehot_tap(dtap, am, kp)
    if extra is not None:
        dh = dh + extra
    return y, relu_vjp(dh, y)


def _real(kp, k):
    return (torch.arange(kp) < k).view(1, kp, 1, 1)


def _dz(dy, z, mean, var, gamma, s12, m, real):
    """dz = inv gamma (dy - S1/m - zhat S2/m) in the compute dtype, m the
    real rows, 0 on the padded rows."""
    inv = torch.rsqrt(var + bwd.EPS)
    zhat = (z.float() - mean) * inv
    dz = ((inv * gamma) * (dy.float() - s12[0] / m - zhat * (s12[1] / m))).to(dy.dtype)
    return torch.where(real, dz, torch.zeros_like(dz))


def _sums(dy, z, mean, var, real):
    dy32 = torch.where(real, dy.float(), torch.zeros_like(dy.float()))
    zhat = (z.float() - mean) * torch.rsqrt(var + bwd.EPS)
    return torch.stack([dy32.sum((0, 1, 2)), (dy32 * zhat).sum((0, 1, 2))])


def reduce_padded(z, dtap, mean, var, gamma, beta, mask=True):
    k = z.shape[1]
    kp = bwd.row_class(k)
    zp = _pad(z, kp)
    # the reduce kernel streams a point's rows in one thread: one lane
    _, dy = _column(zp, dtap, mean, var, gamma, beta, k, 1, mask=mask)
    return _sums(dy, zp, mean, var, _real(kp, k) if mask else _real(kp, kp))


def stage_padded(z, dtap, mean, var, gamma, beta, s12, w_i, zp, meanp, varp,
                 gammap, betap, dtapp, dznext=None, wnext=None, mask=True):
    B_, k, N_, C = z.shape
    kp, dt = bwd.row_class(k), z.dtype
    real = _real(kp, k) if mask else _real(kp, kp)
    zP, zpP = _pad(z, kp), _pad(zp, kp)
    extra = (None if dznext is None
             else torch.matmul(_pad(dznext, kp), wnext.to(dt).t()))
    _, dy = _column(zP, dtap, mean, var, gamma, beta, k,
                    bwd.column_lanes(k, C, dt), extra, mask)
    dz = _dz(dy, zP, mean, var, gamma, s12, B_ * k * N_, real)
    yp = bn_apply(zpP, meanp, varp, gammap, betap)
    hp = torch.where(real, torch.relu(yp), torch.zeros_like(yp))
    dw = mm32(hp.flatten(0, 2).t(), dz.flatten(0, 2))
    _, dyp = _column(zpP, dtapp, meanp, varp, gammap, betap, k,
                     bwd.column_lanes(k, zp.shape[-1], dt),
                     torch.matmul(dz, w_i.to(dt).t()), mask)
    return dz[:, :k], dw, _sums(dyp, zpP, meanp, varp, real)


def edge_padded(z1, dtap1, mean1, var1, gamma1, beta1, s12, dz2, w2, e, w1,
                idx, mask=True):
    B_, k, N_, C = z1.shape
    kp, dt = bwd.row_class(k), z1.dtype
    real = _real(kp, k) if mask else _real(kp, kp)
    zP = _pad(z1, kp)
    extra = torch.matmul(_pad(dz2, kp), w2.to(dt).t())
    _, dy = _column(zP, dtap1, mean1, var1, gamma1, beta1, k,
                    bwd.column_lanes(k, C, dt), extra, mask)
    dz = _dz(dy, zP, mean1, var1, gamma1, s12, B_ * k * N_, real)
    dw = mm32(_pad(e, kp).flatten(0, 2).t(), dz.flatten(0, 2))
    de = mm32(dz, w1.to(dt).t())                          # (B, kp, N, 6)
    dq = torch.where(real, de[..., 3:] - de[..., :3],
                     torch.zeros_like(de[..., 3:])).sum(dim=1)
    _, dscat = edge_vjp(de[:, :k], idx)
    return dw, dq, dscat


def _stage_inputs(rs, k, C, dt, dead):
    z = (rs.randn(B, k, N, C) * 0.7 + rs.randn(C) * 0.2).astype(np.float32)
    z = torch.from_numpy(z).to(dt)
    zf = z.float()
    mean, var = zf.mean((0, 1, 2)), zf.var((0, 1, 2), unbiased=False)
    gamma = torch.from_numpy(rs.uniform(0.5, 1.5, C).astype(np.float32))
    beta = torch.from_numpy((rs.randn(C) * 0.1).astype(np.float32))
    if dead:
        # channels 0..7: every real row's y = (-12 + 10) gamma + 0.5 < 0, so
        # its h is 0; a padded row of z = 0 gives y = 10 gamma + 0.5 > 0
        z[..., :8] = -12.0
        mean[:8], var[:8], beta[:8] = -10.0, 1.0 - bwd.EPS, 0.5
    dtap = torch.from_numpy((rs.randn(B, N, C) * 0.1).astype(np.float32)).to(dt)
    return [z, dtap, mean, var, gamma, beta]


def _calls(k, dt, dead):
    """The five calls' arguments: (name, args, kwargs)."""
    rs = np.random.RandomState(k)
    w = lambda a, b: torch.from_numpy((rs.randn(a, b) / np.sqrt(a)).astype(np.float32))
    st = {C: _stage_inputs(rs, k, C, dt, dead) for C in (256, 128, 64)}
    st1 = _stage_inputs(rs, k, 64, dt, dead)
    ws = {256: w(128, 256), 128: w(64, 128), 64: w(64, 64)}
    s12 = lambda C: torch.from_numpy((rs.randn(2, C) * 3).astype(np.float32))
    calls = [("reduce", st[256], {})]
    for C, cin, cn in bwd.KERNEL_STAGES:
        prev = st1 if C == 64 else st[cin]
        dzn = (torch.from_numpy((rs.randn(B, k, N, cn) * 0.05).astype(np.float32)).to(dt)
               if cn else None)
        calls.append(("stage", [*st[C], s12(C), ws[C], prev[0], *prev[2:], prev[1]],
                      dict(dznext=dzn, wnext=ws[cn] if cn else None)))
    e = torch.from_numpy((rs.randn(B, k, N, 6) * 0.3).astype(np.float32)).to(dt)
    dz2 = torch.from_numpy((rs.randn(B, k, N, 64) * 0.05).astype(np.float32)).to(dt)
    idx = torch.from_numpy(rs.randint(0, N, (B, N, k)).astype(np.int32))
    calls.append(("edge", [*st1, s12(64), dz2, w(64, 64), e, w(6, 64), idx], {}))
    return calls


FNS = {"reduce": (reduce_padded, bwd_reduce_reference),
       "stage": (stage_padded, bwd_stage_reference),
       "edge": (edge_padded, bwd_edge_reference)}


def _outs(out):
    return [out] if torch.is_tensor(out) else list(out)


def _share(got, ref, dt, name, i):
    """max|got - ref| as a share of its limit (chip_smoke.py's)."""
    lim = TOL[dt][0 if (dt == torch.float32 or (name == "stage" and i == 0)) else 1]
    scale = ref.float().abs().max().item()
    return (got.float() - ref.float()).abs().max().item() / (lim * max(scale, 1e-30))


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", KS)
def test_padded_tile_matches_the_plain_versions(k, dtype, dead):
    for name, a, kw in _calls(k, dtype, dead):
        emulate, plain = FNS[name]
        got, ref = _outs(emulate(*a, **kw)), _outs(plain(*a, **kw))
        for i, (g, r) in enumerate(zip(got, ref)):
            assert g.shape == r.shape and g.dtype == r.dtype, (name, i)
            assert torch.isfinite(g.float()).all(), (name, i)
            assert _share(g, r, dtype, name, i) <= 1.0, (name, i, k, dtype, dead)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 5, 25])
def test_an_unmasked_padded_row_would_win(k, dtype):
    # the classes of k = 1, 5, 25 pad 3, 3 and 7 rows a point; on the dead
    # channels a padded row of z = 0 has the largest h of its column, so
    # without the masks the argmax moves onto it and every output is wrong
    assert bwd.row_class(k) > k
    for name, a, kw in _calls(k, dtype, dead=True):
        emulate, plain = FNS[name]
        ref = _outs(plain(*a, **kw))
        wrong = _outs(emulate(*a, **kw, mask=False))
        shares = [_share(g, r, dtype, name, i)
                  for i, (g, r) in enumerate(zip(wrong, ref))]
        assert max(shares) > 1.0, (name, k, dtype, shares)
    # the premise: on channel 0, every real row's h is 0 and a zero row's
    # is above it
    z, _, mean, var, gamma, beta = _calls(k, dtype, dead=True)[0][1]
    h = torch.relu(bn_apply(z, mean, var, gamma, beta))
    h0 = torch.relu(bn_apply(torch.zeros_like(z[:, :1]), mean, var, gamma, beta))
    assert (h[..., :8] == 0).all() and (h0[..., :8] > 0).all()


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_the_lanes_argmax_is_the_first_maximum(lanes):
    # the butterfly over a column's lanes gives the plain version's first
    # argmax (torch's argmax of ReLU(y)) over the real rows, ties included
    rs = np.random.RandomState(lanes)
    h = torch.relu(torch.from_numpy(rs.randn(3, 32, 50, 16).astype(np.float32)))
    h[:, 7] = h[:, 3]                           # tied rows
    h[..., 0] = 0.0                             # whole columns at zero
    for k in (1, 5, 12, 25, 32):
        assert torch.equal(lanes_argmax(h, k, lanes), h[:, :k].argmax(dim=1))
