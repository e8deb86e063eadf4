"""The arithmetic of the float32 forms of the fused PointMLP
(`csrc/pointmlp.cu`: mlp_tf32_kernel) and of the DGCNN backward stage
(`csrc/dgcnn_bwd.cu`: stage_tf32_kernel), emulated in plain PyTorch on the
CPU.

Each float32 product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi of
TF32 parts (`test_torch_tf32x3.split`), one k8 step at a time in the
kernels' order of depth: a step's eight products of a pair of parts are
exact in float64, and their sum is added to a float32 accumulator.

  pointmlp   z over Cin and out over H, k8 step by k8 step from the first;
             z + b1, the moments of each cloud (two passes, biased) and
             h = relu((z - mu) rstd) in float32, as the kernel's epilogue,
             moments and fragments form them
  bwd_stage  extra = dz_{i+1} W_{i+1}^T and dh_{i-1} = dz_i W_i^T as the K
             slices of the block's warps (`cuda_dgcnn_bwd.row_split`), each
             slice step by step, the slices added in order; dW_i over each
             tile's 40 rows (5 steps), the tiles in the order of each
             block's share (`bwd_stage_plan`, `stage_shares`), the blocks'
             partials added in block order; the element work as the plain
             version's (h recomputed as the forward rounds it, the first
             argmax over k, half the cotangent at ReLU(0))

At the shapes of `chip_smoke.py`'s checks cut to size (the MLP at (2, 90,
128 -> 128 -> 64) and (2, 717, 256 -> 256 -> 128); the stages of a real
float32 backward at B=2, N=64, k=20, full widths) each stays within the
float32 limit (1e-4: of the output for the MLP, of each output's largest
value for the backward) of the float32 plain version and of a float64
evaluation, where one TF32 product does not; and the kernel's rule for the
argmax rows (a running first maximum of max(y, 0) over k) picks the plain
version's rows: the numerical argument of the two designs, checked before
the card runs them."""
import numpy as np
import pytest
import torch

from ogmm_tpu_torch.ops import cuda_dgcnn_bwd, cuda_mlp
from ogmm_tpu_torch.ops import dgcnn_train as ops_dgcnn_train
from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import (bn_apply, bwd_stage_reference,
                                              max_vjp, relu_vjp)
from test_torch_tf32x3 import split

LIM_MLP_F32 = 1e-4       # chip_smoke.py's limits of the float32 routes
LIM_BWD_F32 = 1e-4


def stepped(a, b, terms, acc=None):
    """acc + a (R, K) @ b (K, M) as the kernels accumulate it: float32, k8
    step by k8 step from the first, each step's 'three' products of TF32
    parts (or 'one', the high parts' alone) summed exactly and added;
    'exact' the whole product in float64."""
    if terms == "exact":
        return a.double() @ b.double() + (0.0 if acc is None else acc)
    ah, al = split(a)
    bh, bl = split(b)
    pairs = ((ah, bh),) if terms == "one" else ((al, bh), (ah, bl), (ah, bh))
    if acc is None:
        acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in pairs:
            acc = (acc.double() + x[:, k:k + 8].double() @ y[k:k + 8].double()).float()
    return acc


# ------------------------------------------------------------------ the MLP

def mlp_emulated(x, w1, b1, w2, b2, terms):
    B, N, cin = x.shape
    dt = torch.float64 if terms == "exact" else torch.float32
    z = stepped(x.reshape(B * N, cin), w1.t(), terms).to(dt) + b1.to(dt)
    z = z.view(B, N, -1)
    mean = z.mean(dim=1, keepdim=True)
    var = ((z - mean) ** 2).mean(dim=1, keepdim=True)
    h = torch.relu((z - mean) * (1.0 / torch.sqrt(var + 1e-5)))
    out = stepped(h.reshape(B * N, -1).float() if terms != "exact" else h.reshape(B * N, -1),
                  w2.t(), terms).to(dt) + b2.to(dt)
    return out.view(B, N, -1)


def mlp_inputs(B, N, cin, h, cout):
    """chip_smoke.py's check_pointmlp inputs at these shapes."""
    rs = np.random.RandomState(9)
    w = lambda *sh: torch.tensor(rs.randn(*sh).astype(np.float32) / np.sqrt(sh[-1]))
    x = torch.tensor(rs.randn(B, N, cin).astype(np.float32))
    return x, w(h, cin), w(h) * 0.3, w(cout, h), w(cout) * 0.3


# ------------------------------------------------------- the backward stage

@pytest.fixture(scope="module")
def stage_calls():
    """The three stage calls of a real float32 backward at B=2, N=64, k=20,
    full widths, recorded with their arguments while the plain versions run
    them (as chip_smoke.py's bwd_calls on the card)."""
    rs = np.random.RandomState(0)
    B, N = 2, 64
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return bwd_stage_reference(*a, **kw)

    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3)
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, 512)]
    ws = [torch.tensor(rs.randn(*d).astype(np.float32) / np.sqrt(d[0]),
                       requires_grad=True) for d in dims]
    gs = [torch.tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32)) for d in dims]
    bs = [torch.tensor(rs.randn(d[1]).astype(np.float32) * 0.1) for d in dims]
    saved = (ops_dgcnn_train.bwd_stage, ops_dgcnn_train.BWD_KERNELS)
    try:
        ops_dgcnn_train.bwd_stage = record
        ops_dgcnn_train.BWD_KERNELS = True
        out, _, _ = ops_dgcnn_train.dgcnn_train(x, ws, gs, bs, 20, torch.float32)
        wvec = torch.tensor(rs.randn(B, N, 512).astype(np.float32))
        (out * wvec).sum().backward()
    finally:
        ops_dgcnn_train.bwd_stage, ops_dgcnn_train.BWD_KERNELS = saved
    assert [a[0].shape[-1] for a, _ in calls] == [256, 128, 64]
    return calls


def sliced(a, b, M, terms, mpw=1):
    """a (R, K) @ b (K, M) as the warps of the stage kernel's row products
    take it: K in `row_split(M, k, mpw)` slices (as many at every k), each
    stepped, added in order."""
    if terms == "exact":
        return a.double() @ b.double()
    ks = cuda_dgcnn_bwd.row_split(M, 20, mpw)["k_slices"]
    kj = a.shape[1] // ks
    out = stepped(a[:, :kj], b[:kj], terms)
    for i in range(1, ks):
        out = out + stepped(a[:, i * kj:(i + 1) * kj], b[i * kj:(i + 1) * kj], terms)
    return out


def first_argmax(h):
    """The kernel's argmax over k (dim 1): a running maximum from -1 that
    moves only on a larger value, so a tie keeps the first row."""
    best = torch.full_like(h[:, 0], -1.0)
    am = torch.zeros_like(h[:, 0], dtype=torch.long)
    for j in range(h.shape[1]):
        take = h[:, j] > best
        best = torch.where(take, h[:, j], best)
        am = torch.where(take, torch.full_like(am, j), am)
    return am


def tile_rows(t, tn):
    """(B, k, N, C) -> (tiles, k tn, C): tile (b, n0) holds rows (j, n0 + p)
    at j tn + p, zeros past N."""
    B, k, N, C = t.shape
    pad = -(-N // tn) * tn
    t = torch.cat([t, t.new_zeros(B, k, pad - N, C)], dim=2)
    t = t.view(B, k, pad // tn, tn, C).permute(0, 2, 1, 3, 4)
    return t.reshape(B * (pad // tn), k * tn, C)


def weight_gradient(hp, dz, terms):
    """dW = hp^T dz over the m rows: per tile, its rows' k8 steps; per block,
    its share of the tiles in order, added into its partial every
    `dw_flush` tiles; the blocks' partials in block order."""
    if terms == "exact":
        return hp.flatten(0, 2).double().t() @ dz.flatten(0, 2).double()
    B, k, N, C = dz.shape
    plan = cuda_dgcnn_bwd.bwd_stage_plan(B, N, k, C, hp.shape[-1], 0, torch.float32)
    th, td = (tile_rows(t.float(), plan["points_a_tile"]) for t in (hp, dz))
    dw = None
    for a, b in cuda_dgcnn_bwd.stage_shares(plan["tiles"], plan["blocks"]):
        acc = part = None
        for i in range(a, b):
            acc = stepped(th[i].t(), td[i], terms, acc)
            if (i - a) % plan["dw_flush"] == plan["dw_flush"] - 1 or i == b - 1:
                # the accumulators added into the block's partial
                part, acc = (acc if part is None else part + acc), None
        dw = part if dw is None else dw + part
    return dw


def stage_emulated(z, dtap, mean, var, gamma, beta, s12, w_i, zp, meanp, varp,
                   gammap, betap, dtapp, dznext=None, wnext=None, terms="three"):
    """(dz_i, dW_i, S_{i-1}) with the stage kernel's products; 'exact' takes
    the products and what follows them in float64."""
    B, k, N, C = z.shape
    cin = zp.shape[-1]
    dt = torch.float64 if terms == "exact" else torch.float32
    m = B * k * N

    def zhat(zz, mu, v):   # as `cuda_dgcnn_bwd._zhat`, in dt
        return (zz.to(dt) - mu.to(dt)) * torch.rsqrt(v + cuda_dgcnn_bwd.EPS).to(dt)

    y = bn_apply(z, mean, var, gamma, beta)            # as the forward rounds it
    dh = max_vjp(dtap, torch.relu(y)).to(dt)
    if dznext is not None:
        xpw = cuda_dgcnn_bwd.bwd_stage_plan(B, N, k, C, cin, dznext.shape[-1],
                                            torch.float32)["extra_m_tiles_a_warp"]
        dh = dh + sliced(dznext.reshape(-1, dznext.shape[-1]), wnext.t(), C,
                         terms, xpw).view(B, k, N, C).to(dt)
    ig = (torch.rsqrt(var + cuda_dgcnn_bwd.EPS) * gamma).to(dt)
    dz = ig * ((relu_vjp(dh, y.to(dt)) - s12[0].to(dt) / m)
               - zhat(z, mean, var) * (s12[1].to(dt) / m))
    yp = bn_apply(zp, meanp, varp, gammap, betap)
    hp = torch.relu(yp)
    dhp = max_vjp(dtapp, hp).to(dt) + sliced(dz.reshape(-1, C), w_i.t(), cin,
                                              terms).view(B, k, N, cin).to(dt)
    dyp = relu_vjp(dhp, yp.to(dt))
    sums = torch.stack([dyp.sum((0, 1, 2)), (dyp * zhat(zp, meanp, varp)).sum((0, 1, 2))])
    dw = weight_gradient(hp.to(dt), dz, terms)
    return dz, dw, sums


CASES = [("pointmlp", (2, 90, 128, 128, 64)), ("pointmlp", (2, 717, 256, 256, 128)),
         ("bwd_stage", 4), ("bwd_stage", 3), ("bwd_stage", 2)]


def _errors(kernel, shape, stage_calls, terms):
    """Each output's largest error against the float32 plain version and the
    float64 evaluation: absolute for the MLP, as a share of the output's
    largest value for the backward."""
    if kernel == "pointmlp":
        args = mlp_inputs(*shape)
        got = mlp_emulated(*args, terms)
        plain = cuda_mlp.pointmlp_eval_reference(*args, torch.float32)
        exact = mlp_emulated(*args, "exact")
        return [((got.double() - plain.double()).abs().max().item(),
                 (got.double() - exact).abs().max().item())], LIM_MLP_F32
    a, kw = stage_calls[4 - shape]
    got = stage_emulated(*a, **kw, terms=terms)
    plain = bwd_stage_reference(*a, **kw)
    exact = stage_emulated(*a, **kw, terms="exact")
    errs = []
    for g, p, e in zip(got, plain, exact):
        assert g.shape == p.shape
        scale = p.abs().max().item()
        errs.append(((g.double() - p.double()).abs().max().item() / scale,
                     (g.double() - e).abs().max().item() / scale))
    return errs, LIM_BWD_F32


@pytest.mark.parametrize("kernel,shape", CASES)
def test_three_tf32_products_hold_the_float32_limit(kernel, shape, stage_calls):
    errs, lim = _errors(kernel, shape, stage_calls, "three")
    for to_plain, to_exact in errs:
        assert to_plain <= lim and to_exact <= lim, errs


@pytest.mark.parametrize("kernel,shape", [CASES[1], CASES[2]])
def test_one_tf32_product_would_not(kernel, shape, stage_calls):
    errs, lim = _errors(kernel, shape, stage_calls, "one")
    assert max(e for pair in errs for e in pair) > lim, errs


@pytest.mark.parametrize("stage", [4, 3, 2])
def test_the_kernels_argmax_rows_are_the_plain_versions(stage, stage_calls):
    # the kernel keeps a running first maximum of max(y, 0) over k; the
    # plain version's max-VJP takes torch's argmax of ReLU(y): the same row
    # in every column of stages i and i-1
    a, kw = stage_calls[4 - stage]
    z, mean, var, gamma, beta = a[0], *a[2:6]
    zp, meanp, varp, gammap, betap = a[8:13]
    for zz, st in ((z, (mean, var, gamma, beta)), (zp, (meanp, varp, gammap, betap))):
        h = torch.relu(bn_apply(zz, *st))
        assert torch.equal(first_argmax(h), h.argmax(dim=1))
    # and where ReLU ties whole columns at zero: the first row
    h = torch.relu(bn_apply(z, mean, var, gamma, beta - 100.0))
    assert (h == 0).all() and (first_argmax(h) == 0).all()
