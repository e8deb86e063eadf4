"""The arithmetic of the float32 form of the DGCNN backward's edge call
(`csrc/dgcnn_bwd.cu`: edge_tf32_kernel), emulated in plain PyTorch on the
CPU.

  extra   dz_2 W_2^T as the kernel's warps take it: each of the two K halves
          (`bwd_edge_plan(..., k, torch.float32)["extra_k_slices"]`) k8 step by
          k8 step, each step three TF32 products (`stepped`), the halves
          added in order where the element work reads them
  dz_1    the element work of the plain version (h recomputed as the
          forward rounds it, the first argmax over k, half the cotangent at
          ReLU(0)), in float32
  de      dz_1 W_1^T as float32 FMAs over the channels in order
  dW_1    e^T dz_1 as float32 FMAs: each of `dw_parts` parts of a tile's
          rows over the block's tiles in order (`bwd_edge_plan`,
          `stage_shares`), a part's rows in order; the parts added in order,
          the blocks' partials in block order
  dq      sum_k (de[3:] - de[:3]) in k order; dscat the neighbour scatter
          in row order

On the edge call of a real float32 backward at B=2, N=64, k=20, full widths,
each output stays within the float32 limit (1e-4 of its largest value) of
the float32 plain version (`bwd_edge_reference`) and of a float64
evaluation, where one TF32 product does not: the numerical argument of the
design, checked before the card runs it."""
import numpy as np
import pytest
import torch

from ogmm_tpu_torch.ops import cuda_dgcnn_bwd
from ogmm_tpu_torch.ops import dgcnn_train as ops_dgcnn_train
from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import (bn_apply, bwd_edge_reference,
                                              max_vjp, relu_vjp)
from test_torch_mlp_bwd_tf32x3 import first_argmax, stepped, tile_rows

LIM_BWD_F32 = 1e-4       # chip_smoke.py's limit of the float32 routes


@pytest.fixture(scope="module")
def edge_call():
    """The edge call of a real float32 backward at B=2, N=64, k=20, full
    widths, recorded with its arguments while the plain versions run it (as
    chip_smoke.py's bwd_calls on the card)."""
    rs = np.random.RandomState(0)
    B, N = 2, 64
    calls = []

    def record(*a, **kw):
        calls.append((a, kw))
        return bwd_edge_reference(*a, **kw)

    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3)
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, 512)]
    ws = [torch.tensor(rs.randn(*d).astype(np.float32) / np.sqrt(d[0]),
                       requires_grad=True) for d in dims]
    gs = [torch.tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32)) for d in dims]
    bs = [torch.tensor(rs.randn(d[1]).astype(np.float32) * 0.1) for d in dims]
    saved = (ops_dgcnn_train.bwd_edge, ops_dgcnn_train.BWD_KERNELS)
    try:
        ops_dgcnn_train.bwd_edge = record
        ops_dgcnn_train.BWD_KERNELS = True
        out, _, _ = ops_dgcnn_train.dgcnn_train(x, ws, gs, bs, 20, torch.float32)
        wvec = torch.tensor(rs.randn(B, N, 512).astype(np.float32))
        (out * wvec).sum().backward()
    finally:
        ops_dgcnn_train.bwd_edge, ops_dgcnn_train.BWD_KERNELS = saved
    assert len(calls) == 1 and calls[0][0][0].dtype == torch.float32
    return calls[0]


def fma_rows(a, b):
    """a (R, K) @ b (K, M) as float32 FMAs over K in order."""
    acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.float32)
    for k in range(a.shape[1]):
        acc = (acc.double() + a[:, k:k + 1].double() * b[k:k + 1].double()).float()
    return acc


def weight_gradient(e, dz):
    """dW_1 = e^T dz_1: per block, each part of a tile's rows (`dw_parts`,
    one a thread) summed over the block's tiles in order, a tile's rows of
    the part in order, as float32 FMAs; the parts added in order, then the
    blocks' partials in block order."""
    B, k, N, C = dz.shape
    plan = cuda_dgcnn_bwd.bwd_edge_plan(B, N, k, torch.float32)
    te, td = (tile_rows(t.float(), plan["points_a_tile"]) for t in (e, dz))
    parts = plan["dw_parts"]
    per = te.shape[1] // parts
    dw = torch.zeros(e.shape[-1], C, dtype=torch.float32)
    for a, b in cuda_dgcnn_bwd.stage_shares(plan["tiles"], plan["blocks"]):
        acc = torch.zeros(parts, e.shape[-1], C, dtype=torch.float32)
        for i in range(a, b):
            for k in range(per):   # row k of every part at once
                rows = torch.arange(parts) * per + k
                acc = (acc.double() + te[i, rows, :, None].double()
                       * td[i, rows, None, :].double()).float()
        block = torch.zeros_like(dw)
        for q in range(parts):
            block = block + acc[q]
        dw = dw + block
    return dw


def edge_emulated(z1, dtap1, mean1, var1, gamma1, beta1, s12, dz2, w2, e, w1,
                  idx, terms="three"):
    """(dW_1, dq, dscat) with the edge kernel's arithmetic; 'exact' takes
    the products and what follows them in float64."""
    B, k, N, C = z1.shape
    exact = terms == "exact"
    dt = torch.float64 if exact else torch.float32
    m = B * k * N

    def zhat(zz):   # as `cuda_dgcnn_bwd._zhat`, in dt
        return (zz.to(dt) - mean1.to(dt)) * torch.rsqrt(var1 + cuda_dgcnn_bwd.EPS).to(dt)

    y = bn_apply(z1, mean1, var1, gamma1, beta1)        # as the forward rounds it
    a, b = dz2.reshape(-1, C), w2.t()
    if exact:
        extra = a.double() @ b.double()
    else:
        halves = cuda_dgcnn_bwd.bwd_edge_plan(B, N, k, torch.float32)["extra_k_slices"]
        kj = C // halves
        extra = stepped(a[:, :kj], b[:kj], terms)
        for h in range(1, halves):
            extra = extra + stepped(a[:, h * kj:(h + 1) * kj], b[h * kj:(h + 1) * kj], terms)
    dh = max_vjp(dtap1, torch.relu(y)).to(dt) + extra.view(B, k, N, C)
    ig = (torch.rsqrt(var1 + cuda_dgcnn_bwd.EPS) * gamma1).to(dt)
    dz = ig * ((relu_vjp(dh, y.to(dt)) - s12[0].to(dt) / m)
               - zhat(z1) * (s12[1].to(dt) / m))
    if exact:
        de = dz.reshape(-1, C) @ w1.double().t()
        dw = e.reshape(-1, 6).double().t() @ dz.reshape(-1, C)
        de = de.view(B, k, N, 6)
        dq = (de[..., 3:] - de[..., :3]).sum(dim=1)
        rows = idx.long().transpose(1, 2) + N * torch.arange(B).view(B, 1, 1)
        dscat = torch.zeros(B * N, 3, dtype=torch.float64)
        dscat.index_add_(0, rows.reshape(-1), de[..., :3].reshape(-1, 3))
        return dw, dq, dscat.view(B, N, 3)
    de = fma_rows(dz.reshape(-1, C), w1.t()).view(B, k, N, 6)
    diff = de[..., 3:] - de[..., :3]
    dq = torch.zeros(B, N, 3, dtype=torch.float32)
    for j in range(k):
        dq = dq + diff[:, j]
    _, dscat = cuda_dgcnn_bwd.edge_vjp(de, idx)   # index_add_ in row order
    return weight_gradient(e, dz), dq, dscat


def _errors(edge_call, terms):
    """Each output's largest error against the float32 plain version and the
    float64 evaluation, as a share of the output's largest value."""
    a, kw = edge_call
    got = edge_emulated(*a, **kw, terms=terms)
    plain = bwd_edge_reference(*a, **kw)
    exact = edge_emulated(*a, **kw, terms="exact")
    errs = []
    for g, p, x in zip(got, plain, exact):
        assert g.shape == p.shape and g.dtype == p.dtype == torch.float32
        scale = p.abs().max().item()
        errs.append(((g.double() - p.double()).abs().max().item() / scale,
                     (g.double() - x).abs().max().item() / scale))
    return errs


def test_three_tf32_products_hold_the_float32_limit(edge_call):
    errs = _errors(edge_call, "three")
    for to_plain, to_exact in errs:
        assert to_plain <= LIM_BWD_F32 and to_exact <= LIM_BWD_F32, errs


def test_one_tf32_product_would_not(edge_call):
    errs = _errors(edge_call, "one")
    assert max(e for pair in errs for e in pair) > LIM_BWD_F32, errs


def test_the_kernels_argmax_rows_are_the_plain_versions(edge_call):
    # the kernel's lane pairs keep a running first maximum of max(y, 0) over
    # k (group_argmax); the plain version's max-VJP takes torch's argmax
    a, _ = edge_call
    z1, mean1, var1, gamma1, beta1 = a[0], *a[2:6]
    h = torch.relu(bn_apply(z1, mean1, var1, gamma1, beta1))
    assert torch.equal(first_argmax(h), h.argmax(dim=1))
    h = torch.relu(bn_apply(z1, mean1, var1, gamma1, beta1 - 100.0))
    assert (h == 0).all() and (first_argmax(h) == 0).all()
