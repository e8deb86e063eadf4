"""The arithmetic of the float32 DGCNN stage chain on the tensor cores
(`csrc/dgcnn_eval.cu`: dgcnn_stage_tf32_kernel, dgcnn_head_tf32_kernel),
emulated in plain PyTorch on the CPU.

Each float32 operand v is split into hi = tf32(v) and lo = tf32(v - hi),
TF32 being `cvt.rna.tf32.f32`: to nearest, ties away from zero, 10 mantissa
bits; each product a b is taken as a_lo b_hi + a_hi b_lo + a_hi b_hi. Those
products of TF32 values are exact, so the emulation forms them in float64,
sums in float64, rounds to float32 and adds the bias in float32, as the
kernel's epilogue does. At the shapes and magnitudes of `chip_smoke.py`'s
dgcnn check (B=2, N=64, k=20, full widths, emb 512) it stays within the
float32 route's limit of 1e-4 of a float64 evaluation and of the float32
plain version (`dgcnn_eval_reference`), where one TF32 product does not:
the numerical argument of the design, checked before the card runs it."""
import numpy as np
import pytest
import torch

from ogmm_tpu_torch.ops.common import (gather_neighbors, select_smallest,
                                       square_distance3)
from ogmm_tpu_torch.ops.cuda_dgcnn import dgcnn_eval_reference, fold_weights

LIM_DGCNN_F32 = 1e-4     # chip_smoke.py's limit of the float32 route


def tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 holding the TF32 rounding of v: add half of the 13
    dropped bits to the magnitude's bits (ties carry away from zero), then
    clear them, as cvt.rna.tf32.f32 does."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor):
    hi = tf32(v)
    return hi, tf32(v.float() - hi)


def dense(h: torch.Tensor, w: torch.Tensor, terms: str) -> torch.Tensor:
    """h (..., cin) @ w (cin, cout), float32 operands: 'one' one TF32
    product, 'three' the kernel's three, 'exact' in float64 (float64
    result)."""
    if terms == "exact":
        return h.double() @ w.double()
    hh, hl = split(h)
    wh, wl = split(w)
    if terms == "one":
        return (hh.double() @ wh.double()).float()
    return (hl.double() @ wh.double() + hh.double() @ wl.double()
            + hh.double() @ wh.double()).float()


def stage_chain(x, weights, affines, k, terms):
    """The stage chain over the plain version's graph; the weights folded in
    float32 as the plain version folds them."""
    idx = select_smallest(square_distance3(x, x), k)
    nbr = gather_neighbors(x, idx)
    center = x.unsqueeze(2).expand_as(nbr)
    h = torch.cat([nbr - center, center], dim=-1)
    ws, bs = fold_weights(weights, affines, torch.float32)
    if terms == "exact":
        h = h.double()
        bs = [b.double() for b in bs]
    taps = []
    for w, b in zip(ws[:4], bs[:4]):
        h = torch.relu(dense(h, w, terms) + b)
        taps.append(h.amax(dim=2))
    return torch.relu(dense(torch.cat(taps, dim=-1), ws[4], terms) + bs[4])


@pytest.fixture(scope="module")
def inputs():
    """chip_smoke.py's check_dgcnn inputs at a small size."""
    rs = np.random.RandomState(0)
    x = torch.tensor(rs.randn(2, 64, 3).astype(np.float32) * 0.3)
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, 512)]
    ws = [torch.tensor(rs.randn(*d).astype(np.float32) / np.sqrt(d[0])) for d in dims]
    aff = [(torch.tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32)),
            torch.tensor(rs.randn(d[1]).astype(np.float32) * 0.1)) for d in dims]
    return x, ws, aff


@pytest.fixture(scope="module")
def outputs(inputs):
    x, ws, aff = inputs
    return {terms: stage_chain(x, ws, aff, 20, terms)
            for terms in ("exact", "three", "one")}


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                       # TF32's spacing at 1
    v = torch.tensor([one, one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                      one + 3 * ulp / 2, 3.0e-3, -7.25, 0.0], dtype=torch.float32)
    got = tf32(v)
    want = torch.tensor([one, one + ulp, -(one + ulp), one, one + 2 * ulp,
                         np.float32(3.0e-3), -7.25, 0.0], dtype=torch.float32)
    want[5] = float(np.round(3.0e-3 / 2.0 ** -19) * 2.0 ** -19)   # 2^-9 <= v < 2^-8
    assert torch.equal(got, want)
    # 10 mantissa bits kept, within half a TF32 ulp
    r = torch.tensor(np.random.RandomState(1).randn(10000).astype(np.float32))
    t = tf32(r)
    assert torch.all((t.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((t - r).abs() <= r.abs() * 2.0 ** -11)


def test_split_holds_a_float32_value_to_2_pow_minus_22():
    r = torch.tensor(np.random.RandomState(2).randn(10000).astype(np.float32))
    hi, lo = split(r)
    rel = ((hi.double() + lo.double()) - r.double()).abs() / r.double().abs()
    assert rel.max().item() <= 2.0 ** -22


def test_three_tf32_products_hold_the_float32_limit(inputs, outputs):
    x, ws, aff = inputs
    three, exact = outputs["three"], outputs["exact"]
    plain = dgcnn_eval_reference(x, ws, aff, 20, torch.float32)
    assert three.shape == plain.shape == (2, 64, 512)
    # outputs of order one (the largest 1.49), as on the card
    assert 1.0 < exact.abs().max().item() < 16.0
    err_exact = (three.double() - exact).abs().max().item()
    err_plain = (three - plain).abs().max().item()
    assert err_exact <= LIM_DGCNN_F32 and err_plain <= LIM_DGCNN_F32
    # and as close as true float32 is to float64, within a few times
    assert err_exact <= 4 * max((plain.double() - exact).abs().max().item(), 1e-6)


def test_one_tf32_product_would_not(outputs):
    err = (outputs["one"].double() - outputs["exact"]).abs().max().item()
    assert err > LIM_DGCNN_F32
