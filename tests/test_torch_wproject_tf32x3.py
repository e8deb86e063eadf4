"""The arithmetic of the float32 overlap projection on the tensor cores
(`csrc/wproject.cu`: wproject_tf32_kernel, wproject_merge_kernel), emulated
in plain PyTorch on the CPU.

Each logit q . k is taken as three TF32 products (`test_torch_tf32x3.py`'s
`split`: q_lo k_hi + q_hi k_lo + q_hi k_hi), added into one float32
accumulator as the kernel's wgmmas add them: k8 step by k8 step (eight
features of a chunk of 32 in the kernel's order), each product's eight
exact terms summed and rounded into the accumulator. The
online softmax then runs as the kernel runs it: the units of the persistent
grid over tiles of 256 keys (`cuda_stream.wproject_units`), each unit's key
tiles in the kernel's rotated order (`cuda_stream.wproject_key_tiles`), in
base 2 in float32, and a row's partials merged in unit order. On
l2-normalised noisy copies at D = 512 (`chip_smoke.py`'s features), with and
without a direction that every feature shares (as trained features do), the
result stays within the projection's limit of the float32 plain version and
of a float64 evaluation; one TF32 product a logit does not keep the row
logsumexp as close where the features share a direction: the numerical
argument for three products, checked before the card runs the kernel. The
emulation rounds every float32 sum to nearest; the tensor cores' own sums
do not, and on the card the kernel's lse comes out about 1e-6 low on trained
features, still far inside the limit."""
import math

import numpy as np
import pytest
import torch

from ogmm_tpu_torch.ops import cuda_stream
from ogmm_tpu_torch.ops.stream import wproject_stream_lse_plain
from test_torch_tf32x3 import split

LIM_WPROJECT = 1e-4      # chip_smoke.py's limit of the projection
N, M, D = 128, 8192, 512
L2E = 1.0 / math.log(2.0)


def features(seed, shared):
    """(q (1, N, D), k (1, M, D), v (1, M, 1)) float32: q and k rows
    l2-normalised noisy copies of common rows (cosines up to ~0.9); with
    `shared`, every row also carries one common direction of that weight
    (mean cosine ~0.5)."""
    rs = np.random.RandomState(seed)
    base = rs.randn(M, D)
    if shared:
        u = rs.randn(D)
        base += shared * np.sqrt(D) * u / np.linalg.norm(u)
    q = base[rs.permutation(M)[:N]] + 0.3 * rs.randn(N, D)
    k = base + 0.3 * rs.randn(M, D)
    l2 = lambda a: torch.tensor((a / np.linalg.norm(a, axis=-1, keepdims=True))
                                .astype(np.float32))[None]
    return l2(q), l2(k), torch.tensor(rs.randn(1, M, 1).astype(np.float32))


# the kernel's k8 steps: step st of the chunk of 32 features at f0 takes
# features f0 + 8 j + 2 st + h, j = 0..3, h = 0, 1 (csrc/wproject.cu: the
# order of a chunk's features along the products' depth)
STEPS = [[f0 + 8 * j + 2 * st + h for j in range(4) for h in range(2)]
         for f0 in range(0, D, 32) for st in range(4)]


def logits(q, k, terms):
    """(1, N, M) float32 logits as the kernel forms them: for each k8 step
    the products ('three': q_lo k_hi, q_hi k_lo, q_hi k_hi; 'one': q_hi
    k_hi), each an exact float64 sum of eight TF32 products rounded into the
    float32 accumulator."""
    qh, ql = (a.double() for a in split(q))
    kh, kl = (a.double().transpose(1, 2) for a in split(k))
    pairs = ([(ql, kh), (qh, kl), (qh, kh)] if terms == "three" else [(qh, kh)])
    acc = torch.zeros(1, N, M, dtype=torch.float32)
    for idx in STEPS:
        for a, b in pairs:
            acc = (acc.double() + a[:, :, idx] @ b[:, idx]).float()
    return acc


def fma32(a, b, c):
    """float32 fma: the exact a b + c rounded once (float64 holds a b)."""
    return (a.double() * b.double() + c.double()).float()


def online_softmax(s, v, blocks):
    """out, lse (1, N, 1) from logits s (1, N, M) as the kernel's units and
    the merge take them: per unit its key tiles in the kernel's order, a
    running (m, l, acc) in base 2 in float32; the partials of a row merged
    in unit (block) order."""
    keys = cuda_stream.WPROJECT_F32_KEYS
    units = cuda_stream.wproject_units(1, N, M, blocks, keys)
    order = cuda_stream.wproject_key_tiles(1, N, M, blocks, keys)
    l2e = torch.tensor(L2E, dtype=torch.float32)
    parts = []
    for (_, _, tile, _, _), tiles in zip(units, order):
        assert tile == 0                        # N = 128: one query tile
        m = torch.full((N,), -math.inf)
        l, a = torch.zeros(N), torch.zeros(N)
        for kt in tiles:
            st = s[0, :, kt * keys:(kt + 1) * keys]
            vt = v[0, kt * keys:(kt + 1) * keys, 0]
            m_new = torch.maximum(m, st.amax(-1) * l2e)
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(fma32(st, l2e, -m_new[:, None]))
            l = fma32(l, alpha, p.sum(-1))
            a = fma32(a, alpha, (p * vt).sum(-1))
            m = m_new
        parts.append((m, l, a))
    mx = torch.stack([p[0] for p in parts]).amax(0)
    l = torch.zeros(N)
    a = torch.zeros(N)
    for pm, pl, pa in parts:
        w = torch.exp2(pm - mx)
        l = fma32(pl, w, l)
        a = fma32(pa, w, a)
    lse = (mx + torch.log2(l)) * torch.tensor(math.log(2.0), dtype=torch.float32)
    return (a / l).reshape(1, N, 1), lse.reshape(1, N, 1)


def float64_result(q, k, v):
    s = q.double() @ k.double().transpose(1, 2)
    return torch.softmax(s, -1) @ v.double(), torch.logsumexp(s, -1, keepdim=True)


@pytest.fixture(scope="module", params=[0.0, 1.0], ids=["noisy_copies", "shared_direction"])
def case(request):
    q, k, v = features(21, request.param)
    return {"shared": request.param, "q": q, "k": k, "v": v,
            "three": logits(q, k, "three"), "one": logits(q, k, "one"),
            "plain": wproject_stream_lse_plain(q, k, v), "f64": float64_result(q, k, v)}


def test_features_are_unit_rows_with_high_cosines(case):
    q, k = case["q"], case["k"]
    assert torch.allclose(q.norm(dim=-1), torch.ones(1, N), atol=1e-6)
    s = case["f64"]
    cos = (q.double() @ k.double().transpose(1, 2))
    assert 0.8 < cos.amax().item() < 1.0
    mean = cos.mean().item()
    assert (abs(mean) < 0.01) if case["shared"] == 0.0 else (0.3 < mean < 0.7)
    assert 8.5 < s[1].mean().item() < 11.0          # lse ~ log M at cosines ~0


@pytest.mark.parametrize("blocks", [1, 3, 7])
def test_three_tf32_products_hold_the_limit(case, blocks):
    # 32 key tiles of 256 in one query tile: on 3 and 7 blocks the tile
    # splits into units, each reading its key tiles rotated
    out, lse = online_softmax(case["three"], case["v"], blocks)
    for want_out, want_lse in (case["plain"], case["f64"]):
        assert (out.double() - want_out.double()).abs().max().item() <= LIM_WPROJECT
        assert (lse.double() - want_lse.double()).abs().max().item() <= LIM_WPROJECT
    # the logits themselves: 512 products off by about 2^-22 each, and the
    # float32 accumulator's roundings over 192 products
    exact = case["q"].double() @ case["k"].double().transpose(1, 2)
    assert (case["three"].double() - exact).abs().max().item() < 1e-6


def test_one_tf32_product_misses_where_features_share_a_direction(case):
    # one TF32 product a logit: logits ~1e-4 off on either features; on
    # features sharing a direction the errors share a sign, and the row
    # logsumexp moves by more than a tenth of the limit (three products:
    # a few float32 ulps of an lse near 10, 9.5e-7 each)
    exact = case["q"].double() @ case["k"].double().transpose(1, 2)
    assert (case["one"].double() - exact).abs().max().item() > 2e-5
    _, lse_one = online_softmax(case["one"], case["v"], 3)
    _, lse_three = online_softmax(case["three"], case["v"], 3)
    lse64 = case["f64"][1]
    err_one = (lse_one.double() - lse64).abs().max().item()
    err_three = (lse_three.double() - lse64).abs().max().item()
    assert err_three < 4e-6
    if case["shared"]:
        assert err_one >= LIM_WPROJECT / 10
    else:
        assert err_one < LIM_WPROJECT / 10
