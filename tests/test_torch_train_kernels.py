"""The plain versions of the training slice's kernels against the JAX
package on the CPU: `graph_stage1_reference` against `graph_stage1_pallas`
(interpret mode) and the jnp `_graph_stage1`, `nn1_reference` against
`nn1_pallas` (interpret mode) and the port's `nn1` dispatch point."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu.ops.dgcnn_train import _graph_stage1 as jgraph_stage1
from ogmm_tpu.ops.pallas_dgcnn_train import graph_stage1_pallas
from ogmm_tpu.ops.pallas_knn import nn1_pallas
from ogmm_tpu_torch.ops import common
from ogmm_tpu_torch.ops.cuda_dgcnn_train import (graph_stage1,
                                                 graph_stage1_reference)
from ogmm_tpu_torch.ops.cuda_knn import nn1, nn1_reference

from torch_port_util import clouds, n, t

# z1 tolerance: float32 tight (six products, another summation order); bf16
# one rounding of values below ~2, so one ulp = 2^-7 (0.0078)
TOL_Z1 = {"float32": 1e-5, "bfloat16": 0.0079}
TOL_ALPHA = 1e-5       # cosines from float32 coordinates, centroid order


def _w1(seed):
    return (np.random.RandomState(seed).randn(6, 64) / np.sqrt(6)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,posenc_k", [(8, 4), (20, 5), (40, 5)])
def test_graph_stage1_matches_pallas_interpret_and_jnp(dtype, k, posenc_k):
    x, w1 = clouds(21, B=2, N=72), _w1(21)
    tdt = getattr(torch, dtype)
    z1, e, idx, alpha = graph_stage1_reference(t(x), t(w1), k, tdt, posenc_k)
    assert z1.shape == (2, k, 72, 64) and e.shape == (2, k, 72, 6)
    assert z1.dtype == e.dtype == tdt and idx.dtype == torch.int32
    pallas = graph_stage1_pallas(jnp.asarray(x), jnp.asarray(w1), k=k,
                                 tile_n=32, dtype=dtype, interpret=True,
                                 posenc_k=posenc_k)
    ref = jgraph_stage1(jnp.asarray(x), jnp.asarray(w1), k, jnp.dtype(dtype),
                        posenc_k=posenc_k)
    for jz1, je, jidx, jalpha in (pallas, ref):
        np.testing.assert_array_equal(n(idx), np.asarray(jidx))
        # the offset is formed in float32 and rounded once: identical
        np.testing.assert_array_equal(n(e), n(je))
        np.testing.assert_allclose(n(z1), n(jz1), atol=TOL_Z1[dtype], rtol=0)
        np.testing.assert_allclose(n(alpha), n(jalpha), atol=TOL_ALPHA)


def test_graph_stage1_without_angles_and_wrapper_on_cpu():
    x, w1 = clouds(22, B=1, N=40), _w1(22)
    got = graph_stage1(t(x), t(w1), 8, torch.float32, 0)
    want = graph_stage1_reference(t(x), t(w1), 8, torch.float32, 0)
    assert got[3] is None and want[3] is None
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="posenc_k"):
        graph_stage1_reference(t(x), t(w1), 4, torch.float32, 5)


def test_graph_stage1_coincident_points_tie_to_the_lowest_index():
    x = clouds(23, B=1, N=48)
    x[0, 30] = x[0, 5]
    x[0, 41] = x[0, 5]
    idx = graph_stage1_reference(t(x), t(_w1(23)), 8, torch.float32, 0)[2]
    jidx = graph_stage1_pallas(jnp.asarray(x), jnp.asarray(_w1(23)), k=8,
                               tile_n=16, dtype="float32", interpret=True)[2]
    np.testing.assert_array_equal(n(idx), np.asarray(jidx))
    assert list(n(idx)[0, 5, :3]) == [5, 30, 41]


@pytest.mark.parametrize("nq,m", [(32, 72), (72, 72), (16, 130)])
def test_nn1_matches_pallas_interpret(nq, m):
    src, tgt = clouds(24, B=2, N=nq), clouds(25, B=2, N=m)
    d, i = nn1_reference(t(src), t(tgt))
    jd, ji = nn1_pallas(jnp.asarray(src), jnp.asarray(tgt), tile_n=16,
                        interpret=True)
    assert i.dtype == torch.int64 and d.dtype == torch.float32
    np.testing.assert_array_equal(n(i), np.asarray(ji))
    # the Pallas kernel forms the inner product as one HIGHEST matmul, the
    # port in a fixed elementwise order: float32 round-off of values < 4
    np.testing.assert_allclose(n(d), np.asarray(jd), atol=2e-6)


def test_nn1_ties_take_the_first_index_and_the_clamp():
    tgt = clouds(26, B=1, N=20)
    tgt[0, 12] = tgt[0, 3]                   # two equal nearest points
    src = tgt[:, [3, 7]].copy()              # exact hits
    d, i = nn1_reference(t(src), t(tgt))
    jd, ji = nn1_pallas(jnp.asarray(src), jnp.asarray(tgt), tile_n=8,
                        interpret=True)
    np.testing.assert_array_equal(n(i), np.asarray(ji))
    assert list(n(i)[0]) == [3, 7]
    np.testing.assert_allclose(n(d), np.asarray(jd), atol=1e-7)
    assert n(d).max() <= 1e-6                # clamped at 1e-12


def test_nn1_dispatch_point_and_both_directions():
    src, tgt = clouds(27, B=2, N=30), clouds(28, B=2, N=50)
    d, i = common.nn1(t(src), t(tgt))
    rd, ri = nn1(t(src), t(tgt))
    assert torch.equal(d, rd) and torch.equal(i, ri)
    ds, dt = common.nn1_both(t(src), t(tgt))
    full = common.square_distance3(t(src), t(tgt))
    assert torch.equal(ds, full.min(-1).values)
    assert torch.equal(dt, full.min(-2).values)
