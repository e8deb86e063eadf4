"""The port's streamed kernels' plain versions and the large-cloud routes
(`ogmm_tpu_torch/ops/stream.py`, `ops/cuda_stream.py`, the edges route of
`ops/cuda_dgcnn.py`) against the JAX package's Pallas kernels in interpret
mode (`ogmm_tpu/ops/pallas_stream.py`, `pallas_dgcnn.py:dgcnn_edges_pallas`),
on seeded numpy inputs at small sizes with small tiles.

The port forms kNN distances in one fixed float32 order
(`square_distance3`), the JAX package as an einsum: neighbours may differ
only where two distances tie to float32 round-off (held to 1e-6 relative in
float64), and 1-NN distances agree to a few float32 ulps of |x|^2 (1e-6
absolute). The Morton codes,
the sort and the un-sort are the same integers on both sides. The port's
kernels use tiles of their own (64 queries, 512 targets) and build their
cull tables for them; culling and visiting order never change a result."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ogmm_tpu.ops.pallas_stream as jps
from ogmm_tpu.ops.pallas_dgcnn import dgcnn_edges_pallas
from ogmm_tpu_torch.ops import common as tcommon
from ogmm_tpu_torch.ops import cuda_stream, stream
from ogmm_tpu_torch.ops.cuda_dgcnn import dgcnn_edges, dgcnn_edges_reference

from torch_port_util import assert_same_up_to_ties, knn_lanes_mirror, n, t

TN, TM = 32, 64          # the JAX kernels' tiles here: several of each


def _surface(seed, B, N):
    """A height field with noise, as indoor fragments are: Morton tiles of
    it are compact, so the cull skips tiles."""
    rs = np.random.RandomState(seed)
    u = rs.rand(B, N, 2)
    z = 0.3 * np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    return (np.concatenate([u, z], -1) + 0.01 * rs.randn(B, N, 3)).astype(np.float32)


def _clouds(seed, B, N, M):
    src, tgt = _surface(seed, B, N), _surface(seed + 1, B, M)
    tgt[:, M - 17] = tgt[:, 3]            # exact ties across target tiles
    src[:, 5] = tgt[:, 3]                 # an exact hit: the 1e-12 clamp
    return src, tgt


def _sorted(x):
    return np.take_along_axis(x, n(stream.morton_order(t(x)))[..., None], 1)


def _kth(src, tgt, idx):
    """float64 distance of each row's last neighbour."""
    nb = np.take_along_axis(tgt[:, None], idx[..., -1:, None], axis=2)[:, :, 0]
    return ((src.astype(np.float64) - nb) ** 2).sum(-1)


def test_morton_codes_and_cull_tables_match_jax():
    x = _surface(0, 2, 300)
    assert np.array_equal(n(stream.morton3(t(x))),
                          np.asarray(jps._morton3(jnp.asarray(x))).astype(np.int64))
    q = x[:, :90] - 0.2
    mn = np.minimum(q.min(1, keepdims=True), x.min(1, keepdims=True))
    mx = np.maximum(q.max(1, keepdims=True), x.max(1, keepdims=True))
    assert np.array_equal(
        n(stream.morton3(t(q), (t(mn), t(mx)))),
        np.asarray(jps._morton3(jnp.asarray(q), box=(jnp.asarray(mn),
                                                     jnp.asarray(mx)))).astype(np.int64))
    # a stable sort, as jnp.argsort: equal codes keep their row order
    dup = np.repeat(x[:, :50], 3, axis=1)
    assert np.array_equal(n(stream.morton_order(t(dup))),
                          np.asarray(jnp.argsort(jps._morton3(jnp.asarray(dup)),
                                                 axis=-1)))
    xs = _sorted(x)
    for tn, tm in ((TN, TM), (stream.TILE_N, stream.TILE_M)):
        np.testing.assert_allclose(
            n(stream.pair_tile_bounds(t(q), t(xs), tn, tm)),
            np.asarray(jps._pair_tile_bounds(jnp.asarray(q), jnp.asarray(xs),
                                             tn, tm)), rtol=1e-6, atol=1e-9)
    lb = n(stream.tile_pair_bounds(t(xs)))
    assert lb.shape == (2, 5, 1) and (lb == 0).all()   # one target tile


@pytest.mark.parametrize("diag,cull", [(False, False), (True, True)])
def test_knn_stream_matches_jax_kernel(diag, cull):
    src, tgt = (_sorted(a) for a in _clouds(1, 2, 150, 117))
    lb = jps._pair_tile_bounds(jnp.asarray(src), jnp.asarray(tgt), TN, TM) \
        if cull else None
    want = jps.knn_stream(jnp.asarray(src), jnp.asarray(tgt), 8, tile_n=TN,
                          tile_m=TM, interpret=True, diag_order=diag,
                          cull_lb=lb)
    kw = dict(diag_order=diag,
              cull_lb=stream.pair_tile_bounds(t(src), t(tgt)) if cull else None)
    got = cuda_stream.knn_stream(t(src), t(tgt), 8, **kw)
    assert got.dtype == torch.int64 and got.shape == (2, 150, 8)
    assert_same_up_to_ties(n(got), want, src, tgt)
    np.testing.assert_allclose(_kth(src, tgt, n(got)),
                               _kth(src, tgt, np.asarray(want)), rtol=1e-6)
    # the plain version ignores the cull and the order: the exact kNN
    assert torch.equal(got, tcommon.select_smallest(
        tcommon.square_distance3(t(src), t(tgt)), 8))


def test_knn_stream_ties_go_to_the_lowest_index():
    # every target point the same: 0..k-1 for every query, as the JAX kernel
    src, tgt = np.zeros((1, 8, 3), np.float32), np.ones((1, 40, 3), np.float32)
    got = cuda_stream.knn_stream(t(src), t(tgt), 6, diag_order=True,
                                 cull_lb=stream.pair_tile_bounds(t(src), t(tgt)))
    want = jps.knn_stream(jnp.asarray(src), jnp.asarray(tgt), 6, tile_n=8,
                          tile_m=16, interpret=True, diag_order=True)
    assert np.array_equal(n(got), np.asarray(want))
    assert np.array_equal(n(got), np.broadcast_to(np.arange(6), (1, 8, 6)))


def test_self_graphs_match_jax():
    x = _surface(2, 2, 200)
    x[:, 77] = x[:, 12]                    # a duplicated point
    jx = jnp.asarray(x)
    # v-space: the same sorted cloud and un-sort, the graph in sorted rows
    xs, idx, inv = stream.knn_self_vspace(t(x), 10)
    jxs, jidx, jinv = jps.knn_self_vspace(jx, 10, tile_n=TN, tile_m=TM,
                                          interpret=True)
    assert np.array_equal(n(xs), np.asarray(jxs))
    assert np.array_equal(n(inv), np.asarray(jinv))
    assert_same_up_to_ties(n(idx), jidx, n(xs), n(xs))
    assert np.array_equal(n(xs)[np.arange(2)[:, None], n(inv)], x)
    # the same graph in original ids
    got = stream.knn_self_spatial(t(x), 10)
    want = jps.knn_self_spatial(jx, 10, tile_n=TN, tile_m=TM, interpret=True)
    assert_same_up_to_ties(n(got), want, x, x)
    np.testing.assert_allclose(_kth(x, x, n(got)), _kth(x, x, np.asarray(want)),
                               rtol=1e-6)


def test_cross_graph_matches_jax():
    q, x = _surface(3, 2, 90), _surface(4, 2, 230)
    got = stream.knn_cross_spatial(t(q), t(x), 6)
    want = jps.knn_cross_spatial(jnp.asarray(q), jnp.asarray(x), 6,
                                 tile_n=TN, tile_m=TM, interpret=True)
    assert_same_up_to_ties(n(got), want, q, x)
    # the routed entry point of a cross query above M = 4096 goes here
    assert tcommon.knn_route(2, 90, 4097, 3, 6) == "stream"


def test_nn1_stream_matches_jax_kernel_with_cull_and_gate():
    src, tgt = (_sorted(a) for a in _clouds(5, 2, 150, 140))
    gate = 0.003
    jlb = jps._pair_tile_bounds(jnp.asarray(src), jnp.asarray(tgt), TN, TM)
    jd, ji = jps.nn1_stream(jnp.asarray(src), jnp.asarray(tgt), tile_n=TN,
                            tile_m=TM, interpret=True, cull_lb=jlb,
                            max_dist_sq=gate)
    d, i = cuda_stream.nn1_stream(t(src), t(tgt),
                                  cull_lb=stream.pair_tile_bounds(t(src), t(tgt)),
                                  max_dist_sq=gate, diag_order=True)
    assert d.dtype == torch.float32 and i.dtype == torch.int64
    inside = n(d) < gate               # the rows a gated consumer reads
    assert inside.mean() > 0.5
    assert np.array_equal(n(i)[inside], np.asarray(ji)[inside])
    # (|q|^2 + |t|^2) - 2 q.t cancels: the two float32 forms differ by a
    # few ulps of |x|^2 ~ 1, in absolute terms
    np.testing.assert_allclose(n(d)[inside], np.asarray(jd)[inside], atol=1e-6)
    # without a gate every row, against the JAX package's chunked 1-NN
    d, i = cuda_stream.nn1_stream(t(src), t(tgt))
    cd, ci = jps.nn1_chunked(jnp.asarray(src), jnp.asarray(tgt), chunk=64)
    assert np.array_equal(n(i), np.asarray(ci))
    np.testing.assert_allclose(n(d), np.asarray(cd), atol=1e-6)


def test_nn1_stream_t_matches_jax_kernel():
    src, tgt = _clouds(6, 2, 100, 130)
    jd, ji = jps.nn1_stream_t(jnp.asarray(src), jnp.asarray(tgt), tile_n=TN,
                              tile_m=TM, interpret=True)
    d, i = stream.nn1_stream_t(t(src), t(tgt))
    assert np.array_equal(n(i), np.asarray(ji))
    np.testing.assert_allclose(n(d), np.asarray(jd), atol=1e-6)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_wproject_matches_jax_kernel(dtype):
    rs = np.random.RandomState(7)
    B, N, M, D = 2, 70, 53, 64
    q = rs.randn(B, N, D).astype(np.float32)
    k = rs.randn(B, M, D).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True) / 3.0
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rs.randn(B, M, 1).astype(np.float32)
    jq, jk = jnp.asarray(q, dtype), jnp.asarray(k, dtype)
    want_out, want_lse = jps.wproject_stream_lse(jq, jk, jnp.asarray(v),
                                                 tile_n=TN, tile_m=16,
                                                 interpret=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    out, lse = cuda_stream.wproject_stream_lse(t(n(jq), tdt), t(n(jk), tdt), t(v))
    assert out.shape == lse.shape == (B, N, 1) and out.dtype == torch.float32
    # products exact in both (bf16 x bf16 fits float32), float32 sums of 64
    # products and of 53 terms in other orders: 1e-5
    np.testing.assert_allclose(n(out), np.asarray(want_out), atol=1e-5)
    np.testing.assert_allclose(n(lse), np.asarray(want_lse), atol=1e-5)
    np.testing.assert_allclose(n(out), np.asarray(jps.wproject_chunked(
        jq, jk, jnp.asarray(v), chunk=32)), atol=1e-5)


def _units_merged(q, k, v, blocks):
    """The bf16 kernel's arithmetic in plain float64 PyTorch: each unit of
    `wproject_units` makes its rows' partial (m, l, acc) in base 2 over its
    key range, and a tile's partials merge in ascending block order."""
    B, N, _ = q.shape
    M = k.shape[1]
    rows, keys = cuda_stream.WPROJECT_ROWS, cuda_stream.WPROJECT_KEYS
    n_qt = -(-N // rows)
    l2e = 1.0 / np.log(2.0)
    parts = {}
    for i, _, tile, k0, k1 in cuda_stream.wproject_units(B, N, M, blocks):
        b, r0 = tile // n_qt, (tile % n_qt) * rows
        s = q[b, r0:r0 + rows] @ k[b, k0 * keys:k1 * keys].T * l2e
        m = s.amax(-1)
        p = torch.exp2(s - m[:, None])
        parts.setdefault(tile, []).append(
            (i, m, p.sum(-1), p @ v[b, k0 * keys:k1 * keys, 0]))
    out, lse = torch.empty(B, N, 1, dtype=q.dtype), torch.empty(B, N, 1, dtype=q.dtype)
    for tile, ps in parts.items():
        assert [p[0] for p in ps] == sorted(p[0] for p in ps)
        mx = torch.stack([p[1] for p in ps]).amax(0)
        l = sum(p[2] * torch.exp2(p[1] - mx) for p in ps)
        a = sum(p[3] * torch.exp2(p[1] - mx) for p in ps)
        b, r0 = tile // n_qt, (tile % n_qt) * rows
        out[b, r0:r0 + rows, 0] = a / l
        lse[b, r0:r0 + rows, 0] = (mx + torch.log2(l)) / l2e
    return out, lse


@pytest.mark.parametrize("blocks", [1, 3, 7, 16])
def test_wproject_units_merged_in_kernel_order_match_plain_and_jax(blocks):
    # B=2, N=150, M=200: 2 query tiles of 128 rows x 4 key tiles of 64, so
    # units end inside a tile and a block may hold two tiles
    rs = np.random.RandomState(11)
    B, N, M, D = 2, 150, 200, 64
    q = rs.randn(B, N, D).astype(np.float32)
    k = rs.randn(B, M, D).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True) / 3.0
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rs.randn(B, M, 1).astype(np.float32)
    jq, jk = jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16)
    tq, tk = t(n(jq), torch.bfloat16), t(n(jk), torch.bfloat16)
    out, lse = _units_merged(tq.double(), tk.double(), t(v).double(), blocks)
    rout, rlse = stream.wproject_stream_lse_plain(tq, tk, t(v))
    want_out, want_lse = jps.wproject_stream_lse(jq, jk, jnp.asarray(v),
                                                 tile_n=TN, tile_m=16,
                                                 interpret=True)
    # float32 sums of 64 exact products and of 200 terms on the plain and
    # JAX sides against float64 here: 1e-5
    for want_o, want_l in ((rout, rlse), (t(np.asarray(want_out)), t(np.asarray(want_lse)))):
        np.testing.assert_allclose(n(out), n(want_o), atol=1e-5)
        np.testing.assert_allclose(n(lse), n(want_l), atol=1e-5)


def _edges_inputs(seed, dtype, N=70, k=6, emb=64):
    rs = np.random.RandomState(seed)
    x = _surface(seed, 2, N)
    idx = n(tcommon.select_smallest(tcommon.square_distance3(t(x), t(x)), k))
    nbr = np.take_along_axis(x[:, None], idx[..., None], axis=2)
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]
    ws = [(rs.randn(*d) / np.sqrt(d[0])).astype(np.float32) for d in dims]
    aff = [(rs.uniform(0.5, 1.5, d[1]).astype(np.float32),
            (rs.randn(d[1]) * 0.1).astype(np.float32)) for d in dims]
    return x, nbr, ws, aff


@pytest.mark.parametrize("dtype,rtol,atol,k", [
    pytest.param(jnp.float32, 1e-4, 2e-5, 6, id="float32-0.0001-2e-05"),
    pytest.param(jnp.bfloat16, 0.1, 0.05, 6, id="bfloat16-0.1-0.05"),
    # above 32 (the kernel's stage chain in chunks of 32)
    *[pytest.param(dt, rt, at, k, id=f"{dt.__name__}-k{k}")
      for k in (33, 40, 64) for dt, rt, at in ((jnp.float32, 1e-4, 2e-5),
                                               (jnp.bfloat16, 0.1, 0.05))]])
def test_dgcnn_edges_matches_jax_kernel(dtype, rtol, atol, k):
    # the bars of kernel 1's plain version against its Pallas kernel
    # (tests/test_torch_dgcnn.py)
    x, nbr, ws, aff = _edges_inputs(8, dtype, k=k)
    want = dgcnn_edges_pallas(jnp.asarray(x), jnp.asarray(nbr),
                              [jnp.asarray(w) for w in ws],
                              [(jnp.asarray(s), jnp.asarray(b)) for s, b in aff],
                              k=k, tile_n=32, dtype=dtype, interpret=True)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tws, taff = [t(w) for w in ws], [(t(s), t(b)) for s, b in aff]
    got = dgcnn_edges(t(x), t(nbr), tws, taff, k=k, dtype=tdt)
    assert got.dtype == tdt and got.shape == (2, 70, 64)
    assert torch.equal(got, dgcnn_edges_reference(t(x), t(nbr), tws, taff, k, tdt))
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=atol)


def test_plain_versions_by_chunks_equal_one_block():
    # query chunks of 1024 rows: the same bits as one (B, N, M) block
    src, tgt = _clouds(9, 1, 1100, 300)
    ts, tt = t(src), t(tgt)
    full = tcommon.square_distance3(ts, tt)
    assert torch.equal(stream.knn_stream_plain(ts, tt, 5),
                       tcommon.select_smallest(full, 5))
    d, i = stream.nn1_stream_plain(ts, tt)
    assert torch.equal(i, full.argmin(-1)) and torch.equal(d, full.amin(-1))
    rs = np.random.RandomState(10)
    q, k = t(rs.randn(1, 1100, 64)), t(rs.randn(1, 300, 64))
    v = t(rs.randn(1, 300, 1))
    out, lse = stream.wproject_stream_lse_plain(q, k, v)
    s = q @ k.transpose(1, 2)
    torch.testing.assert_close(out, torch.softmax(s, -1) @ v, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1, keepdim=True),
                               rtol=1e-5, atol=1e-6)


# ------------------------- the kNN kernel's lanes, mirrored on the CPU

def _tile_order(n_row, n_m, diag, stretch=1):
    """The target tiles a query row's block visits (knn_stream_kernel: ascending,
    or diagonal-first from the tile holding column tile * 64 * stretch)."""
    if not diag:
        return list(range(n_m))
    start = (n_row // stream.TILE_N) * stream.TILE_N * stretch // stream.TILE_M % n_m
    return [(start + ((t + 1) // 2) * (1 - 2 * (t % 2))) % n_m for t in range(n_m)]


def _knn_lanes_mirror(d, k, diag):
    """knn_stream_kernel's selection for one cloud's (N, M) float32
    distances: the four lanes of `knn_lanes_mirror` over the target tiles of
    512 points in the block's visiting order."""
    M = d.shape[1]
    n_m = -(-M // stream.TILE_M)
    return knn_lanes_mirror(d, k, lambda row: [
        (t * stream.TILE_M, min(stream.TILE_M, M - t * stream.TILE_M))
        for t in _tile_order(row, n_m, diag)])


@pytest.mark.parametrize("k", [1, 7, 20, 32])
@pytest.mark.parametrize("case", ["sorted self, diagonal", "cross, ascending",
                                  "coincident, diagonal"])
def test_knn_lanes_merged_by_rank_equal_plain(k, case):
    # the lanes' partial lists filtered by the shared threshold and merged
    # by rank give the plain version's indices bit for bit, on exact ties
    # across tiles, an exact hit, and 150 coincident points
    if case == "cross, ascending":
        src, tgt = _clouds(11, 1, 70, 1100)
    else:
        src = tgt = _sorted(_surface(12, 1, 600))
        if case.startswith("coincident"):
            tgt = src = src.copy()
            src[:, 200:350] = src[:, 90:91]
            tgt[:, 599] = src[:, 5]
    d = tcommon.square_distance3(t(src), t(tgt))[0]
    got = _knn_lanes_mirror(n(d), k, diag=case.endswith("diagonal"))
    want = stream.knn_stream_plain(t(src), t(tgt), k)[0]
    assert (got >= 0).all()
    assert np.array_equal(got, n(want))
