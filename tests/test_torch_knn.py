"""The port's kNN and position-encoding angle kernels' plain versions
(`ops/cuda_knn.py:knn_reference`, `ops/cuda_posenc.py:
posenc_angles_reference`) against the JAX package's Pallas kernels in
interpret mode and its dense `knn`, the plain routes of `ops.common.knn`
and `ops.common.nn1` (dense, query chunks) against each other, and the
dense kNN kernel's selections mirrored in Python against the plain version:
four lanes a query, a shared threshold, the lists merged by rank, at the
compiled list length (k <= 32); above k = 32 the bisection of the distance
bits, the ties taken in index order and the bitonic sort
(`csrc/knn_wide.cuh`).

The port forms distances in one fixed float32 order (`square_distance3`),
the JAX package as an einsum: the two may order neighbours differently only
where two distances tie to float32 round-off."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu.ops import common as jcommon
from ogmm_tpu.ops.pallas_knn import knn_pallas, posenc_angles_pallas
from ogmm_tpu_torch.ops import common as tcommon
from ogmm_tpu_torch.ops import cuda_knn
from ogmm_tpu_torch.ops.cuda_knn import knn, knn_reference
from ogmm_tpu_torch.ops.cuda_posenc import (posenc_angles,
                                            posenc_angles_reference)

from torch_port_util import knn_lanes_mirror, n, t


def _clouds(seed, B, N, M):
    rs = np.random.RandomState(seed)
    src = (rs.randn(B, N, 3) * 0.3).astype(np.float32)
    tgt = (rs.randn(B, M, 3) * 0.3).astype(np.float32)
    tgt[:, 7] = tgt[:, 3]                   # a duplicated point: exact ties
    if N == M:
        src = tgt.copy()
    return src, tgt


def _assert_same_up_to_ties(got, want, src, tgt):
    """Equal indices, or indices of points at the same distance within 1e-6
    relative (float64 distances of the two choices)."""
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    d = ((src[:, :, None, :].astype(np.float64)
          - tgt[:, None, :, :].astype(np.float64)) ** 2).sum(-1)
    dg = np.take_along_axis(d, got, axis=-1)
    dw = np.take_along_axis(d, want, axis=-1)
    differ = got != want
    assert np.allclose(dg[differ], dw[differ], rtol=1e-6, atol=1e-12), \
        np.abs(dg - dw).max()
    assert differ.mean() < 0.01, differ.mean()


@pytest.mark.parametrize("k,M", [(5, 300), (5, 257), (20, 300), (20, 257),
                                 # above 32, to k = M: the JAX kernel's
                                 # envelope, which the port's kernel takes
                                 (33, 96), (40, 96), (64, 96), (96, 96),
                                 (33, 200), (40, 200), (64, 200), (200, 200)])
def test_knn_plain_version_matches_jax(M, k):
    src, tgt = _clouds(M + k, 2, 300, M)
    got = knn_reference(t(src), t(tgt), k)
    assert got.dtype == torch.int64 and got.shape == (2, 300, k)
    pallas = knn_pallas(jnp.asarray(src), jnp.asarray(tgt), k, interpret=True)
    dense = jcommon.knn(jnp.asarray(src), jnp.asarray(tgt), k, use_pallas=False)
    if k > 32:
        # the Pallas kernel's float32 distances pick the same points in the
        # same order here, ties (the duplicated point) to the lowest index
        np.testing.assert_array_equal(n(got), np.asarray(pallas))
    _assert_same_up_to_ties(n(got), pallas, src, tgt)
    _assert_same_up_to_ties(n(got), dense, src, tgt)
    # ascending distance along k, the nearest point of a self kNN is itself
    d = tcommon.square_distance3(t(src), t(tgt)).gather(-1, got)
    assert (d[..., 1:] >= d[..., :-1]).all()
    if M == 300:
        assert (got[..., 0] == torch.arange(300)).float().mean() > 0.99


def test_knn_ties_go_to_the_lowest_index():
    x = np.zeros((1, 40, 3), np.float32)
    x[0, :, 0] = np.arange(40) // 4         # four coincident points a site
    got = knn_reference(t(x), t(x), 8)
    assert got[0, 5].tolist() == [4, 5, 6, 7, 0, 1, 2, 3]


def test_wrappers_take_the_plain_versions_on_the_cpu():
    src, tgt = _clouds(1, 2, 64, 80)
    assert torch.equal(knn(t(src), t(tgt), 6), knn_reference(t(src), t(tgt), 6))
    x = t(src)
    assert torch.equal(posenc_angles(x, 5), posenc_angles_reference(x, 5))
    # the routed entry point takes the kernel route, so the plain version
    assert torch.equal(tcommon.knn(t(src), t(tgt), 6),
                       knn_reference(t(src), t(tgt), 6))


def test_posenc_angles_plain_version_matches_jax():
    rs = np.random.RandomState(3)
    x = (rs.randn(2, 200, 3) * 0.3).astype(np.float32)
    x[:, 11] = x[:, 4]                       # a duplicated point
    got = posenc_angles_reference(t(x), 5)
    assert got.dtype == torch.float32 and got.shape == (2, 200, 5)
    want = posenc_angles_pallas(jnp.asarray(x), 5, interpret=True)
    np.testing.assert_allclose(n(got), np.asarray(want), atol=1e-5)
    # the point itself comes first and gives 0, as its duplicate does
    assert (got[..., 0] == 0).all() and (got[:, [4, 11], 1] == 0).all()


def test_plain_routes_by_chunks_match_the_dense_route(monkeypatch):
    src, tgt = _clouds(4, 2, 2500, 300)
    dense_knn = tcommon.knn(t(src), t(tgt), 6, normalize=False)
    dense_nn1 = tcommon.nn1_dense(t(src), t(tgt))
    monkeypatch.setattr(tcommon, "DENSE_ELEMS", 1000)
    # no kernel route for the kNN; the 1-NN of 3-D points always has one
    # (whole-target or streamed), so it is held on 4-D points with a zero
    # fourth coordinate: the same distances
    monkeypatch.setattr(tcommon, "KERNEL_MAX_M", 100)
    monkeypatch.setattr(tcommon, "STREAM_MAX_K", 0)
    src4, tgt4 = (np.concatenate([a, np.zeros_like(a[..., :1])], -1)
                  for a in (src, tgt))
    assert tcommon.knn_route(2, 2500, 300, 3, 6) == "chunked"
    assert tcommon.nn1_route(2, 2500, 300, 4) == "chunked"
    # chunks of 1024 query rows: the same distances, up to the blocking of
    # the (rows, 3) x (3, M) product
    _assert_same_up_to_ties(n(tcommon.knn(t(src), t(tgt), 6)), n(dense_knn),
                            src, tgt)
    d, i = tcommon.nn1(t(src4), t(tgt4))
    assert d.shape == i.shape == (2, 2500)
    np.testing.assert_allclose(n(d), n(dense_nn1[0]), rtol=1e-6, atol=1e-7)
    _assert_same_up_to_ties(n(i)[..., None], n(dense_nn1[1])[..., None],
                            src, tgt)


def _dense_lanes(d, k, K=None):
    """The dense selection of csrc/knn_lanes.cuh for one cloud: pass 1
    takes, for each lane, the ceil(K/4)-th smallest of the minima of its
    points of each 64-point sub-tile, and T, the largest over the four
    lanes; pass 2 buffers each lane's points at or below T and inserts them
    into the lanes' lists of the compiled length K (default: the kNN
    kernel's), the first k written. (The kernel also inserts, and tightens
    the threshold, where a lane's buffer of 32 could overflow: with T from
    the start, only where many points tie; here once at the end.)"""
    K = cuda_knn.knn_compiled_k(k) if K is None else K
    N, M = d.shape
    q = -(-K // 4)
    thr0 = np.full(N, -np.inf)
    for lane in range(4):
        minima = np.sort([d[:, s + lane:min(s + 64, M):4].min(axis=1)
                          for s in range(0, M, 64) if s + lane < M], axis=0)
        kth = minima[q - 1] if len(minima) >= q else np.full(N, np.inf)
        thr0 = np.maximum(thr0, kth)
    return knn_lanes_mirror(d, K, lambda row: [(0, M)], kout=k, window=M,
                            thr0=thr0)


@pytest.mark.parametrize("k", [1, 5, 20, 32, 7])
@pytest.mark.parametrize("case", ["duplicated point", "301 coincident points",
                                  "cross"])
def test_dense_knn_lanes_merged_by_rank_equal_plain(k, case):
    # four lanes a query with a shared threshold, merged by rank, give the
    # plain version's indices bit for bit; k = 7 takes the lists of 20
    rs = np.random.RandomState(k)
    tgt = (rs.randn(1, 420, 3) * 0.3).astype(np.float32)
    tgt[:, 210] = tgt[:, 1]                   # a duplicated point: exact ties
    if case == "301 coincident points":
        tgt[:, 100:401] = tgt[:, :1]
    src = ((rs.randn(1, 90, 3) * 0.3).astype(np.float32) if case == "cross"
           else tgt[:, :150].copy())
    d = tcommon.square_distance3(t(src), t(tgt))[0]
    got = _dense_lanes(n(d), k)
    want = knn_reference(t(src), t(tgt), k)[0]
    assert (got >= 0).all()
    assert np.array_equal(got, n(want))


def _kernel_centroid(x):
    """csrc/knn_lanes.cuh's centroid of one cloud (N, 3) in float32: thread t
    of 256 sums the points t, t + 256, ... in order, each warp of 32 sums
    its threads by an xor shuffle tree, the eight warp sums add in order,
    and the sum is divided by N."""
    x = np.asarray(x, np.float32)
    part = np.zeros((256, 3), np.float32)
    for m in range(len(x)):
        part[m % 256] += x[m]
    warps = part.reshape(8, 32, 3)
    for o in (16, 8, 4, 2, 1):
        warps = warps + warps[:, np.arange(32) ^ o]
    total = np.zeros(3, np.float32)
    for w in range(8):
        total += warps[w, 0]
    return total / np.float32(len(x))


def _kernel_angles(x, idx, pk, centroid):
    """GraphOut's epilogue for one cloud in float32: cos(angle(q -> nbr,
    q -> centroid)) of the first pk neighbours, each direction scaled by
    1 / max(|v|, 1e-12)."""
    x = np.asarray(x, np.float32)
    g = x - centroid
    g = g / np.maximum(np.sqrt((g * g).sum(-1, keepdims=True)), np.float32(1e-12))
    v = x[idx[:, :pk]] - x[:, None]
    v = v / np.maximum(np.sqrt((v * v).sum(-1, keepdims=True)), np.float32(1e-12))
    return (v * g[:, None]).sum(-1)


@pytest.mark.parametrize("N", [20, 64, 717, 1024])
@pytest.mark.parametrize("k", [5, 8, 16, 20])
def test_shared_selection_with_angles_equals_graph_and_angle_plain(N, k):
    # the selection of csrc/knn_lanes.cuh with its angle epilogue, as the
    # DGCNN graphs take it (K = the stage chain's rows a point, stage_rows(k),
    # pk = min(5, k), the centroid summed in the kernel) and as the angle
    # kernel does (the kNN kernel's K, pk = k, the centroid given): the
    # plain versions' indices bit for bit, their angles within 1e-5
    from ogmm_tpu_torch.ops.cuda_dgcnn import stage_rows
    from ogmm_tpu_torch.ops.cuda_dgcnn_train import graph_stage1_reference
    rs = np.random.RandomState(N + k)
    x = (rs.randn(1, N, 3) * 0.3).astype(np.float32)
    x[:, N // 2] = x[:, 1]                   # a duplicated point: exact ties
    d = n(tcommon.square_distance3(t(x), t(x)))[0]
    w1 = t(rs.randn(6, 64) / 2.5)
    pk = min(5, k)
    _, _, ridx, ralpha = graph_stage1_reference(t(x), w1, k, torch.float32, pk)
    got = _dense_lanes(d, k, K=stage_rows(k))
    assert np.array_equal(got, n(ridx)[0])
    alpha = _kernel_angles(x[0], got, pk, _kernel_centroid(x[0]))
    np.testing.assert_allclose(alpha, n(ralpha)[0], atol=1e-5)
    # the angle kernel: the kNN kernel's list length, every neighbour's angle
    got = _dense_lanes(d, k)
    assert np.array_equal(got, n(knn_reference(t(x), t(x), k))[0])
    alpha = _kernel_angles(x[0], got, k, x[0].mean(0))
    np.testing.assert_allclose(alpha, n(posenc_angles_reference(t(x), k))[0],
                               atol=1e-5)


NN1_RUN = 8   # csrc/nn1.cu: BT, points of a lane's run


def _nn1_lanes_mirror(d, lanes):
    """csrc/nn1.cu for one cloud's (N, M) float32 distances (clamped at
    1e-12) at `lanes` lanes a query: lane l of a query takes the points l,
    l + lanes, ... in runs of NN1_RUN; the first run whose least distance is
    below the lane's best becomes its best, and the lane's pair is the first
    point of that run at that distance (an index past the target where it
    has no point); the lanes merge by an xor shuffle tree on (distance,
    index) pairs."""
    N, M = d.shape

    def least(a, b):
        take = (b[0] < a[0]) | ((b[0] == a[0]) & (b[1] < a[1]))
        return np.where(take, b[0], a[0]), np.where(take, b[1], a[1])

    pairs = []
    for sub in range(lanes):
        js = np.arange(sub, M, lanes)
        bd = np.full(N, np.inf, np.float32)
        bj = np.full(N, sub)
        for s in range(0, len(js), NN1_RUN):
            run = d[:, js[s:s + NN1_RUN]]
            low = run.min(axis=1)
            better = low < bd
            first = js[s + np.argmax(run == low[:, None], axis=1)]
            bd, bj = np.where(better, low, bd), np.where(better, first, bj)
        pairs.append((bd, bj))
    o = 1
    while o < lanes:
        pairs = [least(pairs[sub], pairs[sub ^ o]) for sub in range(lanes)]
        o <<= 1
    return pairs[0]


@pytest.mark.parametrize("lanes", cuda_knn.NN1_LANES)
@pytest.mark.parametrize("M", [717, 1000, 651, 9])
def test_nn1_lanes_and_chunks_equal_plain(lanes, M):
    # a point duplicated at a low and a high index in two lanes' runs, and
    # several targets within the 1e-12 clamp of a query across lanes and
    # runs; M not a multiple of the lanes or of a run (9 points: lanes
    # without a point at 16 lanes)
    rs = np.random.RandomState(lanes + M)
    tgt = (rs.randn(2, M, 3) * 0.3).astype(np.float32)
    lo, hi, near = 5 % M, M - 1, [j % M for j in (200, 300, 400, 450)]
    tgt[:, hi] = tgt[:, lo]
    tgt[:, near] = tgt[:, [near[0]]] + rs.randn(2, 4, 3) * 1e-8
    src = (rs.randn(2, 40, 3) * 0.3).astype(np.float32)
    src[:, 0], src[:, 1], src[:, 2] = tgt[:, lo], tgt[:, hi], tgt[:, near[0]]
    rd, ri = cuda_knn.nn1_reference(t(src), t(tgt))
    assert (n(ri)[:, :2] == lo).all() and (n(rd)[:, 2] == np.float32(1e-12)).all()
    for b in range(2):
        d = n(tcommon.square_distance3(t(src[b:b + 1]), t(tgt[b:b + 1])))[0]
        got_d, got_i = _nn1_lanes_mirror(d, lanes)
        assert np.array_equal(got_i, n(ri)[b]) and np.array_equal(got_d, n(rd)[b])


@pytest.mark.parametrize("B,N,M", [(24, 128, 717), (2, 5, 3), (1, 1, 4096)])
def test_nn1_plan_of_the_shape_equals_plain(B, N, M):
    # the wrapper's own plan (16 lanes at the clustering's shape; more lanes
    # than points at (2, 5, 3)), on the first two clouds of the shape
    rs = np.random.RandomState(N + M)
    tgt = (rs.randn(2, M, 3) * 0.3).astype(np.float32)
    src = (rs.randn(2, N, 3) * 0.3).astype(np.float32)
    src[:, 0] = tgt[:, M - 1]
    plan = cuda_knn.nn1_plan(B, N, 132)
    rd, ri = cuda_knn.nn1_reference(t(src), t(tgt))
    for b in range(2):
        d = n(tcommon.square_distance3(t(src[b:b + 1]), t(tgt[b:b + 1])))[0]
        got_d, got_i = _nn1_lanes_mirror(d, plan.lanes)
        assert np.array_equal(got_i, n(ri)[b]) and np.array_equal(got_d, n(rd)[b])


def _dense_wide(d, k):
    """The selection of csrc/knn_wide.cuh for one cloud's (N, M) float32
    distances: the keys are the distances' bits; T, the k-th smallest key,
    is set bit by bit from bit 30 where fewer than k keys lie below it; the
    points below T and the first k - (points below T) at T, in index order,
    padded with (inf, INT_MAX) to the list's length and sorted by the
    bitonic network of the kernel, lane loop and all."""
    N, M = d.shape
    keys = np.ascontiguousarray(d, dtype=np.float32).view(np.uint32)
    assert (keys < 2 ** 31).all()
    T = np.zeros(N, np.uint32)
    for bit in range(30, -1, -1):
        cand = T | np.uint32(1 << bit)
        below = (keys < cand[:, None]).sum(1)
        T = np.where(below < k, cand, T)
    need = k - (keys < T[:, None]).sum(1)
    assert (need >= 1).all()
    at = keys == T[:, None]
    take = (keys < T[:, None]) | (at & (np.cumsum(at, 1) - at < need[:, None]))
    assert (take.sum(1) == k).all()
    size = 32
    while size < k:
        size *= 2
    lk = np.full((N, size), np.uint32(0xFFFFFFFF))
    li = np.full((N, size), 2 ** 31 - 1, np.int64)
    for r in range(N):
        sel = np.nonzero(take[r])[0]
        lk[r, :k], li[r, :k] = keys[r, sel], sel
    rows = np.arange(N)[:, None]
    s = 2
    while s <= size:
        stride = s // 2
        while stride > 0:
            tt = np.arange(size // 2)
            lo = 2 * tt - (tt & (stride - 1))
            hi = lo + stride
            ka, kb, ia, ib = lk[:, lo], lk[:, hi], li[:, lo], li[:, hi]
            swap = ((ka > kb) | ((ka == kb) & (ia > ib))) == ((lo & s) == 0)[None]
            lk[rows, lo[None]], lk[rows, hi[None]] = (np.where(swap, kb, ka),
                                                      np.where(swap, ka, kb))
            li[rows, lo[None]], li[rows, hi[None]] = (np.where(swap, ib, ia),
                                                      np.where(swap, ia, ib))
            stride //= 2
        s *= 2
    return li[:, :k]


@pytest.mark.parametrize("M,k", [(96, 33), (96, 40), (96, 64), (96, 96),
                                 (200, 33), (200, 200), (257, 100)])
@pytest.mark.parametrize("case", ["random", "coincident"])
def test_wide_selection_mirror_equals_plain(M, k, case):
    # the selection above k = 32 (knn.cu, dgcnn_eval.cu, graph_stage1.cu)
    # against the plain version's k passes of argmin and mask, on clouds with
    # a duplicated point and with sites of many coincident points (ties at
    # T: the first ones in index order)
    src, tgt = _clouds(M + k, 1, 60, M)
    if case == "coincident":
        tgt[0, :, 0] = np.arange(M) // 7 * 0.01
        tgt[0, :, 1:] = 0.0
        src[0] = tgt[0, :60]
    d = n(tcommon.square_distance3(t(src), t(tgt)))[0]
    got = _dense_wide(d, k)
    want = n(knn_reference(t(src), t(tgt), k))[0]
    np.testing.assert_array_equal(got, want)
