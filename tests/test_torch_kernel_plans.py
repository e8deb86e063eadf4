"""The launch plans of the DGCNN, EM and streamed kernels, on the CPU: the
shapes the EM kernel takes (`cuda_em.kernel_takes`, `cuda_em.smem_bytes`),
the operands the DGCNN wrappers hand their kernels
(`cuda_dgcnn._kernel_operands`, `cuda_dgcnn._concat_scratch`), the float32
stage block (`cuda_dgcnn.f32_stage_plan`) and the stage chain's chunks
above k = 32 (`cuda_dgcnn.stage_chunks`), the kNN kernel's launches
(`cuda_knn.knn_plan`: the register lists to k = 32, the wide selection of
`csrc/knn_wide.cuh` above), the angle kernel's launch
(`cuda_posenc.posenc_plan`), the bf16 and float32
projections' shared memory and persistent grids (`cuda_stream.wproject_plan`,
`wproject_units`, `wproject_smem_bytes`, `wproject_f32_smem_bytes`; the
float32 kernel's rotated key order, `wproject_key_tiles`, and its blocks
reading k in step), the 1-NN kernel's split of the
target (`cuda_stream.nn1_stream_plan`), and the bf16 backward stage's and
fused MLP's launches (`cuda_dgcnn_bwd.bwd_stage_plan`,
`cuda_mlp.pointmlp_plan`): shared memory, the persistent grid's shares and
the partials' counts. The kernels themselves run only on the card
(`tests/test_torch_kernels_gpu.py`)."""
import os
import re

import numpy as np
import pytest
import torch

from ogmm_tpu_torch.ops import (cuda_dgcnn, cuda_dgcnn_bwd, cuda_em, cuda_fps,
                                cuda_stream, stream)

# (N, K) that the EM kernel took before its blocks shrank to 4 warps (its
# envelope then: N <= 3,072 at K > 64, 6,200 at K in 33..64, 11,600 at
# K <= 32); it must take each of them still
EARLIER_ENVELOPE = [(1, 1), (5, 32), (96, 32), (717, 128), (1433, 128),
                    (2048, 16), (3072, 100), (3072, 128), (500, 100),
                    (300, 1), (6200, 33), (6200, 64), (4000, 64),
                    (11600, 1), (11600, 16), (11600, 32), (9000, 20),
                    (35000 // 4, 16)]


@pytest.mark.parametrize("N,K", EARLIER_ENVELOPE)
def test_em_kernel_still_takes_its_earlier_envelope(N, K):
    assert cuda_em.kernel_takes(N, K)


# the first N past a cluster of 16 blocks at each K (a block's slab then
# needs more than 227 KB), and K past 1024
@pytest.mark.parametrize("N,K", [(6705, 128), (8481, 97), (13057, 64),
                                 (24257, 32), (3281, 257), (1617, 512),
                                 (721, 1024), (100, 1025), (100, 0), (0, 16)])
def test_em_kernel_refuses_past_shared_memory_and_k(N, K):
    assert not cuda_em.kernel_takes(N, K)
    if K >= 1 and N >= 1 and K <= cuda_em.KERNEL_MAX_K:
        assert cuda_em.kernel_takes(N - 1, K)


@pytest.mark.parametrize("K", [1, 32, 33, 64, 100, 128, 129, 200, 256, 257,
                               320, 321, 512, 513, 640, 641, 1000, 1024])
def test_em_kernel_takes_exactly_what_fits(K):
    # the first N refused is the first whose block of a cluster of 16 needs
    # more than 227 KB; 8 blocks a cloud wherever their slabs fit
    takes = [N for N in range(1, 100000, 7) if cuda_em.kernel_takes(N, K)]
    last = max(takes)
    assert takes == list(range(1, last + 1, 7))
    assert cuda_em.smem_bytes(last, K, 16) <= cuda_em.SMEM_BYTES
    assert cuda_em.smem_bytes(last + 7 * 16, K, 16) > cuda_em.SMEM_BYTES
    for N in takes:
        fits8 = cuda_em.smem_bytes(N, K, 8) <= cuda_em.SMEM_BYTES
        assert cuda_em.cluster_size(N, K) == (8 if fits8 else 16)


def _jax_em_envelope(K):
    """The largest N the JAX package sends to its EM kernel at K:
    N max(K, 128) 4 B x 5 <= 14 MiB (ogmm_tpu/ops/gmm.py:187-206)."""
    from ogmm_tpu_torch.ops.gmm import EM_VMEM_BYTES
    assert EM_VMEM_BYTES == 14 * 2 ** 20
    return EM_VMEM_BYTES // (max(K, 128) * 4 * 5)


@pytest.mark.parametrize("K0", range(1, 257, 32))
def test_em_plan_holds_the_jax_envelope_at_k_up_to_256(K0):
    # every (N, K) the JAX rule admits at K <= 256 (and K <= N): the chosen
    # cluster's block fits shared memory. A block's shared memory grows with
    # N, so the largest admitted N of each K is the one to hold; a sample of
    # smaller N checks the choice of 8 or 16 blocks too
    for K in range(K0, K0 + 32):
        top = _jax_em_envelope(K)
        assert top >= K
        for N in {K, top // 3, top // 2, top - 1, top}:
            cl = cuda_em.cluster_size(N, K)
            assert cl in cuda_em.CLUSTERS, (N, K)
            assert cuda_em.smem_bytes(N, K, cl) <= cuda_em.SMEM_BYTES, (N, K)
            assert cuda_em.kernel_takes(N, K)
    # the slab's rows are 4 ceil(K / 4) floats apart: padded to 32 columns,
    # K = 129 at its top N would not fit a cluster of 16
    assert cuda_em.smem_bytes(_jax_em_envelope(129), 129, 16) <= cuda_em.SMEM_BYTES
    kp = 160
    rows = -(-_jax_em_envelope(129) // 16)
    assert 4 * rows * kp > cuda_em.SMEM_BYTES - 4 * 15 * kp


@pytest.mark.parametrize("K0", range(257, 857, 40))
def test_em_plan_holds_the_jax_envelope_above_k_256(K0):
    # every (N, K) with 256 < K <= min(N, 1024) that the JAX rule admits
    # (none past K = 856, whose top N is 857): the chosen cluster's block
    # fits shared memory, at the largest admitted N of each K and a sample
    # of smaller ones
    for K in range(K0, min(K0 + 40, 857)):
        top = _jax_em_envelope(K)
        assert top >= K
        for N in {K, K + 1, (K + top) // 2, top - 1, top}:
            cl = cuda_em.cluster_size(N, K)
            assert cl in cuda_em.CLUSTERS, (N, K)
            assert cuda_em.smem_bytes(N, K, cl) <= cuda_em.SMEM_BYTES, (N, K)
            assert cuda_em.kernel_takes(N, K)
    assert _jax_em_envelope(857) < 857


def _first_refused(K):
    """The least N the EM kernel refuses at K (what it takes shrinks only
    as N grows, test_em_kernel_takes_exactly_what_fits)."""
    lo, hi = 1, 1 << 17
    assert cuda_em.kernel_takes(lo, K) and not cuda_em.kernel_takes(hi, K)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if cuda_em.kernel_takes(mid, K) else (lo, mid)
    return hi


def test_em_plan_refuses_only_wide_pairs_with_more_clusters_than_points():
    # what stays plain inside the JAX bound below K = 1025: 108 (N, K) with
    # K > N, all at K >= 897, where K pads to 1024 columns (11 vectors of
    # them, 45 KB) and the slab of ceil(N / 16) rows fills the rest
    refused = [(N, K) for K in range(257, 1025)
               for N in range(_first_refused(K), _jax_em_envelope(K) + 1)]
    assert len(refused) == 108
    assert all(K > N and K >= 897 for N, K in refused)
    assert (817, 897) in refused and (721, 1018) in refused
    assert not cuda_em.kernel_takes(817, 897) and cuda_em.kernel_takes(816, 897)


@pytest.mark.parametrize("K", [257, 300, 320, 384, 512, 513, 700, 1000, 1023, 1024])
def test_em_wide_lanes_cover_each_column_once(K):
    # csrc/sinkhorn_em.cu's lane layout above K = 256, emulated: a warp
    # takes 32 / LPR rows; lane l of a row holds chunk j at columns
    # 4 (l % LPR + LPR j) .. + 3. Every (row, padded column) pair is held
    # exactly once, only a lane's last chunk can pass the slab's stride
    # 4 ceil(K / 4), and the column sums' shuffles (lanes LPR .. 16 apart)
    # join exactly the lanes that hold the same columns
    lpr, kp = cuda_em.lanes_per_row(K), cuda_em.padded_k(K)
    assert lpr == (16 if K <= 512 else 32)
    kpl = kp // (4 * lpr)
    assert kp % (4 * lpr) == 0 and 5 <= kpl <= 8 and kp - K < 4 * lpr
    ks = 4 * -(-K // 4)
    held = np.zeros((32 // lpr, kp), dtype=int)
    for lane in range(32):
        for j in range(kpl):
            c = 4 * (lane % lpr + lpr * j)
            held[lane // lpr, c:c + 4] += 1
            if j < kpl - 1:
                assert c + 4 <= ks
    assert (held == 1).all()
    cols = lambda lane: {4 * (lane % lpr + lpr * j) for j in range(kpl)}
    for lane in range(32):
        group = {lane}
        o = lpr
        while o < 32:
            group |= {x ^ o for x in group}
            o *= 2
        assert group == {x for x in range(32) if cols(x) == cols(lane)}
        assert len(group) == 32 // lpr


def test_em_cluster_size_keeps_8_at_the_request_shapes():
    # the N = 717 and 1433 requests keep their cluster of 8 (the kernel of
    # earlier slices); past 3,352 points at K = 128 a cluster of 16
    assert cuda_em.cluster_size(717, 128) == cuda_em.cluster_size(1433, 128) == 8
    assert cuda_em.cluster_size(3352, 128) == 8
    assert cuda_em.cluster_size(3353, 128) == cuda_em.cluster_size(5734, 128) == 16
    assert cuda_em.cluster_size(2867, 256) == 16
    assert cuda_em.cluster_size(35000, 128) is None
    assert cuda_em.cluster_size(100, 1025) is None
    # n_clusters = 512 at N = 717: a cluster of 8, one 209,008 B block an SM
    assert cuda_em.cluster_size(717, 512) == 8
    assert cuda_em.smem_bytes(717, 512, 8) == 209008
    assert cuda_em.cluster_size(1433, 512) == cuda_em.cluster_size(717, 1023) == 16


def test_em_blocks_of_the_main_shape_fit_four_to_an_sm():
    # 4 blocks of at most 56 KB share an SM's 228 KB, so that the 48 clouds
    # of a request (48 clusters of 8 blocks) can run in one wave
    assert cuda_em.smem_bytes(717, 128) == 55920
    assert 4 * (cuda_em.smem_bytes(717, 128) + 1024) <= 228 * 1024
    # a one-point slab: one row of 32 columns, its 6 floats padded to 8 and
    # 15 column vectors
    assert cuda_em.smem_bytes(1, 32) == 4 * (32 + 8 + 15 * 32)


def _weights(rs, emb):
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]
    ws = [torch.tensor(rs.randn(*d).astype(np.float32)) for d in dims]
    aff = [(torch.tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32)),
            torch.tensor(rs.randn(d[1]).astype(np.float32))) for d in dims]
    return ws, aff


@pytest.mark.parametrize("dtype,emb", [(torch.bfloat16, 128), (torch.float32, 64)])
def test_dgcnn_operands_leave_the_fold_of_stages_1_to_4_to_the_kernel(dtype, emb):
    # one convention for both compute types
    ws, aff = _weights(np.random.RandomState(0), emb)
    got_w, got_s, got_b = cuda_dgcnn._kernel_operands("t", ws, aff, 20, dtype)
    fw, _ = cuda_dgcnn.fold_weights(ws, aff, dtype)
    # stages 1-4: the float32 weights and BN scales as given; b1 .. b5 float32
    assert all(torch.equal(g, w) and g.dtype == torch.float32
               for g, w in zip(got_w[:4], ws[:4]))
    assert all(torch.equal(g, s) for g, (s, _) in zip(got_s, aff[:4]))
    assert all(torch.equal(g, b) and g.dtype == torch.float32
               for g, (_, b) in zip(got_b, aff))
    # the head: w5 folded as the plain version folds it
    assert tuple(got_w[4].shape) == (512, emb) and got_w[4].is_contiguous()
    assert got_w[4].dtype == dtype and torch.equal(got_w[4], fw[4])
    # what the kernels compute from them: the weight times the scale rounded
    # once to the compute type, as fold_weights
    for i in range(4):
        assert torch.equal((got_w[i] * got_s[i][None, :]).to(dtype), fw[i])


@pytest.mark.parametrize("dtype,rows", [(torch.bfloat16, 2 * 37),
                                        (torch.float32, 2 * 37)])
def test_dgcnn_concat_scratch_in_the_compute_type(dtype, rows):
    # both routes write the concat to device memory for their head launch
    cat = cuda_dgcnn._concat_scratch(torch.zeros(2, 37, 3), dtype)
    assert tuple(cat.shape) == (rows, 512) and cat.dtype == dtype


def test_f32_stage_plan_mirrors_the_kernel():
    assert (cuda_dgcnn.F32_POINTS, cuda_dgcnn.F32_WARPS) == (_cu_define("dgcnn_eval.cu", "QF"),
                                                            _cu_define("dgcnn_eval.cu", "NWF"))
    assert cuda_dgcnn.F32_LD == (_cu_define("dgcnn_eval.cu", "LDF_X"), _cu_define("dgcnn_eval.cu", "LDF_Y"))
    # strides of 4 mod 32 keep a B fragment's 32 reads (row g, column t) on
    # 32 banks; the edge rows' 12 does too
    for ld in (*cuda_dgcnn.F32_LD, _cu_define("dgcnn_eval.cu", "LDF_E")):
        assert len({(g * ld + t) % 32 for g in range(8) for t in range(4)}) == 32


@pytest.mark.parametrize("k", cuda_dgcnn.CHUNK_KS)
def test_f32_stage_block_fits_shared_memory_at_every_k(k):
    plan = cuda_dgcnn.f32_stage_plan(48, 717, k)
    # a point of k neighbours takes stage_rows(k) rows, a multiple of 4 of
    # at least 8 (the rows past k repeat its nearest neighbour)
    rows = cuda_dgcnn.stage_rows(k)
    assert plan.rows == rows and rows >= max(k, 8) and rows % 4 == 0
    assert rows - k < 4 or k < 8
    assert rows in cuda_dgcnn.STAGE_KS
    # the edge rows (12 floats) live in the 64-channel buffer; the 128-wide
    # buffer holds stage 3's output in two planes (high and low parts)
    ld_x, ld_y = cuda_dgcnn.F32_LD
    assert plan.smem == 4 * plan.points * (rows * (ld_x + 2 * ld_y) + 512)
    assert _cu_define("dgcnn_eval.cu", "LDF_E") <= ld_x
    assert plan.smem <= cuda_dgcnn.SMEM_PER_BLOCK
    # 8 points a block where they fit, else 4 (csrc f32_points)
    full = 4 * cuda_dgcnn.F32_POINTS * (rows * (ld_x + 2 * ld_y) + 512)
    assert plan.points == (cuda_dgcnn.F32_POINTS if full <= cuda_dgcnn.SMEM_PER_BLOCK
                           else cuda_dgcnn.F32_POINTS // 2)
    # one block an SM: its threads may take all 255 registers
    assert plan.blocks_sm == 1 and plan.warps * 32 * 255 <= cuda_dgcnn.REGS_PER_SM
    # whole 8-row tiles and row groups of whole points (csrc stage_tf32)
    assert plan.points * rows % 16 == 0


@pytest.mark.parametrize("N", [1, 5, 717, 1023, 1024, 35000])
@pytest.mark.parametrize("k", cuda_dgcnn.CHUNK_KS)
def test_f32_stage_grid_covers_every_point_once(N, k):
    B = 3
    plan = cuda_dgcnn.f32_stage_plan(B, N, k)
    gx, gy = plan.grid
    assert gy == B
    # block x owns points [QF x, QF x + QF) of its cloud; those past N are
    # computed on a repeated point and not written
    owned = [x * plan.points + q for x in range(gx) for q in range(plan.points)]
    assert [p for p in owned if p < N] == list(range(N))
    assert (gx - 1) * plan.points < N


# ------------------------------------------- the streamed kernels' plans

H100_SMS = 132


@pytest.mark.parametrize("D", cuda_stream.WPROJECT_BF16_D)
def test_wproject_block_fits_shared_memory(D):
    # the ring of key tiles and its alignment, within a block's 227 KB
    smem = cuda_stream.wproject_smem_bytes(D)
    assert smem <= cuda_em.SMEM_BYTES
    stages = (smem - 1024) // (cuda_stream.WPROJECT_KEYS * D * 2)
    assert stages >= 3 and (smem - 1024) % (cuda_stream.WPROJECT_KEYS * D * 2) == 0


@pytest.mark.parametrize("B,N,M,blocks", [(1, 35000, 35000, H100_SMS),
                                          (2, 130, 4100, H100_SMS),
                                          (1, 70, 50, 1), (2, 300, 1, 6),
                                          (3, 1000, 2000, H100_SMS),
                                          (2, 150, 200, 7)])
def test_wproject_key_chunks_cover_every_key_once_in_order(B, N, M, blocks):
    rows, keys = cuda_stream.WPROJECT_ROWS, cuda_stream.WPROJECT_KEYS
    n_qt, n_kt = -(-N // rows), -(-M // keys)
    units = cuda_stream.wproject_units(B, N, M, blocks)
    # every block has work, and its slots count up from 0 tile by tile
    assert sorted({u[0] for u in units}) == list(range(blocks))
    for i in range(blocks):
        mine = [u for u in units if u[0] == i]
        assert [u[1] for u in mine] == list(range(len(mine)))
        assert [u[2] for u in mine] == list(range(mine[0][2], mine[0][2] + len(mine)))
    # each query tile's chunks, in block order, are [0, n_kt) in ascending
    # key order with neither gap nor overlap: keys [0, M) once each
    for tile in range(B * n_qt):
        chunks = [(u[0], u[3], u[4]) for u in units if u[2] == tile]
        assert [c[0] for c in chunks] == sorted(c[0] for c in chunks)
        edges = [c[1] for c in chunks] + [chunks[-1][2]]
        assert edges[0] == 0 and edges[-1] == n_kt
        assert all(lo < hi for lo, hi in zip(edges, edges[1:]))
    assert (n_kt - 1) * keys < M <= n_kt * keys


def test_wproject_units_fill_the_card_at_the_indoor_shape():
    # (1, 35000, 35000): 274 query tiles x 547 key tiles on 132 SMs. One
    # persistent block an SM, shares within one pair of each other, so no
    # SM idles while another has more than one tile pair left
    blocks, slots = cuda_stream.wproject_plan(1, 35000, 35000, H100_SMS)
    assert blocks == H100_SMS
    units = cuda_stream.wproject_units(1, 35000, 35000, blocks)
    load = [0] * blocks
    for i, _, _, k0, k1 in units:
        load[i] += k1 - k0
    assert sum(load) == 274 * 547 and max(load) - min(load) <= 1
    assert slots == max(u[1] for u in units) + 1 == 4
    # the partials of one call: blocks x slots x (m, l, acc) x 128 rows
    assert blocks * slots * 3 * cuda_stream.WPROJECT_ROWS * 4 < 2 ** 20


@pytest.mark.parametrize("D", range(32, 513, 32))
def test_wproject_f32_block_fits_shared_memory(D):
    # the float32 block's split stages (a TF32 high and low plane of 256
    # keys x 32 features each) and raw chunks, aligned to the swizzle, within
    # a block's 227 KB at every width the envelope takes up to 512
    assert cuda_stream.wproject_takes(D, torch.float32)
    smem = cuda_stream.wproject_f32_smem_bytes(D)
    assert smem <= cuda_em.SMEM_BYTES == 232448
    plane = cuda_stream.WPROJECT_F32_KEYS * cuda_stream.WPROJECT_F32_DC * 4
    assert smem == 7 * plane + 1024 and plane == 32768


@pytest.mark.parametrize("B,N,M,blocks", [(1, 35000, 35000, H100_SMS),
                                          (2, 35000, 35000, H100_SMS),
                                          (2, 130, 4100, 68),
                                          (1, 70, 50, 1), (2, 300, 1, 6),
                                          (1, 129, 65, 2),
                                          (3, 1000, 2000, H100_SMS),
                                          (3, 700, 33000, H100_SMS),
                                          (2, 150, 1000, 7)])
def test_wproject_f32_key_tiles_cover_every_key_once(B, N, M, blocks):
    # the float32 kernel's units over tiles of 256 keys: every block has
    # work, slots count up from 0; each query tile's units, merged in block
    # order, take its logical key tiles [0, n_kt) in ascending order, and
    # read the physical tiles (k + rot) mod n_kt: each key of each row in
    # exactly one unit
    rows, keys = cuda_stream.WPROJECT_ROWS, cuda_stream.WPROJECT_F32_KEYS
    n_qt, n_kt = -(-N // rows), -(-M // keys)
    units = cuda_stream.wproject_units(B, N, M, blocks, keys)
    order = cuda_stream.wproject_key_tiles(B, N, M, blocks, keys)
    assert len(order) == len(units)
    assert sorted({u[0] for u in units}) == list(range(blocks))
    for i in range(blocks):
        assert [u[1] for u in units if u[0] == i] == list(range(sum(u[0] == i for u in units)))
    for tile in range(B * n_qt):
        mine = [(u, o) for u, o in zip(units, order) if u[2] == tile]
        assert [u[0] for u, _ in mine] == sorted(u[0] for u, _ in mine)
        edges = [u[3] for u, _ in mine] + [mine[-1][0][4]]
        assert edges[0] == 0 and edges[-1] == n_kt
        assert all(lo < hi for lo, hi in zip(edges, edges[1:]))
        seen = np.zeros(M, np.int64)
        rot = (mine[0][1][0] - mine[0][0][3]) % n_kt
        for u, o in mine:
            assert o == [(k + rot) % n_kt for k in range(u[3], u[4])]
            for kt in o:
                seen[kt * keys:(kt + 1) * keys] += 1
        assert (seen == 1).all()


def test_wproject_f32_grid_fills_the_card_at_the_indoor_shape():
    # (1, 35000, 35000): 274 query tiles x 137 key tiles of 256 on 132 SMs,
    # shares within one pair of each other; the partials stay small
    keys = cuda_stream.WPROJECT_F32_KEYS
    blocks, slots = cuda_stream.wproject_plan(1, 35000, 35000, H100_SMS, keys)
    assert blocks == H100_SMS
    units = cuda_stream.wproject_units(1, 35000, 35000, blocks, keys)
    load = [0] * blocks
    for i, _, _, k0, k1 in units:
        load[i] += k1 - k0
    assert sum(load) == 274 * 137 and max(load) - min(load) <= 1
    assert slots == max(u[1] for u in units) + 1 == 4
    assert blocks * slots * 3 * cuda_stream.WPROJECT_ROWS * 4 < 2 ** 20


@pytest.mark.parametrize("B", [1, 2])
def test_wproject_f32_blocks_read_k_in_step(B):
    # at the indoor call (B = 1 a request, 2 a train step) the 132 blocks
    # read at most three key tiles of each cloud at any step of their
    # shares (tile s mod n_kt, or that lagged by a share mod n_kt where a
    # unit finishes a tile the block before began): with each block's q
    # tile (256 KB) the working set is 35-36 MB of the L2's 50; in plain order
    # the blocks read some 66 tiles at once, 33 MB of k beside the 34 of q
    keys, n_kt, n_qt = cuda_stream.WPROJECT_F32_KEYS, 137, 274
    units = cuda_stream.wproject_units(B, 35000, 35000, H100_SMS, keys)
    order = cuda_stream.wproject_key_tiles(B, 35000, 35000, H100_SMS, keys)
    seq = [[] for _ in range(H100_SMS)]
    for u, o in zip(units, order):
        seq[u[0]] += [(u[2] // n_qt, kt) for kt in o]
    plain = [[] for _ in range(H100_SMS)]
    for i, _, tile, k0, k1 in units:
        plain[i] += [(tile // n_qt, kt) for kt in range(k0, k1)]
    worst = worst_plain = 0
    for s in range(max(map(len, seq))):
        at = {x[s] for x in seq if s < len(x)}
        worst = max(worst, max(sum(b == c for b, _ in at) for c in range(B)))
        worst_plain = max(worst_plain, len({x[s] for x in plain if s < len(x)}))
    tile_bytes, q_tiles = keys * 512 * 4, H100_SMS * 128 * 512 * 4
    assert worst <= 3 and B * worst * tile_bytes + q_tiles < 40 * 2 ** 20
    assert worst_plain * tile_bytes + q_tiles > 50 * 2 ** 20

@pytest.mark.parametrize("B,N,M", [(1, 35000, 35000), (2, 16, 35000),
                                   (2, 4100, 4097), (1, 1, 4097),
                                   (2, 65, 35000), (3, 700, 9000),
                                   (1, 50000, 512)])
def test_nn1_stream_split_covers_every_target_point_once(B, N, M):
    chunks, per = cuda_stream.nn1_stream_plan(B, N, M, H100_SMS)
    n_m = -(-M // stream.TILE_M)
    seen = np.zeros(M, np.int64)
    for c in range(chunks):
        lo, hi = c * per, min((c + 1) * per, n_m)
        assert lo < hi
        seen[lo * stream.TILE_M:hi * stream.TILE_M] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("B,N,M,chunks", [(1, 35000, 35000, 1),
                                          (2, 16, 35000, 69),
                                          (1, 50000, 512, 1)])
def test_nn1_stream_splits_only_where_queries_cannot_fill_the_card(B, N, M,
                                                                  chunks):
    # the ICP trip's 547 query tiles fill 132 SMs alone; the clustering's
    # 2 x 16 queries get one chunk a target tile: 138 blocks
    got, per = cuda_stream.nn1_stream_plan(B, N, M, H100_SMS)
    assert got == chunks
    blocks = B * -(-N // stream.TILE_N) * got
    assert blocks >= H100_SMS or got == -(-M // stream.TILE_M)


# ------------------------------- the bf16 backward stage and MLP kernels

from ogmm_tpu_torch.ops import cuda_dgcnn_bwd, cuda_mlp  # noqa: E402

STAGES = cuda_dgcnn_bwd.KERNEL_STAGES
# one k of each row class, and the k of the path and of the envelopes phase
CLASS_KS = (1, 4, 5, 8, 12, 16, 20, 24, 25, 32)
GRID_KS = (1, 12, 20, 32)


@pytest.mark.parametrize("k", CLASS_KS)
@pytest.mark.parametrize("stage", STAGES)
def test_bwd_stage_block_fits_shared_memory(stage, k):
    # two buffers of a tile's panels, W_i and W_{i+1} resident, the scratch
    # tile and the 1024-byte alignment, within a block's 227 KB, at every
    # row class; a tile's rows at most 80 and whole k16 steps of the weight
    # gradient's wgmma, half of them a row product's n (a multiple of 8)
    C, cin, cn = stage
    plan = cuda_dgcnn_bwd.bwd_stage_plan(24, 1024, k, C, cin, cn)
    assert plan["smem"] <= cuda_dgcnn_bwd.SMEM_LIMIT
    rows = plan["rows_a_tile"]
    assert rows == plan["row_class"] * plan["points_a_tile"] <= cuda_dgcnn_bwd.MAX_TILE_ROWS
    assert rows % 16 == 0 and plan["row_product_n"] * 2 == rows
    assert plan["row_product_n"] in (16, 24, 32, 40)
    panel = rows * 128
    assert plan["smem"] >= 2 * (C + cin + cn) // 64 * panel + 2 * (cin * C + C * cn)
    # the plan does not depend on the batch or the points
    assert cuda_dgcnn_bwd.bwd_stage_plan(1, 1, k, *stage)["smem"] == plan["smem"]


@pytest.mark.parametrize("B,N", [(1, 1), (1, 3), (2, 5), (1, 1024), (24, 717),
                                 (3, 1000), (48, 717), (7, 129)])
@pytest.mark.parametrize("k", GRID_KS)
@pytest.mark.parametrize("stage", STAGES)
def test_bwd_stage_grid_visits_every_tile_once_in_order(B, N, stage, k):
    plan = cuda_dgcnn_bwd.bwd_stage_plan(B, N, k, *stage)
    tiles = B * -(-N // cuda_dgcnn_bwd.tile_points(k))
    assert plan["tiles"] == tiles
    assert plan["blocks"] == min(cuda_dgcnn_bwd.STAGE_BLOCKS, tiles)
    shares = cuda_dgcnn_bwd.stage_shares(plan["tiles"], plan["blocks"])
    # contiguous, non-empty shares in block order that cover the tiles once
    assert len(shares) == plan["blocks"]
    assert shares[0][0] == 0 and shares[-1][1] == tiles
    assert all(a < b for a, b in shares)
    assert all(shares[i][1] == shares[i + 1][0] for i in range(len(shares) - 1))
    visited = [t for a, b in shares for t in range(a, b)]
    assert visited == list(range(tiles))
    # even shares: no block holds more than one tile above another
    sizes = [b - a for a, b in shares]
    assert max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("B,N", [(24, 717), (1, 1), (2, 5)])
@pytest.mark.parametrize("stage", STAGES)
def test_bwd_stage_partials_are_fixed_by_the_shape(B, N, stage):
    # one dW_i and one S_{i-1} partial a block, summed in block order: the
    # count depends on the shapes only, never on the card
    C, cin, cn = stage
    plan = cuda_dgcnn_bwd.bwd_stage_plan(B, N, 20, C, cin, cn)
    G = plan["blocks"]
    assert plan["part_w"] == (G, cin, C) and plan["part_s"] == (G, 2, cin)
    assert cuda_dgcnn_bwd.bwd_stage_plan(B, N, 20, C, cin, cn) == plan


MLP_WIDTHS = list(range(64, 1025, 64))


@pytest.mark.parametrize("width", MLP_WIDTHS)
def test_pointmlp_blocks_fit_shared_memory_at_every_width(width):
    # the ring of 3 stages, the epilogue's own padded tile and the
    # alignment within 227 KB, as H and as Cout
    plan = cuda_mlp.pointmlp_plan(48, 717, 64, width, width)
    for name in ("z", "out"):
        p = plan[name]
        bn = p["column_tile"]
        assert width % bn == 0 and bn in (64, 128, 256)
        assert p["smem"] <= cuda_mlp.SMEM_LIMIT
        ring = cuda_mlp.GEMM_STAGES * (cuda_mlp.GEMM_ROWS + bn) * cuda_mlp.GEMM_DEPTH * 2
        assert p["epilogue"] >= cuda_mlp.GEMM_ROWS * (bn + 8) * 2
        assert p["smem"] == ring + p["epilogue"] + 1024


@pytest.mark.parametrize("width,tile", [(1024, 256), (512, 256), (768, 256),
                                        (384, 128), (640, 128), (192, 64),
                                        (64, 64), (320, 64)])
def test_pointmlp_column_tile_is_the_widest_that_divides(width, tile):
    assert cuda_mlp.pointmlp_plan(2, 90, 128, width, width)["z"]["column_tile"] == tile


@pytest.mark.parametrize("N", [1, 90, 128, 129, 717, 1024])
def test_pointmlp_row_tiles_stay_in_one_cloud(N):
    # the row tiles of a cloud are their own tiles: a tile never holds two
    # clouds' rows, and the moment partials are one a (cloud, row tile,
    # column)
    plan = cuda_mlp.pointmlp_plan(48, N, 1024, 1024, 512)
    rows = -(-N // cuda_mlp.GEMM_ROWS)
    assert plan["row_tiles"] == rows
    assert plan["z"]["tiles"] == 48 * rows * (1024 // 256)
    assert plan["out"]["tiles"] == 48 * rows * (512 // 256)
    assert plan["partials"] == (48, rows, 2, 1024)


@pytest.mark.parametrize("B,N,width", [(48, 717, 1024), (48, 717, 512),
                                       (1, 1, 64), (3, 90, 128), (2, 1024, 192)])
def test_pointmlp_grid_visits_every_tile_once_in_order(B, N, width):
    # block i takes tiles i, i + G, ... of the (cloud, row tile, column
    # tile) order, the column tiles of a row tile adjacent
    p = cuda_mlp.pointmlp_plan(B, N, 64, width, width)["z"]
    rows, cols = -(-N // cuda_mlp.GEMM_ROWS), width // p["column_tile"]
    G = p["blocks"]
    assert G == min(cuda_mlp.GEMM_BLOCKS, p["tiles"])
    visits = [list(range(i, p["tiles"], G)) for i in range(G)]
    assert sorted(t for v in visits for t in v) == list(range(p["tiles"]))
    decoded = [cuda_mlp.pointmlp_tile(i, rows, cols) for i in range(p["tiles"])]
    assert decoded == [(b, r, c) for b in range(B) for r in range(rows)
                       for c in range(cols)]


# ----------------------------------------------- the whole-loop ICP kernel

from ogmm_tpu_torch.ops import cuda_icp  # noqa: E402

ICP_SHAPES = [(24, 717, 717), (24, 1433, 1433), (48, 717, 717),
              (80, 717, 717), (4, 4096, 4096), (8, 717, 600), (8, 500, 900),
              (1, 1, 1), (3, 37, 4096), (1, 20000, 4096)]
ICP_STATIC_BYTES = 4 * (32 * 16 + 2 * 16 + 16 + 12)   # csrc/icp.cu's static arrays


@pytest.mark.parametrize("B,N,M", ICP_SHAPES)
def test_icp_rows_belong_to_exactly_one_block_of_their_cluster(B, N, M):
    # block r of a cloud's cluster owns rows [r rows, min(N, (r + 1) rows)),
    # and each of them gets `lanes` threads in one of the block's passes
    p = cuda_icp.icp_plan(B, N, M, H100_SMS)
    assert 2 <= p.cluster <= cuda_icp.ICP_MAX_CLUSTER
    seen = np.zeros(N, np.int64)
    for r in range(p.cluster):
        seen[r * p.rows:min(N, (r + 1) * p.rows)] += 1
    assert (seen == 1).all() and p.rows * p.cluster >= N
    assert p.threads % 32 == 0 and 32 <= p.threads <= cuda_icp.ICP_MAX_THREADS
    assert p.lanes in (1, 2, 4, 8) and p.threads % p.lanes == 0
    per_pass = p.threads // p.lanes
    rows_served = [pass_ * per_pass + j for pass_ in range(-(-p.rows // per_pass))
                   for j in range(per_pass)]
    assert set(range(p.rows)) <= set(rows_served)
    # every thread is needed: no pass of idle warps
    assert p.threads <= 32 * -(-p.rows * p.lanes // 32)


@pytest.mark.parametrize("M", [1, 130, 717, 1433, 4096])
@pytest.mark.parametrize("N", [1, 717, 4096, 20000])
@pytest.mark.parametrize("B", [1, 24, 48])
def test_icp_blocks_fit_shared_memory_up_to_m_4096(B, N, M):
    # the target and the rows as float4 (16 bytes a point), the rows'
    # codes; dynamic and static together within the 227 KB of a block
    p = cuda_icp.icp_plan(B, N, M, H100_SMS)
    assert p.smem == 16 * M + 16 * p.rows + 4 * p.rows
    assert p.smem <= cuda_icp.ICP_SMEM_MAX
    assert p.smem + ICP_STATIC_BYTES <= 227 * 1024
    assert cuda_icp.kernel_takes(M, 3, "horn_pi", N)


def test_icp_refined_request_fills_the_card_in_one_wave():
    # B = 24: four blocks a cloud, 96 blocks; the occupancy calculator
    # holds 30 clusters of 4 at once on 132 SMs, 22 of 5 and 15 of 8
    p = cuda_icp.icp_plan(24, 717, 717, H100_SMS)
    assert p.cluster == 4 and 24 * p.cluster <= 30 * 4
    assert (p.rows, p.lanes, p.threads) == (180, 4, 736)
    # N = 1433 keeps the clusters and halves the lanes: one pass of rows
    p = cuda_icp.icp_plan(24, 1433, 1433, H100_SMS)
    assert (p.cluster, p.rows, p.lanes, p.threads) == (4, 359, 2, 736)
    # 48 clouds take two blocks each (96 blocks), more clouds than one wave
    # holds two as well; a few clouds take eight
    assert cuda_icp.icp_plan(48, 717, 717, H100_SMS).cluster == 2
    assert cuda_icp.icp_plan(80, 717, 717, H100_SMS).cluster == 2
    assert cuda_icp.icp_plan(8, 717, 717, H100_SMS).cluster == 8


def test_icp_kernel_takes_the_rows_its_clusters_hold():
    # the rows of eight blocks must fit beside the target, else the eager
    # loop runs
    most = (cuda_icp.ICP_SMEM_MAX - 16 * 4096) // 20 * cuda_icp.ICP_MAX_CLUSTER
    assert cuda_icp.kernel_takes(4096, 3, "horn_pi", 4096)
    assert cuda_icp.kernel_takes(4096, 3, "horn_pi", most)
    assert not cuda_icp.kernel_takes(4096, 3, "horn_pi", most + 9)
    with pytest.raises(ValueError, match="do not fit"):
        cuda_icp.icp_plan(1, most + 9, 4096, H100_SMS)
    assert not cuda_icp.kernel_takes(4097, 3, "horn_pi", 10)


# ------------------------------------------ the bf16 edge pass, its scatter

EDGE_SHAPES = [(1, 1), (1, 3), (2, 5), (1, 1024), (24, 717), (3, 1000),
               (48, 717), (7, 129)]


@pytest.mark.parametrize("B,N", EDGE_SHAPES)
@pytest.mark.parametrize("k", GRID_KS)
def test_bwd_edge_grid_visits_every_tile_once_in_order(B, N, k):
    # both forms: bf16 (edge_wgmma_kernel) and float32 (edge_tf32_kernel)
    for dt in (torch.bfloat16, torch.float32):
        plan = cuda_dgcnn_bwd.bwd_edge_plan(B, N, k, dt)
        tiles = B * -(-N // cuda_dgcnn_bwd.tile_points(k))
        assert plan["tiles"] == tiles
        assert plan["blocks"] == min(cuda_dgcnn_bwd.STAGE_BLOCKS, tiles)
        shares = cuda_dgcnn_bwd.stage_shares(plan["tiles"], plan["blocks"])
        assert [t for a, b in shares for t in range(a, b)] == list(range(tiles))
        assert all(a < b for a, b in shares)


@pytest.mark.parametrize("B,N", [(24, 717), (1, 1), (2, 5), (48, 1024)])
def test_bwd_edge_partials_are_fixed_by_the_shape(B, N):
    # one dW_1 partial a block, summed in block order, in both forms
    for dt in (torch.bfloat16, torch.float32):
        plan = cuda_dgcnn_bwd.bwd_edge_plan(B, N, 20, dt)
        assert plan["part_w"] == (plan["blocks"], 6, cuda_dgcnn_bwd.KERNEL_EDGE[0])
        assert cuda_dgcnn_bwd.bwd_edge_plan(B, N, 20, dt) == plan


@pytest.mark.parametrize("k", CLASS_KS)
def test_bwd_edge_block_fits_shared_memory(k):
    # bf16: two buffers of z_1 and dz_2 panels, W_2 and W_1 panels, the e
    # panel, the extra cotangent's tile, de and the alignment, within 227
    # KB; the same for every shape; a tile's rows whole k16 steps of the
    # weight gradient's wgmma, half of them a row product's n
    plan = cuda_dgcnn_bwd.bwd_edge_plan(24, 1024, k)
    rows = plan["rows_a_tile"]
    assert rows == plan["row_class"] * cuda_dgcnn_bwd.tile_points(k) <= 80
    assert rows % 16 == 0 and plan["row_product_n"] * 2 == rows
    panel = rows * 128
    assert 5 * panel + 2 * 64 * 64 * 2 <= plan["smem"] <= cuda_dgcnn_bwd.SMEM_LIMIT
    assert {cuda_dgcnn_bwd.bwd_edge_plan(*s, k)["smem"] for s in EDGE_SHAPES} == {plan["smem"]}
    # float32: two buffers of z_1 and dz_2 as 32-channel panels and the
    # taps, the extra cotangent's two K halves in rows of 68 floats, the e
    # rows, de, W_1 and the alignment; 16 warps; the same at every N the
    # kernel takes; the bf16 kernel's tiles, each half of them whole 8-row
    # column tiles
    plans = [cuda_dgcnn_bwd.bwd_edge_plan(24, n, k, torch.float32)
             for n in (32, 33, 717, 768, 1024)]
    assert len({p["smem"] for p in plans}) == 1
    assert (2 * 4 * rows * 32 * 4 + 2 * rows * 68 * 4 + 1024 <= plans[0]["smem"]
            <= cuda_dgcnn_bwd.SMEM_LIMIT)
    for p in plans:
        assert p["rows_a_tile"] == rows and (rows // 2) % 8 == 0
        assert p["threads"] == 32 * cuda_dgcnn_bwd.STAGE_WARPS
        # the two K halves of W_2's depth, whole k8 steps each
        assert cuda_dgcnn_bwd.KERNEL_EDGE[2] % (8 * p["extra_k_slices"]) == 0
        # the weight gradient: a thread a (channel, part of the rows), every
        # row of a tile in one part
        assert p["dw_parts"] * cuda_dgcnn_bwd.KERNEL_EDGE[0] == p["threads"]
        assert rows % p["dw_parts"] == 0
        # de: a thread a (row, output)
        assert 6 * rows <= p["threads"]


@pytest.mark.parametrize("B,N", EDGE_SHAPES)
def test_scatter_ranges_cover_each_point_once(B, N):
    plan = cuda_dgcnn_bwd.scatter_plan(B, N, 20)
    gx, gy = plan["grid"]
    assert gy == B and len(plan["ranges"]) == gx * B
    seen = [(b, p) for b, p0, p1 in plan["ranges"] for p in range(p0, p1)]
    assert sorted(seen) == [(b, p) for b in range(B) for p in range(N)]
    assert all(0 < p1 - p0 <= cuda_dgcnn_bwd.SCATTER_POINTS
               for _, p0, p1 in plan["ranges"])
    # the lists of the worst case (every row of the cloud in one range) fit,
    # at every k up to 32 (149.6 KB at k = 32, N = 1024)
    assert plan["smem"] >= 4 * 20 * N
    for k in (1, 20, 32):
        assert cuda_dgcnn_bwd.scatter_plan(B, 1024, k)["smem"] <= cuda_dgcnn_bwd.SMEM_LIMIT
    assert cuda_dgcnn_bwd.scatter_plan(1, 1024, 32)["smem"] == 4 * (18 * 256 + 16 + 32 * 1024)


@pytest.mark.parametrize("B,N", [(24, 717), (48, 1024), (2, 300)])
def test_scatter_uses_more_blocks_than_clouds(B, N):
    # one block a cloud would leave most of the card's 132 SMs idle at B = 24
    assert np.prod(cuda_dgcnn_bwd.scatter_plan(B, N, 20)["grid"]) > B


# ------------------------------------------------------------ the dense kNN

from ogmm_tpu_torch.ops import cuda_knn  # noqa: E402

CSRC = os.path.join(os.path.dirname(__file__), os.pardir, "ogmm_tpu_torch", "csrc")


@pytest.mark.parametrize("B,N", [(48, 1433), (24, 717), (1, 1), (2, 90),
                                 (4, 1000), (3, 64), (3, 65)])
def test_knn_block_plan_covers_every_query_once(B, N):
    plan = cuda_knn.knn_plan(B, N, 257, 20)
    gx, gy = plan["grid"]
    assert gy == B and plan["threads"] == cuda_knn.KNN_QUERIES * cuda_knn.KNN_LANES
    # block x holds the queries [64 x, 64 x + 64): each query of each cloud
    # once, no block without a query
    queries = [x * cuda_knn.KNN_QUERIES + q for x in range(gx)
               for q in range(cuda_knn.KNN_QUERIES)]
    assert [q for q in queries if q < N] == list(range(N))
    assert (gx - 1) * cuda_knn.KNN_QUERIES < N


@pytest.mark.parametrize("M,k", [(M, k) for M in (1, 40, 717, 1433, 2048, 4096)
                                 for k in (1, 5, 20, 32) if k <= M])
def test_knn_block_fits_shared_memory_up_to_4096(M, k):
    # the target as (x, y, z, |t|^2) and the lanes' candidate buffers, or
    # the four lanes' lists of the block's queries in the same bytes
    plan = cuda_knn.knn_plan(2, 100, M, k)
    assert plan["smem"] >= 16 * M + 4 * cuda_knn.KNN_BUFFER * plan["threads"]
    assert plan["smem"] >= plan["threads"] * plan["K"] * 8
    assert plan["smem"] <= cuda_knn.SMEM_LIMIT


def test_knn_compiled_k_is_the_smallest_at_or_above_k():
    ks = cuda_knn.KNN_KS
    assert list(ks) == sorted(ks) and ks[-1] == 32
    for k in range(1, 33):
        K = cuda_knn.knn_compiled_k(k)
        assert K in ks and K >= k
        assert all(c < k for c in ks if c < K)
        assert cuda_knn.knn_plan(1, 10, 40, k)["K"] == K
    # the paths' and the checks' k are compiled as they are
    assert [cuda_knn.knn_compiled_k(k) for k in (1, 5, 20, 32)] == [1, 5, 20, 32]


# ------------------------------------------------------------ the dense 1-NN

NN1_EDGE_SHAPES = [(1, 1, 1), (2, 5, 3), (1, 1, 4096), (24, 717, 4096)]
NN1_PATH_SHAPES = [(24, 512, 717), (24, 128, 717), (24, 717, 717),
                   (24, 1433, 1433)]
# the queries leave SMs without a block: the C.1 check's clustering (16
# nodes of N = 2048 at B = 4), requests of one cloud, a few queries
NN1_FEW_QUERY_SHAPES = [(4, 16, 2048), (1, 128, 717), (1, 717, 717),
                        (1, 1, 4096), (24, 16, 2048), (2, 16, 4096), (1, 100, 1000)]


@pytest.mark.parametrize("B,N,M", NN1_EDGE_SHAPES + NN1_PATH_SHAPES)
def test_nn1_plan_covers_every_pair_once(B, N, M):
    # each query of each cloud belongs to one block's row of queries, and
    # each target point to one lane of its query: the pair (query, point)
    # is formed once
    plan = cuda_knn.nn1_plan(B, N, H100_SMS)
    assert plan.lanes in cuda_knn.NN1_LANES
    assert plan.queries * plan.lanes == cuda_knn.NN1_THREADS * plan.rows
    q_blocks = -(-N // plan.queries)
    assert plan.blocks == q_blocks * B
    queries = np.arange(q_blocks * plan.queries)
    assert (queries[queries < N] == np.arange(N)).all()
    seen = np.zeros(M, np.int64)
    for sub in range(plan.lanes):
        seen[sub::plan.lanes] += 1
    assert (seen == 1).all()
    # the whole target of a cloud sits in a block's shared memory
    assert M * 16 <= cuda_knn.SMEM_LIMIT


@pytest.mark.parametrize("B,N,M", NN1_EDGE_SHAPES + NN1_PATH_SHAPES)
def test_nn1_merge_order_is_fixed_by_the_shape(B, N, M):
    # the plan is a function of the shape alone, and the lanes of a query
    # merge by xor shuffles 1, 2, ..., lanes / 2: each lane ends with the
    # least pair of all lanes, whatever the order of its partners
    plan = cuda_knn.nn1_plan(B, N, H100_SMS)
    cuda_knn.nn1_plan.cache_clear()
    assert cuda_knn.nn1_plan(B, N, H100_SMS) == plan
    lanes = [{sub} for sub in range(plan.lanes)]
    o = 1
    while o < plan.lanes:
        lanes = [lanes[sub] | lanes[sub ^ o] for sub in range(plan.lanes)]
        o <<= 1
    assert all(held == set(range(plan.lanes)) for held in lanes)


@pytest.mark.parametrize("B,N,M,lanes,rows", [
    (24, 128, 717, 16, 1), (24, 1433, 1433, 8, 2), (24, 717, 717, 16, 2),
    (24, 512, 717, 16, 2)])
def test_nn1_plan_fills_the_card(B, N, M, lanes, rows):
    # every SM has a block at the four path shapes; four each with the
    # fewest lanes that give them (the ICP trips, the metrics); else the
    # most lanes (the Welsch loss), one query a thread where two would leave
    # SMs idle (the clustering's 128 queries a cloud: 192 blocks)
    plan = cuda_knn.nn1_plan(B, N, H100_SMS)
    assert (plan.lanes, plan.rows) == (lanes, rows)
    assert plan.blocks >= H100_SMS
    want = cuda_knn.NN1_BLOCKS_AN_SM * H100_SMS
    assert plan.blocks >= want or lanes == cuda_knn.NN1_LANES[-1]
    fewer = [n for n in cuda_knn.NN1_LANES if n < plan.lanes]
    assert all(cuda_knn.nn1_plan_with(B, N, n, cuda_knn.NN1_PLAN_ROWS).blocks
               < want for n in fewer)


@pytest.mark.parametrize("B,N,M", [(24, 512, 717), (24, 717, 717), (24, 128, 717),
                                   (24, 1433, 1433), (48, 1433, 1433),
                                   (24, 717, 4096)])
def test_nn1_plan_splits_nothing_where_the_queries_fill_the_card(B, N, M):
    # one block row of queries takes the whole target of its cloud: the
    # grid is the query blocks of the B clouds, and they fill the card
    plan = cuda_knn.nn1_plan(B, N, H100_SMS)
    assert plan.blocks == -(-N // plan.queries) * B >= H100_SMS


@pytest.mark.parametrize("B,N,M", NN1_FEW_QUERY_SHAPES)
def test_nn1_plan_takes_the_most_blocks_where_the_queries_leave_sms_idle(B, N, M):
    # the target is not split (measured slower, PERF.md §6): the most lanes
    # and one query a thread, the most blocks any compiled plan gives
    plan = cuda_knn.nn1_plan(B, N, H100_SMS)
    assert (plan.lanes, plan.rows) == (cuda_knn.NN1_LANES[-1], 1)
    assert plan.blocks < H100_SMS
    assert plan.blocks == max(cuda_knn.nn1_plan_with(B, N, lanes, rows).blocks
                              for lanes in cuda_knn.NN1_LANES for rows in (1, 2))


@pytest.mark.parametrize("B,N,M", NN1_EDGE_SHAPES)
def test_nn1_plan_at_the_edge_shapes(B, N, M):
    # a plan has a block, and a block has a query
    plan = cuda_knn.nn1_plan(B, N, H100_SMS)
    assert plan.blocks >= 1 and plan.queries >= 1
    if plan.blocks < H100_SMS:
        assert (plan.lanes, plan.rows) == (cuda_knn.NN1_LANES[-1], 1)


def test_nn1_kernel_compiles_the_plans_nn1_plan_returns():
    # csrc/nn1.cu instantiates NN1_PLANS: each (lanes, queries a thread)
    # pair the plan can return, and no other
    text = open(os.path.join(CSRC, "nn1.cu")).read()
    line = re.search(r"#define NN1_PLANS\(X\)(.*)", text).group(1)
    compiled = {(int(a), int(b)) for a, b in re.findall(r"X\((\d+), (\d+)\)", line)}
    returned = {(p.lanes, p.rows) for B in (1, 4, 24, 48)
                for N in (1, 16, 128, 512, 717, 1433, 4096)
                for p in [cuda_knn.nn1_plan(B, N, H100_SMS)]}
    assert compiled == returned


# ------------------------------------------------------- the angle kernel

from ogmm_tpu_torch.ops import cuda_posenc  # noqa: E402


def test_posenc_plan_mirrors_the_kernel():
    text = open(os.path.join(CSRC, "posenc_angles.cu")).read()
    ks = re.search(r"#define POSENC_LANES_KS\(X\)(.*)", text).group(1)
    shared = re.search(r"#define POSENC_SHARED_KS\(X\)(.*)", text).group(1)
    assert tuple(int(k) for k in re.findall(r"X\((\d+)\)", ks)) == cuda_posenc.LANES_KS
    assert _cu_define("posenc_angles.cu", "POSENC_LANES") == cuda_posenc.LANES
    assert _cu_define("posenc_angles.cu", "PT") == cuda_posenc.THREADS
    # the shared selection is compiled at exactly the K the plan gives it
    compiled = {int(k) for k in re.findall(r"X\((\d+)\)", shared)}
    assert {cuda_knn.knn_compiled_k(k) for k in range(9, 33)} == compiled


@pytest.mark.parametrize("k", range(1, 33))
def test_posenc_plan_splits_k_between_the_two_kernels(k):
    plan = cuda_posenc.posenc_plan(24, 717, k)
    if k <= 8:
        # the lanes kernel at the smallest compiled K >= k; round r's winner
        # stays with lane r, so K <= lanes
        assert plan.kernel == "lanes" and plan.lanes == cuda_posenc.LANES
        assert plan.K == min(K for K in cuda_posenc.LANES_KS if K >= k)
        assert plan.K <= plan.lanes and plan.lanes * plan.queries == cuda_posenc.THREADS
    else:
        assert plan.kernel == "shared" and plan.lanes == cuda_knn.KNN_LANES
        assert plan.K == cuda_knn.knn_compiled_k(k)
        assert plan.queries == cuda_knn.KNN_QUERIES


@pytest.mark.parametrize("B,N,k", [(24, 717, 5), (1, 717, 5), (4, 1024, 5),
                                   (2, 5, 5), (3, 6, 1), (1, 64, 8), (2, 1023, 2),
                                   (24, 717, 20), (1, 33, 32), (5, 1000, 9)])
def test_posenc_plan_covers_every_query_once(B, N, k):
    plan = cuda_posenc.posenc_plan(B, N, k)
    gx = plan.blocks // B
    assert gx * B == plan.blocks
    owned = [x * plan.queries + q for x in range(gx) for q in range(plan.queries)]
    assert [q for q in owned if q < N] == list(range(N))
    assert (gx - 1) * plan.queries < N


def test_posenc_plan_fills_the_card_at_the_unfused_step():
    # (24, 717, k=5): 1080 blocks of 256 threads (16 lanes a query), where
    # the shared selection gave 288; one cloud still gives 45
    plan = cuda_posenc.posenc_plan(24, 717, 5)
    assert (plan.kernel, plan.lanes, plan.queries, plan.blocks) == ("lanes", 16, 16, 1080)
    assert plan.blocks >= 2 * H100_SMS
    assert cuda_posenc.posenc_plan(1, 717, 5).blocks == 45


@pytest.mark.parametrize("N,k", [(1025, 5), (64, 33), (4, 5), (64, 0)])
def test_posenc_plan_refuses_what_the_kernel_does_not_take(N, k):
    with pytest.raises(ValueError):
        cuda_posenc.posenc_plan(2, N, k)


# ------------------------------------------------- graph_stage1's edge pass

from ogmm_tpu_torch.ops import cuda_dgcnn_train  # noqa: E402


def edge_rows(rows: int, blocks: int, block: int):
    """The rows block `block` of the edge pass writes, in its order: the
    kernel's grid-stride loop (csrc/graph_stage1.cu), mirrored. Its
    EDGE_ROWS rows of a step (one for each eight threads) start at block *
    EDGE_ROWS + s * stride, s = 0, 1, ..., stride = blocks * EDGE_ROWS (a
    thread takes two steps at once, which changes no row's block)."""
    R = cuda_dgcnn_train.EDGE_ROWS
    return [r for r0 in range(block * R, rows, blocks * R)
            for r in range(r0, min(r0 + R, rows))]


@pytest.mark.parametrize("B,k,N", [(24, 20, 717), (1, 20, 1024), (2, 8, 20),
                                   (1, 8, 8), (3, 16, 90)])
def test_edge_pass_writes_every_row_once(B, k, N):
    # the grid-stride loop: block i takes rows i R, i R + 1, ... (R at a
    # time, eight threads a row), then i R + blocks R, ...: every edge row
    # (b, j, n) once, and each block's rows ascend
    rows = B * k * N
    blocks = cuda_dgcnn_train.edge_plan(B, k, N, H100_SMS)
    assert 1 <= blocks <= cuda_dgcnn_train.EDGE_BLOCKS_AN_SM * H100_SMS
    assert (blocks - 1) * cuda_dgcnn_train.EDGE_ROWS < rows
    assert cuda_dgcnn_train.EDGE_ROWS * 8 == cuda_dgcnn_train.EDGE_THREADS
    seen = np.zeros(rows, np.int64)
    for i in range(blocks):
        mine = edge_rows(rows, blocks, i)
        assert mine == sorted(mine)
        seen[mine] += 1
    assert (seen == 1).all()


# ------------------------------------------- the backward reduce's launch

def _cu_define(source, name):
    text = open(os.path.join(CSRC, source)).read()
    return int(re.search(rf"#define {name} (\d+)", text).group(1))


def test_reduce_plan_mirrors_the_kernel():
    assert cuda_dgcnn_bwd.REDUCE_THREADS == _cu_define("dgcnn_bwd.cu", "RED_NT")
    assert cuda_dgcnn_bwd.REDUCE_CHANNELS == _cu_define("dgcnn_bwd.cu", "RED_CH")


@pytest.mark.parametrize("B,N", [(24, 717), (24, 1433), (1, 5), (1, 1), (3, 90)])
@pytest.mark.parametrize("C", [64, 128, 256])
def test_reduce_plan_visits_every_point_once_in_a_fixed_order(B, N, C):
    plan = cuda_dgcnn_bwd.reduce_plan(B, N, C, 132)
    G = plan["blocks"]
    order = cuda_dgcnn_bwd.reduce_order(B, N, C, G)
    assert len(order) == G
    assert sorted(p for block in order for p in block) == list(range(B * N))
    ppw, warps = plan["points_a_warp"], plan["threads"] // 32
    for i, block in enumerate(order):
        p0, p1 = B * N * i // G, B * N * (i + 1) // G
        assert sorted(block) == list(range(p0, p1))    # a contiguous range
        # rounds of the block's warps, each warp ppw adjacent points
        assert block == [p for r in range(p0, p1, warps * ppw)
                         for p in range(r, min(r + warps * ppw, p1))]
    assert order == cuda_dgcnn_bwd.reduce_order(B, N, C, G)


@pytest.mark.parametrize("B,N", [(24, 717), (24, 1433), (1, 5), (1, 1), (3, 90),
                                 (48, 1433)])
@pytest.mark.parametrize("C", [64, 128, 256])
def test_reduce_partials_are_fixed_by_the_shape(B, N, C):
    plan = cuda_dgcnn_bwd.reduce_plan(B, N, C, 132)
    ppw = 32 * cuda_dgcnn_bwd.REDUCE_CHANNELS // C
    assert plan["points_a_warp"] == ppw
    assert plan["blocks"] == max(1, min(132, -(-(B * N) // (16 * ppw))))
    assert plan["part"] == (plan["blocks"], 2, C)
    assert cuda_dgcnn_bwd.reduce_plan(B, N, C, 132) == plan


@pytest.mark.parametrize("B,N", [(24, 717), (24, 1433)])
@pytest.mark.parametrize("C", [64, 128, 256])
def test_reduce_plan_fills_the_card(B, N, C):
    plan = cuda_dgcnn_bwd.reduce_plan(B, N, C, 132)
    assert plan["blocks"] == 132
    # every warp of every block takes at least one round of points
    shortest = min(len(b) for b in cuda_dgcnn_bwd.reduce_order(B, N, C, 132))
    assert shortest >= plan["threads"] // 32 * plan["points_a_warp"]


# ------------------------------------------------------------ the FPS launch

FPS_SHAPES = [(96, 717), (48, 1433), (4, 35000), (1, 1), (2, 10240), (2, 10241),
              (1, 131072), (1, 131073), (2, 200000)]


def _fps_compiled():
    """(points a thread -> the most threads, the largest cluster, the most
    warps) as csrc/fps.cu compiles them."""
    text = open(os.path.join(CSRC, "fps.cu")).read()
    cases = [int(p) for p in re.findall(r"case (\d+): return \(int\)launch_reg", text)]
    m = re.search(r"value = P <= (\d+) \? (\d+) : P <= (\d+) \? (\d+) : (\d+);", text)
    p1, t1, p2, t2, t3 = map(int, m.groups())
    most = {p: t1 if p <= p1 else t2 if p <= p2 else t3 for p in cases}
    return most, _cu_define("fps.cu", "MAX_CLUSTER"), _cu_define("fps.cu", "MAX_WARPS")


def test_fps_plan_mirrors_the_kernel():
    most, max_cluster, max_warps = _fps_compiled()
    assert cuda_fps.FPS_POINTS == most
    assert max(cuda_fps.FPS_CLUSTERS) == max_cluster
    assert max(most.values()) == 32 * max_warps


@pytest.mark.parametrize("R,N", FPS_SHAPES)
def test_fps_plan_owns_every_point_once(R, N):
    plan = cuda_fps.fps_plan(R, N, 132)
    if plan.route == "l2":
        return                     # every thread strides over the whole row
    ranges = cuda_fps.fps_ranges(plan, N)
    assert len(ranges) == plan.cluster * plan.threads
    # contiguous and ascending: thread after thread, block after block
    assert ranges[0][0] == 0 and ranges[-1][1] == N
    for (a0, a1), (b0, b1) in zip(ranges, ranges[1:]):
        assert a1 == b0 and a0 <= a1
    assert all(b - a <= plan.points for a, b in ranges)
    # each block's share fits its threads, and no block is padding only
    share = -(-N // plan.cluster)
    assert share <= plan.threads * plan.points
    assert (plan.cluster - 1) * share < N


@pytest.mark.parametrize("R,N", FPS_SHAPES)
def test_fps_plan_stays_within_the_compiled_limits(R, N):
    most, max_cluster, max_warps = _fps_compiled()
    plan = cuda_fps.fps_plan(R, N, 132)
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 32 * max_warps
    if plan.route == "registers":
        assert plan.points in most and plan.threads <= most[plan.points]
        assert plan.cluster in cuda_fps.FPS_CLUSTERS and plan.cluster <= max_cluster
        assert plan.points >= cuda_fps.FPS_MIN_POINTS
    else:
        assert (plan.cluster, plan.points) == (1, 0)
    for p in cuda_fps.compiled_plans(R, N, 132):
        assert p.route == "l2" or (p.threads <= most[p.points]
                                   and p.cluster * p.threads * p.points >= N)


def test_fps_route_switches_where_the_register_routes_stop():
    most, max_cluster, _ = _fps_compiled()
    capacity = max_cluster * max(p * t for p, t in most.items())
    assert capacity == 131072
    assert cuda_fps.fps_plan(1, capacity, 132).route == "registers"
    assert cuda_fps.fps_plan(1, capacity + 1, 132).route == "l2"
    assert cuda_fps.fps_plan(2, 200000, 132).route == "l2"
    # one block a row while a block holds the row at FPS_MIN_POINTS a thread
    assert cuda_fps.fps_plan(96, 717, 132).cluster == 1
    assert cuda_fps.fps_plan(48, 1433, 132).cluster == 1
    assert cuda_fps.fps_plan(4, 35000, 132).cluster > 1


def test_dgcnn_rows_mirror_the_kernels():
    # the k the DGCNN kernels take and the row counts their stage chains are
    # compiled for (csrc/knn_select.cuh: DGCNN_MAX_K, DGCNN_KS, dgcnn_rows)
    text = open(os.path.join(CSRC, "knn_select.cuh")).read()
    assert cuda_dgcnn.CHUNK_K == _cu_define("knn_select.cuh", "DGCNN_MAX_K")
    compiled = re.search(r"#define DGCNN_KS\(X\) (.*)", text).group(1)
    assert tuple(int(v) for v in re.findall(r"X\((\d+)\)", compiled)) == cuda_dgcnn.STAGE_KS
    assert {cuda_dgcnn.stage_rows(k) for k in cuda_dgcnn.CHUNK_KS} == set(cuda_dgcnn.STAGE_KS)
    assert "k <= 8 ? 8 : (k + 3) & ~3" in text
    assert all(cuda_dgcnn.stage_rows(k) == (8 if k <= 8 else (k + 3) & ~3)
               for k in cuda_dgcnn.CHUNK_KS)


# ------------------------- the float32 forms of the MLP and backward stage

F32 = torch.float32


@pytest.mark.parametrize("N", [1, 90, 717, 1024])
@pytest.mark.parametrize("width", MLP_WIDTHS)
def test_pointmlp_f32_blocks_fit_shared_memory_at_every_width(N, width):
    # a stage holds x's (or z's) 128 x 32 box and the weight's hi and lo
    # BN x 32 boxes; the ring of 3, the float32 epilogue tile and the
    # alignment within 227 KB, as H and as Cout, at the envelope's N
    plan = cuda_mlp.pointmlp_plan(48, N, 1024, width, width, F32)
    assert plan["launches"] == 4
    assert plan["planes"] == (2 * width * 1024 + 2 * width * width,)
    rows = -(-N // cuda_mlp.GEMM_ROWS)
    assert plan["row_tiles"] == rows and plan["partials"] == (48, rows, 2, width)
    for name in ("z", "out"):
        p = plan[name]
        bn = p["column_tile"]
        assert width % bn == 0 and bn == (128 if width % 128 == 0 else 64)
        assert p["stage"] == (cuda_mlp.GEMM_ROWS + 2 * bn) * cuda_mlp.GEMM_DEPTH_F32 * 4
        assert p["epilogue"] >= cuda_mlp.GEMM_ROWS * (bn + 8) * 4
        assert p["smem"] == cuda_mlp.GEMM_STAGES * p["stage"] + p["epilogue"] + 1024
        assert p["smem"] <= cuda_mlp.SMEM_LIMIT
        assert p["tiles"] == 48 * rows * (width // bn)
        assert p["blocks"] == min(cuda_mlp.GEMM_BLOCKS, p["tiles"])


def test_pointmlp_f32_plan_at_the_attention_call():
    # the path's call: 48 clouds of 717, 1024 -> 1024 -> 512; both products
    # in column tiles of 128, every SM busy
    plan = cuda_mlp.pointmlp_plan(48, 717, 1024, 1024, 512, F32)
    assert plan["z"]["column_tile"] == plan["out"]["column_tile"] == 128
    assert plan["z"]["tiles"] == 48 * 6 * 8 and plan["out"]["tiles"] == 48 * 6 * 4
    assert plan["z"]["blocks"] == plan["out"]["blocks"] == 132
    assert plan["z"]["smem"] == 3 * 49152 + 69632 + 1024 == 218112
    # the bf16 route keeps its plan
    assert cuda_mlp.pointmlp_plan(48, 717, 1024, 1024, 512)["z"]["column_tile"] == 256


@pytest.mark.parametrize("B,N", [(24, 717), (1, 1), (2, 90), (3, 1024), (48, 717)])
@pytest.mark.parametrize("k", GRID_KS)
@pytest.mark.parametrize("stage", STAGES)
def test_bwd_stage_f32_plan(B, N, stage, k):
    # tiles of 2 points (1 above k = 20), a persistent grid of at most 132
    # blocks, one partial of each a block; two buffers of a tile's z rows
    # (padded by 4 floats) and taps, one of its dz_{i+1} rows, and the
    # larger row product's slices, within 227 KB; whole 8-row column tiles
    C, cin, cn = stage
    plan = cuda_dgcnn_bwd.bwd_stage_plan(B, N, k, C, cin, cn, F32)
    tn = cuda_dgcnn_bwd.f32_tile_points(k)
    tiles = B * -(-N // tn)
    assert tn == (2 if k <= 20 else 1) and plan["points_a_tile"] == tn
    assert plan["tiles"] == tiles and plan["blocks"] == min(132, tiles)
    assert plan["part_w"] == (plan["blocks"], cin, C)
    assert plan["part_s"] == (plan["blocks"], 2, cin)
    assert plan["threads"] == 512
    rows = plan["rows_a_tile"]
    assert rows == tn * cuda_dgcnn_bwd.row_class(k) and rows % 8 == 0
    buf = rows * (C + cin + 8) + tn * (C + cin)
    assert plan["smem"] >= 4 * (2 * buf + (rows * (cn + 4) if cn else 0))
    assert plan["smem"] <= cuda_dgcnn_bwd.SMEM_LIMIT
    shares = cuda_dgcnn_bwd.stage_shares(tiles, plan["blocks"])
    assert [t for a, b in shares for t in range(a, b)] == list(range(tiles))


@pytest.mark.parametrize("stage", STAGES)
def test_bwd_stage_f32_warps_cover_every_product_once(stage):
    # the row products: groups of m-tiles x K slices = the 16 warps, every
    # m-tile in one group, each slice whole k8 steps; the weight gradient:
    # each warp 2 m-tiles of C_in by a run of 8-column tiles of C, every
    # (m-tile, column tile) once
    C, cin, cn = stage
    warps = cuda_dgcnn_bwd.STAGE_WARPS
    xpw = cuda_dgcnn_bwd.bwd_stage_plan(24, 717, 20, C, cin, cn, F32)["extra_m_tiles_a_warp"]
    for M, K, mpw in ((C, cn, xpw), (cin, C, 1)):
        if not K:
            continue
        split = cuda_dgcnn_bwd.row_split(M, 20, mpw)
        assert split["groups"] * split["k_slices"] == warps
        assert split["groups"] * split["m_tiles_a_warp"] * 16 == M
        assert (K // split["k_slices"]) % 8 == 0
    mpw, npw = cuda_dgcnn_bwd.bwd_stage_plan(24, 717, 20, C, cin, cn, F32)["dw_tiles_a_warp"]
    groups = (cin // 16) // mpw
    owned = [(mpw * (w % groups) + u, (w // groups) * npw + j)
             for w in range(warps) for u in range(mpw) for j in range(npw)]
    assert sorted(owned) == [(m, n) for m in range(cin // 16) for n in range(C // 8)]


# ---------------------------------- the backward kernels' row classes

from ogmm_tpu_torch.ops import dispatch  # noqa: E402


def test_row_classes_cover_every_k_the_graph_kernel_takes():
    # a library a class (-DBWD_KP), each k of the graph kernel's envelope
    # in the smallest class that holds it, nothing past it
    classes = cuda_dgcnn_bwd.ROW_CLASSES
    assert max(classes) == cuda_dgcnn_bwd.KERNEL_MAX_K and list(classes) == sorted(classes)
    for k in range(1, cuda_dgcnn_bwd.KERNEL_MAX_K + 1):
        kp = cuda_dgcnn_bwd.row_class(k)
        assert kp >= k and not any(k <= c < kp for c in classes)
        assert cuda_dgcnn_bwd.library(k) in dispatch.SOURCES
    assert {dispatch.VARIANTS[f"dgcnn_bwd_k{kp}"] for kp in classes} == {
        ("dgcnn_bwd", (f"-DBWD_KP={kp}",)) for kp in classes}
    for k in (0, cuda_dgcnn_bwd.KERNEL_MAX_K + 1):
        with pytest.raises(ValueError):
            cuda_dgcnn_bwd.row_class(k)


def _cu_tiles():
    """The tile formulas of csrc/dgcnn_bwd.cu as functions of KP."""
    text = open(os.path.join(CSRC, "dgcnn_bwd.cu")).read()
    w = re.search(r"constexpr int WTN = KP <= (\d+) \? (\d+) : KP <= (\d+) \? (\d+) : (\d+);",
                  text).groups()
    f = re.search(r"constexpr int FTN = KP <= (\d+) \? (\d+) : (\d+);", text).groups()
    w, f = [int(v) for v in w], [int(v) for v in f]
    wtn = lambda kp: w[1] if kp <= w[0] else w[3] if kp <= w[2] else w[4]
    ftn = lambda kp: f[1] if kp <= f[0] else f[2]
    return wtn, ftn


@pytest.mark.parametrize("kp", cuda_dgcnn_bwd.ROW_CLASSES)
def test_row_class_tiles_mirror_the_kernel(kp):
    wtn, ftn = _cu_tiles()
    assert cuda_dgcnn_bwd.tile_points(kp) == wtn(kp)
    assert cuda_dgcnn_bwd.f32_tile_points(kp) == ftn(kp)
    # csrc static_asserts: bf16 tiles of whole k16 steps, at most 80 rows,
    # points a power of two dividing 8 (a column's lanes then take rows 8 or
    # 4 apart); float32 stage tiles of whole 8-row column tiles
    rows = kp * wtn(kp)
    assert rows % 16 == 0 and rows <= 80 and 8 % wtn(kp) == 0
    assert kp * ftn(kp) % 8 == 0
    for C in (64, 128, 256):
        lanes = cuda_dgcnn_bwd.column_lanes(kp, C)
        # a thread keeps one channel over its passes; rows 8 or 4 tile rows
        # apart; every lane the same rows of its column
        assert (cuda_dgcnn_bwd.STAGE_THREADS // lanes) % C == 0
        assert wtn(kp) * lanes in (4, 8) and kp % lanes == 0
        # every pass of the element work whole: no warp half idle
        assert (wtn(kp) * C) % (cuda_dgcnn_bwd.STAGE_THREADS // lanes) == 0
        # the float32 stage kernel: one column a thread, the lanes of a
        # column a power of two dividing the class's rows
        g = cuda_dgcnn_bwd.column_lanes(kp, C, torch.float32)
        assert g * ftn(kp) * C == cuda_dgcnn_bwd.STAGE_THREADS and kp % g == 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("kp", cuda_dgcnn_bwd.ROW_CLASSES)
def test_bwd_row_classes_fit_shared_memory_at_n_1024(kp, dtype):
    # every row class's stage (three stages), edge, scatter and reduce
    # launches at N = 1024, within a block's 227 KB
    lim = cuda_dgcnn_bwd.SMEM_LIMIT
    for stage in STAGES:
        assert cuda_dgcnn_bwd.bwd_stage_plan(24, 1024, kp, *stage, dtype)["smem"] <= lim
    assert cuda_dgcnn_bwd.bwd_edge_plan(24, 1024, kp, dtype)["smem"] <= lim
    assert cuda_dgcnn_bwd.scatter_plan(24, 1024, kp)["smem"] <= lim
    # the reduce's static shared memory (red, szh, last): any k, any N
    red = 4 * cuda_dgcnn_bwd.REDUCE_THREADS * (2 * cuda_dgcnn_bwd.REDUCE_CHANNELS + 1)
    assert red + 8 * 256 + 4 <= 48 * 1024


def test_bwd_stage_f32_flush_mirrors_the_kernel():
    # the float32 weight gradient's chains: DW_FLUSH tiles a block, which
    # the k = 20 step (at most 94 tiles a block at N <= 1024, B = 24) never
    # reaches, and which cut k = 32, N = 1024's 186 into two
    assert cuda_dgcnn_bwd.DW_FLUSH_TILES == _cu_define("dgcnn_bwd.cu", "DW_FLUSH")
    for N in (717, 1024):
        plan = cuda_dgcnn_bwd.bwd_stage_plan(24, N, 20, 256, 128, 0, torch.float32)
        assert -(-plan["tiles"] // plan["blocks"]) < plan["dw_flush"]
    plan = cuda_dgcnn_bwd.bwd_stage_plan(24, 1024, 32, 256, 128, 0, torch.float32)
    assert -(-plan["tiles"] // plan["blocks"]) == 187 and plan["dw_flush"] == 96


# ------------------------------- the dense kernels above k = 32 (A.11.2)

@pytest.mark.parametrize("k", [1, 8, 20, 32, 33, 40, 64, 65, 100, 717, 1024])
def test_stage_chunks_cover_every_neighbour_once(k):
    # csrc/dgcnn_eval.cu:launch_stages: chunks of DGCNN_MAX_K neighbours in
    # order, the last the rest, each at a compiled row count, the chunks
    # after the first merged into the concat by a max
    text = open(os.path.join(CSRC, "dgcnn_eval.cu")).read()
    assert "for (int j0 = 0; j0 < k; j0 += DGCNN_MAX_K)" in text
    chunks = cuda_dgcnn.stage_chunks(k)
    assert len(chunks) == -(-k // cuda_dgcnn.CHUNK_K)
    assert [j for j0, kc in chunks for j in range(j0, j0 + kc)] == list(range(k))
    assert all(kc == cuda_dgcnn.CHUNK_K for _, kc in chunks[:-1])
    for _, kc in chunks:
        assert cuda_dgcnn.stage_rows(kc) in cuda_dgcnn.STAGE_KS
        # each chunk's float32 block fits, at one block an SM
        plan = cuda_dgcnn.f32_stage_plan(48, 717, kc)
        assert plan.smem <= cuda_dgcnn.SMEM_PER_BLOCK and plan.blocks_sm == 1
    # the stage chains stay the seven compiled row counts at every k
    assert {cuda_dgcnn.stage_rows(kc) for _, kc in chunks} <= set(cuda_dgcnn.STAGE_KS)


def test_f32_stage_plan_is_one_chunk():
    # a launch takes at most CHUNK_K neighbours a point; a larger k is chunks
    with pytest.raises(ValueError, match="one stage launch"):
        cuda_dgcnn.f32_stage_plan(48, 717, cuda_dgcnn.CHUNK_K + 1)


def test_wide_selection_mirrors_the_kernel():
    # csrc/knn_wide.cuh: queries a block, warps, the list's least length,
    # the cloud's envelope, the dynamic shared memory beside the centroid's
    # static 3 x 8 floats
    assert (cuda_knn.WIDE_QUERIES, cuda_knn.WIDE_WARPS, cuda_knn.WIDE_MIN_LIST) == (
        _cu_define("knn_wide.cuh", "WIDE_QUERIES"), _cu_define("knn_wide.cuh", "WIDE_WARPS"),
        _cu_define("knn_wide.cuh", "WIDE_MIN_LIST"))
    assert _cu_define("knn_wide.cuh", "WIDE_MAX_M") == cuda_knn.KERNEL_MAX_M == 4096
    text = open(os.path.join(CSRC, "knn_wide.cuh")).read()
    assert "#define WIDE_SMEM (232448 - 3 * WIDE_WARPS * 4)" in text
    assert cuda_knn.WIDE_SMEM == cuda_knn.SMEM_LIMIT - 3 * cuda_knn.WIDE_WARPS * 4
    assert _cu_define("knn.cu", "MAXK") == cuda_knn.LIST_MAX_K == 32
    for k, want in ((1, 32), (32, 32), (33, 64), (64, 64), (65, 128), (717, 1024),
                    (1024, 1024), (4096, 4096)):
        assert cuda_knn.wide_list(k) == want


@pytest.mark.parametrize("M", [33, 96, 717, 1024, 1433, 2048, 3000, 4096])
def test_wide_selection_fits_every_k_of_the_envelope(M):
    # every 32 < k <= M <= 4096 (row 8) fits a block: the cloud and at least
    # one warp's keys and list; the graphs' clouds (M <= 1024, rows 1 and 3)
    # take all WIDE_WARPS warps, whose sums make the angles' centroid
    for k in sorted({*range(33, M + 1, 97), M}):
        warps = cuda_knn.wide_warps(M, k)
        assert warps in (1, 2, 4, 8)
        smem = cuda_knn.wide_smem(M, k, warps)
        assert smem <= cuda_knn.WIDE_SMEM
        assert warps == cuda_knn.WIDE_WARPS or cuda_knn.wide_smem(M, k, 2 * warps) > cuda_knn.WIDE_SMEM
        # keys, then the list of each warp: the padded list sorts in the keys'
        # buffer, so that buffer holds max(M, list) words
        assert smem == 16 * M + 4 * warps * (max(M, cuda_knn.wide_list(k))
                                             + cuda_knn.wide_list(k))
        if M <= 1024:
            assert warps == cuda_knn.WIDE_WARPS
        plan = cuda_knn.knn_plan(2, 100, M, k)
        assert plan["K"] == cuda_knn.wide_list(k) and plan["threads"] == 32 * warps
        assert plan["smem"] == smem


@pytest.mark.parametrize("B,N", [(48, 1433), (24, 717), (1, 1), (3, 32), (3, 33)])
def test_wide_selection_grid_covers_every_query_once(B, N):
    plan = cuda_knn.knn_plan(B, N, 1433, 40)
    gx, gy = plan["grid"]
    assert gy == B
    # block x: queries [32 x, 32 x + 32), warp w of W takes w, w + W, ...
    warps = plan["threads"] // 32
    owned = sorted(x * cuda_knn.WIDE_QUERIES + q for x in range(gx)
                   for w in range(warps) for q in range(w, cuda_knn.WIDE_QUERIES, warps))
    assert [q for q in owned if q < N] == list(range(N))
    assert (gx - 1) * cuda_knn.WIDE_QUERIES < N
