"""The launch plans of the DGCNN, EM and streamed kernels, on the CPU: the
shapes the EM kernel takes (`cuda_em.kernel_takes`, `cuda_em.smem_bytes`),
the operands the DGCNN wrappers hand their kernels
(`cuda_dgcnn._kernel_operands`, `cuda_dgcnn._concat_scratch`), the bf16
projection's shared memory and persistent grid (`cuda_stream.wproject_plan`,
`wproject_units`, `wproject_smem_bytes`) and the 1-NN kernel's split of the
target (`cuda_stream.nn1_stream_plan`). The kernels themselves run only on
the card (`tests/test_torch_kernels_gpu.py`)."""
import numpy as np
import pytest
import torch

from ogmm_tpu_torch.ops import cuda_dgcnn, cuda_em, cuda_stream, stream

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


@pytest.mark.parametrize("N,K", [(3353, 128), (3353, 97), (6529, 64),
                                 (12129, 32), (100, 129), (100, 0), (0, 16)])
def test_em_kernel_refuses_past_shared_memory_and_k(N, K):
    assert not cuda_em.kernel_takes(N, K)


@pytest.mark.parametrize("K", [1, 32, 33, 64, 100, 128])
def test_em_kernel_takes_exactly_what_fits(K):
    # the first N refused is the first whose block needs more than 227 KB
    takes = [N for N in range(1, 13000, 7) if cuda_em.kernel_takes(N, K)]
    last = max(takes)
    assert takes == list(range(1, last + 1, 7))
    assert cuda_em.smem_bytes(last, K) <= cuda_em.SMEM_BYTES
    assert cuda_em.smem_bytes(last + 7 * 8, K) > cuda_em.SMEM_BYTES


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
                                        (torch.float32, 0)])
def test_dgcnn_concat_scratch_only_for_bf16(dtype, rows):
    cat = cuda_dgcnn._concat_scratch(torch.zeros(2, 37, 3), dtype)
    assert tuple(cat.shape) == (rows, 512) and cat.dtype == dtype


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
