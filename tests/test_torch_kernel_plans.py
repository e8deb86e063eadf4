"""The launch plans of the DGCNN and EM kernels, on the CPU: the shapes the
EM kernel takes (`cuda_em.kernel_takes`, `cuda_em.smem_bytes`) and the
operands the DGCNN wrappers hand their kernels (`cuda_dgcnn._kernel_operands`,
`cuda_dgcnn._concat_scratch`). The kernels themselves run only on the card
(`tests/test_torch_kernels_gpu.py`)."""
import numpy as np
import pytest
import torch

from ogmm_tpu_torch.ops import cuda_dgcnn, cuda_em

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
