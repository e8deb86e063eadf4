"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and `nvcc` and is skipped without one.
Run them on a machine with the card (no JAX needed there):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from ogmm_tpu_torch import configs
from ogmm_tpu_torch.api import Registrar
from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops import dgcnn_train as ops_dgcnn_train
from ogmm_tpu_torch.ops.cuda_dgcnn import (CHUNK_KS, dgcnn_eval,
                                           dgcnn_eval_reference)
from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import (KERNEL_STAGES, bwd_edge,
                                              bwd_edge_reference, bwd_reduce,
                                              bwd_reduce_reference, bwd_stage,
                                              bwd_stage_reference)
from ogmm_tpu_torch.ops.cuda_dgcnn_train import (graph_stage1,
                                                 graph_stage1_reference)
from ogmm_tpu_torch.ops.cuda_em import sinkhorn_em, sinkhorn_em_reference
from ogmm_tpu_torch.ops.cuda_knn import knn, knn_reference, nn1, nn1_reference
from ogmm_tpu_torch.ops.cuda_posenc import (posenc_angles,
                                            posenc_angles_reference)
from ogmm_tpu_torch.ops import cuda_fps, cuda_icp, cuda_mlp, cuda_stream, stream
from ogmm_tpu_torch.ops import cuda_dgcnn, cuda_knn, cuda_posenc
from ogmm_tpu_torch.ops.common import index_points
from ogmm_tpu_torch.ops.cuda_dgcnn import dgcnn_edges, dgcnn_edges_reference
from ogmm_tpu_torch.train import (create_train_state, make_train_step,
                                  train_loss)

pytestmark = pytest.mark.gpu

NONE = {name: 0 for name in dispatch.KERNELS}
# neighbour counts the DGCNN kernels are checked at: every row count their
# stage chains are compiled for (8, 12, ..., 32), k below 8 and k padded
# up to the next multiple of 4 (the rows past k repeat the nearest)
GPU_KS = (1, 4, 5, 8, 10, 12, 16, 20, 23, 25, 28, 32)
assert set(GPU_KS) <= set(CHUNK_KS)
# above 32: the wide selection, the stage chain in chunks of 32
WIDE_KS = (33, 40, 64, 300)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _dgcnn_inputs(rs, dev, B, N, emb):
    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=dev)
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]
    ws = [torch.tensor(rs.randn(*d).astype(np.float32) / np.sqrt(d[0]),
                       device=dev) for d in dims]
    aff = [(torch.tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32), device=dev),
            torch.tensor(rs.randn(d[1]).astype(np.float32) * 0.1, device=dev))
           for d in dims]
    return x, ws, aff


@pytest.mark.parametrize("B,N,emb", [(3, 128, 64), (2, 717, 512), (1, 20, 64),
                                     (1, 1024, 128)])
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0625)])
def test_dgcnn_kernel_matches_plain(card, B, N, emb, dtype, lim):
    x, ws, aff = _dgcnn_inputs(np.random.RandomState(N), card, B, N, emb)
    out, alpha = dgcnn_eval(x, ws, aff, 20, dtype, 5)
    ref, ralpha = dgcnn_eval_reference(x, ws, aff, 20, dtype, 5)
    torch.cuda.synchronize()
    assert out.dtype == dtype
    assert (out.float() - ref.float()).abs().max().item() <= lim
    assert (alpha - ralpha).abs().max().item() <= 1e-5


def test_dgcnn_kernel_ties_and_no_angles(card):
    x, ws, aff = _dgcnn_inputs(np.random.RandomState(1), card, 2, 96, 64)
    x[:, 40] = x[:, 7]                       # coincident points: exact ties
    out = dgcnn_eval(x, ws, aff, 20, torch.float32, 0)
    ref = dgcnn_eval_reference(x, ws, aff, 20, torch.float32, 0)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("kwargs,match", [(dict(k=65), "k <= N"),
                                          (dict(dtype=torch.float16), "dtype")])
def test_dgcnn_kernel_refuses_what_it_does_not_take(card, kwargs, match):
    x, ws, aff = _dgcnn_inputs(np.random.RandomState(2), card, 1, 64, 64)
    with pytest.raises(ValueError, match=match):
        dgcnn_eval(x, ws, aff, **kwargs)
    big, _, _ = _dgcnn_inputs(np.random.RandomState(2), card, 1, 1100, 64)
    with pytest.raises(ValueError, match="N="):
        dgcnn_eval(big, ws, aff)


@pytest.mark.parametrize("B,N,K", [(3, 96, 32), (2, 200, 64), (2, 717, 128),
                                   (1, 5, 32), (1, 1500, 128),
                                   # above K = 256: 16 lanes a row to 512,
                                   # 32 to 1024, clusters of 8 and 16, K > N
                                   (2, 717, 512), (1, 300, 257), (2, 1433, 512),
                                   (1, 717, 1023), (1, 857, 856), (1, 100, 700),
                                   (2, 640, 640), (1, 716, 1024)])
def test_em_kernel_one_trip_matches_plain(card, B, N, K):
    rs = np.random.RandomState(N)
    xyz = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    o = torch.tensor(rs.rand(B, N).astype(np.float32), device=card)
    o = o / o.sum(-1, keepdim=True)
    n0 = torch.tensor(rs.randn(B, K, 3).astype(np.float32) * 0.3, device=card)
    got = sinkhorn_em(xyz, o, n0, iters=1)
    want = sinkhorn_em_reference(xyz, o, n0, iters=1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4


@pytest.mark.parametrize("sk_iters", [1, 2, 10])
def test_em_kernel_sinkhorn_trip_counts(card, sk_iters):
    rs = np.random.RandomState(3)
    xyz = torch.tensor(rs.randn(2, 128, 3).astype(np.float32) * 0.3, device=card)
    o = torch.full((2, 128), 1 / 128, device=card)
    n0 = xyz[:, :32].contiguous()
    got = sinkhorn_em(xyz, o, n0, iters=2, sk_iters=sk_iters, tau=0.5)
    want = sinkhorn_em_reference(xyz, o, n0, iters=2, sk_iters=sk_iters, tau=0.5)
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-3


def test_em_kernel_zero_overlap_rows_stay_finite(card):
    rs = np.random.RandomState(4)
    xyz = torch.tensor(rs.randn(1, 64, 3).astype(np.float32), device=card)
    o = torch.zeros(1, 64, device=card)
    o[:, :8] = 1 / 8
    got = sinkhorn_em(xyz, o, xyz[:, :32].contiguous(), iters=3)
    want = sinkhorn_em_reference(xyz, o, xyz[:, :32].contiguous(), iters=3)
    assert all(torch.isfinite(g).all() for g in got)
    assert (got[1] - want[1]).abs().max().item() <= 1e-3


def test_em_kernel_refuses_what_it_does_not_take(card):
    xyz = torch.zeros(1, 64, 3, device=card)
    o = torch.full((1, 64), 1 / 64, device=card)
    with pytest.raises(ValueError, match="K <= 1024"):
        sinkhorn_em(torch.zeros(1, 300, 3, device=card),
                    torch.full((1, 300), 1 / 300, device=card),
                    torch.zeros(1, 1025, 3, device=card))
    big = torch.zeros(1, 6705, 3, device=card)   # past a cluster of 16 blocks
    with pytest.raises(ValueError, match="N=6705"):
        sinkhorn_em(big, torch.full((1, 6705), 1 / 6705, device=card),
                    torch.zeros(1, 128, 3, device=card))
    with pytest.raises(ValueError, match="o_norm"):
        sinkhorn_em(xyz, o[:, :10], torch.zeros(1, 32, 3, device=card))


@pytest.mark.parametrize("B,N", [(2, 717), (3, 128), (1, 20), (1, 1024)])
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.0313)])
def test_graph_stage1_kernel_matches_plain(card, B, N, dtype, lim):
    rs = np.random.RandomState(N)
    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    w1 = torch.tensor(rs.randn(6, 64).astype(np.float32) / 2.5, device=card)
    z1, e, idx, alpha = graph_stage1(x, w1, 20, dtype, 5)
    rz1, re, ridx, ralpha = graph_stage1_reference(x, w1, 20, dtype, 5)
    torch.cuda.synchronize()
    assert z1.shape == (B, 20, N, 64) and z1.dtype == e.dtype == dtype
    assert torch.equal(idx, ridx) and torch.equal(e, re)
    assert (z1.float() - rz1.float()).abs().max().item() <= lim
    assert (alpha - ralpha).abs().max().item() <= 1e-5


def test_graph_stage1_kernel_ties_and_no_angles(card):
    rs = np.random.RandomState(7)
    x = torch.tensor(rs.randn(2, 96, 3).astype(np.float32) * 0.3, device=card)
    x[:, 40] = x[:, 7]                       # coincident points: exact ties
    w1 = torch.tensor(rs.randn(6, 64).astype(np.float32), device=card)
    got = graph_stage1(x, w1, 20, torch.float32, 0)
    want = graph_stage1_reference(x, w1, 20, torch.float32, 0)
    assert got[3] is None and torch.equal(got[2], want[2])
    assert (got[0] - want[0]).abs().max().item() <= 1e-5


def test_graph_stage1_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros(1, 64, 3, device=card)
    w1 = torch.zeros(6, 64, device=card)
    with pytest.raises(ValueError, match="k <= N"):
        graph_stage1(x, w1, k=65)
    with pytest.raises(ValueError, match="N="):
        graph_stage1(torch.zeros(1, 1100, 3, device=card), w1)
    with pytest.raises(ValueError, match="w1"):
        graph_stage1(x, torch.zeros(6, 32, device=card))
    with pytest.raises(ValueError, match="dtype"):
        graph_stage1(x, w1, dtype=torch.float16)


@pytest.mark.parametrize("B,Nq,M", [(2, 512, 717), (2, 128, 717),
                                    (2, 717, 717), (1, 5, 4096), (3, 1, 1),
                                    (1, 300, 1500)])
def test_nn1_kernel_matches_plain(card, B, Nq, M):
    rs = np.random.RandomState(Nq + M)
    src = torch.tensor(rs.randn(B, Nq, 3).astype(np.float32) * 0.3, device=card)
    tgt = torch.tensor(rs.randn(B, M, 3).astype(np.float32) * 0.3, device=card)
    d, i = nn1(src, tgt)
    rd, ri = nn1_reference(src, tgt)
    torch.cuda.synchronize()
    assert i.dtype == torch.int64 and torch.equal(i, ri)
    assert torch.equal(d, rd)


def test_nn1_kernel_takes_the_first_of_equal_minima(card):
    rs = np.random.RandomState(8)
    tgt = torch.tensor(rs.randn(1, 2000, 3).astype(np.float32), device=card)
    tgt[0, 1500] = tgt[0, 3]                 # the same point, other tile
    tgt[0, 1600] = tgt[0, 1100]
    d, i = nn1(tgt[:, [3, 1100, 1500]].contiguous(), tgt)
    assert i[0].tolist() == [3, 1100, 3]
    assert d.max().item() <= 1e-6


def test_nn1_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(ValueError, match="M <= 4096"):
        nn1(torch.zeros(1, 8, 3, device=card), torch.zeros(1, 4097, 3, device=card))
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        nn1(torch.zeros(1, 8, 2, device=card), torch.zeros(1, 9, 2, device=card))


NN1_PATH_SHAPES = [(24, 512, 717), (24, 128, 717), (24, 717, 717),
                   (24, 1433, 1433), (4, 16, 2048), (1, 128, 717), (1, 717, 717)]


@pytest.mark.parametrize("B,Nq,M", NN1_PATH_SHAPES)
def test_nn1_kernel_at_the_path_shapes_is_bit_equal_and_fixed(card, B, Nq, M):
    # the Welsch loss, the clustering, the metrics, the N = 1433 ICP trips,
    # the C.1 check's clustering (4 blocks) and requests of one cloud: the
    # plain version's distances and indices, and a relaunch gives the same
    # bits
    rs = np.random.RandomState(Nq)
    tgt = torch.tensor(rs.randn(B, M, 3).astype(np.float32) * 0.3, device=card)
    src = torch.tensor(rs.randn(B, Nq, 3).astype(np.float32) * 0.3, device=card)
    src[:, 0] = tgt[:, 3]                    # an exact hit: the clamp
    d, i = nn1(src, tgt)
    rd, ri = nn1_reference(src, tgt)
    torch.cuda.synchronize()
    assert torch.equal(i, ri) and torch.equal(d, rd)
    again = nn1(src, tgt)
    assert torch.equal(again[0], d) and torch.equal(again[1], i)


@pytest.mark.parametrize("lanes,rows", [(4, 2), (8, 2), (16, 2), (16, 1)])
@pytest.mark.parametrize("M", [717, 9])
def test_nn1_takes_the_first_of_equal_minima_across_lanes(card, lanes, rows, M):
    # every compiled plan: a point duplicated at a low and a high index (in
    # two lanes' runs), a cluster of targets within the 1e-12 clamp of a
    # query spread over lanes; 9 points leave lanes without a point
    rs = np.random.RandomState(lanes + rows + M)
    tgt = rs.randn(3, M, 3).astype(np.float32) * 0.3
    lo, hi, near = 5 % M, M - 1, [j % M for j in (200, 300, 400, 450)]
    tgt[:, hi] = tgt[:, lo]
    tgt[:, near] = tgt[:, [near[0]]] + rs.randn(3, 4, 3) * 1e-8
    src = rs.randn(3, 40, 3).astype(np.float32) * 0.3
    src[:, 0], src[:, 1], src[:, 2] = tgt[:, lo], tgt[:, hi], tgt[:, near[0]]
    src, tgt = (torch.tensor(a, device=card) for a in (src, tgt))
    plan = cuda_knn.nn1_plan_with(3, 40, lanes, rows)
    d, i = cuda_knn._nn1_cuda(src, tgt, plan)
    rd, ri = nn1_reference(src, tgt)
    torch.cuda.synchronize()
    assert torch.equal(i, ri) and torch.equal(d, rd)
    assert (i[:, :2] == lo).all() and (d[:, 2] == 1e-12).all()
    again = cuda_knn._nn1_cuda(src, tgt, plan)
    assert torch.equal(again[0], d) and torch.equal(again[1], i)


@pytest.mark.parametrize("B,N", [(24, 717), (1, 1024), (2, 20)])
@pytest.mark.parametrize("k", GPU_KS + WIDE_KS[:3])
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.0313)])
def test_graph_stage1_kernel_every_k_matches_plain_and_is_fixed(card, B, N, k,
                                                                dtype, lim):
    N = max(N, k)                            # k <= N: a point's k neighbours
    rs = np.random.RandomState(N + k)
    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    x[:, N // 2] = x[:, 1]                   # a duplicated point: exact ties
    w1 = torch.tensor(rs.randn(6, 64).astype(np.float32) / 2.5, device=card)
    pk = min(5, k)
    got = graph_stage1(x, w1, k, dtype, pk)
    z1, e, idx, alpha = got
    rz1, re, ridx, ralpha = graph_stage1_reference(x, w1, k, dtype, pk)
    torch.cuda.synchronize()
    assert z1.shape == (B, k, N, 64) and e.shape == (B, k, N, 6)
    assert torch.equal(idx, ridx) and torch.equal(e, re)
    assert (z1.float() - rz1.float()).abs().max().item() <= lim
    assert (alpha - ralpha).abs().max().item() <= 1e-5
    again = graph_stage1(x, w1, k, dtype, pk)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,N,k", [(48, 717, 20), (2, 1024, 16), (3, 20, 8),
                                   (4, 717, 40), (2, 1024, 1024), (3, 33, 33)])
def test_dgcnn_eval_selection_equals_the_plain_graph(card, B, N, k):
    x, ws, aff = _dgcnn_inputs(np.random.RandomState(N), card, B, N, 64)
    x[:, N // 2] = x[:, 1]
    idx = torch.empty(B, N, k, dtype=torch.int32, device=card)
    cuda_dgcnn._dgcnn_eval_cuda(x, ws, aff, k, torch.bfloat16, min(5, k), idx=idx)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), knn_reference(x, x, k))


@pytest.mark.parametrize("B,N,k", [(24, 717, 5), (4, 1024, 5), (2, 50, 32),
                                   (1, 20, 20), (2, 300, 7)])
def test_posenc_angles_selection_equals_the_plain_one(card, B, N, k):
    rs = np.random.RandomState(N + k)
    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    x[:, 10] = x[:, 3]
    idx = torch.empty(B, N, k, dtype=torch.int32, device=card)
    alpha = cuda_posenc._posenc_angles_cuda(x, k, idx=idx)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), knn_reference(x, x, k))
    assert (alpha - posenc_angles_reference(x, k)).abs().max().item() <= 1e-5


def test_wrappers_count_their_launches(card):
    x, ws, aff = _dgcnn_inputs(np.random.RandomState(5), card, 1, 64, 64)
    dispatch.reset_launch_counts()
    dgcnn_eval(x, ws, aff)
    dgcnn_eval_reference(x, ws, aff)
    graph_stage1(x, ws[0], 20, torch.float32, 5)
    graph_stage1_reference(x, ws[0], 20, torch.float32, 5)
    nn1(x, x)
    nn1_reference(x, x)
    knn(x, x, 5)
    knn_reference(x, x, 5)
    posenc_angles(x, 5)
    posenc_angles_reference(x, 5)
    assert dispatch.launch_counts == {**NONE, "dgcnn_eval": 1,
                                      "graph_stage1": 1, "nn1": 1, "knn": 1,
                                      "posenc_angles": 1}


@pytest.mark.parametrize("dtype,lim", [("float32", 1e-3), ("bfloat16", 0.15)])
def test_registrar_runs_on_the_card_by_default(card, dtype, lim):
    cfg = configs.mnet(model=configs.ModelConfig(
        emb_dims=64, n_clusters=32, km_clusters=32, dtype=dtype))
    reg = Registrar(cfg, seed=1)
    assert reg.device.type == "cuda"
    src = np.random.RandomState(6).randn(2, 128, 3).astype(np.float32) * 0.3
    dispatch.reset_launch_counts()
    rot, trans, so, to = reg(src, src[:, ::-1].copy(), refine=True)
    assert rot.is_cuda and torch.isfinite(rot).all() and so.shape == (2, 128)
    # the clustering loss of the forward takes one 1-NN of the 2B clouds
    assert dispatch.launch_counts == {**NONE, "dgcnn_eval": 1,
                                      "sinkhorn_em": 1, "nn1": 1}
    # the same weights through the plain versions on the CPU: float32 agrees
    # to round-off; bf16 rounds at other places in the two matmul libraries
    cpu = Registrar(cfg, seed=1, device="cpu")
    _, _, cso, _ = cpu(src, src[:, ::-1].copy(), refine=False)
    assert (so.cpu() - cso).abs().max().item() <= lim



# ------------------------------------------- routing by shape (fault C.1)

@pytest.mark.parametrize("k", GPU_KS + WIDE_KS)
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0625)])
def test_dgcnn_kernels_take_every_compiled_k(card, k, dtype, lim):
    x, ws, aff = _dgcnn_inputs(np.random.RandomState(k), card, 2, 300, 64)
    x[:, 50] = x[:, 9]                       # ties
    pk = min(5, k)
    out, alpha = dgcnn_eval(x, ws, aff, k, dtype, pk)
    ref, ralpha = dgcnn_eval_reference(x, ws, aff, k, dtype, pk)
    assert (out.float() - ref.float()).abs().max().item() <= lim
    assert (alpha - ralpha).abs().max().item() <= 1e-5
    got = graph_stage1(x, ws[0], k, dtype, pk)
    want = graph_stage1_reference(x, ws[0], k, dtype, pk)
    assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B,N,M,k", [(48, 1433, 1433, 20), (2, 4096, 4096, 20),
                                     (24, 717, 717, 5), (3, 1000, 257, 32),
                                     (2, 90, 2000, 1), (1, 40, 40, 32),
                                     (24, 1433, 1433, 20), (24, 717, 717, 20),
                                     (24, 4096, 4096, 20), (4, 1000, 257, 32),
                                     (3, 70, 40, 7), (2, 50, 3, 2),
                                     (24, 717, 717, 16), (24, 717, 717, 40),
                                     (4, 1433, 1433, 64), (2, 300, 257, 257),
                                     (2, 1024, 4096, 1024), (1, 40, 4096, 4096)])
def test_knn_kernel_matches_plain(card, B, N, M, k):
    rs = np.random.RandomState(N + M + k)
    tgt = torch.tensor(rs.randn(B, M, 3).astype(np.float32) * 0.3, device=card)
    tgt[:, M // 2] = tgt[:, 1]               # a duplicated point: ties
    src = tgt.clone() if N == M else torch.tensor(
        rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    got = knn(src, tgt, k)
    want = knn_reference(src, tgt, k)
    torch.cuda.synchronize()
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert torch.equal(knn(src, tgt, k), got)      # a relaunch: the same bits


def test_knn_kernel_many_coincident_points(card):
    # 301 coincident points: many candidates tie at every lane's threshold
    rs = np.random.RandomState(11)
    x = torch.tensor(rs.randn(2, 600, 3).astype(np.float32), device=card)
    x[:, 100:400] = x[:, :1]
    for k in (1, 20, 32, 40, 350):
        assert torch.equal(knn(x, x, k), knn_reference(x, x, k))


def test_knn_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros(1, 8, 3, device=card)
    with pytest.raises(ValueError, match="M <= 4096"):
        knn(x, torch.zeros(1, 4097, 3, device=card), 5)
    with pytest.raises(ValueError, match="k <= M"):
        knn(x, x, 9)
    with pytest.raises(ValueError, match="k <= M"):
        knn(torch.zeros(1, 64, 3, device=card), torch.zeros(1, 64, 3, device=card), 65)
    with pytest.raises(ValueError, match=r"\(B, N, 3\)"):
        knn(torch.zeros(1, 8, 2, device=card), torch.zeros(1, 9, 2, device=card), 2)


@pytest.mark.parametrize("B,N,k", [(24, 717, 5), (4, 1024, 5), (2, 50, 32),
                                   (1, 20, 20)])
def test_posenc_angles_kernel_matches_plain(card, B, N, k):
    rs = np.random.RandomState(N + k)
    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    x[:, 10] = x[:, 3]                       # a duplicated point
    got = posenc_angles(x, k)
    want = posenc_angles_reference(x, k)
    torch.cuda.synchronize()
    assert got.shape == (B, N, k)
    assert (got - want).abs().max().item() <= 1e-5


def test_posenc_angles_kernel_refuses_what_it_does_not_take(card):
    with pytest.raises(ValueError, match="N <= 1024"):
        posenc_angles(torch.zeros(1, 1025, 3, device=card), 5)
    with pytest.raises(ValueError, match="k <= min"):
        posenc_angles(torch.zeros(1, 64, 3, device=card), 33)


@pytest.mark.parametrize("B,N,K", [(4, 2048, 16), (2, 500, 100), (2, 300, 1),
                                   (3, 3072, 128)])
def test_em_kernel_takes_any_k_up_to_128(card, B, N, K):
    rs = np.random.RandomState(N + K)
    xyz = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    o = torch.tensor(rs.rand(B, N).astype(np.float32), device=card)
    o = o / o.sum(-1, keepdim=True)
    n0 = torch.tensor(rs.randn(B, K, 3).astype(np.float32) * 0.3, device=card)
    got = sinkhorn_em(xyz, o, n0, iters=1)
    want = sinkhorn_em_reference(xyz, o, n0, iters=1)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4


@pytest.mark.parametrize("over,N,launched", [
    (dict(), 1100, {"knn": 1, "sinkhorn_em": 1, "nn1": 1}),
    (dict(gnn_k=12), 300, {"dgcnn_eval": 1, "sinkhorn_em": 1, "nn1": 1}),
    (dict(gnn_k=33), 300, {"dgcnn_eval": 1, "sinkhorn_em": 1, "nn1": 1}),
    (dict(gnn_k=16), 300, {"dgcnn_eval": 1, "sinkhorn_em": 1, "nn1": 1}),
    (dict(n_clusters=16), 2048, {"knn": 1, "sinkhorn_em": 1, "nn1": 1}),
    # C.2: an emb the eval kernel does not take runs the unfused chain
    (dict(emb_dims=96), 300, {"knn": 1, "posenc_angles": 1, "sinkhorn_em": 1,
                              "nn1": 1}),
    # C.3: dgcnn_fused_edges; the edges kernel takes k = 33 (in chunks), the
    # kNN kernel its graph
    (dict(gnn_k=33, dgcnn_fused_edges=True), 1100,
     {"knn": 1, "dgcnn_edges": 1, "sinkhorn_em": 1, "nn1": 1}),
    (dict(gnn_k=12, dgcnn_fused_edges=True), 1100,
     {"knn": 1, "dgcnn_edges": 1, "sinkhorn_em": 1, "nn1": 1}),
    (dict(emb_dims=96, dgcnn_fused_edges=True), 1100,
     {"knn": 1, "sinkhorn_em": 1, "nn1": 1}),
    (dict(dgcnn_fused_edges=True), 1100,
     {"knn": 1, "dgcnn_edges": 1, "sinkhorn_em": 1, "nn1": 1})])
def test_registrar_routes_by_shape_on_the_card(card, over, N, launched):
    cfg = configs.mnet(model=configs.ModelConfig(
        **{**dict(emb_dims=64, n_clusters=32, km_clusters=32), **over}))
    reg = Registrar(cfg, seed=1)
    src = np.random.RandomState(6).randn(2, N, 3).astype(np.float32) * 0.3
    dispatch.reset_launch_counts()
    rot, _, so, _ = reg(src, src[:, ::-1].copy(), refine=False)
    torch.cuda.synchronize()
    assert torch.isfinite(rot).all() and so.shape == (2, N)
    assert dispatch.launch_counts == {**NONE, **launched}
    cpu = Registrar(cfg, seed=1, device="cpu")
    _, _, cso, _ = cpu(src, src[:, ::-1].copy(), refine=False)
    assert (so.cpu() - cso).abs().max().item() <= 1e-3

def _train_batch(rs, B, N):
    src = rs.randn(B, N, 3).astype(np.float32) * 0.3
    gt = np.tile(np.eye(3, 4, dtype=np.float32), (B, 1, 1))
    gt[:, :, 3] = rs.uniform(-0.2, 0.2, (B, 3))
    tgt = src + gt[:, None, :, 3]
    ones = np.ones((B, N), np.float32)
    return {"src_xyz": src, "tgt_xyz": tgt, "src_overlap": ones,
            "tgt_overlap": ones, "transform_gt": gt}


def test_train_step_runs_on_the_card_by_default(card):
    cfg = configs.mnet(model=configs.ModelConfig(
        emb_dims=64, n_clusters=32, km_clusters=32, em_iters=2))
    state = create_train_state(cfg, steps_per_epoch=10, seed=2)
    assert state.device.type == "cuda"
    batch = _train_batch(np.random.RandomState(9), 2, 128)
    cpu = create_train_state(cfg, steps_per_epoch=10, seed=2, device="cpu")
    cpu.generator = state.generator = None
    ref, _ = train_loss(cpu, cfg, batch)
    dispatch.reset_launch_counts()
    got, _ = train_loss(state, cfg, batch)
    got.backward()
    torch.cuda.synchronize()
    # src and tgt each through the graph kernel; Welsch 2, clustering 1,
    # no labels or metrics in the loss
    assert dispatch.launch_counts == {**NONE, "sinkhorn_em": 1,
                                      "graph_stage1": 2, "nn1": 3}
    # float32 on the card against the CPU: round-off through two EM trips
    assert abs(got.item() - ref.item()) <= 1e-3 * abs(ref.item())
    for n_, p in state.model.named_parameters():
        assert torch.isfinite(p.grad).all(), n_
    metrics = make_train_step(cfg)(state, batch)
    assert all(torch.isfinite(v).all() for v in metrics.values())


# ------------------------------------------------ the DGCNN backward kernels

BWD = {"bwd_reduce": (bwd_reduce, bwd_reduce_reference),
       "bwd_stage": (bwd_stage, bwd_stage_reference),
       "bwd_edge": (bwd_edge, bwd_edge_reference)}


def _bwd_calls(dev, B, N, dtype, seed, k=20):
    """The arguments of the five backward calls of one DGCNN training
    forward and backward at (B, N) over a graph of k neighbours, recorded
    through the plain versions."""
    calls = []

    def record(name):
        def fn(*a, **kw):
            calls.append((name, a, kw))
            return BWD[name][1](*a, **kw)
        return fn

    x, ws, aff = _dgcnn_inputs(np.random.RandomState(seed), dev, B, N, 512)
    ws = [w.requires_grad_(True) for w in ws]
    saved = {name: getattr(ops_dgcnn_train, name) for name in BWD}
    saved_switch = ops_dgcnn_train.BWD_KERNELS
    try:
        for name in BWD:
            setattr(ops_dgcnn_train, name, record(name))
        ops_dgcnn_train.BWD_KERNELS = True
        out, _, _ = ops_dgcnn_train.dgcnn_train(
            x, ws, [a[0] for a in aff], [a[1] for a in aff], k, dtype)
        wvec = torch.tensor(np.random.RandomState(seed + 1).randn(
            B, N, 512).astype(np.float32), device=dev)
        (out.float() * wvec).sum().backward()
    finally:
        for name, fn in saved.items():
            setattr(ops_dgcnn_train, name, fn)
        ops_dgcnn_train.BWD_KERNELS = saved_switch
    assert [c[0] for c in calls] == ["bwd_reduce"] + ["bwd_stage"] * 3 + ["bwd_edge"]
    return calls


def _bwd_limit(name, i, dtype, ref):
    """float32: the same arithmetic in another order; bf16: dz two ulps at
    its largest value (one rounding of a cotangent moves it by one ulp),
    the float32 sums over B k N rows in another order 2e-2 of their scale."""
    scale = ref.float().abs().max().item()
    if dtype == torch.float32:
        return 1e-4 * scale
    is_dz = name == "bwd_stage" and i == 0
    return (2.0 ** -6 if is_dz else 2e-2) * scale


@pytest.mark.parametrize("B,N", [(24, 717), (1, 1024), (2, 25), (24, 768)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_edge_one_pass_matches_plain(card, B, N, dtype):
    # the edge call of a real backward: the one-pass kernels (bf16 on wgmma,
    # float32 on mma.sync in 3xTF32; a full grid of 132 blocks, a ragged
    # one, DeepGMR's src) against the plain version within
    # LIM_BWD_SUM_BF16 / LIM_BWD_F32, twice bit for bit
    name, a, kw = _bwd_calls(card, B, N, dtype, seed=B + N)[-1]
    assert name == "bwd_edge"
    got, again, ref = bwd_edge(*a, **kw), bwd_edge(*a, **kw), bwd_edge_reference(*a, **kw)
    torch.cuda.synchronize()
    for i, (g, g2, r) in enumerate(zip(got, again, ref)):
        assert torch.equal(g, g2), i
        assert g.shape == r.shape and g.dtype == r.dtype == torch.float32
        err = (g - r).abs().max().item()
        assert err <= _bwd_limit(name, i, dtype, r), (i, err)


@pytest.mark.parametrize("B,N,k", [(3, 90, 20), (4, 717, 20), (1, 20, 20),
                                   (3, 90, 1), (3, 90, 5), (2, 717, 12),
                                   (3, 90, 25), (2, 1024, 32), (1, 32, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_match_plain(card, B, N, k, dtype):
    # the five calls of a real backward at k = 20 and in the other row
    # classes (k = 1, 5, 25 with padded rows), N = k included
    for name, a, kw in _bwd_calls(card, B, N, dtype, seed=N, k=k):
        kern, plain = BWD[name]
        got, ref = kern(*a, **kw), plain(*a, **kw)
        torch.cuda.synchronize()
        for i, (g, r) in enumerate(zip(got, ref) if name != "bwd_reduce"
                                   else [(got, ref)]):
            assert g.shape == r.shape and g.dtype == r.dtype, name
            assert torch.isfinite(g.float()).all(), name
            err = (g.float() - r.float()).abs().max().item()
            assert err <= _bwd_limit(name, i, dtype, r), (name, i, err)


def test_bwd_kernels_are_deterministic(card):
    for name, a, kw in _bwd_calls(card, 4, 717, torch.bfloat16, seed=3):
        first, second = BWD[name][0](*a, **kw), BWD[name][0](*a, **kw)
        if name == "bwd_reduce":
            first, second = [first], [second]
        for u, v in zip(first, second):
            assert torch.equal(u, v), name


def test_bwd_kernels_refuse_what_they_do_not_take(card):
    # outside the graph kernel's envelope (1 <= k <= 32, k <= N <= 1024)
    # each wrapper raises: the plain version never runs on the card
    z = torch.zeros(1, 33, 64, 256, device=card)
    tap = torch.zeros(1, 64, 256, device=card)
    v = torch.ones(256, device=card)
    with pytest.raises(ValueError, match="k <= 32"):
        bwd_reduce(z, tap, v, v, v, v)
    with pytest.raises(ValueError, match="dtype"):
        bwd_reduce(torch.zeros(1, 20, 64, 256, device=card, dtype=torch.float16),
                   tap.half(), v, v, v, v)
    w = torch.zeros(96, 256, device=card)
    zp = torch.zeros(1, 20, 64, 96, device=card)
    tp = torch.zeros(1, 64, 96, device=card)
    u = torch.ones(96, device=card)
    z20 = torch.zeros(1, 20, 64, 256, device=card)
    with pytest.raises(ValueError, match="C_in"):
        bwd_stage(z20, tap, v, v, v, v, torch.zeros(2, 256, device=card), w,
                  zp, u, u, u, u, tp)
    # the stage kernel stops at N = 1024 and at N < k; the reduce takes any N
    with pytest.raises(ValueError, match="N <= 1024"):
        bwd_stage(torch.zeros(1, 20, 1100, 256, device=card),
                  torch.zeros(1, 1100, 256, device=card), v, v, v, v,
                  torch.zeros(2, 256, device=card), w, zp, u, u, u, u, tp)
    with pytest.raises(ValueError, match="k <= N"):
        bwd_stage(torch.zeros(1, 20, 19, 256, device=card),
                  torch.zeros(1, 19, 256, device=card), v, v, v, v,
                  torch.zeros(2, 256, device=card), w, zp, u, u, u, u, tp)


def _reduce_args(dev, B, N, C, dtype, seed):
    """The reduce's inputs at any (B, N): pre-BN z with tied rows, its
    batch moments, a channel whose y are all < 0 and one whose first column
    has y == 0 exactly on every row, the tap cotangent."""
    rs = np.random.RandomState(seed)
    t = lambda *shape: torch.tensor(rs.randn(*shape).astype(np.float32), device=dev)
    z = t(B, 20, N, C).to(dtype)
    z[:, 5] = z[:, 2]                                # tied maxima over k
    zf = z.float()
    mean, var = zf.mean((0, 1, 2)), zf.var((0, 1, 2), unbiased=False)
    gamma = 1 + 0.2 * t(C)
    beta = 0.1 * t(C)
    beta[0] = -100.0                                 # every y < 0
    beta[1] = 0.0
    z[0, :, 0, 1] = mean[1].to(dtype)                # every y == 0
    return z, t(B, N, C).to(dtype), mean, var, gamma, beta


@pytest.mark.parametrize("N", [717, 1433, 5, 1])
@pytest.mark.parametrize("C", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_reduce_one_pass_kernel_matches_plain(card, N, C, dtype):
    # the one-pass reduce at the step's N, at N = 1433 (beyond the stage
    # kernels' 1024), N not a multiple of a warp's points and one point;
    # a relaunch bit for bit. y and each column's argmax are the plain
    # version's bit for bit, so the limit is that of float32 sums taken in
    # another order: 1e-4 of the largest sum
    B = 24 if N > 5 else 2
    args = _reduce_args(card, B, N, C, dtype, seed=N + C)
    got, again = bwd_reduce(*args), bwd_reduce(*args)
    ref = bwd_reduce_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert got.shape == (2, C) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    # dtap as the backward hands it: a slice of the concatenated taps'
    # cotangent, read in place
    wide = torch.zeros(B, N, C + 256, dtype=dtype, device=card)
    wide[..., 256:] = args[1]
    sliced = bwd_reduce(args[0], wide[..., 256:], *args[2:])
    assert torch.equal(sliced, got)


def _stage_args(dev, B, N, stage, seed, dtype=torch.bfloat16, k=20):
    """Arguments of one stage call in `dtype` at any (B, N) over a graph of
    k neighbours: pre-BN z of stages i and i-1 with their batch moments, tap
    cotangents, sums, weights and the cotangent of the stage above."""
    C, cin, cn = stage
    rs = np.random.RandomState(seed)
    bf = dtype

    def z(c):
        v = torch.tensor(rs.randn(B, k, N, c).astype(np.float32), device=dev).to(bf)
        var, mean = torch.var_mean(v.float(), dim=(0, 1, 2), unbiased=False)
        return v, mean, var + 0.1

    def t(*shape, scale=1.0):
        return torch.tensor(rs.randn(*shape).astype(np.float32) * scale, device=dev)

    zi, mean, var = z(C)
    zp, meanp, varp = z(cin)
    kw = {}
    if cn:
        kw = {"dznext": t(B, k, N, cn, scale=0.1).to(bf), "wnext": t(C, cn, scale=0.1)}
    return ((zi, t(B, N, C).to(bf), mean, var, 1 + 0.2 * t(C), 0.1 * t(C),
             t(2, C, scale=float(B * N)), t(cin, C, scale=0.1), zp, meanp, varp,
             1 + 0.2 * t(cin), 0.1 * t(cin), t(B, N, cin).to(bf)), kw)


@pytest.mark.parametrize("B,N", [(1, 1), (1, 3), (2, 717), (1, 1024), (3, 90)])
@pytest.mark.parametrize("stage", KERNEL_STAGES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_bwd_stage_one_pass_kernel_matches_plain(card, B, N, stage, dtype):
    # the persistent one-pass kernels (bf16 on wgmma; float32 on mma.sync
    # in 3xTF32) at one point, N not a multiple of their tiles (4 and 2
    # points), the request's N and the largest; twice bit for bit; k = 20,
    # or N where N < 20 (the graph has at most N neighbours)
    a, kw = _stage_args(card, B, N, stage, seed=N + stage[0], dtype=dtype,
                        k=min(20, N))
    got = bwd_stage(*a, **kw)
    again = bwd_stage(*a, **kw)
    ref = bwd_stage_reference(*a, **kw)
    torch.cuda.synchronize()
    for i, (g, g2, r) in enumerate(zip(got, again, ref)):
        assert torch.equal(g, g2), i
        assert g.shape == r.shape and g.dtype == r.dtype
        assert torch.isfinite(g.float()).all()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= _bwd_limit("bwd_stage", i, dtype, r), (i, err)


def test_bwd_wrappers_count_their_launches(card):
    calls = _bwd_calls(card, 2, 64, torch.float32, seed=4)
    dispatch.reset_launch_counts()
    for name, a, kw in calls:
        BWD[name][0](*a, **kw)
        BWD[name][1](*a, **kw)
    assert dispatch.launch_counts == {**NONE, "bwd_reduce": 1, "bwd_stage": 3,
                                      "bwd_edge": 1}


# ------------------------------------------- the indoor request's kernels

def _surface(rs, dev, B, N):
    u = rs.rand(B, N, 2)
    z = 0.3 * np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    x = np.concatenate([u, z], -1) + 0.01 * rs.randn(B, N, 3)
    return torch.tensor(x.astype(np.float32), device=dev)


def _morton(x):
    return index_points(x, stream.morton_order(x))


@pytest.mark.parametrize("B,N,M,k", [(2, 5000, 5000, 20), (1, 4100, 4097, 1),
                                     (2, 37, 6000, 32), (1, 700, 4500, 16),
                                     (1, 35000, 35000, 16)])
@pytest.mark.parametrize("cull", [False, True])
def test_knn_stream_kernel_matches_plain(card, B, N, M, k, cull):
    rs = np.random.RandomState(N + k)
    tgt = _morton(_surface(rs, card, B, M))
    src = tgt if N == M else _morton(_surface(rs, card, B, N))
    if N == M:
        tgt[:, 100:301] = tgt[:, 50:51]       # 201 coincident points
    kw = dict(diag_order=True, cull_lb=stream.pair_tile_bounds(src, tgt)) \
        if cull else {}
    got = cuda_stream.knn_stream(src, tgt, k, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, stream.knn_stream_plain(src, tgt, k))


@pytest.mark.parametrize("k", [1, 7, 20, 32])
def test_knn_stream_kernel_at_each_k_with_cull(card, k):
    # the self graph of a sorted surface with the cull and the diagonal
    # order, 151 coincident points: the plain version's indices, the same
    # bits on a relaunch, and counters that add up
    rs = np.random.RandomState(40 + k)
    x = _morton(_surface(rs, card, 2, 6000))
    x[:, 1000:1151] = x[:, 300:301]
    lb = stream.tile_pair_bounds(x)
    visits = torch.zeros(3, dtype=torch.int32, device=card)
    got = cuda_stream.knn_stream(x, x, k, diag_order=True, cull_lb=lb,
                                 visits=visits)
    again = cuda_stream.knn_stream(x, x, k, diag_order=True, cull_lb=lb)
    torch.cuda.synchronize()
    assert torch.equal(got, stream.knn_stream_plain(x, x, k))
    assert torch.equal(got, again)
    tiles, most, scans = visits.tolist()
    assert lb.shape[1] * 2 <= tiles <= lb.numel()
    assert 1 <= most <= lb.shape[2]
    assert 0 < scans <= tiles * (stream.TILE_M // 64) * (stream.TILE_N // 8)


def test_nn1_stream_kernel_matches_plain(card):
    rs = np.random.RandomState(3)
    tgt = _morton(_surface(rs, card, 2, 6000))
    src = _morton(_surface(rs, card, 2, 5000)) + 0.002
    gate = 0.075 ** 2
    d, i = cuda_stream.nn1_stream(src, tgt, cull_lb=stream.pair_tile_bounds(
        src, tgt), max_dist_sq=gate, diag_order=True)
    rd, ri = stream.nn1_stream_plain(src, tgt)
    inside = rd < gate
    assert torch.equal(d[inside], rd[inside]) and torch.equal(i[inside], ri[inside])
    assert (d[~inside] >= gate).all()
    d, i = cuda_stream.nn1_stream(src, tgt)
    assert torch.equal(d, rd) and torch.equal(i, ri)


@pytest.mark.parametrize("B,N,M,D,dtype", [(1, 3000, 2500, 512, torch.bfloat16),
                                           (2, 70, 50, 64, torch.bfloat16),
                                           (1, 500, 700, 128, torch.float32)])
def test_wproject_kernel_matches_plain(card, B, N, M, D, dtype):
    rs = np.random.RandomState(D)
    l2 = lambda a: (a / a.norm(dim=-1, keepdim=True)).to(dtype)
    q = l2(torch.tensor(rs.randn(B, N, D).astype(np.float32), device=card))
    k = l2(torch.tensor(rs.randn(B, M, D).astype(np.float32), device=card))
    v = torch.tensor(rs.randn(B, M, 1).astype(np.float32), device=card)
    out, lse = cuda_stream.wproject_stream_lse(q, k, v)
    rout, rlse = stream.wproject_stream_lse_plain(q, k, v)
    assert (out - rout).abs().max().item() <= 1e-4
    assert (lse - rlse).abs().max().item() <= 1e-4


@pytest.mark.parametrize("N", [1, 16, 63, 65, 4100])
@pytest.mark.parametrize("M", [4097, 35000])
@pytest.mark.parametrize("gated", [False, True])
def test_nn1_stream_any_shape_matches_plain(card, N, M, gated):
    # the 1-NN design of four lanes a query: N below, at and above a query
    # tile, few query tiles (the target split into chunks) and many; with
    # the cull and the ICP gate the rows within the gate are exact
    rs = np.random.RandomState(N + M)
    tgt = _morton(_surface(rs, card, 2, M))
    src = _morton(_surface(rs, card, 2, N)) + 0.002
    kw = dict(diag_order=True, cull_lb=stream.pair_tile_bounds(src, tgt),
              max_dist_sq=0.02 ** 2) if gated else {}
    d, i = cuda_stream.nn1_stream(src, tgt, **kw)
    rd, ri = stream.nn1_stream_plain(src, tgt)
    inside = rd < 0.02 ** 2 if gated else torch.ones_like(rd, dtype=torch.bool)
    assert torch.equal(d[inside], rd[inside]) and torch.equal(i[inside], ri[inside])
    assert (d[~inside] >= 0.02 ** 2).all()
    d2, i2 = cuda_stream.nn1_stream(src, tgt, **kw)
    assert torch.equal(d, d2) and torch.equal(i, i2)   # the same bits again


@pytest.mark.parametrize("cull", [False, True])
def test_nn1_stream_coincident_points_take_the_first(card, cull):
    # 301 copies of one point: every query at one of them ties 301 ways
    rs = np.random.RandomState(11)
    x = _surface(rs, card, 1, 4200)
    x[:, 100:401] = x[:, :1]
    x = _morton(x)
    kw = dict(diag_order=True, cull_lb=stream.tile_pair_bounds(x)) if cull else {}
    d, i = cuda_stream.nn1_stream(x, x, **kw)
    rd, ri = stream.nn1_stream_plain(x, x)
    assert torch.equal(d, rd) and torch.equal(i, ri)


def test_nn1_stream_counts_the_tiles_it_searches(card):
    rs = np.random.RandomState(12)
    x = _morton(_surface(rs, card, 1, 9000))
    lb = stream.tile_pair_bounds(x)
    every, culled = (torch.zeros(1, dtype=torch.int32, device=card) for _ in range(2))
    cuda_stream.nn1_stream(x, x, visits=every)
    cuda_stream.nn1_stream(x, x, cull_lb=lb, diag_order=True, visits=culled)
    assert every.item() == lb.shape[1] * lb.shape[2]
    assert 0 < culled.item() < every.item()


@pytest.mark.parametrize("B,N,M,D", [(2, 130, 4100, 512), (1, 70, 50, 64),
                                     (2, 300, 1, 128), (1, 129, 65, 256),
                                     (3, 1000, 2000, 512)])
def test_wproject_wgmma_any_shape_matches_plain(card, B, N, M, D):
    # N and M not multiples of the unit's 128 rows or the tile's 64 keys;
    # M = 1; more units than blocks and fewer
    rs = np.random.RandomState(N + M + D)
    l2 = lambda a: (a / a.norm(dim=-1, keepdim=True)).to(torch.bfloat16)
    base = torch.tensor(rs.randn(B, max(N, M), D).astype(np.float32), device=card)
    q = l2(base[:, :N] + 0.3 * torch.randn_like(base[:, :N]))
    k = l2(base[:, :M] + 0.3 * torch.randn_like(base[:, :M]))
    v = torch.tensor(rs.randn(B, M, 1).astype(np.float32), device=card)
    out, lse = cuda_stream.wproject_stream_lse(q, k, v)
    rout, rlse = stream.wproject_stream_lse_plain(q, k, v)
    assert (out - rout).abs().max().item() <= 1e-4
    assert (lse - rlse).abs().max().item() <= 1e-4
    out2, lse2 = cuda_stream.wproject_stream_lse(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("B,N,M,D", [(2, 130, 4100, 512), (1, 70, 50, 32),
                                     (2, 300, 1, 96), (1, 129, 65, 32),
                                     (3, 1000, 2000, 512), (3, 700, 33000, 96),
                                     (1, 257, 513, 96)])
def test_wproject_tf32_any_shape_matches_plain(card, B, N, M, D):
    # the float32 kernel (three TF32 products a logit, tiles of 128 rows x
    # 256 keys): N and M not multiples of the tiles, M = 1, D = 32, 96 and
    # 512, B = 3, more units than blocks (a query tile over several blocks,
    # its key tiles rotated) and fewer
    rs = np.random.RandomState(N + M + D + 1)
    l2 = lambda a: a / a.norm(dim=-1, keepdim=True)
    base = torch.tensor(rs.randn(B, max(N, M), D).astype(np.float32), device=card)
    q = l2(base[:, :N] + 0.3 * torch.randn_like(base[:, :N]))
    k = l2(base[:, :M] + 0.3 * torch.randn_like(base[:, :M]))
    v = torch.tensor(rs.randn(B, M, 1).astype(np.float32), device=card)
    dispatch.reset_launch_counts()
    out, lse = cuda_stream.wproject_stream_lse(q, k, v)
    assert dispatch.launch_counts["wproject"] == 1
    rout, rlse = stream.wproject_stream_lse_plain(q, k, v)
    assert (out - rout).abs().max().item() <= 1e-4
    assert (lse - rlse).abs().max().item() <= 1e-4
    out2, lse2 = cuda_stream.wproject_stream_lse(q, k, v)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)


@pytest.mark.parametrize("dtype,lim_qk", [(torch.float32, 1e-4),
                                          (torch.bfloat16, 2 ** -7)])
def test_wproject_gradient_with_the_kernel_matches_plain_autograd(card, dtype,
                                                                  lim_qk):
    # `stream.wproject`: the kernel's forward, the chunked recompute backward
    # from the kernel's lse, against autograd through the plain version;
    # each gradient as a share of its largest |value| (bf16 dq and dk are
    # rounded once: one bf16 ulp, 2^-7 of a value)
    rs = np.random.RandomState(5)
    B, N, M, D = 1, 5000, 5000, 512
    l2 = lambda a: (a / a.norm(dim=-1, keepdim=True)).to(dtype)
    base = torch.tensor(rs.randn(B, N, D).astype(np.float32), device=card)
    q0 = l2(base + 0.3 * torch.randn_like(base))
    k0 = l2(base[:, torch.randperm(N, device=card)] + 0.3 * torch.randn_like(base))
    v0 = torch.tensor(rs.randn(B, M, 1).astype(np.float32), device=card)
    g = torch.tensor(rs.randn(B, N, 1).astype(np.float32), device=card)
    grads = []
    for fwd in (cuda_stream.wproject_stream_lse, None):
        q, k, v = (a.clone().requires_grad_() for a in (q0, k0, v0))
        if fwd is None:
            out = stream.wproject_stream_lse_plain(q, k, v)[0]
        else:
            dispatch.reset_launch_counts()
            out = stream.wproject(q, k, v, fwd)
            assert dispatch.launch_counts["wproject"] == 1
        out.backward(g)
        grads.append((out.detach(), q.grad, k.grad, v.grad))
    for name, a, b, lim in zip(("out", "dq", "dk", "dv"), *grads,
                               (1e-4, lim_qk, lim_qk, 1e-4)):
        assert a.dtype == b.dtype, name
        err = (a.float() - b.float()).abs().max().item()
        assert err <= lim * b.float().abs().max().item(), (name, err)


def test_wproject_grid_fills_the_card_at_the_indoor_shape(card):
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    blocks, slots = cuda_stream.wproject_plan(1, 35000, 35000, sms)
    assert blocks == sms and slots >= 1
    blocks, slots = cuda_stream.wproject_plan(1, 35000, 35000, sms,
                                              cuda_stream.WPROJECT_F32_KEYS)
    assert blocks == sms and slots >= 1


@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0625)])
def test_dgcnn_edges_kernel_matches_plain(card, dtype, lim):
    rs = np.random.RandomState(4)
    x, ws, aff = _dgcnn_inputs(rs, card, 2, 3001, 512)
    nbr = x[:, torch.tensor(rs.randint(0, 3001, (3001, 20)), device=card)]
    out = dgcnn_edges(x, nbr, ws, aff, 20, dtype)
    ref = dgcnn_edges_reference(x, nbr, ws, aff, 20, dtype)
    assert (out.float() - ref.float()).abs().max().item() <= lim


def test_indoor_kernels_refuse_what_they_do_not_take(card):
    x = torch.zeros(1, 100, 3, device=card)
    with pytest.raises(ValueError, match="k <="):
        cuda_stream.knn_stream(x, x, 33)
    with pytest.raises(ValueError, match="cull table"):
        cuda_stream.nn1_stream(x, x, cull_lb=torch.zeros(1, 1, 2, device=card))
    q = torch.zeros(1, 10, 48, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="D in"):
        cuda_stream.wproject_stream_lse(q, q, torch.zeros(1, 10, 1, device=card))
    _, ws, aff = _dgcnn_inputs(np.random.RandomState(0), card, 1, 8, 96)
    with pytest.raises(ValueError, match="emb a multiple of 64"):
        dgcnn_edges(x, torch.zeros(1, 100, 33, 3, device=card), ws, aff, 33)


def test_indoor_registrar_routes_on_the_card(card):
    cfg = configs.indoor()
    cfg = cfg.replace(model=configs.ModelConfig(
        **{**cfg.model.__dict__, "emb_dims": 64, "num_heads": 2,
           "icp_iters": 3, "overlap_stream": True, "dgcnn_fused_edges": True}))
    reg = Registrar(cfg, seed=1)
    rs = np.random.RandomState(7)
    src = _surface(rs, card, 1, 5000).cpu().numpy()
    dispatch.reset_launch_counts()
    rot, _, so, _ = reg(src, src[:, ::-1].copy(), refine=True)
    torch.cuda.synchronize()
    assert torch.isfinite(rot).all() and so.shape == (1, 5000)
    assert dispatch.launch_counts == {**NONE, "knn_stream": 1, "wproject": 2,
                                      "dgcnn_edges": 1, "nn1_stream": 4,
                                      "sinkhorn_em": 1}


# ------------------------------------------- the whole-loop and fused kernels

@pytest.mark.parametrize("B,N,cin,h,cout", [(3, 90, 128, 128, 64),
                                            (2, 717, 1024, 1024, 512),
                                            (1, 1024, 64, 128, 64)])
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0625)])
def test_pointmlp_kernel_matches_plain(card, B, N, cin, h, cout, dtype, lim):
    rs = np.random.RandomState(N)
    w = lambda *s: torch.tensor(rs.randn(*s).astype(np.float32) / np.sqrt(s[-1]),
                                device=card)
    x = torch.tensor(rs.randn(B, N, cin).astype(np.float32), device=card).to(dtype)
    args = (x, w(h, cin), w(h) * 0.3, w(cout, h), w(cout) * 0.3, dtype)
    out = cuda_mlp.pointmlp_eval(*args)
    ref = cuda_mlp.pointmlp_eval_reference(*args)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (B, N, cout)
    assert (out.float() - ref.float()).abs().max().item() <= lim


@pytest.mark.parametrize("B,N,cin,h,cout", [(1, 1, 64, 64, 64),
                                            (2, 129, 192, 320, 448),
                                            (1, 1024, 1024, 512, 1024),
                                            (4, 717, 256, 384, 128),
                                            (48, 717, 1024, 1024, 512)])
@pytest.mark.parametrize("dtype,lim", [(torch.bfloat16, 0.0625),
                                       (torch.float32, 1e-4)])
def test_pointmlp_wgmma_route_any_width(card, B, N, cin, h, cout, dtype, lim):
    # the column tiles of 64, 128 and 256 (bf16) and 64, 128 (float32, in
    # 3xTF32), one point, N not a multiple of the 128-row tile; twice bit
    # for bit
    rs = np.random.RandomState(cin + h)
    w = lambda *s: torch.tensor(rs.randn(*s).astype(np.float32) / np.sqrt(s[-1]),
                                device=card)
    x = torch.tensor(rs.randn(B, N, cin).astype(np.float32), device=card).to(dtype)
    args = (x, w(h, cin), w(h) * 0.3, w(cout, h), w(cout) * 0.3, dtype)
    out, again = cuda_mlp.pointmlp_eval(*args), cuda_mlp.pointmlp_eval(*args)
    ref = cuda_mlp.pointmlp_eval_reference(*args)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert out.shape == (B, N, cout) and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= lim


@pytest.mark.parametrize("R,N,npoint", [(96, 717, 128), (4, 1433, 128),
                                        (4, 35000, 128), (3, 50, 60)])
def test_fps_kernel_matches_plain(card, R, N, npoint):
    rs = np.random.RandomState(N)
    x = torch.tensor(rs.randn(R, N, 3).astype(np.float32), device=card)
    x[:, N // 2] = x[:, 1]                   # a duplicated point: tied distances
    dist = torch.full((R, N), 1e10, device=card)
    dist[R // 2:] = ((x[R // 2:] - x[R // 2:].mean(1, keepdim=True)) ** 2).sum(-1)
    start = torch.tensor(rs.randint(0, N, R), device=card)
    start[R // 2:] = dist[R // 2:].argmax(-1)
    got = cuda_fps.fps(x, npoint, dist, start)
    want = cuda_fps.fps_reference(x, npoint, dist, start)
    assert torch.equal(got, want)


# (rows, points): a block a row (717, 1433, one point, a small row), a
# cluster a row (10,241, 35,000), the L2 route (140,000)
FPS_PLAN_SHAPES = [(96, 717), (48, 1433), (1, 1), (3, 50), (2, 10241),
                   (4, 35000), (2, 140000)]


def _fps_rows(dev, R, N, seed):
    """fps_combined-like rows: random starts at 1e10 and centre starts with
    the distances to the centroid, a duplicated point."""
    rs = np.random.RandomState(seed)
    x = torch.tensor(rs.randn(R, N, 3).astype(np.float32), device=dev)
    if N > 2:
        x[:, N // 2] = x[:, 1]
    dist = torch.full((R, N), 1e10, device=dev)
    h = R // 2
    dist[h:] = ((x[h:] - x[h:].mean(1, keepdim=True)) ** 2).sum(-1)
    start = torch.tensor(rs.randint(0, N, R), device=dev)
    start[h:] = dist[h:].argmax(-1)
    return x, dist, start


@pytest.mark.parametrize("R,N", FPS_PLAN_SHAPES)
def test_fps_every_plan_matches_plain(card, R, N):
    # the plan's launch and every compiled one near it (block and cluster
    # routes, 1 to 16 blocks a row, 2 to 16 points a thread, the L2 route):
    # ids identical to the plain loop; the register routes leave the
    # distance row as it was
    x, dist, start = _fps_rows(card, R, N, seed=N)
    kept = dist.clone()
    want = cuda_fps.fps_reference(x, 48, dist, start)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = cuda_fps.compiled_plans(R, N, sms)
    assert cuda_fps.fps_plan(R, N, sms) in plans
    for plan in plans:
        got = cuda_fps._fps_cuda(x, 48, dist, start, plan)
        assert torch.equal(got, want), plan
    assert torch.equal(dist, kept)
    assert torch.equal(cuda_fps.fps(x, 48, dist, start), want)


@pytest.mark.parametrize("R,N", [(96, 717), (4, 35000)])
def test_fps_all_equal_cloud(card, R, N):
    # every distance ties at 0 after the first step: index 0 each step
    x = torch.full((R, N, 3), -0.5, device=card)
    dist = torch.full((R, N), 1e10, device=card)
    start = torch.arange(R, device=card) % N
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    want = cuda_fps.fps_reference(x, 16, dist, start)
    assert (want[:, 1:] == 0).all()
    for plan in cuda_fps.compiled_plans(R, N, sms):
        assert torch.equal(cuda_fps._fps_cuda(x, 16, dist, start, plan), want), plan


@pytest.mark.parametrize("B,N,M", [(24, 717, 717), (3, 300, 4096), (2, 500, 130),
                                   (4, 1433, 1433), (48, 717, 717),
                                   (80, 717, 717), (2, 4096, 4096)])
def test_icp_kernel_matches_plain(card, B, N, M):
    rs = np.random.RandomState(M)
    src = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    tgt = torch.tensor(rs.randn(B, M, 3).astype(np.float32) * 0.3, device=card)
    k = min(N, M)
    tgt[:, :k] = src[:, :k] + 0.01           # near copies: inliers
    tgt[-1] += 100.0                         # a cloud without inliers
    init = torch.eye(4, device=card).expand(B, 4, 4).contiguous()
    r, t, first = cuda_icp.icp_fused(src, tgt, init, 0.05 ** 2, return_first=True)
    rr, rt, rfirst = cuda_icp.icp_fused_reference(src, tgt, init, 0.05 ** 2,
                                                  return_first=True)
    torch.cuda.synchronize()
    assert torch.equal(first, rfirst)
    assert (r - rr).abs().max().item() <= 1e-4
    assert (t - rt).abs().max().item() <= 1e-4
    assert torch.equal(r[-1], init[-1, :3, :3]) and torch.equal(t[-1], init[-1, :3, 3])
    r2, t2, first2 = cuda_icp.icp_fused(src, tgt, init, 0.05 ** 2, return_first=True)
    assert torch.equal(r, r2) and torch.equal(t, t2) and torch.equal(first, first2)


def test_loop_kernels_refuse_what_they_do_not_take(card):
    x = torch.zeros(2, 100, 48, device=card)
    w = lambda *s: torch.zeros(*s, device=card)
    with pytest.raises(ValueError, match="multiples of 64"):
        cuda_mlp.pointmlp_eval(x, w(64, 48), w(64), w(64, 64), w(64), torch.float32)
    with pytest.raises(ValueError, match="N <= 1024"):
        cuda_mlp.pointmlp_eval(w(1, 1025, 64), w(64, 64), w(64), w(64, 64),
                               w(64), torch.float32)
    with pytest.raises(ValueError, match="M <= 4096"):
        cuda_icp.icp_fused(w(1, 10, 3), w(1, 4097, 3),
                           torch.eye(4, device=card)[None], 0.01)
    with pytest.raises(ValueError, match="start"):
        cuda_fps.fps(w(2, 10, 3), 4, w(2, 10), w(3).long())


def test_loop_switches_launch_each_kernel(card):
    cfg = configs.mnet(model=configs.ModelConfig(emb_dims=64, n_clusters=16,
                                                 km_clusters=16, num_heads=2))
    src = np.random.RandomState(3).randn(2, 300, 3).astype(np.float32) * 0.3
    outs = {}
    for on in (True, False):
        reg = Registrar(cfg, seed=2, loop_kernels=on)     # the same weights
        dispatch.reset_launch_counts()
        outs[on] = reg(src, src[:, ::-1].copy(), refine=True)
        torch.cuda.synchronize()
        got = {k: dispatch.launch_counts[k] for k in ("fps", "icp", "pointmlp")}
        assert got == ({"fps": 1, "icp": 1, "pointmlp": 3} if on else
                       {"fps": 0, "icp": 0, "pointmlp": 0})
    assert (outs[True][2] - outs[False][2]).abs().max().item() <= 0.05


# ------------------ the tensor-core stage chain and the one-wave EM kernel

@pytest.mark.parametrize("N", [20, 717, 1023, 1024])
@pytest.mark.parametrize("k", GPU_KS)
@pytest.mark.parametrize("emb", [64, 512])
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0625)])
def test_dgcnn_kernel_ragged_point_tiles(card, N, k, emb, dtype, lim):
    # N not a multiple of the 8 (or 4) points a block of the stage kernel
    # takes
    N = max(N, k)
    x, ws, aff = _dgcnn_inputs(np.random.RandomState(N + k), card, 2, N, emb)
    pk = min(5, k)
    out, alpha = dgcnn_eval(x, ws, aff, k, dtype, pk)
    again, _ = dgcnn_eval(x, ws, aff, k, dtype, pk)
    ref, ralpha = dgcnn_eval_reference(x, ws, aff, k, dtype, pk)
    torch.cuda.synchronize()
    assert out.shape == (2, N, emb) and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= lim
    assert (alpha - ralpha).abs().max().item() <= 1e-5
    assert torch.equal(out, again)           # the same bits every launch


@pytest.mark.parametrize("N", [37, 35000])
@pytest.mark.parametrize("k", [20, 40])
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0625)])
def test_dgcnn_edges_kernel_any_n(card, N, k, dtype, lim):
    rs = np.random.RandomState(N)
    x, ws, aff = _dgcnn_inputs(rs, card, 2, N, 512)
    nbr = x[:, torch.tensor(rs.randint(0, N, (N, k)), device=card)]
    out = dgcnn_edges(x, nbr, ws, aff, k, dtype)
    again = dgcnn_edges(x, nbr, ws, aff, k, dtype)
    ref = dgcnn_edges_reference(x, nbr, ws, aff, k, dtype)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= lim
    assert torch.equal(out, again)


@pytest.mark.parametrize("B,N,K", [(2, 3072, 128), (2, 3352, 128), (2, 700, 1),
                                   (2, 700, 32), (2, 700, 100), (48, 717, 128),
                                   (2, 12128, 32)])
def test_em_kernel_one_wave_design_matches_plain(card, B, N, K):
    # (2, 3352, 128) and (2, 12128, 32) fill a block's shared memory
    rs = np.random.RandomState(N + K)
    xyz = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    o = torch.tensor(rs.rand(B, N).astype(np.float32), device=card)
    o = o / o.sum(-1, keepdim=True)
    n0 = torch.tensor(rs.randn(B, K, 3).astype(np.float32) * 0.3, device=card)
    got = sinkhorn_em(xyz, o, n0, iters=1)
    again = sinkhorn_em(xyz, o, n0, iters=1)
    want = sinkhorn_em_reference(xyz, o, n0, iters=1)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4
        assert torch.equal(g, a)             # the same bits every launch


def test_em_kernel_runs_the_request_in_one_wave(card):
    # 48 clouds of (717, 128): the occupancy calculator's count of clusters
    # of 8 blocks the card holds at once
    from ogmm_tpu_torch.ops import cuda_em
    assert cuda_em.max_clusters(717, 128) >= 48


# ------------------------------------- the angle kernel sized for a small k

POSENC_SHAPES = [(N, k) for N in (5, 6, 64, 717, 1023, 1024)
                 for k in (1, 5, 8, 20, 32) if k <= N]


def _posenc_check(x, k):
    """Kernel against plain: identical neighbours, angles within 1e-5, a
    relaunch bit-equal."""
    B, N, _ = x.shape
    idx = torch.empty(B, N, k, dtype=torch.int32, device=x.device)
    got = cuda_posenc._posenc_angles_cuda(x, k, idx=idx)
    again = cuda_posenc._posenc_angles_cuda(x, k)
    torch.cuda.synchronize()
    assert torch.equal(idx.long(), knn_reference(x, x, k))
    assert (got - posenc_angles_reference(x, k)).abs().max().item() <= 1e-5
    assert torch.equal(got, again)


@pytest.mark.parametrize("N,k", POSENC_SHAPES)
def test_posenc_angles_every_routed_k_matches_plain(card, N, k):
    rs = np.random.RandomState(N + 100 * k)
    x = torch.tensor(rs.randn(2, N, 3).astype(np.float32) * 0.3, device=card)
    x[:, N // 2] = x[:, 1]                   # a duplicated point: exact ties
    _posenc_check(x, k)


@pytest.mark.parametrize("k", [1, 5, 8, 20, 32])
def test_posenc_angles_coincident_points_take_the_lowest_index(card, k):
    # most of a lane's points sit at T: its buffer overflows and its warp
    # scans again, draining as it goes
    rs = np.random.RandomState(k)
    x = torch.tensor(rs.randn(3, 600, 3).astype(np.float32) * 0.3, device=card)
    x[:, 100:400] = x[:, :1]                 # 301 coincident points
    _posenc_check(x, k)


@pytest.mark.parametrize("B,N,k", [(24, 717, 5), (1, 717, 5), (3, 64, 8),
                                   (2, 1024, 2), (2, 7, 1)])
def test_posenc_angles_at_batch_sizes_matches_plain(card, B, N, k):
    rs = np.random.RandomState(B + N + k)
    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    x[:, N // 2] = x[:, 1]
    _posenc_check(x, k)


# ------------------------------------------------- DeepGMR (768 vs 1536)

def _deepgmr_pair(rs, n_src, n_tgt):
    """src, and tgt: a rotated, shifted copy of src and n_tgt - n_src other
    points, permuted."""
    from scipy.spatial.transform import Rotation
    src = (rs.randn(2, n_src, 3) * 0.3).astype(np.float32)
    rot = Rotation.from_rotvec(rs.uniform(-0.4, 0.4, (2, 3))).as_matrix()
    tgt = np.concatenate([np.einsum("bij,bnj->bni", rot, src) + 0.1,
                          rs.randn(2, n_tgt - n_src, 3) * 0.3], axis=1)
    return src, tgt[:, rs.permutation(n_tgt)].astype(np.float32)


@pytest.mark.parametrize("loop_kernels", [False, True])
def test_deepgmr_forward_kernels_match_plain(card, loop_kernels):
    """A small DeepGMR request with src inside the fused DGCNN's envelope
    (N = 384: dgcnn_eval) and tgt above it (M = 1152: the knn kernel, the
    unfused chain), refined through the 1-NN kernel's ICP trips or the
    whole-loop ICP kernel, against the same weights through the plain
    versions on the CPU: the moments to round-off of the 3xTF32 stage
    chain, the poses to 1e-3."""
    cfg = configs.mnet(model=configs.ModelConfig(emb_dims=64, n_clusters=16),
                       model_name="DeepGMR")
    src, tgt = _deepgmr_pair(np.random.RandomState(31), 384, 1152)
    reg = Registrar(cfg, seed=1, loop_kernels=loop_kernels)
    cpu = Registrar(cfg, seed=1, device="cpu", loop_kernels=loop_kernels)
    for refine in (False, True):
        dispatch.reset_launch_counts()
        got = reg(src, tgt, refine=refine)
        torch.cuda.synchronize()
        want = {**NONE, "dgcnn_eval": 1, "knn": 1}
        if refine:
            want.update({"icp": 1} if loop_kernels else {"nn1": 30})
        assert dispatch.launch_counts == want
        ref = cpu(src, tgt, refine=refine)
        assert got[2].shape == (2, 384) and got[3].shape == (2, 1152)
        for a, b in zip(got[:2], ref[:2]):
            assert (a.cpu() - b).abs().max().item() <= 1e-3
    with torch.no_grad():
        for x in (src, tgt):
            g = reg.model.moments(torch.tensor(x, device=card))
            r = cpu.model.moments(torch.tensor(x))
            for a, b in zip(g, r):
                assert (a.cpu() - b).abs().max().item() <= 1e-5


def test_deepgmr_train_step_kernels_match_plain(card):
    """One DeepGMR train step: src through graph_stage1 (N = 384), tgt
    through the knn kernel and the unfused chain (M = 1152), the metrics'
    1-NN both ways (N != M); the loss and gradients against the CPU's."""
    cfg = configs.mnet(model=configs.ModelConfig(emb_dims=64, n_clusters=16),
                       model_name="DeepGMR")
    src, tgt = _deepgmr_pair(np.random.RandomState(32), 384, 1152)
    gt = np.tile(np.eye(4, dtype=np.float32)[:3], (2, 1, 1))
    batch = {"src_xyz": src, "tgt_xyz": tgt, "transform_gt": gt,
             "src_overlap": np.ones((2, 384), np.float32),
             "tgt_overlap": np.ones((2, 1152), np.float32)}
    losses, grads = {}, {}
    for dev in (card, torch.device("cpu")):
        state = create_train_state(cfg, 10, seed=0, device=dev)
        dispatch.reset_launch_counts()
        loss, _ = train_loss(state, cfg, batch)
        loss.backward()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert dispatch.launch_counts == {**NONE, "graph_stage1": 1,
                                              "knn": 1}
        losses[dev.type] = loss.item()
        grads[dev.type] = torch.cat([p.grad.flatten().cpu() for p in
                                     state.model.parameters()])
    assert abs(losses["cuda"] - losses["cpu"]) <= 1e-4 * abs(losses["cpu"])
    rel = ((grads["cuda"] - grads["cpu"]).norm() / grads["cpu"].norm()).item()
    assert rel <= 1e-3


@pytest.mark.parametrize("B,N,launched", [
    (4, 717, {"knn": 1}),                                  # dense trips
    (2, 1433, {"knn": 1, "nn1": 30}),
    (1, 5000, {"knn_stream": 1, "nn1_stream": 30})])       # spatial route
def test_point_to_plane_on_the_card_matches_the_cpu(card, B, N, launched):
    """refine_registration(pl=True): the normals through the kNN kernels
    (k = 16) and the trips through the route's 1-NN, against the same call
    on the CPU's plain versions."""
    from ogmm_tpu_torch.ops.icp import refine_registration
    rs = np.random.RandomState(N)
    src = _surface(rs, card, B, N)
    def about_z(a):
        c, s = np.cos(a), np.sin(a)
        z, o = np.zeros_like(a), np.ones_like(a)
        m = np.stack([np.stack([c, -s, z], -1), np.stack([s, c, z], -1),
                      np.stack([z, z, o], -1)], -2)
        return torch.tensor(m.astype(np.float32), device=card)

    a = rs.uniform(-0.3, 0.3, B)
    rot = about_z(a)
    tr = torch.tensor(rs.uniform(-0.1, 0.1, (B, 3)).astype(np.float32), device=card)
    tgt = src @ rot.transpose(1, 2) + tr[:, None]
    rot0 = about_z(a + 0.03)
    dispatch.reset_launch_counts()
    got = refine_registration(src, tgt, rot0, tr + 0.005, 0.035, pl=True)
    torch.cuda.synchronize()
    assert dispatch.launch_counts == {**NONE, **launched}
    want = refine_registration(src.cpu(), tgt.cpu(), rot0.cpu(),
                               (tr + 0.005).cpu(), 0.035, pl=True)
    for g, w in zip(got, want):
        assert (g.cpu() - w).abs().max().item() <= 1e-4
    assert (got[0] - rot).abs().max().item() <= 1e-3



# ------------------------------------ the point-sharded request's shapes

@pytest.mark.parametrize("world", [1, 2, 4])
def test_knn_stream_at_the_sharded_shape(card, world):
    """The cross graph of one process's rows of the indoor cloud against
    the whole cloud, (1, 35000 / W, 35000, k = 20), as `knn_cross_spatial`
    gives it: the plain version's indices (in the kernel's sorted spaces,
    with the cull and the diagonal stretched by W)."""
    rs = np.random.RandomState(60 + world)
    full = _surface(rs, card, 1, 35000)
    rows = full[:, :35000 // world]
    box = (full.amin(dim=1, keepdim=True), full.amax(dim=1, keepdim=True))
    qs = index_points(rows, stream.morton_order(rows, box))
    ts = index_points(full, stream.morton_order(full, box))
    got = cuda_stream.knn_stream(qs, ts, 20, diag_order=True, stretch=world,
                                 cull_lb=stream.pair_tile_bounds(qs, ts))
    torch.cuda.synchronize()
    assert torch.equal(got, stream.knn_stream_plain(qs, ts, 20))


@pytest.mark.parametrize("world", [1, 2, 4])
def test_nn1_stream_at_the_sharded_shapes(card, world):
    """An ICP trip of the sharded request, (1, 35000 / W, 35000), sorted
    clouds, the cull and the gate (exact within the gate), and the
    clustering's (2, 16, 35000 / W) without them (exact)."""
    rs = np.random.RandomState(70 + world)
    tgt = _morton(_surface(rs, card, 1, 35000))
    src = _morton(tgt[:, torch.randperm(35000, device=card)[:35000 // world]]
                  + 0.002)
    gate = 0.07 ** 2
    d, i = cuda_stream.nn1_stream(src, tgt, cull_lb=stream.pair_tile_bounds(
        src, tgt), max_dist_sq=gate, diag_order=True, stretch=world)
    rd, ri = stream.nn1_stream_plain(src, tgt)
    inside = rd < gate
    assert torch.equal(d[inside], rd[inside]) and torch.equal(i[inside], ri[inside])
    local = _surface(rs, card, 2, 35000 // world)
    means = _surface(rs, card, 2, 16)
    d, i = cuda_stream.nn1_stream(means, local)
    rd, ri = stream.nn1_stream_plain(means, local)
    assert torch.equal(d, rd) and torch.equal(i, ri)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wproject_at_the_sharded_shape(card, world, dtype):
    """The overlap head of the sharded request: one process's queries
    against the whole other cloud, (1, 35000 / W, 35000, 512), out and lse
    within 1e-4 of the plain version."""
    rs = np.random.RandomState(80 + world)
    l2 = lambda a: (a / a.norm(dim=-1, keepdim=True)).to(dtype)
    q = l2(torch.tensor(rs.randn(1, 35000 // world, 512).astype(np.float32),
                        device=card))
    k = l2(torch.tensor(rs.randn(1, 35000, 512).astype(np.float32), device=card))
    v = torch.tensor(rs.randn(1, 35000, 1).astype(np.float32), device=card)
    out, lse = cuda_stream.wproject_stream_lse(q, k, v)
    rout, rlse = stream.wproject_stream_lse_plain(q, k, v)
    assert (out - rout).abs().max().item() <= 1e-4
    assert (lse - rlse).abs().max().item() <= 1e-4


# ------------------------------------------ the envelopes of the JAX rules

@pytest.mark.parametrize("B,N,K", [(2, 3353, 128), (2, 5734, 128), (1, 4096, 128),
                                   (2, 2867, 256), (2, 5690, 129), (2, 1500, 200),
                                   (3, 300, 256), (2, 13056, 64)])
def test_em_kernel_past_a_cluster_of_8_matches_plain(card, B, N, K):
    # clusters of 16 blocks (the slab's rows 4 ceil(K / 4) floats apart) and
    # K above 128: one trip tightly, ten on the outputs the model consumes
    from ogmm_tpu_torch.ops import cuda_em
    assert cuda_em.kernel_takes(N, K)
    assert cuda_em.max_clusters(N, K) >= 1
    rs = np.random.RandomState(N + K)
    xyz = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=card)
    o = torch.tensor(rs.rand(B, N).astype(np.float32), device=card)
    o = o / o.sum(-1, keepdim=True)
    n0 = xyz[:, rs.choice(N, K, replace=False)].contiguous()
    got = sinkhorn_em(xyz, o, n0, iters=1)
    want = sinkhorn_em_reference(xyz, o, n0, iters=1)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        assert (g - w).abs().max().item() <= 1e-4
    got = sinkhorn_em(xyz, o, n0, iters=10)
    again = sinkhorn_em(xyz, o, n0, iters=10)
    want = sinkhorn_em_reference(xyz, o, n0, iters=10)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert (got[1] - want[1]).abs().max().item() <= 1e-3
    assert (got[2] - want[2]).abs().max().item() <= 1e-2


@pytest.mark.parametrize("k,N", [(12, 3001), (5, 37), (25, 500), (32, 64)])
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0625)])
def test_dgcnn_edges_kernel_every_k(card, k, N, dtype, lim):
    rs = np.random.RandomState(N + k)
    x, ws, aff = _dgcnn_inputs(rs, card, 2, N, 512)
    nbr = x[:, torch.tensor(rs.randint(0, N, (N, k)), device=card)]
    out = dgcnn_edges(x, nbr, ws, aff, k, dtype)
    ref = dgcnn_edges_reference(x, nbr, ws, aff, k, dtype)
    torch.cuda.synchronize()
    assert (out.float() - ref.float()).abs().max().item() <= lim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gnn_k12_request_and_step_run_the_kernels(card, dtype):
    # the request of configs.mnet(gnn_k=12) through the eval kernel; a train
    # step through graph_stage1 (twice: one a cloud side) and the plain
    # backward (the backward kernels take k = 20)
    cfg = configs.mnet(model=configs.ModelConfig(
        emb_dims=64, n_clusters=32, km_clusters=32, gnn_k=12, dtype=dtype))
    reg = Registrar(cfg, seed=1)
    src = np.random.RandomState(7).randn(2, 300, 3).astype(np.float32) * 0.3
    dispatch.reset_launch_counts()
    rot, _, so, _ = reg(src, src[:, ::-1].copy(), refine=False)
    torch.cuda.synchronize()
    assert torch.isfinite(rot).all()
    assert dispatch.launch_counts == {**NONE, "dgcnn_eval": 1, "sinkhorn_em": 1,
                                      "nn1": 1}
    state = create_train_state(cfg, steps_per_epoch=10, seed=0)
    dispatch.reset_launch_counts()
    metrics = make_train_step(cfg)(state, _train_batch(np.random.RandomState(8), 4, 300))
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).all() for v in metrics.values())
    assert dispatch.launch_counts["graph_stage1"] == 2
    assert dispatch.launch_counts["bwd_stage"] == 0


def test_request_at_n4096_runs_the_em_kernel(card):
    # the JAX rule sends N = 4,096 at K = 128 to its EM kernel: a cluster of
    # 16 blocks a cloud here
    cfg = configs.mnet(model=configs.ModelConfig(emb_dims=64))
    reg = Registrar(cfg, seed=1)
    src = np.random.RandomState(9).randn(2, 4096, 3).astype(np.float32) * 0.3
    dispatch.reset_launch_counts()
    rot, _, so, _ = reg(src, src[:, ::-1].copy(), refine=False)
    torch.cuda.synchronize()
    assert torch.isfinite(rot).all() and so.shape == (2, 4096)
    assert dispatch.launch_counts["sinkhorn_em"] == 1
