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
from ogmm_tpu_torch.ops.cuda_dgcnn import (KERNEL_KS, dgcnn_eval,
                                           dgcnn_eval_reference)
from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import (bwd_edge, bwd_edge_reference,
                                              bwd_reduce, bwd_reduce_reference,
                                              bwd_stage, bwd_stage_reference)
from ogmm_tpu_torch.ops.cuda_dgcnn_train import (graph_stage1,
                                                 graph_stage1_reference)
from ogmm_tpu_torch.ops.cuda_em import sinkhorn_em, sinkhorn_em_reference
from ogmm_tpu_torch.ops.cuda_knn import knn, knn_reference, nn1, nn1_reference
from ogmm_tpu_torch.ops.cuda_posenc import (posenc_angles,
                                            posenc_angles_reference)
from ogmm_tpu_torch.ops import cuda_fps, cuda_icp, cuda_mlp, cuda_stream, stream
from ogmm_tpu_torch.ops.common import index_points
from ogmm_tpu_torch.ops.cuda_dgcnn import dgcnn_edges, dgcnn_edges_reference
from ogmm_tpu_torch.train import (create_train_state, make_train_step,
                                  train_loss)

pytestmark = pytest.mark.gpu

NONE = {name: 0 for name in dispatch.KERNELS}


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


@pytest.mark.parametrize("kwargs,match", [(dict(k=12), "k in"),
                                          (dict(dtype=torch.float16), "dtype")])
def test_dgcnn_kernel_refuses_what_it_does_not_take(card, kwargs, match):
    x, ws, aff = _dgcnn_inputs(np.random.RandomState(2), card, 1, 64, 64)
    with pytest.raises(ValueError, match=match):
        dgcnn_eval(x, ws, aff, **kwargs)
    big, _, _ = _dgcnn_inputs(np.random.RandomState(2), card, 1, 1100, 64)
    with pytest.raises(ValueError, match="N="):
        dgcnn_eval(big, ws, aff)


@pytest.mark.parametrize("B,N,K", [(3, 96, 32), (2, 200, 64), (2, 717, 128),
                                   (1, 5, 32), (1, 1500, 128)])
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
    with pytest.raises(ValueError, match="K <= 128"):
        sinkhorn_em(xyz, o, torch.zeros(1, 129, 3, device=card))
    big = torch.zeros(1, 3353, 3, device=card)        # past shared memory
    with pytest.raises(ValueError, match="N=3353"):
        sinkhorn_em(big, torch.full((1, 3353), 1 / 3353, device=card),
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
    with pytest.raises(ValueError, match="k in"):
        graph_stage1(x, w1, k=12)
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

@pytest.mark.parametrize("k", KERNEL_KS)
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0625)])
def test_dgcnn_kernels_take_every_compiled_k(card, k, dtype, lim):
    x, ws, aff = _dgcnn_inputs(np.random.RandomState(k), card, 2, 300, 64)
    x[:, 50] = x[:, 9]                       # ties
    out, alpha = dgcnn_eval(x, ws, aff, k, dtype, 5)
    ref, ralpha = dgcnn_eval_reference(x, ws, aff, k, dtype, 5)
    assert (out.float() - ref.float()).abs().max().item() <= lim
    assert (alpha - ralpha).abs().max().item() <= 1e-5
    got = graph_stage1(x, ws[0], k, dtype, 5)
    want = graph_stage1_reference(x, ws[0], k, dtype, 5)
    assert torch.equal(got[2], want[2]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("B,N,M,k", [(48, 1433, 1433, 20), (2, 4096, 4096, 20),
                                     (24, 717, 717, 5), (3, 1000, 257, 32),
                                     (2, 90, 2000, 1), (1, 40, 40, 32)])
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


def test_knn_kernel_many_coincident_points(card):
    # more candidates at the threshold than the kernel's list of 256 holds
    rs = np.random.RandomState(11)
    x = torch.tensor(rs.randn(2, 600, 3).astype(np.float32), device=card)
    x[:, 100:400] = x[:, :1]
    for k in (1, 20, 32):
        assert torch.equal(knn(x, x, k), knn_reference(x, x, k))


def test_knn_kernel_refuses_what_it_does_not_take(card):
    x = torch.zeros(1, 8, 3, device=card)
    with pytest.raises(ValueError, match="M <= 4096"):
        knn(x, torch.zeros(1, 4097, 3, device=card), 5)
    with pytest.raises(ValueError, match="k <= min"):
        knn(x, x, 9)
    with pytest.raises(ValueError, match="k <= min"):
        knn(torch.zeros(1, 64, 3, device=card), torch.zeros(1, 64, 3, device=card), 33)
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
    (dict(gnn_k=12), 300, {"knn": 1, "posenc_angles": 1, "sinkhorn_em": 1,
                           "nn1": 1}),
    (dict(gnn_k=16), 300, {"dgcnn_eval": 1, "sinkhorn_em": 1, "nn1": 1}),
    (dict(n_clusters=16), 2048, {"knn": 1, "sinkhorn_em": 1, "nn1": 1})])
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


def _bwd_calls(dev, B, N, dtype, seed):
    """The arguments of the five backward calls of one DGCNN training
    forward and backward at (B, N), recorded through the plain versions."""
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
            x, ws, [a[0] for a in aff], [a[1] for a in aff], 20, dtype)
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


@pytest.mark.parametrize("B,N", [(3, 90), (4, 717), (1, 20)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bwd_kernels_match_plain(card, B, N, dtype):
    for name, a, kw in _bwd_calls(card, B, N, dtype, seed=N):
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
    z = torch.zeros(1, 8, 64, 256, device=card)
    tap = torch.zeros(1, 64, 256, device=card)
    v = torch.ones(256, device=card)
    with pytest.raises(ValueError, match="20"):
        bwd_reduce(z, tap, v, v, v, v)
    with pytest.raises(ValueError, match="N <= 1024"):
        bwd_reduce(torch.zeros(1, 20, 1100, 256, device=card),
                   torch.zeros(1, 1100, 256, device=card), v, v, v, v)
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
                                     (2, 37, 6000, 32), (1, 700, 4500, 16)])
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
    _, ws, aff = _dgcnn_inputs(np.random.RandomState(0), card, 1, 8, 64)
    with pytest.raises(ValueError, match="k in"):
        dgcnn_edges(x, torch.zeros(1, 100, 6, 3, device=card), ws, aff, 6)


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


@pytest.mark.parametrize("B,N,M", [(24, 717, 717), (3, 300, 4096), (2, 500, 130),
                                   (4, 1433, 1433)])
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
@pytest.mark.parametrize("k", KERNEL_KS)
@pytest.mark.parametrize("emb", [64, 512])
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0625)])
def test_dgcnn_kernel_ragged_point_tiles(card, N, k, emb, dtype, lim):
    # N not a multiple of the 8 points a block of the stage kernel takes
    x, ws, aff = _dgcnn_inputs(np.random.RandomState(N + k), card, 2, N, emb)
    out, alpha = dgcnn_eval(x, ws, aff, k, dtype, 5)
    again, _ = dgcnn_eval(x, ws, aff, k, dtype, 5)
    ref, ralpha = dgcnn_eval_reference(x, ws, aff, k, dtype, 5)
    torch.cuda.synchronize()
    assert out.shape == (2, N, emb) and torch.isfinite(out.float()).all()
    assert (out.float() - ref.float()).abs().max().item() <= lim
    assert (alpha - ralpha).abs().max().item() <= 1e-5
    assert torch.equal(out, again)           # the same bits every launch


@pytest.mark.parametrize("N", [37, 35000])
@pytest.mark.parametrize("dtype,lim", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 0.0625)])
def test_dgcnn_edges_kernel_any_n(card, N, dtype, lim):
    rs = np.random.RandomState(N)
    x, ws, aff = _dgcnn_inputs(rs, card, 2, N, 512)
    nbr = x[:, torch.tensor(rs.randint(0, N, (N, 20)), device=card)]
    out = dgcnn_edges(x, nbr, ws, aff, 20, dtype)
    again = dgcnn_edges(x, nbr, ws, aff, 20, dtype)
    ref = dgcnn_edges_reference(x, nbr, ws, aff, 20, dtype)
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
