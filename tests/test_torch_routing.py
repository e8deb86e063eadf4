"""Each route rule of the port against the rule of the JAX package, at the
boundary shapes.

The JAX side is observed, not restated: with its kernels switched on
(`pallas_override(True)`, the accelerator's rule) its kernels and plain
paths are replaced by stubs that raise `Taken(name)`, and the name that
comes back is the route it chose. Where the JAX package runs a kernel whose
envelope is wider than the port's (k > 32 for the streamed kNN, the angles
and the backward kernels, points of C != 3, the EM above the port's shared
memory), the port takes the route the JAX package takes off its accelerator
(`pallas_override(False)`)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ogmm_tpu.nn.attention as jattention
import ogmm_tpu.nn.dgcnn as jdgcnn
import ogmm_tpu.nn.gmmreg as jgmmreg
import ogmm_tpu.ops.common as jcommon
import ogmm_tpu.ops.dgcnn_train as jdgcnn_train
import ogmm_tpu.ops.gmm as jgmm
import ogmm_tpu.ops.pallas_dgcnn as jpallas_dgcnn
import ogmm_tpu.ops.pallas_em as jpallas_em
import ogmm_tpu.ops.pallas_knn as jpallas_knn
import ogmm_tpu.ops.pallas_mlp as jpallas_mlp
import ogmm_tpu.ops.pallas_stream as jpallas_stream
from ogmm_tpu.configs import ModelConfig as JModelConfig
from ogmm_tpu.nn.layers import PointMLP as JPointMLP
from ogmm_tpu.ops.dispatch import pallas_override
from ogmm_tpu.ops.icp import icp_point_to_point as jicp
from ogmm_tpu.parallel import sp_mesh as jsp_mesh
from ogmm_tpu_torch.nn import gmmreg as tgmmreg
from ogmm_tpu_torch.nn.attention import angle_route
from ogmm_tpu_torch.nn import dgcnn as tdgcnn
from ogmm_tpu_torch.nn.dgcnn import edges_route, fused_route
from ogmm_tpu_torch.ops import common as tcommon
from ogmm_tpu_torch.ops import cuda_dgcnn, cuda_em, cuda_icp, cuda_mlp, cuda_posenc
from ogmm_tpu_torch.ops import icp as ticp
from ogmm_tpu_torch.ops.cuda_dgcnn import CHUNK_KS, KERNEL_MAX_N, kernel_takes
from ogmm_tpu_torch.ops.gmm import em_route

from torch_port_util import clouds, n, randomise_stats, t, to_plain

NS = [1024, 1025, 4096, 4097]
KS = [20, 16, 33]


class Taken(Exception):
    pass


def _stub(monkeypatch, module, name, label=None):
    def fn(*a, **kw):
        raise Taken(label or name)
    monkeypatch.setattr(module, name, fn)


def _taken(fn):
    try:
        fn()
    except Taken as e:
        return e.args[0]
    return None


# -------------------------------------------------------------- kNN, 1-NN

@pytest.fixture
def knn_stubs(monkeypatch):
    _stub(monkeypatch, jpallas_knn, "knn_pallas", "kernel")
    for name in ("knn_self_spatial", "knn_cross_spatial", "knn_stream"):
        _stub(monkeypatch, jpallas_stream, name, "stream")
    _stub(monkeypatch, jpallas_stream, "knn_chunked", "chunked")
    _stub(monkeypatch, jcommon, "square_distance", "dense")
    _stub(monkeypatch, jpallas_knn, "nn1_pallas", "kernel")
    _stub(monkeypatch, jpallas_stream, "nn1_stream", "stream")
    _stub(monkeypatch, jpallas_stream, "nn1_chunked", "chunked")


def _jax_knn(B, N, M, k, C, on_accelerator, same=True):
    src = jnp.zeros((B, N, C))
    tgt = src if same and N == M else jnp.zeros((B, M, C))
    with pallas_override(on_accelerator):
        return _taken(lambda: jcommon.knn(src, tgt, k))


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("k", KS)
def test_knn_route_follows_the_jax_rule(knn_stubs, N, k):
    for B, M, C in [(2, N, 3), (1, 300, 3), (2, N, 6)]:
        jax_route = _jax_knn(B, N, M, k, C, True)
        port = tcommon.knn_route(B, N, M, C, k)
        if jax_route == "kernel" and C == 3:
            # every k <= M <= 4096, k = 33 too: the JAX kernel's envelope
            assert port == "kernel", (B, N, M, C, k)
        elif jax_route == "stream" and C == 3 and k <= tcommon.STREAM_MAX_K:
            assert port == "stream", (B, N, M, C, k)
        else:
            # a JAX kernel the port lacks: its route off the accelerator
            assert port == _jax_knn(B, N, M, k, C, False), (B, N, M, C, k)
            assert port != "kernel"


@pytest.mark.parametrize("B,N,M,want", [(16, 2048, 2048, "dense"),
                                        (16, 2049, 2048, "chunked"),
                                        (4, 4096, 4096, "dense"),
                                        (2, 4097, 4097, "dense"),
                                        (4, 4097, 4097, "chunked")])
def test_plain_routes_switch_at_64_mi_elements(knn_stubs, B, N, M, want):
    # at B N M = 2^26 the dense matrix, above it query chunks, where the
    # port has no kernel (4-D points; k = 33 above M = 4096, past the
    # streamed kernel's lists; the 1-NN of 4-D points); 3-D points at
    # M <= 4096 take the kernel at k = 33 and above M = 4096 stream at
    # k <= 32, as on the JAX package's accelerator
    assert _jax_knn(B, N, M, 33, 3, False, same=False) == want
    assert _jax_knn(B, N, M, 33, 4, False, same=False) == want
    assert tcommon.knn_route(B, N, M, 4, 33) == want
    if M <= tcommon.KERNEL_MAX_M:
        assert tcommon.knn_route(B, N, M, 3, 33) == "kernel"
    else:
        assert tcommon.knn_route(B, N, M, 3, 33) == want
    if M > tcommon.KERNEL_MAX_M:
        assert tcommon.knn_route(B, N, M, 3, 20) == "stream"
        with pallas_override(False):
            assert _taken(lambda: jcommon.nn1(jnp.zeros((B, N, 4)),
                                              jnp.zeros((B, M, 4)))) == want
        assert tcommon.nn1_route(B, N, M, 4) == want
        assert tcommon.nn1_route(B, N, M) == "stream"


@pytest.mark.parametrize("M", [1, 717, 1024, 1025, 1433, 4096, 4097])
@pytest.mark.parametrize("prefer_dense", [False, True])
def test_nn1_route_follows_the_jax_rule(knn_stubs, M, prefer_dense):
    src, tgt = jnp.zeros((2, 300, 3)), jnp.zeros((2, M, 3))
    with pallas_override(True):
        jax_route = _taken(lambda: jcommon.nn1(src, tgt,
                                               prefer_dense=prefer_dense))
    assert tcommon.nn1_route(2, 300, M, 3, prefer_dense) == jax_route
    # points of another width take the JAX package's plain route
    with pallas_override(False):
        plain = _taken(lambda: jcommon.nn1(jnp.zeros((2, 300, 4)),
                                           jnp.zeros((2, M, 4)),
                                           prefer_dense=prefer_dense))
    assert tcommon.nn1_route(2, 300, M, 4, prefer_dense) == plain


# ----------------------------------------------------------------- the EM

EM_KS = [16, 128, 100, 129, 256]
EM_NS = NS + [2867, 2868, 3072, 3073, 5734, 5735, 11600, 11601]
# the wide forms (K > 256): K at each form's edges and the top of the JAX
# bound (N K 20 B <= 14 MiB); N at the bound's edge of each of them (717 at
# K = 1023, 716 at 1024 and 1025, 857 at 856, 1430 at 513, 1433 at 512,
# 1911 at 384, 2856 at 257) and one past it, and a small cloud
EM_WIDE_KS = [257, 384, 512, 513, 856, 1023, 1024, 1025]
EM_WIDE_NS = [100, 716, 717, 718, 857, 858, 1430, 1431, 1433, 1434, 1911,
              1912, 2856, 2857]


def _jax_em_route(monkeypatch, N, K):
    _stub(monkeypatch, jpallas_em, "sinkhorn_em", "kernel")
    _stub(monkeypatch, jgmm, "_em_jnp", "plain")
    xyz = jnp.zeros((1, N, 3))
    with pallas_override(True):
        return _taken(lambda: jgmm.wkeans_plus(
            xyz, jnp.zeros((1, N, 4)), jnp.ones((1, N)), K,
            init_nodes=jnp.zeros((1, K, 3))))


@pytest.mark.parametrize("N,K", [(N, K) for K in EM_KS for N in EM_NS]
                         + [(N, K) for K in EM_WIDE_KS for N in EM_WIDE_NS])
def test_em_route_follows_the_jax_rule(monkeypatch, N, K):
    jax_route = _jax_em_route(monkeypatch, N, K)
    want = "kernel" if jax_route == "kernel" and cuda_em.kernel_takes(N, K) \
        else "plain"
    assert em_route(N, K) == want
    # the port's kernel covers the JAX kernel's envelope at K <= 256 (a
    # cluster of 16 blocks a cloud where 8 do not hold the plan) and at
    # K <= min(N, 1024); what stays plain is K > 1024, and K > N at
    # K >= 897 where the plan does not fit (test_em_route_stays_plain_...)
    if jax_route == "kernel" and (K <= 256 or K <= min(N, 1024)):
        assert want == "kernel"
    if jax_route == "kernel" and want == "plain":
        assert K > 1024 or (N < K and K >= 897)


@pytest.mark.parametrize("N,K", [(716, 1025), (100, 1025), (817, 897),
                                 (721, 1018)])
def test_em_route_stays_plain_past_the_kernel(monkeypatch, N, K):
    # the departures from the JAX rule: K past 1024 (the JAX kernel takes
    # any K in its bound), and K > N pairs whose slab of the plan does not
    # fit a cluster of 16 blocks beside 11 vectors of 1024 columns
    assert _jax_em_route(monkeypatch, N, K) == "kernel"
    assert em_route(N, K) == "plain" and not cuda_em.kernel_takes(N, K)


# -------------------------------------------------------------- the DGCNN

@pytest.fixture(scope="module")
def dgcnn_variables():
    jm = jdgcnn.DGCNN(emb_dims=64, k=20)
    with pallas_override(False):
        return jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 3)),
                       train=False)


@pytest.mark.parametrize("N", NS + [20, 16])
@pytest.mark.parametrize("k", KS + [4, 12, 32])
@pytest.mark.parametrize("train,fused_train", [(False, None), (True, None),
                                               (True, True), (True, False)])
def test_dgcnn_route_follows_the_jax_rule(monkeypatch, dgcnn_variables, N, k,
                                          train, fused_train):
    _stub(monkeypatch, jpallas_dgcnn, "dgcnn_eval_pallas", "fused")
    _stub(monkeypatch, jdgcnn_train, "dgcnn_train_fused", "fused")
    _stub(monkeypatch, jdgcnn, "knn", "unfused")
    jm = jdgcnn.DGCNN(emb_dims=64, k=k, fused_train=fused_train)
    x = jnp.zeros((1, N, 3))
    with pallas_override(True):
        jax_route = _taken(lambda: jm.apply(dgcnn_variables, x, train=train,
                                            mutable=["batch_stats"]))
    port = fused_route(N, k, train, False, fused_train is not False)
    # the port's kernels take every 1 <= k <= N <= 1024, k = 33 too (a
    # forced JAX fused_train=True runs its custom VJP at any N); elsewhere
    # the JAX package's unfused route; at k <= N <= 1024 the JAX rule itself
    assert port == (jax_route == "fused" and k <= N <= KERNEL_MAX_N)
    if k <= N <= KERNEL_MAX_N:
        assert port == (jax_route == "fused")
    # a given graph always takes the unfused route in the port
    assert not fused_route(N, k, train, True, fused_train is not False)


def test_the_kernels_take_the_modelnet_and_the_c1_graphs():
    # a stage launch takes 1 to 32 neighbours a point; above, the chain runs
    # in chunks of them
    assert set(CHUNK_KS) == set(range(1, 33))
    # one envelope for both eval kernels and both routes: every k >= 1
    # (k = 33 and the DGCNN authors' k = 40 too), emb a multiple of 64
    assert all(kernel_takes(k, emb) for k in (*range(1, 33), 33, 40, 64, 1024)
               for emb in (64, 512))
    assert kernel_takes(33, 64) and kernel_takes(33, 512)
    assert not any(kernel_takes(k, emb) for k, emb in
                   ((20, 96), (20, 32), (33, 96), (20, 0), (0, 64)))


# the faults C.2 and C.3: where the JAX package runs its eval or edges
# kernel at a k or emb the port's kernels do not take, the port takes the
# unfused chain, which computes the same function; held against the JAX
# forward on its plain route at the float32 bar of tests/test_torch_dgcnn.py
# (rtol 1e-4, atol 2e-5)

def _dgcnn_pair(monkeypatch, emb, k, N, seed):
    """A JAX DGCNN and the port's with the same weights and statistics, the
    port's kernel wrappers stubbed so that a call shows as a route."""
    x = clouds(seed, B=1, N=N, scale=0.4)
    jm = jdgcnn.DGCNN(emb_dims=emb, k=k, fused=False)
    with pallas_override(False):
        v = randomise_stats(jm.init(jax.random.PRNGKey(seed),
                                    jnp.asarray(x[:, :64]), train=False), seed)
    tm = tdgcnn.DGCNN(emb, k, fused_edges=True)
    plain = to_plain(v)
    tm.load_state_dict({**{a: t(b) for a, b in plain["params"].items()},
                        **{a: t(b) for a, b in plain["batch_stats"].items()}},
                       strict=True)
    _stub(monkeypatch, tdgcnn, "dgcnn_eval", "fused")
    _stub(monkeypatch, tdgcnn, "dgcnn_edges", "edges")
    return x, v, tm.eval()


@pytest.mark.parametrize("emb", [96, 32])
def test_c2_eval_at_an_emb_the_kernel_does_not_take(monkeypatch,
                                                    dgcnn_variables, emb):
    _stub(monkeypatch, jpallas_dgcnn, "dgcnn_eval_pallas", "fused")
    with pallas_override(True):
        jax_route = _taken(lambda: jdgcnn.DGCNN(emb_dims=64, k=20).apply(
            dgcnn_variables, jnp.zeros((1, 717, 3)), train=False))
    # the JAX rule fuses every eval at N <= 1024 without a graph, at any
    # emb (its own variables at emb 64 show the rule; emb enters no branch)
    assert jax_route == "fused"
    assert fused_route(717, 20, False, False, emb=64)
    assert not fused_route(717, 20, False, False, emb=emb)
    # training's fused route (graph_stage1 and the products) takes any emb
    assert fused_route(717, 20, True, False, emb=emb)
    x, v, tm = _dgcnn_pair(monkeypatch, emb, 20, 717, 4)
    with torch.no_grad():
        got = tm(t(x))                   # neither stub raised: unfused
    with pallas_override(False):
        want = jdgcnn.DGCNN(emb_dims=emb, k=20, fused=False).apply(
            v, jnp.asarray(x), train=False)
    assert got.shape == (1, 717, emb)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=2e-5)


@pytest.mark.parametrize("k,emb", [(33, 64), (20, 96)])
def test_c3_fused_edges_where_the_kernel_does_not_take_k_or_emb(
        monkeypatch, dgcnn_variables, k, emb):
    # the edges kernel takes any k (above 32 its stage chain runs in
    # chunks), so k = 33 takes it, as the JAX kernel does; emb 96 it does
    # not take, and the unfused chain runs
    _stub(monkeypatch, jpallas_dgcnn, "dgcnn_eval_pallas", "fused")
    _stub(monkeypatch, jpallas_dgcnn, "dgcnn_edges_pallas", "edges")
    graph = jnp.zeros((1, 1100, 20), jnp.int32)
    with pallas_override(True):
        jax_route = _taken(lambda: jdgcnn.DGCNN(
            emb_dims=64, k=20, fused_edges=True).apply(
                dgcnn_variables, jnp.zeros((1, 1100, 3)), train=False,
                nbr_idx=graph))
    # the JAX package runs its edges kernel at any k and emb
    assert jax_route == "edges"
    assert edges_route(1100, False, True, True, k=20, emb=64)
    takes = emb % 64 == 0
    assert edges_route(1100, False, True, True, k=k, emb=emb) == takes
    # the refusals stay where the JAX package refuses, whatever k and emb
    for train, have_graph in ((True, True), (False, False)):
        with pytest.raises(ValueError, match="fused_edges=True needs"):
            edges_route(1100, train, have_graph, True, k=k, emb=emb)
    x, v, tm = _dgcnn_pair(monkeypatch, emb, k, 1100, 5)
    idx = np.asarray(jcommon.knn(jnp.asarray(x), jnp.asarray(x), k,
                                 use_pallas=False)).astype(np.int64)
    if takes:
        assert _taken(lambda: tm(t(x), nbr_idx=torch.from_numpy(idx))) == "edges"
        # the edges kernel's plain version on the CPU
        monkeypatch.setattr(tdgcnn, "dgcnn_edges", cuda_dgcnn.dgcnn_edges)
    with torch.no_grad():
        got = tm(t(x), nbr_idx=torch.from_numpy(idx))   # edges or unfused
    with pallas_override(False):
        want = jdgcnn.DGCNN(emb_dims=emb, k=k, fused=False).apply(
            v, jnp.asarray(x), train=False, nbr_idx=jnp.asarray(idx))
    assert got.shape == (1, 1100, emb)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=2e-5)


# ------------------------------------------------- the position encoding

@pytest.fixture(scope="module")
def posenc_variables():
    pe = jattention.PositionEncoding(32)
    with pallas_override(False):
        return pe.init(jax.random.PRNGKey(0), jnp.zeros((1, 40, 3)), 5, False,
                       alpha=jnp.zeros((1, 40, 5)))


@pytest.mark.parametrize("N", NS + [5])
@pytest.mark.parametrize("k", [5, 20, 33])
@pytest.mark.parametrize("have_alpha,have_graph", [(False, False),
                                                   (False, True),
                                                   (True, False)])
def test_angle_route_follows_the_jax_rule(monkeypatch, posenc_variables, N, k,
                                          have_alpha, have_graph):
    _stub(monkeypatch, jpallas_knn, "posenc_angles_pallas", "kernel")
    _stub(monkeypatch, jattention, "knn", "knn")
    _stub(monkeypatch, jattention, "gather_neighbors", "graph")
    pe = jattention.PositionEncoding(32)
    x = jnp.zeros((1, N, 3))
    alpha = jnp.zeros((1, N, k)) if have_alpha else None
    graph = jnp.zeros((1, N, k), jnp.int32) if have_graph else None
    with pallas_override(True):
        jax_route = _taken(lambda: pe.apply(posenc_variables, x, k, False,
                                            nbr_idx=graph, alpha=alpha)) \
            or "given"
    port = angle_route(N, k, have_alpha, have_graph)
    # the port's angle kernel keeps its register lists: k <= 32
    assert cuda_posenc.KERNEL_MAX_K == 32
    if jax_route == "kernel" and not (k <= 32 and k <= N):
        assert port == "knn"
    else:
        assert port == jax_route


# ------------------------------------------------------ the shared graph

@pytest.mark.parametrize("N", NS + [717])
def test_the_graph_is_shared_above_the_fused_envelope(N):
    # ogmm_tpu/nn/gmmreg.py:154: share_graph = N > 1024 and pos_k <= gnn_k
    # (GMMReg of either package refuses pos_k > gnn_k)
    assert tgmmreg.share_graph(N) == (N > 1024)


# ------------------------------------------------ the large-cloud routes

@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("k", KS)
def test_vspace_route_follows_the_jax_rule(monkeypatch, N, k):
    # ogmm_tpu/ops/common.py:217-243: the Morton-sorted graph above N = 4096
    _stub(monkeypatch, jpallas_stream, "knn_self_vspace", "vspace")
    _stub(monkeypatch, jcommon, "knn", "knn")
    x = jnp.zeros((1, N, 3))
    with pallas_override(True):
        jax_route = _taken(lambda: jcommon.knn_self_vspace(x, k))
    port = tcommon.vspace_route(N, 3, k)
    assert port == (jax_route == "vspace" and k <= tcommon.STREAM_MAX_K)
    assert not tcommon.vspace_route(N, 6, k)


@pytest.mark.parametrize("M", [4096, 4097])
def test_icp_route_follows_the_jax_rule(knn_stubs, M):
    # ogmm_tpu/ops/icp.py:133-161: the spatial route (sorted clouds, the
    # culled and gated nn1_stream) above M = 4096
    src, tgt = jnp.zeros((1, 300, 3)), jnp.zeros((1, M, 3))
    init = jnp.broadcast_to(jnp.eye(4), (1, 4, 4))
    with pallas_override(True):
        jax_route = _taken(lambda: jicp(src, tgt, init, 0.1, max_iter=1))
    assert jax_route == ("stream" if M > 4096 else "kernel")
    assert tcommon.nn1_route(1, 300, M, 3, prefer_dense=True) == jax_route


@pytest.mark.parametrize("M,method,switch,want", [
    (4096, "horn_pi", True, "kernel"), (1, "horn_pi", True, "kernel"),
    (4097, "horn_pi", True, "stream"), (4096, "horn", True, "nn1"),
    (4096, "horn_pi", False, "nn1"), (717, "horn_pi", True, "kernel"),
    (717, "horn_pi", False, "nn1")])
def test_icp_kernel_takes_m_up_to_4096(monkeypatch, M, method, switch, want):
    # with use_kernel the whole-loop kernel takes the 'horn_pi' refinement
    # up to M = 4096 (the target in shared memory); the JAX package's
    # icp_pallas has no route rule of its own (ogmm_tpu/ops/icp.py:144-148)
    _stub(monkeypatch, cuda_icp, "icp_fused", "kernel")
    _stub(monkeypatch, ticp.cuda_stream, "nn1_stream", "stream")
    _stub(monkeypatch, ticp, "nn1", "nn1")      # the dense or kernel 1-NN
    src, tgt = torch.zeros(1, 8, 3), torch.zeros(1, M, 3)
    init = torch.eye(4).expand(1, 4, 4)
    got = _taken(lambda: ticp.icp_point_to_point(src, tgt, init, 0.1,
                                                 max_iter=1, method=method,
                                                 use_kernel=switch))
    assert got == want
    assert cuda_icp.kernel_takes(M, 3, method, 8) == (M <= 4096 and method == "horn_pi")
    assert not cuda_icp.kernel_takes(M, 6, method, 8)


@pytest.mark.parametrize("N", [717, 1024, 1025])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("channels", [(128, 64), (128, 128, 64)])
@pytest.mark.parametrize("ndim", [3, 4])
def test_pointmlp_fused_route_follows_the_jax_rule(monkeypatch, N, train,
                                                   channels, ndim):
    # ogmm_tpu/nn/layers.py:124-131 with fuse_eval=True on its accelerator
    _stub(monkeypatch, jpallas_mlp, "pointmlp_eval_pallas", "kernel")
    shape = (1, N, 64) if ndim == 3 else (1, 2, N, 64)
    x = jnp.zeros(shape)
    jm = JPointMLP(channels, fuse_eval=True)
    v = jm.init(jax.random.PRNGKey(0), x[..., :4, :])
    with pallas_override(True):
        jax_route = _taken(lambda: jm.apply(v, x, train=train)) or "layers"
    port = cuda_mlp.mlp_route(True, train, shape, channels, torch.bfloat16)
    assert port == (jax_route == "kernel")
    assert not cuda_mlp.mlp_route(False, train, shape, channels, torch.bfloat16)


@pytest.mark.parametrize("channels,dtype,want", [
    ((128, 64), torch.float32, True), ((64, 32), torch.bfloat16, False),
    ((96, 64), torch.bfloat16, False), ((128, 64), torch.float16, False)])
def test_the_fused_mlp_takes_the_kernel_where_it_takes_the_widths(channels,
                                                                  dtype, want):
    # the JAX kernel takes any width; where the port's does not (Cin, H and
    # Cout multiples of 64, bf16 or float32), the layer chain runs instead
    assert cuda_mlp.mlp_route(True, False, (2, 90, 64), channels, dtype) == want


def _overlap_cfg(overlap_stream=None):
    return JModelConfig(emb_dims=32, n_clusters=4, km_clusters=4, num_heads=2,
                        gnn_k=6, pos_k=4, em_iters=1, sinkhorn_iters=1,
                        overlap_stream=overlap_stream)


@pytest.fixture(scope="module")
def gmmreg_variables():
    # the parameters do not depend on the point count or the head's route
    x = jnp.asarray(np.random.RandomState(0).randn(1, 40, 3), jnp.float32)
    with pallas_override(False):
        return jgmmreg.GMMReg(cfg=_overlap_cfg(False)).init(
            {"params": jax.random.PRNGKey(0)}, x, x, train=False)


@pytest.mark.parametrize("N,overlap_stream", [(40, None), (48, None),
                                              (40, True), (48, False)])
def test_overlap_route_follows_the_jax_rule(monkeypatch, gmmreg_variables, N,
                                            overlap_stream):
    # ogmm_tpu/nn/gmmreg.py:141-144, with the 2^26 threshold of both
    # packages lowered to 2,000 elements so that a small forward crosses it
    # (B N N = 1,600 and 2,304)
    assert tcommon.DENSE_ELEMS == jcommon._DENSE_ELEMS == 2 ** 26
    monkeypatch.setattr(jcommon, "_DENSE_ELEMS", 2000)
    monkeypatch.setattr(tgmmreg, "DENSE_ELEMS", 2000)
    _stub(monkeypatch, jgmmreg, "_overlap_wproject", "stream")
    # the clustering comes right after the head: stop there
    _stub(monkeypatch, jgmmreg, "wkeans_plus", "dense")
    x = jnp.asarray(np.random.RandomState(1).randn(1, N, 3), jnp.float32)
    with pallas_override(False):
        jax_route = _taken(lambda: jgmmreg.GMMReg(
            cfg=_overlap_cfg(overlap_stream)).apply(gmmreg_variables, x, x,
                                                    train=False))
    port = tgmmreg.overlap_route(1, N, N, 32, torch.float32, overlap_stream)
    assert port == jax_route


@pytest.mark.parametrize("D,dtype,want", [(512, torch.bfloat16, "stream"),
                                          (32, torch.bfloat16, "chunked"),
                                          (32, torch.float32, "stream"),
                                          (48, torch.float32, "chunked")])
def test_the_streamed_head_takes_the_kernel_where_it_takes_the_width(D, dtype,
                                                                    want):
    # the JAX package's kernel takes any D; where the port's does not, its
    # plain version (the JAX package's wproject_chunked) streams instead
    assert tgmmreg.overlap_route(1, 50, 50, D, dtype, True) == want


def test_overlap_streams_above_64_mi_elements():
    route = lambda *a: tgmmreg.overlap_route(*a, 512, torch.bfloat16, None)
    assert route(1, 8192, 8192) == "dense"
    assert route(1, 8193, 8192) == route(1, 35000, 35000) == "stream"
    assert tgmmreg.overlap_route(1, 35000, 35000, 512, torch.bfloat16,
                                 False) == "dense"


@pytest.mark.parametrize("N", [1024, 1025])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("have_graph", [False, True])
def test_edges_route_follows_the_jax_rule(monkeypatch, dgcnn_variables, N,
                                          train, have_graph):
    # ogmm_tpu/nn/dgcnn.py:146-197 with dgcnn_fused_edges=True
    _stub(monkeypatch, jpallas_dgcnn, "dgcnn_eval_pallas", "fused")
    _stub(monkeypatch, jpallas_dgcnn, "dgcnn_edges_pallas", "edges")
    _stub(monkeypatch, jdgcnn_train, "dgcnn_train_fused", "fused")
    _stub(monkeypatch, jdgcnn, "knn", "unfused")
    jm = jdgcnn.DGCNN(emb_dims=64, k=20, fused_edges=True)
    x = jnp.zeros((1, N, 3))
    graph = jnp.zeros((1, N, 20), jnp.int32) if have_graph else None

    def jax_call():
        try:
            return _taken(lambda: jm.apply(dgcnn_variables, x, train=train,
                                           nbr_idx=graph,
                                           mutable=["batch_stats"]))
        except ValueError:
            return "raise"

    with pallas_override(True):
        jax_route = jax_call() or "unfused"
    try:
        fused = fused_route(N, 20, train, have_graph)
        if (train or not fused) and edges_route(N, train, have_graph, True):
            port = "edges"
        else:
            port = "fused" if fused else "unfused"
    except ValueError:
        port = "raise"
    if jax_route == "fused" and not train and have_graph:
        # the JAX eval kernel ignores a given graph; the port's fused route
        # never takes one (GMMReg gives one only above N = 1024)
        assert port == "unfused"
    else:
        assert port == jax_route


# -------------------------------------------- under a process group

SENTINEL = object()          # a group the pure route rules only compare to None


def _in_shard_map(fn, *args):
    """fn(*args) inside a shard_map over the one-device mesh 'sp' (the JAX
    package's point-sharded context), args sharded on axis 1."""
    from jax.sharding import PartitionSpec as P
    specs = tuple(P(None, "sp") for _ in args)
    return jax.shard_map(fn, mesh=jsp_mesh(1), in_specs=specs,
                         out_specs=P(), check_vma=False)(*args)


@pytest.mark.parametrize("N,K", [(717, 128), (1024, 16), (4097, 16)])
def test_em_route_under_a_group_follows_the_jax_rule(monkeypatch, N, K):
    # ogmm_tpu/ops/gmm.py:163-170, :186-190: with axis_name the jnp EM, and
    # a forced kernel raises
    _stub(monkeypatch, jpallas_em, "sinkhorn_em", "kernel")
    _stub(monkeypatch, jgmm, "_em_jnp", "plain")
    nodes = jnp.zeros((1, K, 3))
    run = lambda use: lambda x, f, o: jgmm.wkeans_plus(
        x, f, o, K, init_nodes=nodes, axis_name="sp", use_pallas=use)
    args = (jnp.zeros((1, N, 3)), jnp.zeros((1, N, 4)), jnp.ones((1, N)))
    with pallas_override(True):
        assert _taken(lambda: _in_shard_map(run(None), *args)) == "plain"
        with pytest.raises(ValueError, match="use_pallas"):
            _in_shard_map(run(True), *args)
    assert em_route(N, K, SENTINEL) == "plain"
    from ogmm_tpu_torch.ops.gmm import wkeans_plus
    with pytest.raises(ValueError, match="em_kernel"):
        wkeans_plus(torch.zeros(1, N, 3), torch.zeros(1, N, 4),
                    torch.ones(1, N), K, init_nodes=torch.zeros(1, K, 3),
                    em_kernel=True, group=SENTINEL)


@pytest.mark.parametrize("N", [717, 1024])
def test_pointmlp_route_under_a_group_follows_the_jax_rule(monkeypatch, N):
    # ogmm_tpu/nn/layers.py:124-126: sp_axis keeps the layer chain
    _stub(monkeypatch, jpallas_mlp, "pointmlp_eval_pallas", "kernel")
    channels = (128, 64)
    jm = JPointMLP(channels, fuse_eval=True, sp_axis="sp")
    v = JPointMLP(channels).init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 64)))
    x = jnp.zeros((1, N, 64))
    with pallas_override(True):
        jax_route = _taken(lambda: _in_shard_map(
            lambda a: jm.apply(v, a, train=False).sum(), x)) or "layers"
    assert jax_route == "layers"
    shape = (1, N, 64)
    assert cuda_mlp.mlp_route(True, False, shape, channels, torch.bfloat16)
    assert not cuda_mlp.mlp_route(True, False, shape, channels,
                                  torch.bfloat16, SENTINEL)


@pytest.mark.parametrize("world", [1, 2])
def test_backward_kernels_under_a_group_follow_the_jax_rule(monkeypatch,
                                                            world):
    # ogmm_tpu/nn/dgcnn.py:209-217: the fused training path cannot reduce
    # its BN moments over replicas, and forcing it with bn_axis_name raises
    from ogmm_tpu.nn.dgcnn import DGCNN as JDGCNN
    from ogmm_tpu_torch.ops import dgcnn_train as tdgcnn_train
    from ogmm_tpu_torch.parallel import comm
    jm = JDGCNN(k=20, bn_axis_name="dp", fused_train=True)
    with pytest.raises(ValueError, match="bn_axis_name"):
        jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 3)), train=True)
    monkeypatch.setattr(comm, "axis_size",
                        lambda g: 1 if g is None else world)
    assert tdgcnn_train.bwd_kernels_take(20, 717)
    assert tdgcnn_train.bwd_kernels_take(20, 717, SENTINEL) == (world == 1)
    monkeypatch.setattr(tdgcnn_train, "BWD_KERNELS", True)
    x = torch.zeros(1, 32, 3)
    if world > 1:
        with pytest.raises(ValueError, match="BWD_KERNELS"):
            tdgcnn_train.dgcnn_train(x, [], [], [], group=SENTINEL)


def _jax_bwd_route(monkeypatch, k, N):
    """The route the JAX custom VJP (`ogmm_tpu/ops/dgcnn_train.py:_bwd_vjp`)
    takes for stages 4..1 with `_BWD_PALLAS` on, on the accelerator's rule:
    "kernels" (`_bwd_pallas`) or "plain" (the jnp mirror, whose first call
    of its own is `_max_vjp`), observed on zero residuals of one cloud of N
    points over a graph of k neighbours (traced with `jax.eval_shape`: the
    rule reads shapes only)."""
    _stub(monkeypatch, jdgcnn_train, "_bwd_pallas", "kernels")
    _stub(monkeypatch, jdgcnn_train, "_max_vjp", "plain")
    monkeypatch.setattr(jdgcnn_train, "_BWD_PALLAS", True)
    emb, dims = 8, (64, 64, 128, 256)
    z = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    ws = [z(6, 64), z(64, 64), z(64, 128), z(128, 256), z(512, emb)]
    res = (z(1, N, 3), jax.ShapeDtypeStruct((1, N, k), jnp.int32), z(1, k, N, 6),
           tuple(z(1, k, N, c) for c in dims), z(1, N, emb),
           tuple(z(1, N, c) for c in dims), tuple(ws),
           tuple(z(c) for c in (*dims, emb)), tuple(z(c) for c in (*dims, emb)),
           tuple((z(c), z(c)) for c in (*dims, emb)))
    with pallas_override(True), pytest.raises(Taken) as taken:
        jax.eval_shape(lambda r, d: jdgcnn_train._bwd_vjp(k, jnp.float32, 0, r,
                                                          (d, None, None)),
                       res, z(1, N, emb))
    return str(taken.value)


@pytest.mark.parametrize("N", ["k", 717, 1024, 1025])
@pytest.mark.parametrize("k", list(range(1, 34)))
def test_backward_kernels_follow_the_jax_rule(monkeypatch, k, N):
    # the JAX package sends stages 4..1 through its three backward kernels
    # at any k whenever N <= 1024; the port's kernels take 1 <= k <= 32
    # (k <= N, their row classes): k = 33 is the port's named departure and
    # takes the plain backward, while graph_stage1, the forward's graph
    # kernel, takes it as the JAX rule does
    from ogmm_tpu_torch.ops import dgcnn_train as tdgcnn_train
    from ogmm_tpu_torch.ops.cuda_dgcnn_train import graph_takes
    N = k if N == "k" else N
    jax_route = _jax_bwd_route(monkeypatch, k, N)
    assert jax_route == ("kernels" if N <= 1024 else "plain")
    port = tdgcnn_train.bwd_kernels_take(k, N)
    assert port == (jax_route == "kernels" and k <= 32)
    # the graph kernel's envelope is the JAX rule's; the backward's is it
    # cut at 32
    assert graph_takes(k, N) == (jax_route == "kernels" and k <= N)
    assert port == (graph_takes(k, N) and k <= 32)


@pytest.mark.parametrize("k", [33, 40, 1024])
def test_the_kernels_that_stay_at_32(monkeypatch, knn_stubs, k):
    # above k = 32 the JAX package runs a kernel where the port runs plain:
    # the backward kernels (rows 5-7, their row classes), the streamed kNN
    # (row 11, its register lists, STREAM_MAX_K) and the angles (row 9, its
    # lists); rows 1, 3, 8 and 10 take the same k
    from ogmm_tpu_torch.ops import dgcnn_train as tdgcnn_train
    from ogmm_tpu_torch.ops.cuda_dgcnn_train import graph_takes
    assert _jax_bwd_route(monkeypatch, k, 1024) == "kernels"
    assert graph_takes(k, 1024) and not tdgcnn_train.bwd_kernels_take(k, 1024)
    # row 11: the streamed route above M = 4096 (3-D points), the
    # Morton-sorted graph above N = 4096
    assert _jax_knn(1, 4097, 4097, k, 3, True) == "stream"
    assert tcommon.knn_route(1, 4097, 4097, 3, k) == _jax_knn(1, 4097, 4097, k, 3, False)
    assert tcommon.knn_route(1, 4097, 4097, 3, k) not in ("kernel", "stream")
    assert k > tcommon.STREAM_MAX_K and not tcommon.vspace_route(4097, 3, k)
    # row 8 takes every k <= M <= 4096
    assert _jax_knn(1, 1024, 4096, k, 3, True, same=False) == "kernel"
    assert tcommon.knn_route(1, 1024, 4096, 3, k) == "kernel"
    # row 9: the angle kernel's own limit
    assert angle_route(1024, k, False, False) == "knn"
    with pytest.raises(ValueError, match="posenc_angles kernel takes"):
        cuda_posenc.posenc_plan(1, 1024, k)
    # rows 1 and 10 take it
    assert fused_route(1024, k, False, False) and fused_route(1024, k, True, False)
    assert edges_route(4097, False, True, True, k=k, emb=512)
