"""The indoor serving request of the port (`Registrar(configs.indoor(...))`)
against the JAX package on the CPU, at the widths of
tests/test_indoor_path.py (emb 32, K = 8, gnn_k = 6) and B = 1, N = 4,300,
so that the large-cloud routes engage by shape: the Morton-sorted v-space
graph (N > 4096), the streamed 1-NN of the clustering loss and of ICP's
spatial route (M > 4096), and the streamed overlap head
(`overlap_stream=True`; by size it streams above B N N = 64 Mi elements).

The JAX side runs its plain routes (`pallas_override(False)`), which it
names as its numerical reference: the original-order graph, the dense 1-NN,
`wproject_chunked`. It is handed the port's kNN graph through a host
callback: the two packages' float32 distances may order near-ties
otherwise, and at N > 4096 exact ties go to the lowest Morton-sorted
position (on a 4,300-point fragment a few rows have two neighbours at the
same float32 distance; one of them moved the position encoding of an
anchor and 27 overlap scores by up to 0.065). tests/test_torch_stream.py
holds the graphs to each other up to ties. Tolerances are those of
tests/test_torch_large_n.py: overlap scores 1e-4, pose 2e-3 (the EM of the
two packages sums in other orders).

Port-only checks at the same size: the v-space route against the
original-order control (`dgcnn_vspace=False`, 2e-5, as the JAX package's
own test), `dgcnn_fused_edges=True` against the unfused stage chain (1e-4:
BN folded into the weights or applied after the product, float32; at
emb 64, gnn_k = 8, widths the edges kernel takes), the
routes each path takes, and the training forward's refusal of the edges
kernel (its streamed head trains: tests/test_torch_indoor_train.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ogmm_tpu.nn.attention as jattention
import ogmm_tpu.nn.dgcnn as jdgcnn
from ogmm_tpu import configs as jconfigs
from ogmm_tpu.nn.gmmreg import GMMReg as JGMMReg
from ogmm_tpu.ops import common as jcommon
from ogmm_tpu.ops.dispatch import pallas_override
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch.api import Registrar
from ogmm_tpu_torch.nn import dgcnn as tdgcnn
from ogmm_tpu_torch.nn import gmmreg as tgmmreg
from ogmm_tpu_torch.nn.gmmreg import GMMReg as TGMMReg
from ogmm_tpu_torch.ops import common as tcommon
from ogmm_tpu_torch.ops import cuda_stream
from ogmm_tpu_torch.weights import convert_variables

from torch_port_util import n, randomise_stats, t, to_plain

B, N = 1, 4300
WIDTHS = dict(emb_dims=32, n_clusters=8, km_clusters=8, num_heads=2, gnn_k=6,
              pos_k=4, em_iters=2, sinkhorn_iters=3, icp_iters=2)


def _pair(seed):
    """An indoor-like fragment (a noisy height field) and a rigid copy of
    it, rotated 20 degrees, shifted and permuted."""
    rs = np.random.RandomState(seed)
    u = rs.rand(B, N, 2)
    z = 0.3 * np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    src = (np.concatenate([u, z], -1) + 0.01 * rs.randn(B, N, 3)).astype(np.float32)
    a = np.radians(20.0)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]], np.float32)
    tgt = (src @ rot.T + np.array([0.1, -0.05, 0.02], np.float32))
    return src, tgt[:, rs.permutation(N)].astype(np.float32)


def _port_graph(src, tgt, k, *_, **__):
    """The port's kNN graph inside a JAX program (a host callback): above
    N = 4096 the Morton-sorted one, where exact float32 ties go to the
    lowest sorted position (the JAX package's contract on its accelerator;
    its plain route would take the lowest original index)."""
    def host(s, g):
        x = t(s)
        return n(tcommon.knn(x, x if np.array_equal(s, g) else t(g), k)
                 ).astype(np.int32)
    return jax.pure_callback(
        host, jax.ShapeDtypeStruct(src.shape[:2] + (k,), jnp.int32), src, tgt)


def _port_cfg(**model):
    cfg = tconfigs.indoor()
    return cfg.replace(model=dataclasses.replace(cfg.model, **{**WIDTHS, **model}))


@pytest.fixture(scope="module")
def jax_request():
    """The JAX forward without and with ICP, and the variables it ran with."""
    jm = dataclasses.replace(jconfigs.indoor().model, **WIDTHS,
                             overlap_stream=True)
    model = JGMMReg(cfg=jm)
    src, tgt = _pair(0)
    with pytest.MonkeyPatch.context() as mp, pallas_override(False):
        for module in (jcommon, jdgcnn, jattention):
            mp.setattr(module, "knn", _port_graph)
        v = randomise_stats(model.init({"params": jax.random.PRNGKey(0)},
                                       jnp.asarray(src[:, :64]),
                                       jnp.asarray(tgt[:, :64]), train=False), 0)
        outs = {refine: [np.asarray(o) for o in model.apply(
            v, jnp.asarray(src), jnp.asarray(tgt), train=False,
            is_test=refine)] for refine in (False, True)}
    return convert_variables(to_plain(v)), src, tgt, outs


@pytest.mark.parametrize("refine", [False, True])
def test_indoor_request_matches_jax(jax_request, refine):
    state, src, tgt, outs = jax_request
    reg = Registrar(_port_cfg(overlap_stream=True), state_dict=state,
                    device="cpu")
    rot, trans, so, to = reg(src, tgt, refine=refine)
    jr, jt, jso, jto, _ = outs[refine]
    assert so.shape == to.shape == (B, N)
    np.testing.assert_allclose(n(so), jso, atol=1e-4)
    np.testing.assert_allclose(n(to), jto, atol=1e-4)
    np.testing.assert_allclose(n(rot), jr, atol=2e-3)
    np.testing.assert_allclose(n(trans), jt, atol=2e-3)


def _forward(state, src, tgt, refine=False, **model):
    tm = TGMMReg(_port_cfg(**model).model)
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        return tm.eval()(t(src), t(tgt), refine=refine)


def test_vspace_matches_original_order_routing(jax_request):
    # the same math in another row space: 2e-5, the bar of the JAX
    # package's own test (tests/test_indoor_path.py:90)
    state, src, tgt, _ = jax_request
    out = _forward(state, src, tgt)
    ref = _forward(state, src, tgt, dgcnn_vspace=False)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), n(b), rtol=2e-5, atol=2e-5)


# widths the edges kernel takes (`ops.cuda_dgcnn.kernel_takes`): at WIDTHS'
# gnn_k = 6 and emb 32 the port runs the unfused chain even with
# dgcnn_fused_edges=True, where the JAX package runs its edges kernel (C.3)
EDGE_WIDTHS = dict(emb_dims=64, gnn_k=8)


@pytest.fixture(scope="module")
def edges_state():
    torch.manual_seed(0)
    return TGMMReg(_port_cfg(**EDGE_WIDTHS).model).state_dict()


def test_fused_edges_matches_the_unfused_chain(jax_request, edges_state):
    _, src, tgt, _ = jax_request
    out = _forward(edges_state, src, tgt, refine=True, dgcnn_fused_edges=True,
                   **EDGE_WIDTHS)
    ref = _forward(edges_state, src, tgt, refine=True, **EDGE_WIDTHS)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-4)


@pytest.fixture
def calls(monkeypatch):
    """Counts of the calls of each kernel wrapper (their plain versions run
    on the CPU), as the launch counts on the card."""
    counts = {}

    def counted(module, name, key):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            counts[key] = counts.get(key, 0) + 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapper)

    counted(cuda_stream, "knn_stream", "knn_stream")
    counted(cuda_stream, "nn1_stream", "nn1_stream")
    counted(tgmmreg, "wproject_stream_lse", "wproject")
    counted(tdgcnn, "dgcnn_edges", "dgcnn_edges")
    return counts


@pytest.mark.parametrize("refine,edges", [(False, False), (True, True)])
def test_the_request_takes_the_streamed_routes(jax_request, edges_state, calls,
                                               refine, edges):
    state, src, tgt, _ = jax_request
    _forward(state, src, tgt, refine=refine, overlap_stream=None,
             dgcnn_fused_edges=edges)
    # one graph for the 2B stacked clouds; the head by size (B N N = 18.5 M
    # elements here, under 64 Mi): dense; the clustering loss's 1-NN and one
    # a trip of ICP; no edges kernel at gnn_k = 6, emb 32 (C.3)
    assert calls == {"knn_stream": 1, "nn1_stream": 1 + refine * WIDTHS["icp_iters"]}
    calls.clear()
    _forward(state, src, tgt, overlap_stream=True)
    assert calls == {"knn_stream": 1, "nn1_stream": 1, "wproject": 2}
    if edges:
        calls.clear()
        _forward(edges_state, src, tgt, dgcnn_fused_edges=True, **EDGE_WIDTHS)
        assert calls == {"knn_stream": 1, "nn1_stream": 1, "dgcnn_edges": 1}


def test_training_refuses_the_streamed_head_and_the_edges_kernel(calls):
    # the streamed head trains (its gradient is the chunked recompute of
    # `ops.stream.wproject`, held in tests/test_torch_indoor_train.py); the
    # edges kernel stays refused in training, as in the JAX package
    src, tgt = (a[:, :64] for a in _pair(1))
    tm = TGMMReg(_port_cfg(overlap_stream=True).model).train()
    out = tm(t(src), t(tgt))
    assert calls == {"wproject": 2}
    out[2].sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in tm.overlap.parameters())
    tm = TGMMReg(_port_cfg(dgcnn_fused_edges=True).model).train()
    with pytest.raises(ValueError, match="fused_edges=True needs eval mode"):
        tm(t(src), t(tgt))
    # eval without a graph (N <= 1024): the whole-cloud route, no refusal
    tm.eval()(t(src), t(tgt))
