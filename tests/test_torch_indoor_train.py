"""One indoor train step of the port with the streamed overlap head
(`overlap_stream=True`: `ops/stream.py:wproject`, its gradient the chunked
recompute `wproject_bwd`) against the JAX package's train step on the CPU,
at the sizes of tests/test_torch_indoor.py (B = 1, N = 4,300: the
Morton-sorted v-space graph and the streamed 1-NN engage by shape; its
WIDTHS), and against the port's own dense head, which is exact below
B N N = 64 Mi elements.

The JAX side runs its plain routes (`pallas_override(False)`: its head is
`wproject_chunked`, differentiated by JAX), is handed the port's kNN graph
(tests/test_torch_indoor.py:_port_graph), and takes its gradients eagerly
(`jax.value_and_grad`; ROADMAP.md C, "Jitted JAX gradients").

Tolerances. Against the port's dense head, those of tests/test_torch_large_n.py:
the loss to 1e-4 relative, every gradient to 2e-4 relative (or, where zero
in exact arithmetic, below 1e-6 of the largest); the two heads differ by
4.5e-6 at most. Against JAX the loss and the running statistics keep those
bars (measured 3e-7 on the loss), but the gradients of one step at this size
cannot meet 2e-4: the step is piecewise smooth (max over k neighbours,
LeakyReLU and ReLU), and the two packages' float32 forwards, 4e-6 apart,
take other branches at elements within round-off of a kink. Measured on
this batch: the port against JAX 5.5e-4 over all gradients, at most 1.2e-3
for a gradient of at least 1% of the largest; the port against itself with
every weight moved by 1e-7 of its value, 4.4e-4 and 1e-3 (the dense head
gives the same figures against JAX, so the streamed head adds nothing).
The bars are four times those: 2e-3 over all gradients, 5e-3 for each
gradient of at least 1% of the largest, and for the smaller ones (the
overlap heads' and the biases) 5e-5 of the largest gradient."""
import dataclasses

import numpy as np
import pytest
import torch

import ogmm_tpu.nn.attention as jattention
import ogmm_tpu.nn.dgcnn as jdgcnn
from ogmm_tpu import configs as jconfigs
from ogmm_tpu.ops import common as jcommon
from ogmm_tpu_torch import configs as tconfigs
from ogmm_tpu_torch.nn import gmmreg as tgmmreg
from ogmm_tpu_torch.train import create_train_state, train_loss
from ogmm_tpu_torch.weights import convert_variables, flat_variables

from test_torch_indoor import WIDTHS, _port_graph
from test_torch_large_n import _jax_step, _rel

B, N = 1, 4300


def _batch(seed):
    """A noisy height field and a rigid copy (25 degrees about a tilted
    axis, shifted, permuted); 0/1 overlap labels."""
    from scipy.spatial.transform import Rotation
    rs = np.random.RandomState(seed)
    u = rs.rand(B, N, 2)
    z = 0.3 * np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    src = (np.concatenate([u, z], -1) + 0.01 * rs.randn(B, N, 3)).astype(np.float32)
    R = Rotation.from_rotvec([[0.2, 0.3, 0.35]] * B).as_matrix().astype(np.float32)
    tr = np.array([[0.1, -0.05, 0.02]] * B, np.float32)
    tgt = (np.einsum("bij,bnj->bni", R, src) + tr[:, None])[:, rs.permutation(N)]
    return {"src_xyz": src, "tgt_xyz": tgt.astype(np.float32),
            "src_overlap": (rs.rand(B, N) < 0.8).astype(np.float32),
            "tgt_overlap": (rs.rand(B, N) < 0.8).astype(np.float32),
            "transform_gt": np.concatenate([R, tr[:, :, None]], -1)}


def _configs(**model):
    jc = jconfigs.indoor()
    jc = jc.replace(model=dataclasses.replace(jc.model, **WIDTHS, **model))
    tc = tconfigs.indoor()
    return jc, tc.replace(model=dataclasses.replace(tc.model, **WIDTHS, **model))


@pytest.fixture(scope="module")
def jax_step():
    """The JAX package's loss, gradients and running statistics of one step
    with its streamed head, and the variables it started from."""
    jc, _ = _configs(overlap_stream=True)
    batch = _batch(0)
    with pytest.MonkeyPatch.context() as mp:
        for module in (jcommon, jdgcnn, jattention):
            mp.setattr(module, "knn", _port_graph)
        _, variables, loss, grads, stats = _jax_step(jc, batch)
    return batch, variables, loss, grads, stats


def _port_step(tc, variables, batch):
    """Loss, gradients and running statistics of one port step."""
    state = create_train_state(tc, steps_per_epoch=10, device="cpu",
                               state_dict=convert_variables(variables))
    state.generator = None                   # anchors from index 0, as JAX
    loss, _ = train_loss(state, tc, batch)
    loss.backward()
    stats = {k: v for k, v in flat_variables(state.model.state_dict()).items()
             if k.startswith("batch_stats/")}
    return loss.item(), flat_variables({k: p.grad for k, p in
                                        state.model.named_parameters()}), stats


def test_streamed_head_train_step_matches_jax(jax_step, monkeypatch):
    batch, variables, jloss, jgrads, jstats = jax_step
    _, tc = _configs(overlap_stream=True)
    calls = []
    proj = tgmmreg.wproject

    def counted(*a):
        calls.append(a[3])
        return proj(*a)
    monkeypatch.setattr(tgmmreg, "wproject", counted)
    loss, grads, stats = _port_step(tc, variables, batch)
    # both directions of the head through the projection with a gradient
    assert calls == [tgmmreg.wproject_stream_lse] * 2
    np.testing.assert_allclose(loss, jloss, rtol=1e-4)
    assert set(stats) == set(jstats)
    for k in stats:
        np.testing.assert_allclose(stats[k], jstats[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert set(grads) == set(jgrads)
    scale = max(np.linalg.norm(g) for g in jgrads.values())
    total = np.sqrt(sum(np.sum((grads[k] - jgrads[k]) ** 2) for k in jgrads))
    assert total <= 2e-3 * np.sqrt(sum(np.sum(g ** 2) for g in jgrads.values()))
    bad = {}
    for k, g in jgrads.items():
        if np.linalg.norm(g) >= 1e-2 * scale:
            err, ok = _rel(grads[k], g), _rel(grads[k], g) <= 5e-3
        else:
            err = np.linalg.norm(grads[k] - g) / scale
            ok = err <= 5e-5
        if not ok:
            bad[k] = err
    assert not bad, bad


@pytest.mark.parametrize("route", ["chunked", "stream"])
def test_streamed_head_train_step_matches_the_dense_head(jax_step, route,
                                                         monkeypatch):
    # "chunked" (the plain forward where the kernel does not take D or the
    # type) and "stream" (the kernel's wrapper, its plain version here)
    # both go through the projection with a gradient
    batch, variables, _, _, _ = jax_step
    monkeypatch.setattr(tgmmreg, "wproject_takes",
                        lambda D, dt: route == "stream")
    _, tc = _configs(overlap_stream=True)
    loss, grads, _ = _port_step(tc, variables, batch)
    _, dc = _configs(overlap_stream=None)          # dense below 64 Mi
    assert tgmmreg.overlap_route(B, N, N, WIDTHS["emb_dims"], torch.float32,
                                 None) == "dense"
    dloss, dgrads, _ = _port_step(dc, variables, batch)
    np.testing.assert_allclose(loss, dloss, rtol=1e-4)
    scale = max(np.linalg.norm(g) for g in dgrads.values())
    for k, g in dgrads.items():
        if np.linalg.norm(g) < 1e-6 * scale:
            assert np.linalg.norm(grads[k]) < 1e-6 * scale, k
        else:
            assert _rel(grads[k], g) < 2e-4, k
