"""The port's DGCNN training path (`ops/dgcnn_train.py`, the custom
autograd function, and `nn.DGCNN` in train mode) against the JAX package's
custom VJP (`dgcnn_train_fused`, forced on the CPU with `fused_train=True`):
outputs, batch moments, running statistics, the position-encoding angles,
and the gradients of every weight, BatchNorm parameter and the points."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu.nn.dgcnn import DGCNN as JDGCNN
from ogmm_tpu_torch.nn.dgcnn import DGCNN as TDGCNN

from torch_port_util import n, t

B, N, K, EMB, PK = 2, 80, 8, 64, 4


def _setup(seed, dtype, dead_channels=False, duplicates=False, k=K):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, N, 3) * 0.4).astype(np.float32)
    if duplicates:
        # coincident points: identical edge rows, so the max over k ties
        x[:, 10:20] = x[:, 20:30]
    jm = JDGCNN(emb_dims=EMB, k=k, dtype=dtype, fused=False, fused_train=True)
    v = jax.jit(lambda a: jm.init(jax.random.PRNGKey(seed), a, train=False))(
        jnp.asarray(x))
    params = {k: np.array(a) for k, a in v["params"].items()}
    stats = {k: rs.uniform(0.1, 1.0, a.shape).astype(np.float32)
             if k.endswith("var") else (rs.randn(*a.shape) * 0.1).astype(np.float32)
             for k, a in v["batch_stats"].items()}
    for i in range(1, 6):
        s = params[f"bn{i}_scale"]
        params[f"bn{i}_scale"] = (1 + 0.1 * rs.randn(*s.shape)).astype(np.float32)
        params[f"bn{i}_bias"] = (0.05 * rs.randn(*s.shape)).astype(np.float32)
        if dead_channels:
            # scale 0 and bias 0: the BN output is exactly 0 on the channel,
            # so the ReLU sees 0 (half cotangent) and the max over k ties
            params[f"bn{i}_scale"][:3] = 0.0
            params[f"bn{i}_bias"][:3] = 0.0
    wvec = rs.randn(B, N, EMB).astype(np.float32)
    return x, jm, params, stats, wvec


def _jax_side(jm, params, stats, x, wvec):
    def loss(p, xx):
        (out, alpha), mut = jm.apply({"params": p, "batch_stats": stats}, xx,
                                     train=True, mutable=["batch_stats"],
                                     with_posenc_alpha=PK)
        return (out.astype(jnp.float32) * wvec).sum(), (out, alpha, mut)
    (val, (out, alpha, mut)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return val, out, alpha, mut["batch_stats"], gp, gx


def _torch_side(params, stats, x, wvec, dtype, k=K):
    tm = TDGCNN(EMB, k, torch.bfloat16 if dtype else torch.float32)
    tm.load_state_dict({k: t(a) for k, a in {**params, **stats}.items()},
                       strict=True)
    tm.train()
    xt = t(x).requires_grad_(True)
    out, alpha = tm(xt, with_posenc_alpha=PK)
    val = (out.float() * t(wvec)).sum()
    val.backward()
    grads = {k: p.grad for k, p in tm.named_parameters()}
    return val, out, alpha, tm, grads, xt.grad


def _close(a, b, rtol, atol_frac, mismatch_frac=0.0, what=""):
    a, b = n(a), n(b)
    ok = np.isclose(a, b, rtol=rtol, atol=atol_frac * (np.abs(b).max() + 1e-12))
    assert 1.0 - ok.mean() <= mismatch_frac, (
        f"{what}: {(~ok).sum()}/{ok.size} elements differ, max "
        f"{np.abs(a - b).max():.3g}")


# fp32 agrees to float32 round-off; bf16 to the bf16 rounding of a ~20-op
# chain, with isolated elements apart where bf16 values tie or round across
# a ReLU (the JAX test of its own kernel uses the same bars)
CASES = {
    "float32": dict(dtype=None, rtol_out=1e-5, rtol=2e-3, atol=1e-4, frac=0.0),
    "bfloat16": dict(dtype="bfloat16", rtol_out=0.02, rtol=0.1, atol=0.05,
                     frac=0.03),
}


@pytest.mark.parametrize("case", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["plain", "relu_at_zero", "max_ties"])
def test_dgcnn_train_matches_jax_custom_vjp(case, variant):
    c = CASES[case]
    x, jm, params, stats, wvec = _setup(
        31, c["dtype"], dead_channels=variant == "relu_at_zero",
        duplicates=variant == "max_ties")
    jval, jout, jalpha, jstats, jgp, jgx = _jax_side(jm, params, stats, x, wvec)
    tval, tout, talpha, tm, tgp, tgx = _torch_side(params, stats, x, wvec,
                                                   c["dtype"])
    np.testing.assert_allclose(n(tval), n(jval), rtol=c["rtol_out"])
    _close(tout, jout, c["rtol"], c["atol"], c["frac"], "features")
    np.testing.assert_allclose(n(talpha), n(jalpha), atol=1e-5)
    # running statistics: 0.9 old + 0.1 batch moments (biased variance)
    for k, v in jstats.items():
        np.testing.assert_allclose(n(getattr(tm, k)), n(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    assert set(tgp) == set(jgp)
    for k in jgp:
        _close(tgp[k], jgp[k], c["rtol"], c["atol"], c["frac"], k)
    _close(tgx, jgx, c["rtol"], c["atol"], c["frac"], "x")


@pytest.mark.parametrize("case", ["float32", "bfloat16"])
def test_dgcnn_train_matches_jax_custom_vjp_at_k12(case):
    # a graph of 12 neighbours: graph_stage1 writes exactly 12 edge rows a
    # point (the batch moments sum over them), and the backward is the plain
    # one (the backward kernels take k = 20)
    c = CASES[case]
    x, jm, params, stats, wvec = _setup(32, c["dtype"], k=12)
    jval, jout, jalpha, jstats, jgp, jgx = _jax_side(jm, params, stats, x, wvec)
    tval, tout, talpha, tm, tgp, tgx = _torch_side(params, stats, x, wvec,
                                                   c["dtype"], k=12)
    np.testing.assert_allclose(n(tval), n(jval), rtol=c["rtol_out"])
    _close(tout, jout, c["rtol"], c["atol"], c["frac"], "features")
    np.testing.assert_allclose(n(talpha), n(jalpha), atol=1e-5)
    for k, v in jstats.items():
        np.testing.assert_allclose(n(getattr(tm, k)), n(v), rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for k in jgp:
        _close(tgp[k], jgp[k], c["rtol"], c["atol"], c["frac"], k)
    _close(tgx, jgx, c["rtol"], c["atol"], c["frac"], "x")


def test_relu_at_zero_passes_half_and_ties_go_to_the_first_maximum():
    """Direct check of the two backward rules on a one-stage toy: BN output
    exactly 0 on a dead channel, all k neighbours tied there."""
    from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import max_vjp as _max_vjp
    from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import relu_vjp as _relu_vjp
    g = torch.ones(1, 3, 1, 2)
    y = torch.tensor([0.0, -1.0, 2.0]).view(1, 3, 1, 1).expand(1, 3, 1, 2)
    assert _relu_vjp(g, y)[0, :, 0, 0].tolist() == [0.5, 0.0, 1.0]
    h = torch.zeros(1, 3, 1, 2)
    h[0, 2, 0, 1] = 1.0
    d = _max_vjp(torch.ones(1, 1, 2), h)
    assert d[0, :, 0, 0].tolist() == [1.0, 0.0, 0.0]      # tie: the first
    assert d[0, :, 0, 1].tolist() == [0.0, 0.0, 1.0]


def test_eval_after_training_uses_the_updated_statistics():
    x, jm, params, stats, _ = _setup(32, None)
    tm = TDGCNN(EMB, K, torch.float32)
    tm.load_state_dict({k: t(a) for k, a in {**params, **stats}.items()})
    tm.train()
    with torch.no_grad():
        tm(t(x))
    _, mut = jm.apply({"params": params, "batch_stats": stats},
                      jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm.eval()
    with torch.no_grad():
        got = tm(t(x))
    want = jm.apply({"params": params, "batch_stats": mut["batch_stats"]},
                    jnp.asarray(x), train=False)
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=1e-4)
