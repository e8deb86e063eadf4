"""The port's fused eval DGCNN (plain version on the CPU) against the JAX
package: the naive jnp composition and the Pallas kernel in interpret mode,
same numpy inputs, same weights with non-trivial BatchNorm statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu.nn.dgcnn import DGCNN as JDGCNN
from ogmm_tpu.ops import common as jcommon
from ogmm_tpu.ops.pallas_dgcnn import dgcnn_eval_pallas
from ogmm_tpu_torch.nn.dgcnn import DGCNN as TDGCNN
from ogmm_tpu_torch.ops.cuda_dgcnn import dgcnn_eval, dgcnn_eval_reference

from torch_port_util import clouds, n, randomise_stats, t, to_plain


def _pair(seed, dtype, emb=64, k=20, B=2, N=96):
    x = clouds(seed, B=B, N=N, scale=0.4)
    jm = JDGCNN(emb_dims=emb, k=k, dtype=dtype, fused=False)
    v = randomise_stats(jm.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                                train=False), seed)
    tm = TDGCNN(emb, k, torch.bfloat16 if dtype else torch.float32)
    plain = to_plain(v)
    state = {**{k_: t(a) for k_, a in plain["params"].items()},
             **{k_: t(a) for k_, a in plain["batch_stats"].items()}}
    tm.load_state_dict(state, strict=True)
    return x, jm, v, tm.eval()


def _folded(v):
    p, s = v["params"], v["batch_stats"]
    ws = [p[f"w{i}"] for i in range(1, 6)]
    aff = []
    for i in range(1, 6):
        sc = p[f"bn{i}_scale"] * jax.lax.rsqrt(s[f"bn{i}_var"] + 1e-5)
        aff.append((sc, p[f"bn{i}_bias"] - s[f"bn{i}_mean"] * sc))
    return ws, aff


def test_matches_jax_naive_fp32():
    x, jm, v, tm = _pair(0, None)
    want = jm.apply(v, jnp.asarray(x), train=False)
    got, alpha = tm(t(x), with_posenc_alpha=5)
    assert got.dtype == torch.float32 and got.shape == (2, 96, 64)
    # folded vs unfolded BatchNorm affine in float32: 1e-5
    np.testing.assert_allclose(n(got), n(want), rtol=1e-4, atol=2e-5)
    jx = jnp.asarray(x)
    nbr = jcommon.gather_neighbors(jx, jcommon.knn(jx, jx, 5, use_pallas=False))
    np.testing.assert_allclose(n(alpha), n(jcommon.posenc_alpha(jx, nbr)), atol=2e-6)


def test_matches_jax_naive_bf16():
    x, jm, v, tm = _pair(1, "bfloat16")
    want = jm.apply(v, jnp.asarray(x), train=False)
    got = tm(t(x))
    assert got.dtype == torch.bfloat16
    # five bf16 stages (8 mantissa bits) with the BatchNorm folded before the
    # cast on one side and applied after it on the other
    np.testing.assert_allclose(n(got), n(want), rtol=0.1, atol=0.05)


@pytest.mark.parametrize("dtype,rtol,atol", [(jnp.float32, 1e-4, 2e-5),
                                             (jnp.bfloat16, 0.1, 0.05)])
def test_matches_pallas_kernel_interpreted(dtype, rtol, atol):
    x, _, v, tm = _pair(2, "bfloat16" if dtype == jnp.bfloat16 else None)
    ws, aff = _folded(v)
    want, walpha = dgcnn_eval_pallas(jnp.asarray(x), ws, aff, k=20, dtype=dtype,
                                     interpret=True, posenc_k=5)
    got, alpha = tm(t(x), with_posenc_alpha=5)
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=atol)
    # the angles come from float32 coordinates in both, whatever the body's type
    np.testing.assert_allclose(n(alpha), n(walpha), atol=2e-6)


@pytest.mark.parametrize("dtype,rtol,atol,k", [
    pytest.param(None, 1e-4, 2e-5, 12, id="None-0.0001-2e-05"),
    pytest.param("bfloat16", 0.1, 0.05, 12, id="bfloat16-0.1-0.05"),
    # above 32: the kernel's stage chain in chunks of 32, the wide selection
    *[pytest.param(dt, rt, at, k, id=f"{dt}-k{k}")
      for k in (33, 40, 64) for dt, rt, at in ((None, 1e-4, 2e-5),
                                               ("bfloat16", 0.1, 0.05))]])
def test_matches_jax_at_gnn_k12(dtype, rtol, atol, k):
    # k = 12, which the kernel's stage chain takes as 12 rows a point (k = 4
    # and 25 as 8 and 28, the rows past k repeating the nearest neighbour),
    # and k = 33, 40, 64 (chunks of 32 and the rest): the JAX naive forward
    # and its Pallas kernel in interpret mode
    x, jm, v, tm = _pair(6, dtype, k=k)
    got, alpha = tm(t(x), with_posenc_alpha=5)
    np.testing.assert_allclose(n(got), n(jm.apply(v, jnp.asarray(x), train=False)),
                               rtol=rtol, atol=atol)
    ws, aff = _folded(v)
    want, walpha = dgcnn_eval_pallas(jnp.asarray(x), ws, aff, k=k,
                                     dtype=jnp.bfloat16 if dtype else jnp.float32,
                                     interpret=True, posenc_k=5)
    np.testing.assert_allclose(n(got), n(want), rtol=rtol, atol=atol)
    np.testing.assert_allclose(n(alpha), n(walpha), atol=2e-6)


def test_full_width_cloud_matches_jax_naive():
    x, jm, v, tm = _pair(3, None, emb=64, B=1, N=717)
    want = jm.apply(v, jnp.asarray(x), train=False)
    np.testing.assert_allclose(n(tm(t(x))), n(want), rtol=1e-4, atol=2e-5)


def test_wrapper_takes_the_plain_version_on_cpu_only():
    x, _, v, _ = _pair(4, None)
    ws, aff = _folded(v)
    ws = [t(np.asarray(w)) for w in ws]
    aff = [(t(np.asarray(a)), t(np.asarray(b))) for a, b in aff]
    a = dgcnn_eval(t(x), ws, aff, dtype=torch.float32)
    b = dgcnn_eval_reference(t(x), ws, aff, dtype=torch.float32)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="posenc_k"):
        dgcnn_eval(t(x), ws, aff, k=4, posenc_k=5)


def test_unsupported_modes_raise():
    _, _, _, tm = _pair(5, None)
    x = t(clouds(5))
    with pytest.raises(ValueError, match="posenc_centroid"):
        tm(x, with_posenc_alpha=5, posenc_centroid=x.mean(1, keepdim=True))
    with pytest.raises(ValueError, match="posenc_centroid"):
        tm.train()(x, with_posenc_alpha=5,
                   posenc_centroid=x.mean(1, keepdim=True))
