"""The overlap head's projection with its gradient (`ops/stream.py:wproject`,
the forward through the kernel's plain version on the CPU, the backward
`wproject_bwd` recomputing the softmax by query chunks) against `jax.vjp` of
the JAX package's `wproject_stream` with the Pallas kernel in interpret mode
(whose VJP is the recompute `_wproject_bwd`), and against autograd through
the dense softmax in float64.

Inputs: B = 2, N = M = 300 (not a multiple of a chunk), D = 64,
l2-normalised features (cosine logits, as the head gives), v and the
upstream gradient of unit scale. Tolerances, each a share of the largest
|value| of the reference:
  float32   1e-5 (the same float32 products, summed in other orders)
  bf16      2^-7 for dq and dk (float32 results rounded to bf16 once: two
            float32 values a few ulps apart may round to neighbouring bf16
            values, one bf16 ulp, at most 2^-7 of the value, apart; 4.8e-4
            measured), 1e-5 for the float32 output and dv (v stays float32)
  float64   1e-12 against autograd through the dense softmax."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ogmm_tpu.ops.pallas_stream import wproject_stream as jwproject
from ogmm_tpu_torch.ops import stream

from torch_port_util import n, t

B, N, M, D = 2, 300, 300, 64


def _inputs(seed, dtype=np.float32):
    rs = np.random.RandomState(seed)
    base = rs.randn(B, N, D)
    q = base + 0.3 * rs.randn(B, N, D)
    k = base[:, rs.permutation(N)[:M]] + 0.3 * rs.randn(B, M, D)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    v = rs.randn(B, M, 1)
    g = rs.randn(B, N, 1)
    return (a.astype(dtype) for a in (q, k, v, g))


def _port(q, k, v, g, dtype, chunk=None, fwd=stream.wproject_stream_lse_plain):
    """out and (dq, dk, dv) of the port's projection; the chunk of the
    backward forced through `wproject_bwd` when given."""
    tq, tk = t(q, dtype).requires_grad_(), t(k, dtype).requires_grad_()
    tv = t(v, torch.float64 if dtype == torch.float64 else torch.float32)
    tv.requires_grad_()
    if chunk is None:
        out = stream.wproject(tq, tk, tv, fwd)
        out.backward(t(g, out.dtype))
        return out, (tq.grad, tk.grad, tv.grad)
    with torch.no_grad():
        out, lse = fwd(tq, tk, tv)
        return out, stream.wproject_bwd(tq, tk, tv, out, lse,
                                        t(g, out.dtype), chunk=chunk)


def _jax(q, k, v, g, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    out, vjp = jax.vjp(lambda a, b, c: jwproject(a, b, c, interpret=True),
                       jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v))
    return out, vjp(jnp.asarray(g))


def _assert_close(got, want, lim, what):
    got, want = n(got), n(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= lim * np.abs(want).max(), f"{what}: {err:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gradients_match_the_jax_vjp(dtype):
    q, k, v, g = _inputs(0)
    out, grads = _port(q, k, v, g, dtype)
    jout, jgrads = _jax(q, k, v, g, dtype)
    assert [a.dtype for a in grads] == [dtype, dtype, torch.float32]
    lims = (1e-5, 1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 2 ** -7, 1e-5)
    _assert_close(out, jout, 1e-5, "out")
    for name, a, b, lim in zip(("dq", "dk", "dv"), grads, jgrads, lims):
        _assert_close(a, b, lim, name)


@pytest.mark.parametrize("chunk", [None, 128, 7])
def test_gradients_match_dense_autograd_in_float64(chunk):
    # chunk 128 and 7 leave a short last chunk (300 = 2 x 128 + 44 and
    # 42 x 7 + 6): its missing rows repeat the last one with a zero g
    q, k, v, g = _inputs(1, np.float64)
    tq, tk, tv = (t(a, torch.float64).requires_grad_() for a in (q, k, v))
    want = torch.softmax(tq @ tk.transpose(1, 2), dim=-1) @ tv
    wgrads = torch.autograd.grad(want, (tq, tk, tv), t(g, torch.float64))

    def dense(a, b, c):
        s = a @ b.transpose(1, 2)
        return torch.softmax(s, -1) @ c, torch.logsumexp(s, -1, keepdim=True)

    out, grads = _port(q, k, v, g, torch.float64, chunk=chunk, fwd=dense)
    _assert_close(out, want, 1e-12, "out")
    for name, a, b in zip(("dq", "dk", "dv"), grads, wgrads):
        assert a.dtype == torch.float64
        _assert_close(a, b, 1e-12, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_short_last_chunk_matches_the_jax_vjp(dtype):
    q, k, v, g = _inputs(2)
    _, grads = _port(q, k, v, g, dtype, chunk=128)
    _, jgrads = _jax(q, k, v, g, dtype)
    lims = (1e-5, 1e-5, 1e-5) if dtype == torch.float32 else (2 ** -7, 2 ** -7, 1e-5)
    for name, a, b, lim in zip(("dq", "dk", "dv"), grads, jgrads, lims):
        _assert_close(a, b, lim, name)


def test_the_chunk_rule_is_the_jax_packages():
    # min(N, max(256, 2^24 // M)): the indoor call takes chunks of 479 rows
    assert stream.wproject_bwd_chunk(35000, 35000) == 479
    assert stream.wproject_bwd_chunk(300, 300) == 300
    assert stream.wproject_bwd_chunk(100000, 200000) == 256
    assert stream.wproject_bwd_chunk(4300, 4300) == 3901


def test_the_backward_saves_no_matrix():
    # what autograd keeps for the backward: q, k, v, out and lse, no (N, M)
    q, k, v, _ = _inputs(3)
    tq, tk = t(q).requires_grad_(), t(k).requires_grad_()
    out = stream.wproject(tq, tk, t(v), stream.wproject_stream_lse_plain)
    saved = out.grad_fn.saved_tensors
    assert sorted(tuple(s.shape) for s in saved) == sorted(
        [(B, N, D), (B, M, D), (B, M, 1), (B, N, 1), (B, N, 1)])
