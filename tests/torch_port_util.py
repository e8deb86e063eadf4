"""Shared helpers of the tests that hold `ogmm_tpu_torch` against `ogmm_tpu`.

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU (tests/conftest.py) and data passes between the two as
numpy arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

# the suite runs several worker processes side by side: keep each one's
# PyTorch to two threads so that they do not oversubscribe the cores
torch.set_num_threads(2)


def t(a, dtype=torch.float32):
    """numpy -> CPU tensor."""
    return torch.from_numpy(np.array(a)).to(dtype)


def n(x):
    """tensor or jax array -> float32/int numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if a.dtype.kind == "f" or a.dtype.name == "bfloat16" else a


def clouds(seed, B=2, N=96, scale=0.3):
    return (np.random.RandomState(seed).randn(B, N, 3) * scale).astype(np.float32)


def randomise_stats(variables, seed):
    """Give every BatchNorm non-trivial running statistics and affine
    parameters (the JAX init leaves them at 0/1), keeping the tree shape."""
    rs = np.random.RandomState(seed)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", path[-1]))
        a = np.asarray(a)
        if name.endswith("var"):
            return jnp.asarray(rs.uniform(0.5, 1.5, a.shape).astype(np.float32))
        if name.endswith("mean"):
            return jnp.asarray((rs.randn(*a.shape) * 0.1).astype(np.float32))
        if name.endswith("scale"):
            return jnp.asarray(rs.uniform(0.8, 1.2, a.shape).astype(np.float32))
        if name.endswith("bias") and a.ndim == 1:
            return jnp.asarray((rs.randn(*a.shape) * 0.05).astype(np.float32))
        return jnp.asarray(a)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def to_plain(tree):
    """flax variables -> nested dict of numpy arrays."""
    from flax.core import unfreeze
    return jax.tree_util.tree_map(np.asarray, jax.device_get(unfreeze(tree)))


def assert_same_up_to_ties(got, want, src, tgt, max_share=0.01):
    """kNN indices (B, N, k) equal, or of points at the same distance within
    1e-6 relative (float64 distances of the two choices): the two packages
    form float32 distances in other orders, so near-ties may go either way
    (at most `max_share` of the entries)."""
    got, want = np.asarray(got).astype(np.int64), np.asarray(want).astype(np.int64)
    assert got.shape == want.shape
    src, tgt = np.asarray(src, np.float64), np.asarray(tgt, np.float64)
    B, N, k = got.shape
    dg = ((src[:, :, None, :] - np.take_along_axis(
        tgt[:, None], got[..., None], axis=2)) ** 2).sum(-1)
    dw = ((src[:, :, None, :] - np.take_along_axis(
        tgt[:, None], want[..., None], axis=2)) ** 2).sum(-1)
    differ = got != want
    assert np.allclose(dg[differ], dw[differ], rtol=1e-6, atol=1e-12), \
        np.abs(dg - dw).max()
    assert differ.mean() <= max_share, differ.mean()
