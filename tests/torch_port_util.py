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


KNN_LANES, KNN_SUBT = 4, 64   # csrc/knn_lanes.cuh: NL lanes a query, SUBT points


def knn_lanes_mirror(d, K, tiles, kout=None, window=KNN_SUBT, thr0=None):
    """The four-lane selection of `csrc/knn_lanes.cuh` (the dense kNN kernel
    and `knn_stream_kernel`) for one cloud's (N, M) float32 distances, in
    Python: `tiles(row)` gives the (first point, size) of the target tiles
    a row's query visits, in order, each taken in windows of `window`
    points; lane l keeps a sorted list of at most K (distance, index) pairs
    of the points l, l + 4, ... of each window, inserting a candidate at or
    below the threshold its lanes share (from thr0[row], or inf); after
    each window the threshold becomes the smaller of itself and min(least
    K-th, largest ceil(K/4)-th); at the end the four lists merge by rank and
    the pairs of rank below kout (default K) are written."""
    import bisect
    kout = K if kout is None else kout
    N, M = d.shape
    q = -(-K // KNN_LANES)
    out = np.full((N, kout), -1, np.int64)
    for row in range(N):
        lists = [[] for _ in range(KNN_LANES)]
        thr = float("inf") if thr0 is None else float(thr0[row])
        for m0, size in tiles(row):
            for s in range(0, size, window):
                for lane, lst in enumerate(lists):
                    js = np.arange(m0 + s + lane, m0 + min(s + window, size),
                                   KNN_LANES)
                    for j in js[d[row, js] <= thr]:   # in order
                        c = (float(d[row, j]), int(j))
                        if len(lst) < K or c < lst[-1]:
                            bisect.insort(lst, c)
                            del lst[K:]
                kth = [lst[K - 1][0] if len(lst) >= K else np.inf for lst in lists]
                qth = [lst[q - 1][0] if len(lst) >= q else np.inf for lst in lists]
                thr = min(thr, min(kth), max(qth))
        for lane, lst in enumerate(lists):
            for s, c in enumerate(lst):
                rank = s + sum(bisect.bisect_left(o, c)
                               for i, o in enumerate(lists) if i != lane)
                if rank < kout:
                    out[row, rank] = c[1]
    return out
