"""Batched point-cloud primitives (channel-last, explicit device).

Points and features are (B, N, C) with channels last, as in the JAX
package, so that the two compare like with like. Geometry runs in true
float32: every matrix product here goes through `matmul32`, which turns TF32
off for its call.

`knn` and `nn1` choose their route from shapes, as the JAX package's
`ops/common.py:knn/nn1` do on its accelerator, before anything runs: the
whole-target kernel at M <= 4096, the streamed kernels of `ops/stream.py`
above (3-D points), where the port's kernel takes the shape (on a CPU
tensor the kernel's plain version, so that the CPU follows the card's
route); else the JAX package's plain route, the dense (B, N, M) matrix up to
64 Mi elements and query chunks above.
"""
from __future__ import annotations

import torch

from ogmm_tpu_torch.parallel import comm

# the JAX package's envelopes (ogmm_tpu/ops/common.py:_PALLAS_FULL_M,
# _DENSE_ELEMS): whole-target kernels up to M = 4096, the dense matrix up to
# 64 Mi elements, query chunks of 1024 rows above
KERNEL_MAX_M = 4096
STREAM_MAX_K = 32          # knn_stream.cu keeps a sorted list of k in registers
DENSE_ELEMS = 2 ** 26
CHUNK = 1024
ICP_DENSE_MAX_M = 1024     # `nn1(prefer_dense=True)`: ICP's dense route


def matmul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 matrix product with TF32 off, whatever the global setting."""
    if not a.is_cuda:
        return torch.matmul(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sq_norm3(x: torch.Tensor) -> torch.Tensor:
    """|x|^2 of (..., 3) points, summed left to right. The CUDA kernels form
    it in the same order without fused multiply-adds, so that kernel and
    plain version select the same neighbours bit for bit."""
    return x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1] + x[..., 2] * x[..., 2]


def square_distance3(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """`square_distance` for 3-D points by elementwise float32 arithmetic in
    a fixed order: (|s|^2 + |d|^2) - 2 (s0 d0 + s1 d1 + s2 d2), clamped at
    1e-12. (B, N, 3) x (B, M, 3) -> (B, N, M)."""
    s, d = src.unsqueeze(2), dst.unsqueeze(1)
    inner = s[..., 0] * d[..., 0] + s[..., 1] * d[..., 1] + s[..., 2] * d[..., 2]
    d2 = (sq_norm3(src).unsqueeze(2) + sq_norm3(dst).unsqueeze(1)) - 2.0 * inner
    return d2.clamp_min(1e-12)


def square_distance(src: torch.Tensor, dst: torch.Tensor,
                    normalize: bool = False) -> torch.Tensor:
    """Pairwise squared euclidean distance (B, N, C) x (B, M, C) -> (B, N, M),
    clamped at 1e-12. `normalize=True` assumes unit-norm inputs and returns
    2 - 2 <x, y>."""
    inner = matmul32(src.float(), dst.float().transpose(-1, -2))
    if normalize:
        return 2.0 - 2.0 * inner
    d = ((src ** 2).sum(-1).unsqueeze(-1) + (dst ** 2).sum(-1).unsqueeze(-2)
         - 2.0 * inner)
    return d.clamp_min(1e-12)


def select_smallest(dist: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of each row of (..., M), ascending,
    ties to the lowest index: k passes of integer argmin and mask, never a
    comparison of recomputed floats."""
    d = dist.clone()
    out = []
    for _ in range(k):
        am = d.argmin(dim=-1, keepdim=True)
        out.append(am)
        d.scatter_(-1, am, float("inf"))
    return torch.cat(out, dim=-1)


def by_chunks(fn, src: torch.Tensor):
    """fn over query chunks of CHUNK rows, concatenated along the rows."""
    parts = [fn(src[:, i:i + CHUNK]) for i in range(0, src.shape[1], CHUNK)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p, dim=1) for p in zip(*parts))
    return torch.cat(parts, dim=1)


def knn_route(B: int, N: int, M: int, C: int, k: int,
              normalize: bool = False) -> str:
    """'kernel', 'stream', 'dense' or 'chunked' for a kNN of (B, N, C)
    queries among (B, M, C) points: for euclidean 3-D points the kernel at
    1 <= k <= M <= 4096 and the streamed kernel above at k <= 32 (the JAX
    package's `knn_pallas` and `knn_stream` take any C, and the streamed one
    any k); otherwise the JAX package's plain route (`knn_chunked` above 64
    Mi elements, the dense matrix below)."""
    if not normalize and C == 3:
        if M <= KERNEL_MAX_M and 1 <= k <= M:
            return "kernel"
        if M > KERNEL_MAX_M and 1 <= k <= STREAM_MAX_K:
            return "stream"
    if not normalize and B * N * M > DENSE_ELEMS:
        return "chunked"
    return "dense"


def knn(src: torch.Tensor, tgt: torch.Tensor, k: int,
        normalize: bool = False) -> torch.Tensor:
    """Indices of the k nearest neighbours of each src point among tgt:
    (B, N, C) x (B, M, C) -> int64 (B, N, k), ascending distance, ties to
    the lowest index, by the route of `knn_route`. The stream route sorts
    the clouds along a Morton curve (`ops.stream.knn_self_spatial` when tgt
    is src, else `knn_cross_spatial`): ties then go to the lowest sorted
    position, the JAX package's contract there."""
    route = knn_route(src.shape[0], src.shape[1], tgt.shape[1], src.shape[2],
                      k, normalize)
    if route == "kernel":
        from ogmm_tpu_torch.ops import cuda_knn      # imports this module
        return cuda_knn.knn(src, tgt, k)
    if route == "stream":
        from ogmm_tpu_torch.ops import stream        # imports this module
        if src is tgt:
            return stream.knn_self_spatial(src, k)
        return stream.knn_cross_spatial(src, tgt, k)
    if route == "chunked":
        return by_chunks(
            lambda q: select_smallest(square_distance(q, tgt), k), src)
    return select_smallest(square_distance(src, tgt, normalize), k)


def vspace_route(N: int, C: int, k: int) -> bool:
    """Whether a self-kNN graph of N points is built in Morton-sorted row
    space: where the streamed kernel takes it (3-D points, N > 4096,
    k <= 32), the JAX package's `ops/common.py:knn_self_vspace` rule on its
    accelerator (which takes any k)."""
    return C == 3 and N > KERNEL_MAX_M and 1 <= k <= STREAM_MAX_K


def knn_self_vspace(x: torch.Tensor, k: int):
    """The self-kNN graph in the cheapest row space: (B, N, 3) -> (xs, idx,
    inv). Where `vspace_route` says so, the graph of the Morton-sorted cloud
    xs in sorted rows (`ops.stream.knn_self_vspace`), per-point outputs
    un-sorted with `inv`; elsewhere (x, knn(x, x, k), None), the graph in
    original order."""
    B, N, C = x.shape
    if vspace_route(N, C, k):
        from ogmm_tpu_torch.ops import stream        # imports this module
        return stream.knn_self_vspace(x, k)
    return x, knn(x, x, k), None


def nn1_dense(src: torch.Tensor, tgt: torch.Tensor):
    """Nearest neighbour, dense route: (B, N, C) x (B, M, C) ->
    (min squared distance (B, N), index (B, N))."""
    d = square_distance(src, tgt)
    return d.min(dim=-1)


def nn1_route(B: int, N: int, M: int, C: int = 3,
              prefer_dense: bool = False) -> str:
    """'dense', 'kernel', 'stream' or 'chunked' for the 1-NN of (B, N, C)
    queries among (B, M, C) points, the JAX package's `nn1` rule: with
    `prefer_dense` (ICP) the dense matrix at M <= 1024; for 3-D points the
    kernel at M <= 4096 and the streamed kernel above (`nn1_stream`, which
    the JAX package runs at any C); otherwise its plain route (`nn1_chunked`
    above 64 Mi elements, else dense)."""
    if prefer_dense and M <= ICP_DENSE_MAX_M:
        return "dense"
    if C == 3:
        return "kernel" if M <= KERNEL_MAX_M else "stream"
    if B * N * M > DENSE_ELEMS:
        return "chunked"
    return "dense"


def nn1(src: torch.Tensor, tgt: torch.Tensor, prefer_dense: bool = False):
    """Nearest neighbour, the one dispatch point of ICP, the losses, the
    metrics and the overlap labels: (B, N, C) x (B, M, C) -> (min squared
    distance (B, N), index (B, N) int64), first index among equal minima, by
    the route of `nn1_route`. The kernel and stream routes launch their CUDA
    kernel on a CUDA tensor and run its plain version (fixed-order
    distances, `square_distance3`) on a CPU tensor."""
    route = nn1_route(src.shape[0], src.shape[1], tgt.shape[1], src.shape[2],
                      prefer_dense)
    if route == "kernel":
        from ogmm_tpu_torch.ops import cuda_knn      # imports this module
        return cuda_knn.nn1(src, tgt)
    if route == "stream":
        from ogmm_tpu_torch.ops import cuda_stream   # imports this module
        return cuda_stream.nn1_stream(src, tgt)
    if route == "chunked":
        return by_chunks(lambda q: nn1_dense(q, tgt), src)
    return nn1_dense(src, tgt)


def nn1_both(src: torch.Tensor, tgt: torch.Tensor):
    """Squared distance of every point to the nearest point of the OTHER
    cloud: (B, N, 3) x (B, M, 3) -> (d_src (B, N), d_tgt (B, M))."""
    return nn1(src, tgt)[0], nn1(tgt, src)[0]


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather rows: (B, N, C) indexed by int (B, S) -> (B, S, C)."""
    return torch.gather(
        points, 1, idx.long().unsqueeze(-1).expand(-1, -1, points.shape[-1]))


def gather_neighbors(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) + int (B, N, k) -> (B, N, k, C)."""
    B, N, k = idx.shape
    return index_points(points, idx.reshape(B, N * k)).reshape(
        B, N, k, points.shape[-1])


def graph_feature(x: torch.Tensor, k: int,
                  idx: torch.Tensor | None = None) -> torch.Tensor:
    """EdgeConv features [nbr - x, x]: (B, N, C) -> (B, N, k, 2C), over the
    given graph or the dense kNN graph of x."""
    if idx is None:
        idx = knn(x, x, k)
    nbr = gather_neighbors(x, idx)
    center = x.unsqueeze(2).expand_as(nbr)
    return torch.cat([nbr - center, center], dim=-1)


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-12) -> torch.Tensor:
    return x / x.norm(dim=dim, keepdim=True).clamp_min(eps)


def posenc_alpha(x: torch.Tensor, nbr: torch.Tensor,
                 centroid: torch.Tensor | None = None) -> torch.Tensor:
    """Position-encoding angle features from gathered neighbours:
    cos(angle(p -> nbr_j, p -> centroid)); x (B, N, 3), nbr (B, N, k, 3)
    -> (B, N, k) float32. A coincident neighbour gives 0."""
    if centroid is None:
        centroid = x.mean(dim=1, keepdim=True)
    p2gc = l2_normalize(x - centroid)
    p2lc = l2_normalize(nbr - x.unsqueeze(2))
    return (p2lc * p2gc.unsqueeze(2)).sum(-1)


def cos_similarity(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Cosine similarity matrix (B, N, D) x (B, M, D) -> (B, N, M)."""
    return matmul32(l2_normalize(x), l2_normalize(y).transpose(-1, -2))


def cos_distance(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """2 - 2 cos_similarity of the l2-normalised rows: (B, N, D) x (B, M, D)
    -> (B, N, M)."""
    return 2.0 - 2.0 * cos_similarity(x, y)


def cdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Euclidean (not squared) distance matrix (B, N, C) x (B, M, C) ->
    (B, N, M) float32: the square root of `square_distance` (its float32
    product with TF32 off, clamped at 1e-12), as `torch.cdist`."""
    return square_distance(x, y).sqrt()


# ---------------------------------------------------------------------------
# Point-sharded (sequence-parallel) helpers. In the sharded forward
# (`parallel/sp.py`) per-point tensors are (B, n_local, C) blocks of a global
# (B, N, C) array: process r of the group owns rows [r n_local, (r + 1)
# n_local), and global row indices keep their meaning. The two cross-shard
# primitives of the forward: a gather of rows by global index and a global
# 1-NN combine, both over tiny payloads (S <= 128 rows).
# ---------------------------------------------------------------------------

def sp_local_info(local_n: int, group):
    """(row offset of this process's block, global point count)."""
    return comm.axis_index(group) * local_n, local_n * comm.axis_size(group)


def index_points_sp(points: torch.Tensor, idx: torch.Tensor,
                    group) -> torch.Tensor:
    """`index_points` over a point-sharded array with global indices:
    points (B, n_local, C) this process's rows, idx (B, S) global row
    indices, the same on every process. Each process gathers the rows it
    owns (a clipped local gather and an ownership mask) and one all-reduce
    assembles the (B, S, C) rows on every process."""
    n_local = points.shape[1]
    start, _ = sp_local_info(n_local, group)
    local = idx.long() - start
    own = (local >= 0) & (local < n_local)
    got = index_points(points, local.clamp(0, n_local - 1))
    got = torch.where(own.unsqueeze(-1), got, torch.zeros_like(got))
    return comm.psum(got, group)


def nn1_sp(queries: torch.Tensor, tgt_local: torch.Tensor, group):
    """1-NN of queries (B, S, C), the same on every process, among a
    point-sharded target (this process's rows tgt_local (B, n_local, C)):
    the local `nn1`, then an all-gather of the (distance, global index)
    pairs and the minimum over the processes, ties to the lowest process
    and so to the lowest global index. Returns (min squared distance
    (B, S), global index (B, S) int64), the same on every process."""
    start, _ = sp_local_info(tgt_local.shape[1], group)
    d, i = nn1(queries, tgt_local)
    d_all = comm.all_gather(d.unsqueeze(0), group)          # (W, B, S)
    i_all = comm.all_gather((i + start).unsqueeze(0), group)
    sel = d_all.argmin(dim=0, keepdim=True)
    return (d_all.gather(0, sel).squeeze(0), i_all.gather(0, sel).squeeze(0))
