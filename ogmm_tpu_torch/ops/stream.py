"""Large-cloud neighbour searches and the streamed overlap projection: the
counterpart of the JAX package's `ogmm_tpu/ops/pallas_stream.py`.

Above M = 4096 target points the whole-target kernels do not apply, and the
(B, N, M) matrices stop fitting (the indoor request, N = M = 35,000, would
need 4.9 GB a pair). There the JAX package streams the target through its
kernels, and so does the port (`csrc/knn_stream.cu`, `csrc/wproject.cu`,
wrappers in `ops/cuda_stream.py`):

  knn_self_vspace, knn_self_spatial   the self-kNN graph of a Morton-sorted
        cloud with a tile-pair AABB cull and diagonal-first visiting, the
        graph kept in sorted row space or mapped back to original ids;
  knn_cross_spatial   the same for a cross query, both sides sorted against
        their joint box;
  nn1_stream_t    the 1-NN of the TPU package's transposed-layout kernel,
        served by the `nn1_stream` kernel.

Here also live the plain PyTorch versions of the three kernels
(`knn_stream_plain`, `nn1_stream_plain`, `wproject_stream_lse_plain`),
query-chunked so that peak memory stays at (B, CHUNK, M), and the cull
tables of the port's tiles (`pair_tile_bounds`). Culling and visiting order
never change a result: the plain versions ignore both.

`wproject` is the overlap head's projection with a gradient: its forward is
the kernel (or the plain version), its backward (`wproject_bwd`) recomputes
the softmax by query chunks from the saved row logsumexp, as the JAX
package's recompute VJP does, so that the head trains at N = 35,000 without
an (N, M) matrix.
"""
from __future__ import annotations

import torch

from ogmm_tpu_torch.ops.common import (STREAM_MAX_K, by_chunks, index_points,
                                       matmul32, select_smallest,
                                       square_distance3)

# the kernels' tiles (csrc/knn_stream.cu: STN, STM): query points of a block,
# target points of a shared-memory tile. The cull tables are built for them.
TILE_N = 64
TILE_M = 512


# ------------------------------------------------------- plain versions

@torch.no_grad()
def knn_stream_plain(src: torch.Tensor, tgt: torch.Tensor, k: int,
                     diag_order: bool = False, stretch: int = 1,
                     cull_lb: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the `knn_stream` kernel: (B, N, 3) x (B, M, 3) ->
    int64 (B, N, k), ascending fixed-order float32 distance, ties to the
    lowest index; query chunks of CHUNK rows. The kernel's visiting order
    and cull table are accepted and ignored: they never change a result."""
    tgt = tgt.float()
    return by_chunks(lambda q: select_smallest(square_distance3(q, tgt), k),
                   src.float())


@torch.no_grad()
def nn1_stream_plain(src: torch.Tensor, tgt: torch.Tensor,
                     cull_lb: torch.Tensor | None = None,
                     max_dist_sq: float | None = None,
                     diag_order: bool = False, stretch: int = 1):
    """Plain version of the `nn1_stream` kernel: (B, N, 3) x (B, M, 3) ->
    (min squared distance (B, N), index (B, N) int64), first index among
    equal minima; query chunks. Exact on every row: the kernel's gate only
    lets it leave rows whose nearest point lies at or beyond max_dist_sq."""
    tgt = tgt.float()

    def one(q):
        d = square_distance3(q, tgt)
        i = d.argmin(dim=-1)
        return d.gather(-1, i.unsqueeze(-1)).squeeze(-1), i

    return by_chunks(one, src.float())


def wproject_stream_lse_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor):
    """Plain version of the `wproject` kernel: softmax(q k^T) v and the row
    logsumexp, q (B, N, D), k (B, M, D) in the body's type (products exact,
    summed in float32), v (B, M, 1) -> out (B, N, 1), lse (B, N, 1), both
    float32; query chunks. Differentiable (autograd through the chunks)."""
    kt = k.float().transpose(1, 2)
    v = v.float()

    def one(qc):
        s = matmul32(qc.float(), kt)                     # (B, chunk, M)
        return (torch.matmul(torch.softmax(s, dim=-1), v),
                torch.logsumexp(s, dim=-1, keepdim=True))

    return by_chunks(one, q)


# ------------------------------------- the projection with its gradient

def wproject_bwd_chunk(N: int, M: int) -> int:
    """Query rows a chunk of the projection's backward: the JAX package's
    rule (`ogmm_tpu/ops/pallas_stream.py:_wproject_bwd`), which holds a
    chunk's (B, chunk, M) float32 blocks near 2^24 elements a cloud."""
    return min(N, max(256, 2 ** 24 // max(M, 1)))


def _tail(x: torch.Tensor, s: int, chunk: int, fill: float | None = None):
    """Rows [s, s + chunk) of x (B, N, C); past N the last row repeated, or
    `fill`."""
    part = x[:, s:s + chunk]
    pad = chunk - part.shape[1]
    if not pad:
        return part
    rest = (part[:, -1:].expand(-1, pad, -1) if fill is None
            else part.new_full((part.shape[0], pad, part.shape[2]), fill))
    return torch.cat([part, rest], dim=1)


def wproject_bwd(q, k, v, out, lse, g, chunk: int | None = None):
    """The gradients (dq, dk, dv) of out = softmax(q k^T) v from the saved
    out and row logsumexp lse (B, N, 1) and the upstream gradient g
    (B, N, 1), without an (N, M) matrix: the JAX package's `_wproject_bwd`.
    For each chunk of query rows, p = exp(s - lse) is recomputed and, with
    o = out,
        s_bar = p g (v_m - o),  dq = s_bar k,  dk += s_bar^T q,  dv += p^T g.
    dk and dv accumulate in place over the chunks; the last chunk repeats
    its last row and takes a zero g there, so the extra rows add nothing.
    Products in float32 (float64 for float64 inputs) with TF32 off; the
    gradients in the inputs' types."""
    B, N, D = q.shape
    M = k.shape[1]
    chunk = wproject_bwd_chunk(N, M) if chunk is None else chunk
    ct = torch.promote_types(q.dtype, torch.float32)      # float64 stays
    k32 = k.to(ct)
    kt = k32.transpose(1, 2)
    vrow = v.to(ct).reshape(B, 1, M)
    g, out, lse = g.to(ct), out.to(ct), lse.to(ct)
    dq = torch.empty(B, N, D, dtype=ct, device=q.device)
    dk = torch.zeros(B, M, D, dtype=ct, device=q.device)
    dv = torch.zeros(B, M, 1, dtype=ct, device=q.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for s in range(0, N, chunk):
            qc = _tail(q, s, chunk).to(ct)
            gc = _tail(g, s, chunk, 0.0)
            p = torch.bmm(qc, kt).sub_(_tail(lse, s, chunk)).exp_()
            sbar = (vrow - _tail(out, s, chunk)).mul_(p).mul_(gc)
            e = min(s + chunk, N)
            dq[:, s:e] = torch.bmm(sbar, k32)[:, :e - s]
            dk.baddbmm_(sbar.transpose(1, 2), qc)
            dv.baddbmm_(p.transpose(1, 2), gc)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _WProject(torch.autograd.Function):
    """softmax(q k^T) v whose forward is `fwd` (the kernel's wrapper or its
    plain version) and whose backward recomputes the softmax by chunks from
    the saved row logsumexp: q, k, v, out and lse are saved, never an (N, M)
    block."""

    @staticmethod
    def forward(ctx, q, k, v, fwd):
        out, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*wproject_bwd(q, k, v, out, lse, g), None)


def wproject(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             fwd) -> torch.Tensor:
    """softmax(q k^T) v, q (B, N, D), k (B, M, D), v (B, M, 1) -> (B, N, 1)
    float32, differentiable in q, k and v by `wproject_bwd`. The forward is
    `fwd(q, k, v) -> (out, lse)`, the function the overlap head's route
    chose: `cuda_stream.wproject_stream_lse` (the kernel on a CUDA tensor,
    its plain version on the CPU) or `wproject_stream_lse_plain`."""
    return _WProject.apply(q, k, v, fwd)


# ------------------------------------------------- sorting and cull tables

def morton3(x: torch.Tensor, box=None) -> torch.Tensor:
    """(B, N, 3) -> (B, N) int64 Morton (Z-order) codes, 10 bits an axis, of
    the points normalised to their cloud's box (or `box` = (min, max), each
    (B, 1, 3): two clouds sorted against one box get comparable ranks). The
    same codes as the JAX package's `_morton3`."""
    if box is not None:
        mn, mx = box
    else:
        mn = x.amin(dim=1, keepdim=True)
        mx = x.amax(dim=1, keepdim=True)
    q = (x - mn) / (mx - mn).clamp_min(1e-9) * 1023.0
    q = q.clamp(0.0, 1023.0).to(torch.int64)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return spread(q[..., 0]) | (spread(q[..., 1]) << 1) | (spread(q[..., 2]) << 2)


def morton_order(x: torch.Tensor, box=None) -> torch.Tensor:
    """(B, N) int64 permutation sorting each cloud along its Morton curve,
    equal codes in row order (a stable sort, as `jnp.argsort`)."""
    return torch.sort(morton3(x, box), dim=-1, stable=True).indices


def tile_boxes(xs: torch.Tensor, tile: int):
    """(B, N, 3) -> per-tile boxes ((B, T, 3) mins, maxs) of consecutive
    tiles of `tile` rows; the missing rows of the last tile are left out."""
    B, N, _ = xs.shape
    T = -(-N // tile)
    pad = T * tile - N
    lo = torch.nn.functional.pad(xs, (0, 0, 0, pad), value=float("inf"))
    hi = torch.nn.functional.pad(xs, (0, 0, 0, pad), value=float("-inf"))
    return (lo.reshape(B, T, tile, 3).amin(dim=2),
            hi.reshape(B, T, tile, 3).amax(dim=2))


def pair_tile_bounds(qs: torch.Tensor, ts: torch.Tensor,
                     tile_n: int = TILE_N, tile_m: int = TILE_M) -> torch.Tensor:
    """(B, T_n, T_m) float32 lower bounds of every squared distance between
    a point of query tile i and one of target tile j: the squared box gap,
    less a tolerance of 1e-5 (1 + max|q|^2 + max|t|^2) so that it bounds the
    COMPUTED distance too ((|q|^2 + |t|^2) - 2 q.t loses a few ulps of the
    squared magnitudes), clamped at 0. The JAX package's `_pair_tile_bounds`."""
    qs, ts = qs.float(), ts.float()
    nlo, nhi = tile_boxes(qs, tile_n)
    mlo, mhi = tile_boxes(ts, tile_m)
    gap = torch.maximum(nlo.unsqueeze(2) - mhi.unsqueeze(1),
                        mlo.unsqueeze(1) - nhi.unsqueeze(2)).clamp_min(0.0)
    lb = (gap * gap).sum(-1)
    tol = 1e-5 * (1.0 + (qs * qs).sum(-1).amax(dim=1)
                  + (ts * ts).sum(-1).amax(dim=1))
    lb = (lb - tol[:, None, None]).clamp_min(0.0)
    return torch.where(torch.isfinite(lb), lb, torch.zeros_like(lb))


def tile_pair_bounds(xs: torch.Tensor, tile_n: int = TILE_N,
                     tile_m: int = TILE_M) -> torch.Tensor:
    """The self-graph table of `pair_tile_bounds`."""
    return pair_tile_bounds(xs, xs, tile_n, tile_m)


# ------------------------------------------------------ the graph routes

def _knn_self_sorted(x: torch.Tensor, k: int):
    """Morton-sort the cloud, build the cull table, stream the self-kNN in
    sorted space: (xs, idx_s over xs, order), order[b, r] the original id of
    sorted row r."""
    from ogmm_tpu_torch.ops import cuda_stream      # imports this module
    order = morton_order(x)
    xs = index_points(x.float(), order)
    idx_s = cuda_stream.knn_stream(xs, xs, k, diag_order=True,
                                   cull_lb=tile_pair_bounds(xs))
    return xs, idx_s, order


def knn_self_vspace(x: torch.Tensor, k: int):
    """Self-kNN graph kept in Morton-sorted row space: (B, N, 3) ->
    (xs (B, N, 3) sorted cloud, idx_s (B, N, k) int64 rows of xs, inv
    (B, N)). Row r of idx_s belongs to sorted row r; per-point outputs
    computed in that order return to the original order by a row gather
    with `inv`. Same neighbour sets, ascending distance, ties to the lowest
    SORTED position (the JAX package's contract)."""
    xs, idx_s, order = _knn_self_sorted(x, k)
    return xs, idx_s, torch.argsort(order, dim=-1)


def knn_self_spatial(x: torch.Tensor, k: int) -> torch.Tensor:
    """Self-kNN graph through the Morton sort, in original ids and rows:
    (B, N, 3) -> (B, N, k) int64."""
    B, N, _ = x.shape
    _, idx_s, order = _knn_self_sorted(x, k)
    orig = torch.gather(order, 1, idx_s.reshape(B, -1)).reshape(B, N, k)
    inv = torch.argsort(order, dim=-1)
    return index_points(orig, inv)


def knn_cross_spatial(q: torch.Tensor, t: torch.Tensor, k: int) -> torch.Tensor:
    """Cross kNN of (B, L, 3) queries among (B, M, 3) points, both sides
    Morton-sorted against their joint box, the diagonal stretched by M / L:
    (B, L, k) int64 original target ids, rows in q's order."""
    from ogmm_tpu_torch.ops import cuda_stream      # imports this module
    B, L, _ = q.shape
    M = t.shape[1]
    q, t = q.float(), t.float()
    box = (torch.minimum(q.amin(dim=1, keepdim=True), t.amin(dim=1, keepdim=True)),
           torch.maximum(q.amax(dim=1, keepdim=True), t.amax(dim=1, keepdim=True)))
    qord, tord = morton_order(q, box), morton_order(t, box)
    qs, ts = index_points(q, qord), index_points(t, tord)
    idx_s = cuda_stream.knn_stream(qs, ts, k, diag_order=True,
                                   stretch=max(1, round(M / L)),
                                   cull_lb=pair_tile_bounds(qs, ts))
    orig = torch.gather(tord, 1, idx_s.reshape(B, -1)).reshape(B, L, k)
    return index_points(orig, torch.argsort(qord, dim=-1))


def nn1_stream_t(src: torch.Tensor, tgt: torch.Tensor):
    """The JAX package's transposed-layout 1-NN (`nn1_stream_t`): the same
    function as `nn1_stream`, which serves it on the card."""
    from ogmm_tpu_torch.ops import cuda_stream      # imports this module
    return cuda_stream.nn1_stream(src, tgt)
