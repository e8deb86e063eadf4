"""Uniform-grid fixed-radius 1-NN for ICP against a large target, plain
PyTorch, the JAX package's `ops/grid_nn.py`.

ICP gates every correspondence at `nn_d < threshold^2`, so the nearest
neighbour is only consumed when it lies within `threshold`. With a cell
pitch of at least `threshold`, every target point within `threshold` of a
query lies in one of the query's 27 neighbouring cells, and a query whose 27
cells hold nothing within reach would have been gated to weight 0 anyway
(+inf here, the same effect).

`build_grid` sorts the target by cell key once; each ICP trip then pays, a
query, 27 binary searches (`torch.searchsorted`) and a window of `cap`
candidates in each of the 27 runs: O(N 27 cap) instead of O(N M).

  * cell keys encode the clipped integer coordinates as (cx<<20)|(cy<<10)|cz
    (int64 here): monotone, valid for up to 1024 cells an axis. Clipping is
    monotone, so two points within one pitch stay neighbours after it.
  * a cell holding more than `cap` points contributes its first `cap` in
    sorted order. `build_grid` returns the densest cell's count
    (`max_occupancy`, on the device) so that a caller can check `cap`; the
    ICP does not read it in its loop.
  * exact ties go to the lowest position in the candidate window, not to the
    lowest original index as on the dense route: both points are equally
    near, and ICP consumes only the gathered coordinates.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_BITS = 10                      # cells an axis <= 1024
_CMAX = (1 << _BITS) - 1


class Grid(NamedTuple):
    """The target of one ICP call, sorted into cells."""
    pts_sorted: torch.Tensor     # (B, M, 3) float32, sorted by cell key
    ids_sorted: torch.Tensor     # (B, M) int64 original indices
    cid_sorted: torch.Tensor     # (B, M) int64 cell keys, ascending
    origin: torch.Tensor         # (B, 3) float32, the target's min corner
    max_occupancy: torch.Tensor  # (B,) int64 points in the densest cell


def _cells(points: torch.Tensor, origin: torch.Tensor, cell: float) -> torch.Tensor:
    """(B, P, 3) -> (B, P, 3) int64 clipped cell coordinates."""
    c = torch.floor((points - origin.unsqueeze(1)) / cell).long()
    return c.clamp(0, _CMAX)


def _encode(c: torch.Tensor) -> torch.Tensor:
    return (c[..., 0] << (2 * _BITS)) | (c[..., 1] << _BITS) | c[..., 2]


@torch.no_grad()
def build_grid(tgt: torch.Tensor, cell: float) -> Grid:
    """Sort a (B, M, 3) target into `cell`-sized buckets."""
    tgt = tgt.float()
    origin = tgt.amin(dim=1)
    cid = _encode(_cells(tgt, origin, cell))
    cid_sorted, order = torch.sort(cid, dim=-1, stable=True)
    pts_sorted = torch.gather(tgt, 1, order.unsqueeze(-1).expand(-1, -1, 3))
    run = (torch.searchsorted(cid_sorted, cid_sorted, right=True)
           - torch.searchsorted(cid_sorted, cid_sorted))
    return Grid(pts_sorted, order, cid_sorted, origin, run.amax(dim=-1))


# the 27 stencil offsets in the JAX package's order (meshgrid 'ij')
_OFFSETS = [(i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)]


@torch.no_grad()
def nn1_radius(query: torch.Tensor, grid: Grid, cell: float, cap: int = 32):
    """The nearest target point within the 27-cell stencil of each query:
    query (B, N, 3) -> (d2 (B, N) float32, idx (B, N) int64 original
    target indices). A query without a candidate gets +inf (and index of
    the window's first slot)."""
    B, N, _ = query.shape
    q = query.float()
    qc = _cells(q, grid.origin, cell)                           # (B, N, 3)
    off = torch.tensor(_OFFSETS, dtype=torch.long, device=q.device)
    keys = _encode((qc.unsqueeze(2) + off).clamp(0, _CMAX))    # (B, N, 27)
    keys = keys.reshape(B, N * 27)
    start = torch.searchsorted(grid.cid_sorted, keys)
    end = torch.searchsorted(grid.cid_sorted, keys, right=True)
    slot = torch.arange(cap, device=q.device)
    cand = start.unsqueeze(-1) + slot                           # (B, N*27, cap)
    valid = (cand < end.unsqueeze(-1)).reshape(B, N, 27 * cap)
    M = grid.pts_sorted.shape[1]
    cand = cand.clamp_max(M - 1).reshape(B, N * 27 * cap)
    cpts = torch.gather(grid.pts_sorted, 1, cand.unsqueeze(-1).expand(-1, -1, 3))
    cids = torch.gather(grid.ids_sorted, 1, cand).reshape(B, N, 27 * cap)
    diff = q.unsqueeze(2) - cpts.reshape(B, N, 27 * cap, 3)
    sq = diff * diff
    d2 = (sq[..., 0] + sq[..., 1] + sq[..., 2]).clamp_min(1e-12)
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    best, at = d2.min(dim=-1)
    return best, torch.gather(cids, -1, at.unsqueeze(-1)).squeeze(-1)
