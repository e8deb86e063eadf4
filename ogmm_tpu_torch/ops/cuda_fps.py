"""Farthest-point sampling from a given state: the CUDA kernel's wrapper and
its plain version, the loop of tensor operations.

`fps(xyz, npoint, distance, start)` runs the FPS chain over (R, N, 3) rows
from an initial distance row (R, N) and a start index (R,) each: step i
takes `start` (then the previous step's choice) as sample i, lowers every
point's distance to the squared distance from it, and picks the point of
largest distance next, ties to the lowest index. The state in, not a mode,
lets one launch serve rows that start differently (`ops.fps.fps_combined`:
random-start anchors and centre-start clustering seeds).

On a CUDA tensor the wrapper launches `csrc/fps.cu` as `fps_plan` says (any
N): a block or a thread block cluster a row with the points and running
distances in registers, P contiguous points a thread (up to 16 blocks of
8,192 points a row), and beyond that the L2 route, one block a row reading
the points and a scratch copy of the distances from L2; on a CPU tensor it
runs `fps_reference`. `ops.fps` reaches it with `use_kernel=True`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ogmm_tpu_torch.ops import dispatch


@torch.no_grad()
def fps_reference(xyz: torch.Tensor, npoint: int, distance: torch.Tensor,
                  start: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one step of tensor operations a sample, the
    squared distance summed x, y, z in that order (a `sum(-1)` on the card
    adds in another order). The step writes into buffers made once, through
    views made once, and the ids are stacked at the end: 7 launches a step
    and less host work than the `sum(-1)` loop. Returns int64 (R, npoint)."""
    rows = torch.arange(xyz.shape[0], device=xyz.device)
    distance = distance.clone()
    sq = torch.empty_like(xyz)
    x2, y2, z2 = sq.unbind(-1)
    dist = torch.empty_like(distance)
    ids = [start]
    for _ in range(npoint - 1):
        torch.sub(xyz, xyz[rows, ids[-1]].unsqueeze(1), out=sq)
        sq.square_()
        torch.add(x2, y2, out=dist).add_(z2)
        torch.minimum(distance, dist, out=distance)
        ids.append(distance.argmax(dim=-1))
    return torch.stack(ids, dim=1)[:, :npoint].long()


class FpsPlan(NamedTuple):
    """One launch of `csrc/fps.cu`: `cluster` blocks a row of `threads`
    threads, `points` contiguous points a thread in registers (route
    "registers"), or one block a row over L2 (route "l2", points 0)."""
    cluster: int
    threads: int
    points: int
    route: str


# points a thread the register routes compile -> the most threads of such a
# block (csrc/fps.cu:FpsThreads, its launch bounds)
FPS_POINTS = {2: 1024, 4: 1024, 8: 768, 16: 512}
# blocks a row: a thread block cluster above 1 (above 8 non-portable)
FPS_CLUSTERS = (1, 2, 4, 8, 16)
# the fewest points a thread of a block a row (fewer warps to reduce a
# step, more points a thread to update); a cluster's blocks take the most
# (its step waits on every warp's record through distributed shared memory)
FPS_MIN_POINTS = 4
# a row spreads over twice the blocks while each keeps at least this many
# points and the rows' blocks still fit the card at one block an SM
FPS_SPREAD_POINTS = 2048
FPS_L2_THREADS = 1024
_ROUTES = {"registers": 0, "l2": 1}


def _block_plan(cluster: int, N: int, min_points: int = FPS_MIN_POINTS):
    """(threads, points) of the blocks of a row of N points split over
    `cluster` blocks: the fewest points a thread (at least `min_points`)
    whose block holds its ceil(N / cluster) points, threads a multiple of
    32; None where no compiled block holds them."""
    share = -(-N // cluster)
    for points, most in sorted(FPS_POINTS.items()):
        if points < min_points:
            continue
        threads = 32 * -(-(-(-share // points)) // 32)
        if threads <= most:
            return threads, points
    return None


@functools.lru_cache(maxsize=None)
def fps_plan(R: int, N: int, n_sm: int) -> FpsPlan:
    """The kernel's launch for R rows of N points on n_sm SMs: the fewest
    blocks a row whose blocks hold it in registers, doubled while each block
    keeps FPS_SPREAD_POINTS points and the R rows' blocks fit the card, at
    FPS_MIN_POINTS or more points a thread for a block a row and the most
    for a cluster; the L2 route where even FPS_CLUSTERS[-1] blocks cannot
    hold the row."""
    cluster = next((c for c in FPS_CLUSTERS if _block_plan(c, N)), None)
    if cluster is None:
        return FpsPlan(1, FPS_L2_THREADS, 0, "l2")
    while (2 * cluster <= FPS_CLUSTERS[-1] and R * 2 * cluster <= n_sm
           and -(-N // (2 * cluster)) >= FPS_SPREAD_POINTS):
        cluster *= 2
    points = FPS_MIN_POINTS if cluster == 1 else max(FPS_POINTS)
    return FpsPlan(cluster, *_block_plan(cluster, N, points), "registers")


def compiled_plans(R: int, N: int, n_sm: int) -> list:
    """The launches the kernel compiles near `fps_plan`'s for this shape
    (half, the same and twice its blocks a row, each points a thread that
    holds the row there), then the L2 route: the probe's sweep."""
    near = fps_plan(R, N, n_sm).cluster
    plans = []
    for c in (c for c in FPS_CLUSTERS if near // 2 <= c <= 2 * near):
        for points in FPS_POINTS:
            bp = _block_plan(c, N, points)
            if bp is not None and bp[1] == points:
                plans.append(FpsPlan(c, *bp, "registers"))
    return plans + [FpsPlan(1, FPS_L2_THREADS, 0, "l2")]


def fps_ranges(plan: FpsPlan, N: int) -> list:
    """The points [start, stop) each thread of a row owns on a register
    route, in (block rank, thread) order, as `csrc/fps.cu:fps_reg_kernel`
    sets them: block r owns [r S, r S + S) (S = ceil(N / cluster)), its
    thread t the P points from r S + t P, cut at the share's end and N."""
    S, P = -(-N // plan.cluster), plan.points
    ranges = []
    for r in range(plan.cluster):
        hi = min(N, (r + 1) * S)
        ranges += [(min(hi, r * S + t * P), min(hi, r * S + (t + 1) * P))
                   for t in range(plan.threads)]
    return ranges


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _fps_cuda(xyz, npoint, distance, start, plan=None):
    R, N, C = xyz.shape
    if C != 3 or distance.shape != (R, N) or start.shape != (R,):
        raise ValueError(f"fps kernel takes xyz (R, N, 3), distance (R, N) and "
                         f"start (R,); got {tuple(xyz.shape)}, "
                         f"{tuple(distance.shape)}, {tuple(start.shape)}")
    if npoint < 1 or N < 1:
        raise ValueError(f"fps kernel takes N >= 1 and npoint >= 1; got N={N}, "
                         f"npoint={npoint}")
    if not (distance.is_cuda and start.is_cuda):
        raise ValueError("fps kernel takes the state on the points' device")
    if plan is None:
        plan = fps_plan(R, N, _n_sm(xyz.get_device()))
    xyz = xyz.float().contiguous()
    # the register routes only read the distances; the L2 route keeps its
    # running distances in a scratch copy
    dist = (distance.float().clone(memory_format=torch.contiguous_format)
            if plan.route == "l2" else distance.float().contiguous())
    start = start.long().contiguous()
    ids = torch.empty(R, npoint, dtype=torch.int64, device=xyz.device)
    fn = dispatch.kernel_fn("fps", "fps_launch", (ctypes.c_void_p,) * 4
                            + (ctypes.c_int,) * 7 + (ctypes.c_void_p,))
    code = fn(*[ctypes.c_void_p(a.data_ptr()) for a in (xyz, dist, start, ids)],
              R, N, npoint, plan.cluster, plan.threads, plan.points,
              _ROUTES[plan.route], ctypes.c_void_p(dispatch.current_stream(xyz)))
    dispatch.check_launch(code, "fps")
    dispatch.launch_counts["fps"] += 1
    return ids


def fps(xyz: torch.Tensor, npoint: int, distance: torch.Tensor,
        start: torch.Tensor) -> torch.Tensor:
    """FPS ids (R, npoint) int64 of (R, N, 3) rows from the initial
    distances (R, N) and start indices (R,). Launches the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor."""
    if xyz.is_cuda:
        return _fps_cuda(xyz, npoint, distance, start)
    return fps_reference(xyz, npoint, distance, start)
