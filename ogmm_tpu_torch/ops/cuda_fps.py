"""Farthest-point sampling from a given state: the CUDA kernel's wrapper and
its plain version, the loop of tensor operations.

`fps(xyz, npoint, distance, start)` runs the FPS chain over (R, N, 3) rows
from an initial distance row (R, N) and a start index (R,) each: step i
takes `start` (then the previous step's choice) as sample i, lowers every
point's distance to the squared distance from it, and picks the point of
largest distance next, ties to the lowest index. The state in, not a mode,
lets one launch serve rows that start differently (`ops.fps.fps_combined`:
random-start anchors and centre-start clustering seeds).

On a CUDA tensor the wrapper launches `csrc/fps.cu` (any N: the rows sit in
shared memory up to 10,240 points and are read from L2 beyond); on a CPU
tensor it runs `fps_reference`. `ops.fps` reaches it with `use_kernel=True`.
"""
from __future__ import annotations

import ctypes

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


def _fps_cuda(xyz, npoint, distance, start):
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
    xyz = xyz.float().contiguous()
    dist = distance.float().clone(memory_format=torch.contiguous_format)
    start = start.long().contiguous()
    ids = torch.empty(R, npoint, dtype=torch.int64, device=xyz.device)
    fn = dispatch.load_kernel("fps").fps_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    code = fn(*[ctypes.c_void_p(a.data_ptr()) for a in (xyz, dist, start, ids)],
              R, N, npoint, ctypes.c_void_p(dispatch.current_stream(xyz)))
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
