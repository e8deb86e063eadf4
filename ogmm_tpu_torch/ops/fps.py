"""Farthest-point sampling.

The 128-step chain is inherent to FPS; each step is one (B, N) distance
update and an argmax (ties to the lowest index). By default it runs as a
loop of tensor operations (`ops.cuda_fps.fps_reference`); with
`use_kernel=True` as one `fps` kernel launch for all rows
(`ops.cuda_fps.fps`), the counterpart of the JAX package's
`use_pallas=True` (`ogmm_tpu/ops/fps.py:44-52`). `nn.gmmreg.GMMReg` passes
its `loop_kernels` flag. The random start of the non-centre variant comes
from an explicit `torch.Generator`. The kernel and its plain version take
3-D points; rows of another width (`ops.gmm.wkeans` over features) take a
loop of tensor operations over any width, whatever `use_kernel` says.
"""
from __future__ import annotations

import torch

from ogmm_tpu_torch.ops import cuda_fps


def _random_start(B: int, N: int, generator: torch.Generator | None,
                  device) -> torch.Tensor:
    if generator is None:
        return torch.zeros(B, dtype=torch.long, device=device)
    return torch.randint(0, N, (B,), generator=generator,
                         device=generator.device).to(device)


def _center_state(xyz: torch.Tensor):
    centroid = xyz.mean(dim=1, keepdim=True)
    dist = ((xyz - centroid) ** 2).sum(-1).clamp_max(1e10)
    return dist, dist.argmax(dim=-1)


@torch.no_grad()
def _fps_any_width(x: torch.Tensor, npoint: int, distance: torch.Tensor,
                   farthest: torch.Tensor) -> torch.Tensor:
    """The FPS recurrence over (R, N, C) rows of any width C, the squared
    distance summed by `sum(-1)`."""
    rows = torch.arange(x.shape[0], device=x.device)
    distance = distance.clone()
    ids = [farthest]
    for _ in range(npoint - 1):
        d = ((x - x[rows, ids[-1]].unsqueeze(1)) ** 2).sum(-1)
        distance = torch.minimum(distance, d)
        ids.append(distance.argmax(dim=-1))
    return torch.stack(ids, dim=1)[:, :npoint].long()


def _fps_loop(xyz: torch.Tensor, npoint: int, distance: torch.Tensor,
              farthest: torch.Tensor, use_kernel: bool) -> torch.Tensor:
    """The FPS recurrence from an explicit (distance, start) state."""
    if xyz.shape[-1] != 3:
        return _fps_any_width(xyz, npoint, distance, farthest)
    if use_kernel:
        return cuda_fps.fps(xyz, npoint, distance, farthest)
    return cuda_fps.fps_reference(xyz, npoint, distance, farthest)


def farthest_point_sample(xyz: torch.Tensor, npoint: int,
                          is_center: bool = False,
                          generator: torch.Generator | None = None,
                          use_kernel: bool = False,
                          start: torch.Tensor | None = None) -> torch.Tensor:
    """Sample `npoint` indices per cloud: xyz (B, N, C) -> int64 (B, npoint).
    `is_center` starts from the point farthest from the centroid; otherwise
    from `start` (B,) where given, else a random index drawn from
    `generator` (index 0 without one). `use_kernel` runs the chain as one
    kernel launch."""
    B, N, _ = xyz.shape
    if is_center:
        distance, farthest = _center_state(xyz)
    else:
        distance = xyz.new_full((B, N), 1e10)
        farthest = (_random_start(B, N, generator, xyz.device)
                    if start is None else start)
    return _fps_loop(xyz, npoint, distance, farthest, use_kernel)


def fps_combined(xyz: torch.Tensor, npoint: int,
                 generator: torch.Generator | None = None,
                 use_kernel: bool = False,
                 start: torch.Tensor | None = None):
    """Anchor FPS and centre-seeded FPS over the same clouds in one 2B-row
    loop (one kernel launch with `use_kernel`): the chain's cost is per
    step, not per row. The anchors start at `start` (B,) where given, as in
    `farthest_point_sample`.
    Returns (anchor_ids (B, npoint), center_ids (B, npoint))."""
    B, N, _ = xyz.shape
    dist_center, start_center = _center_state(xyz)
    if start is None:
        start = _random_start(B, N, generator, xyz.device)
    ids = _fps_loop(
        torch.cat([xyz, xyz], dim=0), npoint,
        torch.cat([xyz.new_full((B, N), 1e10), dist_center], dim=0),
        torch.cat([start, start_center]), use_kernel)
    return ids[:B], ids[B:]
