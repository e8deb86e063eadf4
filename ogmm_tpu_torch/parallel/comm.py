"""Collectives over an explicit `torch.distributed` process group, the
counterparts of the JAX package's axis primitives (`jax.lax.psum`, `pmax`,
`all_gather(tiled=True)`, `axis_index`, `axis_size`).

Every function takes `group`; `group=None` means one process (nothing is
sharded): the reductions return their input and the rank is 0. A group of
size one is a real group and takes the sharded code paths.

The forward-only forms (`psum`, `pmax`, `all_gather`) serve the point-sharded
eval forward. `psum_grad` is differentiable (`torch.distributed.nn`: its
backward is the all-reduce of the cotangent) and carries the global
BatchNorm statistics of data-parallel training (`batch_moments`).
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_size(group) -> int:
    """Processes in the group (1 for None)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group) -> int:
    """This process's rank in the group (0 for None)."""
    return 0 if group is None else dist.get_rank(group)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group's processes, on every process (no gradient)."""
    if group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
    return y


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise maximum of x over the group's processes (no gradient)."""
    if group is None:
        return x
    y = x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The processes' x concatenated along `dim` in rank order (every
    process gives the same shape; no gradient)."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(axis_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def row_range(n: int, group) -> tuple[int, int]:
    """This process's contiguous block [lo, hi) of n rows split over the
    group: rank r takes [r n // W, (r + 1) n // W)."""
    w, r = axis_size(group), axis_index(group)
    return r * n // w, (r + 1) * n // w


def gather_rows(x: torch.Tensor, n: int, group) -> torch.Tensor:
    """The inverse of `row_range`: each process's rows of a global (n, ...)
    tensor, x of this process's block, assembled on every process (blocks
    may differ by one row: padded for the collective, trimmed after)."""
    if group is None:
        return x
    w = axis_size(group)
    per = -(-n // w)
    pad = x.new_zeros((per - x.shape[0], *x.shape[1:]))
    parts = all_gather(torch.cat([x, pad]), group).split(per)
    return torch.cat([p[:(r + 1) * n // w - r * n // w]
                      for r, p in enumerate(parts)])


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return psum(x, group)

    @staticmethod
    def backward(ctx, g):
        return psum(g, ctx.group), None


def psum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over the group: the backward sums the cotangent
    over the group too (as `torch.distributed.nn`'s all_reduce does), so
    that each process's inputs get the gradient of the sum of every
    process's objective."""
    if group is None:
        return x
    return _PsumGrad.apply(x, group)


def batch_moments(x32: torch.Tensor, axes, group):
    """Global mean and biased variance of float32 x over `axes` and over the
    group's processes, differentiable, in two passes: the sums and the
    element count first, then the centred sum of squares about the global
    mean. (A mean of the processes' variances would miss the spread between
    their means; the single-pass E[x^2] - E[x]^2 cancels at large means.)"""
    s = x32.sum(axes)
    count = x32.new_full((1,), x32.numel() // max(s.numel(), 1))
    tot = psum_grad(torch.cat([s.reshape(-1), count]), group)
    mean = (tot[:-1] / tot[-1]).reshape(s.shape)
    d = x32 - mean
    var = psum_grad((d * d).sum(axes), group) / tot[-1]
    return mean, var
