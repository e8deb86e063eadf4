"""Shared point-wise layers, channel-last (B, N, C).

A 1x1 conv over (B, C, N) is a Linear over (B, N, C). Parameters and
running statistics stay float32; a layer computes in the `dtype` it was
built with (the network body's compute type) by casting on the way in.

Groups (`torch.distributed` process groups, None for one process): a
BatchNorm's `bn_group` (set on a whole model by `set_bn_group`) is the
data-parallel group of training, over which its batch statistics are
global; `instance_norm` and `PointMLP` take the point-sharding group of the
sharded eval forward (`parallel/sp.py`).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ogmm_tpu_torch.ops import cuda_mlp
from ogmm_tpu_torch.parallel import comm


class Dense(nn.Linear):
    """Linear layer that computes in `dtype`."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class BN(nn.Module):
    """BatchNorm over the trailing feature axis, eps 1e-5, the semantics of
    flax `nn.BatchNorm(momentum=0.9)`: in training it normalises with the
    batch statistics (float32, biased variance E[x^2] - E[x]^2 clipped at
    0) and updates running = 0.9 running + 0.1 batch with that same biased
    variance (`F.batch_norm` would store the unbiased one); in eval it uses
    the running statistics. The affine is applied in float32 and the result
    cast to the compute type. `update_stats=False` keeps the running
    statistics in training (the recompute of `nn.gmmreg._remat`)."""

    def __init__(self, features: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.update_stats = True
        self.bn_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if self.bn_group is not None:
                mean, var = comm.batch_moments(x32, axes, self.bn_group)
            else:
                mean = x32.mean(axes)
                var = ((x32 * x32).mean(axes) - mean * mean).clamp_min(0.0)
            if self.update_stats:
                with torch.no_grad():
                    self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                    self.running_var.copy_(0.9 * self.running_var + 0.1 * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + 1e-5) * self.weight
        y = (x32 - mean) * mul + self.bias
        return y.to(self.compute_dtype)


def set_bn_group(model: nn.Module, group) -> None:
    """Make every BatchNorm of `model` (`BN`, the DGCNN's stage norms) take
    its batch statistics over the data-parallel `group` (None: this
    process's batch only)."""
    for m in model.modules():
        if hasattr(m, "bn_group"):
            m.bn_group = group


def instance_norm(x: torch.Tensor, eps: float = 1e-5,
                  group=None) -> torch.Tensor:
    """InstanceNorm1d (no affine) for (B, N, C): normalise over N, moments
    in float32 whatever the compute type. With a point-sharding `group` x
    holds this process's rows of each cloud and the moments cover all of
    them: the sum and the count all-reduced, then the centred sum of
    squares (two passes: the single-pass form cancels at large means)."""
    x32 = x.float()
    if group is None:
        var, mean = torch.var_mean(x32, dim=-2, keepdim=True, unbiased=False)
    else:
        count = x32.new_full(x32.shape[:-2] + (1, 1),
                             float(x32.shape[-2]))
        tot = comm.psum(torch.cat([x32.sum(dim=-2, keepdim=True), count], -1),
                        group)
        mean = tot[..., :-1] / tot[..., -1:]
        d = x32 - mean
        var = comm.psum((d * d).sum(dim=-2, keepdim=True), group) / tot[..., -1:]
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class ConvHead(nn.Module):
    """Projection / overlap / fusion head:
    deep:    Dense(h)+BN+ReLU -> Dense(h)+BN+ReLU -> Dense(out)
    shallow: Dense(h)+BN+ReLU -> Dense(out)"""

    def __init__(self, in_size: int, out_size: int, hidden_size: int,
                 deep: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        sizes = [in_size] + [hidden_size] * (2 if deep else 1)
        self.n_hidden = len(sizes) - 1
        for i in range(self.n_hidden):
            setattr(self, f"dense{i}", Dense(sizes[i], sizes[i + 1], dtype=dtype))
            setattr(self, f"bn{i}", BN(sizes[i + 1], dtype))
        setattr(self, f"dense{self.n_hidden}",
                Dense(hidden_size, out_size, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = getattr(self, f"dense{i}")(x)
            x = torch.relu(getattr(self, f"bn{i}")(x))
        return getattr(self, f"dense{self.n_hidden}")(x)


class PointMLP(nn.Module):
    """Dense + InstanceNorm + ReLU stack; no norm or ReLU after the last.
    `fuse_eval` (the JAX attribute, off by default) runs the two-layer eval
    chain as one `pointmlp` kernel call where `ops.cuda_mlp.mlp_route` says
    so, reading the same parameters. `sp_group` shards the point axis: the
    InstanceNorm moments cover the group's rows, and the layer chain runs
    (the fused kernel holds a whole cloud)."""

    def __init__(self, in_size: int, channels: Sequence[int],
                 dtype: torch.dtype = torch.float32, fuse_eval: bool = False,
                 sp_group=None):
        super().__init__()
        self.sp_group = sp_group
        sizes = [in_size] + list(channels)
        self.n_layers = len(channels)
        self.channels = tuple(channels)
        self.compute_dtype = dtype
        self.fuse_eval = fuse_eval
        for i in range(self.n_layers):
            setattr(self, f"dense{i}", Dense(sizes[i], sizes[i + 1], dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if cuda_mlp.mlp_route(self.fuse_eval, self.training, x.shape,
                              self.channels, self.compute_dtype, self.sp_group):
            return cuda_mlp.pointmlp_eval(
                x, self.dense0.weight, self.dense0.bias, self.dense1.weight,
                self.dense1.bias, self.compute_dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"dense{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(instance_norm(x, group=self.sp_group))
        return x
