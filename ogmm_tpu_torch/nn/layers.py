"""Shared point-wise layers, channel-last (B, N, C).

A 1x1 conv over (B, C, N) is a Linear over (B, N, C). Parameters and
running statistics stay float32; a layer computes in the `dtype` it was
built with (the network body's compute type) by casting on the way in.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

from ogmm_tpu_torch.ops import cuda_mlp


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
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


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm1d (no affine) for (B, N, C): normalise over N, moments
    in float32 whatever the compute type."""
    x32 = x.float()
    var, mean = torch.var_mean(x32, dim=-2, keepdim=True, unbiased=False)
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
    so, reading the same parameters."""

    def __init__(self, in_size: int, channels: Sequence[int],
                 dtype: torch.dtype = torch.float32, fuse_eval: bool = False):
        super().__init__()
        sizes = [in_size] + list(channels)
        self.n_layers = len(channels)
        self.channels = tuple(channels)
        self.compute_dtype = dtype
        self.fuse_eval = fuse_eval
        for i in range(self.n_layers):
            setattr(self, f"dense{i}", Dense(sizes[i], sizes[i + 1], dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if cuda_mlp.mlp_route(self.fuse_eval, self.training, x.shape,
                              self.channels, self.compute_dtype):
            return cuda_mlp.pointmlp_eval(
                x, self.dense0.weight, self.dense0.bias, self.dense1.weight,
                self.dense1.bias, self.compute_dtype)
        for i in range(self.n_layers):
            x = getattr(self, f"dense{i}")(x)
            if i < self.n_layers - 1:
                x = torch.relu(instance_norm(x))
        return x
