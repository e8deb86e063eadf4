"""Geometric position encoding and anchor-conditioned transformer blocks,
channel-last. Heads split contiguously: (B, N, H, d_head). The BatchNorms of
the position encoding take batch statistics in training (`layers.BN`)."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ogmm_tpu_torch.nn.layers import BN, Dense, PointMLP
from ogmm_tpu_torch.ops import cuda_posenc
from ogmm_tpu_torch.ops.common import (gather_neighbors, knn, matmul32,
                                       posenc_alpha)


def angle_route(n: int, k: int, have_alpha: bool, have_graph: bool) -> str:
    """Where the position encoding's angle features of k neighbours over
    clouds of n points come from, the JAX package's branches
    (`ogmm_tpu/nn/attention.py:69-84`): 'given' (the caller supplies them),
    'kernel' (`ops.cuda_posenc.posenc_angles`: no graph given, N <= 1024;
    the port's kernel also needs k <= 32), else a gather of coordinates
    through the given graph's k-prefix ('graph') or through a kNN of the
    cloud ('knn')."""
    if have_alpha:
        return "given"
    if (not have_graph and n <= cuda_posenc.KERNEL_MAX_N
            and 1 <= k <= min(cuda_posenc.KERNEL_MAX_K, n)):
        return "kernel"
    return "graph" if have_graph else "knn"


class PositionEncoding(nn.Module):
    """Distance-to-centroid and neighbour-angle embedding of (B, N, 3):
      dist:  |p - centroid|^2 -> Dense(64) -> Dense(dim/2)
      angle: cos(angle(p->nbr_j, p->centroid)) over k neighbours
             -> Dense(64) -> max over k -> Dense(dim/2)
    concatenated to (B, N, dim). Bias-free Dense + BN + LeakyReLU(0.2)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = dtype
        self.dense0 = Dense(1, 64, bias=False, dtype=dtype)
        self.bn0 = BN(64, dtype)
        self.dense1 = Dense(64, dim // 2, bias=False, dtype=dtype)
        self.bn1 = BN(dim // 2, dtype)
        self.dense2 = Dense(1, 64, bias=False, dtype=dtype)
        self.bn2 = BN(64, dtype)
        self.dense3 = Dense(64, dim // 2, bias=False, dtype=dtype)
        self.bn3 = BN(dim // 2, dtype)

    def forward(self, points: torch.Tensor, k: int = 5,
                alpha: torch.Tensor | None = None,
                nbr_idx: torch.Tensor | None = None,
                centroid: torch.Tensor | None = None) -> torch.Tensor:
        """points (B, N, 3) -> (B, N, dim). `alpha` (B, N, k) supplies the
        angle features (the DGCNN encoder emits them from its own neighbour
        selection); `nbr_idx` (B, N, >= k) a graph whose k-prefix gives the
        neighbours; without either they come as `angle_route` says.
        `centroid` (B, 1, 3) replaces the points' own centroid (the sharded
        forward gives a process's rows and the whole cloud's centroid)."""
        if centroid is None:
            centroid = points.mean(dim=1, keepdim=True)
        g_dis = ((points - centroid) ** 2).sum(dim=-1, keepdim=True)
        h = F.leaky_relu(self.bn0(self.dense0(g_dis)), 0.2)
        dis_feature = F.leaky_relu(self.bn1(self.dense1(h)), 0.2)

        route = angle_route(points.shape[1], k, alpha is not None,
                            nbr_idx is not None)
        if route == "kernel":
            alpha = cuda_posenc.posenc_angles(points, k)
        elif route != "given":
            idx = (nbr_idx[..., :k] if route == "graph"
                   else knn(points, points, k))
            alpha = posenc_alpha(points, gather_neighbors(points, idx),
                                 centroid)
        a = F.leaky_relu(self.bn2(self.dense2(alpha.unsqueeze(-1))), 0.2)
        a = a.amax(dim=2)                                    # (B, N, 64)
        ang_feature = F.leaky_relu(self.bn3(self.dense3(a)), 0.2)
        return torch.cat([dis_feature, ang_feature], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scaled dot-product attention, (B, N, H, Dh) x (B, M, H, Dh) ->
    (B, N, H, Dh) in v's type. Scores and softmax in float32."""
    dh = q.shape[-1]
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, ., Dh)
    scores = matmul32(qh.float(), kh.float().transpose(-1, -2)) / dh ** 0.5
    prob = torch.softmax(scores, dim=-1)
    return torch.matmul(prob.to(v.dtype), vh).transpose(1, 2)


class MultiHeadAttention(nn.Module):
    def __init__(self, num_heads: int, d_model: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be a multiple of num_heads")
        self.num_heads = num_heads
        for i in range(4):                    # query, key, value, merge
            setattr(self, f"dense{i}", Dense(d_model, d_model, dtype=dtype))

    def forward(self, query, key, value):
        B, N, D = query.shape
        M = key.shape[1]
        H = self.num_heads
        q = self.dense0(query).reshape(B, N, H, D // H)
        k = self.dense1(key).reshape(B, M, H, D // H)
        v = self.dense2(value).reshape(B, M, H, D // H)
        return self.dense3(attention(q, k, v).reshape(B, N, D))


class TransformerBlock(nn.Module):
    """message = MHA(src, tgt, tgt); out = MLP([2d -> 2d -> d]) of
    concat[src, message]. The caller adds the residual. `fuse_eval` goes
    to the MLP, and so does `sp_group`: under point sharding the attention
    is already local (a process's queries against anchors every process
    holds) and only the MLP's InstanceNorm moments cross processes."""

    def __init__(self, feature_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, fuse_eval: bool = False,
                 sp_group=None):
        super().__init__()
        self.mha = MultiHeadAttention(num_heads, feature_dim, dtype)
        self.mlp = PointMLP(2 * feature_dim, (2 * feature_dim, feature_dim),
                            dtype, fuse_eval, sp_group)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        message = self.mha(src, tgt, tgt)
        return self.mlp(torch.cat([src.to(message.dtype), message], dim=-1))
