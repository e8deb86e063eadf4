"""Geometric position encoding and anchor-conditioned transformer blocks,
channel-last. Heads split contiguously: (B, N, H, d_head). The BatchNorms of
the position encoding take batch statistics in training (`layers.BN`)."""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from ogmm_tpu_torch.nn.layers import BN, Dense, PointMLP
from ogmm_tpu_torch.ops.common import (gather_neighbors, knn, matmul32,
                                       posenc_alpha)


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
                alpha: torch.Tensor | None = None) -> torch.Tensor:
        """points (B, N, 3) -> (B, N, dim). `alpha` (B, N, k) supplies the
        angle features (the fused DGCNN encoder emits them from its own
        neighbour selection); without it they come from a dense kNN."""
        centroid = points.mean(dim=1, keepdim=True)
        g_dis = ((points - centroid) ** 2).sum(dim=-1, keepdim=True)
        h = F.leaky_relu(self.bn0(self.dense0(g_dis)), 0.2)
        dis_feature = F.leaky_relu(self.bn1(self.dense1(h)), 0.2)

        if alpha is None:
            nbr = gather_neighbors(points, knn(points, points, k))
            alpha = posenc_alpha(points, nbr, centroid)
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
    concat[src, message]. The caller adds the residual."""

    def __init__(self, feature_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.mha = MultiHeadAttention(num_heads, feature_dim, dtype)
        self.mlp = PointMLP(2 * feature_dim, (2 * feature_dim, feature_dim),
                            dtype)

    def forward(self, src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
        message = self.mha(src, tgt, tgt)
        return self.mlp(torch.cat([src.to(message.dtype), message], dim=-1))
