"""DGCNN edge-conv encoder, channel-last.

Five stages over edge features from one kNN graph on the raw xyz input:
Dense -> BN -> ReLU with a max over the k neighbours after each of the first
four; the four taps concatenate (64+64+128+256 = 512) into a final
Dense(emb_dims) -> BN -> ReLU.

In eval mode BatchNorm folds into per-channel (scale, bias) from the running
statistics, and the whole encoder is one call of `ops.cuda_dgcnn.dgcnn_eval`:
the fused CUDA kernel on the card, its plain version on the CPU. In training
it is `ops.dgcnn_train.dgcnn_train` (the graph_stage1 kernel, batch
statistics, a hand-written backward), and the five running-statistic pairs
update from the batch moments it returns.
"""
from __future__ import annotations

import torch
from torch import nn

from ogmm_tpu_torch.ops import dgcnn_train as _train
from ogmm_tpu_torch.ops.cuda_dgcnn import STAGES, dgcnn_eval


class DGCNN(nn.Module):
    def __init__(self, emb_dims: int = 512, k: int = 20,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.emb_dims, self.k, self.compute_dtype = emb_dims, k, dtype
        dims = [6, *STAGES]
        outs = [*STAGES, emb_dims]
        ins = dims[:4] + [sum(STAGES)]
        for i, (cin, cout) in enumerate(zip(ins, outs), start=1):
            setattr(self, f"w{i}", nn.Parameter(
                torch.randn(cin, cout) / cin ** 0.5))
            setattr(self, f"bn{i}_scale", nn.Parameter(torch.ones(cout)))
            setattr(self, f"bn{i}_bias", nn.Parameter(torch.zeros(cout)))
            self.register_buffer(f"bn{i}_mean", torch.zeros(cout))
            self.register_buffer(f"bn{i}_var", torch.ones(cout))

    def _folded_affine(self, i: int):
        """(scale, bias) folding the BN running statistics of stage i."""
        s = getattr(self, f"bn{i}_scale") * torch.rsqrt(
            getattr(self, f"bn{i}_var") + 1e-5)
        return s, getattr(self, f"bn{i}_bias") - getattr(self, f"bn{i}_mean") * s

    def forward(self, x: torch.Tensor, with_posenc_alpha: int = 0,
                posenc_centroid: torch.Tensor | None = None):
        """x (B, N, 3) -> (B, N, emb_dims) in the compute type; with
        `with_posenc_alpha` = k2 > 0 also the position-encoding angle
        features (B, N, k2) float32 of the k2 nearest neighbours."""
        if posenc_centroid is not None:
            raise ValueError(
                "posenc_centroid is not supported: the fused encoder takes "
                "the centroid of the cloud it is given")
        weights = [getattr(self, f"w{i}") for i in range(1, 6)]
        if self.training:
            return self._forward_train(x, weights, with_posenc_alpha)
        affines = [self._folded_affine(i) for i in range(1, 6)]
        return dgcnn_eval(x, weights, affines, k=self.k,
                          dtype=self.compute_dtype,
                          posenc_k=with_posenc_alpha)

    def _forward_train(self, x, weights, posenc_k):
        out, moments, alpha = _train.dgcnn_train(
            x, weights, [getattr(self, f"bn{i}_scale") for i in range(1, 6)],
            [getattr(self, f"bn{i}_bias") for i in range(1, 6)], k=self.k,
            dtype=self.compute_dtype, posenc_k=posenc_k)
        with torch.no_grad():
            for i, (mean, var) in enumerate(moments, start=1):
                ra_mean = getattr(self, f"bn{i}_mean")
                ra_var = getattr(self, f"bn{i}_var")
                ra_mean.copy_(0.9 * ra_mean + 0.1 * mean)
                ra_var.copy_(0.9 * ra_var + 0.1 * var)
        return (out, alpha) if posenc_k else out
