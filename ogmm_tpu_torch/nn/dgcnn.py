"""DGCNN edge-conv encoder, channel-last.

Five stages over edge features from one kNN graph on the raw xyz input:
Dense -> BN -> ReLU with a max over the k neighbours after each of the first
four; the four taps concatenate (64+64+128+256 = 512) into a final
Dense(emb_dims) -> BN -> ReLU.

Two routes over one parameter set, chosen from shapes by `fused_route`:

  fused    In eval mode BatchNorm folds into per-channel (scale, bias) from
           the running statistics, and the whole encoder is one call of
           `ops.cuda_dgcnn.dgcnn_eval`: the fused CUDA kernel on the card, its
           plain version on the CPU. In training it is
           `ops.dgcnn_train.dgcnn_train` (the graph_stage1 kernel, batch
           statistics, a hand-written backward), and the five
           running-statistic pairs update from the batch moments it returns.
  edges    With `fused_edges` (the config's `dgcnn_fused_edges=True`), an
           eval forward over a given graph above N = 1024 runs the stage
           chain through `ops.cuda_dgcnn.dgcnn_edges`, BN folded, as the
           JAX package's `dgcnn_edges_pallas` (`ogmm_tpu/nn/dgcnn.py:163-197`);
           the angles come from the same float32 neighbours. It raises in
           training and without a graph (`edges_route`); at a k or emb the
           kernel does not take, the unfused chain runs instead.
  unfused  The JAX package's jnp composition (`ogmm_tpu/nn/dgcnn.py:242-274`):
           a kNN graph (`ops.common.knn`) or a given one, the edge tensor
           [nbr - x, x] formed in float32 and cast, and per stage a product
           in the compute dtype with float32 accumulation, BatchNorm in the
           compute dtype from float32 statistics (the running ones in eval,
           unfolded; the batch moments with the biased variance in
           training, through autograd), ReLU and a max over k.

`bn_group` (set by `nn.layers.set_bn_group`) is the data-parallel group of
training: the batch moments of every stage are then those of the group's
global batch (`comm.batch_moments` on the unfused route, the same two
passes inside `ops.dgcnn_train` on the fused one), and the running
statistics move alike on every process.
"""
from __future__ import annotations

import torch
from torch import nn

from ogmm_tpu_torch.ops import dgcnn_train as _train
from ogmm_tpu_torch.ops.common import (gather_neighbors, knn, posenc_alpha)
from ogmm_tpu_torch.ops.cuda_dgcnn import (KERNEL_MAX_N, STAGES, dgcnn_edges,
                                           dgcnn_eval, kernel_takes)
from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import bn_apply
from ogmm_tpu_torch.parallel import comm


def fused_route(n: int, k: int, train: bool, have_graph: bool,
                fused_train: bool = True, emb: int = 512) -> bool:
    """Whether a DGCNN over clouds of n points with a k-neighbour graph and
    emb output channels takes the fused kernels. The JAX package's rule on
    its accelerator (`ogmm_tpu/nn/dgcnn.py:146-152`, `:199-208`): fused at
    N <= 1024 unless a graph is given, in training unless `fused_train` is
    False (`dgcnn_fused_train=False`), at any 1 <= k <= n, as the JAX
    kernels take. The port's eval kernel needs emb a multiple of 64
    (`ops.cuda_dgcnn.kernel_takes`); elsewhere the unfused route, which
    computes the same function. A given graph always takes the unfused
    route (the JAX eval kernel would ignore it; GMMReg gives one only above
    N = 1024)."""
    if have_graph or not 1 <= k <= n <= KERNEL_MAX_N:
        return False
    return fused_train if train else kernel_takes(k, emb)


def edges_route(n: int, train: bool, have_graph: bool, fused_edges: bool,
                k: int = 20, emb: int = 512) -> bool:
    """Whether a DGCNN that does not take the fused route runs its stage
    chain through the edges kernel, the JAX package's rule
    (`ogmm_tpu/nn/dgcnn.py:163-177`): only with `fused_edges`; never where
    the JAX package's whole-cloud eval kernel comes first (eval, N <= 1024);
    and an explicit `fused_edges` in training or without a graph raises
    rather than run another route, as there. The edges kernel takes any k;
    where it does not take emb (`ops.cuda_dgcnn.kernel_takes`) the unfused
    chain runs the same function."""
    if not fused_edges or (not train and n <= KERNEL_MAX_N):
        return False
    if train or not have_graph:
        raise ValueError(
            "fused_edges=True needs eval mode and a supplied graph (nbr_idx "
            "or nbr_xyz): the kernel folds BN running statistics and has no "
            "backward")
    return kernel_takes(k, emb)


class DGCNN(nn.Module):
    def __init__(self, emb_dims: int = 512, k: int = 20,
                 dtype: torch.dtype = torch.float32,
                 fused_train: bool = True, fused_edges: bool = False):
        super().__init__()
        self.emb_dims, self.k, self.compute_dtype = emb_dims, k, dtype
        self.fused_train, self.fused_edges = fused_train, fused_edges
        self.bn_group = None
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
                posenc_centroid: torch.Tensor | None = None,
                nbr_idx: torch.Tensor | None = None,
                nbr_xyz: torch.Tensor | None = None):
        """x (B, N, 3) -> (B, N, emb_dims) in the compute type; with
        `with_posenc_alpha` = k2 > 0 also the position-encoding angle
        features (B, N, k2) float32 of the k2 nearest neighbours, or None
        where the route does not make them (the unfused route without
        `nbr_xyz`).

        `nbr_idx` (B, N, k) supplies the graph, `nbr_xyz` (B, N, k, 3) its
        gathered float32 coordinates (it wins over `nbr_idx`); either sends
        the call down the unfused route, or the edges route (`edges_route`).
        `posenc_centroid` (B, 1, 3) is the centroid of the angles there; the
        fused route takes the centroid of the cloud it is given and refuses
        another."""
        weights = [getattr(self, f"w{i}") for i in range(1, 6)]
        have_graph = nbr_idx is not None or nbr_xyz is not None
        fused = fused_route(x.shape[1], self.k, self.training, have_graph,
                            self.fused_train, self.emb_dims)
        # the eval kernel comes first; an explicit fused_edges raises in
        # training whatever the route, as in the JAX package
        if (self.training or not fused) and edges_route(
                x.shape[1], self.training, have_graph, self.fused_edges,
                self.k, self.emb_dims):
            return self._forward_edges(x, weights, with_posenc_alpha,
                                       posenc_centroid, nbr_idx, nbr_xyz)
        if not fused:
            return self._forward_unfused(x, weights, with_posenc_alpha,
                                         posenc_centroid, nbr_idx, nbr_xyz)
        if posenc_centroid is not None:
            raise ValueError(
                "posenc_centroid is not supported on the fused route: the "
                "fused encoder takes the centroid of the cloud it is given")
        if self.training:
            return self._forward_train(x, weights, with_posenc_alpha)
        affines = [self._folded_affine(i) for i in range(1, 6)]
        return dgcnn_eval(x, weights, affines, k=self.k,
                          dtype=self.compute_dtype,
                          posenc_k=with_posenc_alpha)

    def _forward_edges(self, x, weights, posenc_k, centroid, nbr_idx,
                       nbr_xyz):
        x = x.float()
        if nbr_xyz is None:
            nbr_xyz = gather_neighbors(x, nbr_idx)
        affines = [self._folded_affine(i) for i in range(1, 6)]
        out = dgcnn_edges(x, nbr_xyz, weights, affines, k=self.k,
                          dtype=self.compute_dtype)
        if posenc_k:
            return out, posenc_alpha(x, nbr_xyz[:, :, :posenc_k], centroid)
        return out

    def _update_stats(self, i: int, mean, var):
        with torch.no_grad():
            ra_mean = getattr(self, f"bn{i}_mean")
            ra_var = getattr(self, f"bn{i}_var")
            ra_mean.copy_(0.9 * ra_mean + 0.1 * mean)
            ra_var.copy_(0.9 * ra_var + 0.1 * var)

    def _forward_train(self, x, weights, posenc_k):
        out, moments, alpha = _train.dgcnn_train(
            x, weights, [getattr(self, f"bn{i}_scale") for i in range(1, 6)],
            [getattr(self, f"bn{i}_bias") for i in range(1, 6)], k=self.k,
            dtype=self.compute_dtype, posenc_k=posenc_k, group=self.bn_group)
        for i, (mean, var) in enumerate(moments, start=1):
            self._update_stats(i, mean, var)
        return (out, alpha) if posenc_k else out

    def _bn(self, i: int, z: torch.Tensor) -> torch.Tensor:
        """BatchNorm of stage i over every axis but the last: float32 batch
        moments (biased variance) in training, updating the running ones;
        the running statistics in eval; normalised in z's dtype."""
        if self.training:
            axes = tuple(range(z.dim() - 1))
            if self.bn_group is not None:
                mean, var = comm.batch_moments(z.float(), axes, self.bn_group)
            else:
                var, mean = torch.var_mean(z.float(), dim=axes, unbiased=False)
            self._update_stats(i, mean.detach(), var.detach())
        else:
            mean, var = getattr(self, f"bn{i}_mean"), getattr(self, f"bn{i}_var")
        return bn_apply(z, mean, var, getattr(self, f"bn{i}_scale"),
                        getattr(self, f"bn{i}_bias"))

    def _forward_unfused(self, x, weights, posenc_k, centroid, nbr_idx,
                         nbr_xyz):
        x = x.float()
        alpha = None
        if nbr_xyz is None:
            idx = nbr_idx if nbr_idx is not None else knn(x, x, self.k)
            nbr_xyz = gather_neighbors(x, idx)
        elif posenc_k:
            alpha = posenc_alpha(x, nbr_xyz[:, :, :posenc_k], centroid)
        center = x.unsqueeze(2).expand_as(nbr_xyz)
        h = torch.cat([nbr_xyz - center, center], dim=-1).to(self.compute_dtype)
        taps = []
        for i in range(4):
            z = torch.matmul(h, weights[i].to(h.dtype))
            h = torch.relu(self._bn(i + 1, z))
            taps.append(h.amax(dim=2))                     # (B, N, C_i)
        cat = torch.cat(taps, dim=-1)                      # (B, N, 512)
        out = torch.relu(self._bn(5, torch.matmul(cat, weights[4].to(cat.dtype))))
        return (out, alpha) if posenc_k else out
