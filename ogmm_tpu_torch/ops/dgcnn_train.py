"""Differentiable DGCNN training forward with a hand-written backward.

The port of `ogmm_tpu/ops/dgcnn_train.py` (the custom VJP the JAX package
runs by default on the accelerator) as a `torch.autograd.Function`:

  forward   `graph_stage1` (the CUDA kernel on the card: kNN graph, edge rows
            [nbr - q, q], pre-BN z1 in (B, k, N, C) layout), then stages 2-4
            as products in the compute dtype with float32 accumulation; each
            stage is BatchNorm with batch moments (float32, biased variance,
            eps 1e-5, normalised in the compute dtype), ReLU and a max over
            k; the four maxima concatenate to 512 channels for stage 5
            (Dense(emb) + BN + ReLU).
  backward  stage 5 and the tap cotangents in PyTorch; stages 4..1 either
            in plain PyTorch, the mirror of `_bwd_vjp`: per stage the BN
            batch-statistic gradient dz = s (dy - E[dy] - zhat E[dy zhat])
            with float32 reductions, weight gradients from the saved pre-BN
            activations (h recomputed), and the edge scatter into dx
            (`index_add_`); or, with `BWD_KERNELS` on and a shape they
            take (`bwd_kernels_take`: 1 <= k <= 32, k <= N <= 1024),
            through the three backward kernels of `ops/cuda_dgcnn_bwd.py`
            (five launches: the sums of stage 4, stages 4, 3 and 2, then
            stage 1 and dx), as the JAX package's `_bwd_pallas`.

Kept from the JAX function: the ReLU cotangent at exactly 0 is half the
incoming one (`jnp.maximum` semantics); the max over k sends a tie's
cotangent to the FIRST maximal element through an integer argmax one-hot,
never through a float-equality mask on recomputed values.

Returns (features (B, N, emb) in the compute dtype, five (mean, var) float32
batch moments for the caller's running-statistic update, alpha or None).

With a data-parallel `group` (each process holding a block of the batch)
the batch moments are the global batch's, in two passes (the sums and the
count all-reduced, then the centred sum of squares), and the backward's
E[dy] and E[dy zhat] are all-reduced too; dgamma and dbeta stay this
process's sums, as every weight gradient does, for the trainer's gradient
all-reduce. The backward kernels fuse those column sums inside
`bwd_stage`, between the stages, where no collective can reach them:
`bwd_kernels_take` refuses a group of more than one process, and
`BWD_KERNELS` on under one raises rather than run the plain backward.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import (EPS, bn_apply, bwd_edge,
                                              bwd_reduce, bwd_stage, edge_vjp,
                                              kernels_take, max_vjp, mm32,
                                              relu_vjp)
from ogmm_tpu_torch.ops.cuda_dgcnn_train import graph_stage1
from ogmm_tpu_torch.parallel import comm

# stages 4..1 of the backward through the kernels of ops/cuda_dgcnn_bwd.py
# (the counterpart of the JAX package's _BWD_PALLAS, off by default as
# there; on a CPU tensor the kernels' plain versions run)
BWD_KERNELS = False


def bwd_kernels_take(k: int, n: int, group=None) -> bool:
    """Whether the backward kernels take a graph of k neighbours over clouds
    of n points (`cuda_dgcnn_bwd.kernels_take`: 1 <= k <= 32, k <= n <=
    1024; the JAX rule takes any k at n <= 1024, and k > 32 is this port's
    departure: the forward's graph kernel takes it, `cuda_dgcnn_train.
    graph_takes`, and the backward runs plain), and the batch is this
    process's alone (the kernels sum the BatchNorm columns inside a stage:
    no data-parallel group of more than one process); other shapes take the
    plain backward even with `BWD_KERNELS` on."""
    return kernels_take(k, n) and comm.axis_size(group) == 1


def _refuse_bwd_kernels(group) -> None:
    """`BWD_KERNELS` on under a data-parallel group of more than one process
    raises: the plain backward is never run in its place silently (the JAX
    package's rule for its fused path and sync-BN, `nn/dgcnn.py:209-217`)."""
    if BWD_KERNELS and comm.axis_size(group) > 1:
        raise ValueError(
            "BWD_KERNELS=True is incompatible with a data-parallel group of "
            "more than one process: the backward kernels sum the BatchNorm "
            "columns inside a stage and cannot all-reduce them; turn "
            "BWD_KERNELS off")


def _moments(z, group=None):
    """Batch mean and biased variance over every axis but the last, in
    float32, over the group's global batch where there is a group."""
    axes = tuple(range(z.dim() - 1))
    if group is not None:
        return comm.batch_moments(z.float(), axes, group)
    var, mean = torch.var_mean(z.float(), dim=axes, unbiased=False)
    return mean, var


def _stage_bwd(dy, z, mean, var, gamma, group=None):
    """BatchNorm (batch statistics) backward: dy, already through the ReLU
    -> (dz in the compute dtype, dgamma, dbeta), reductions in float32.
    Forms zhat and dy in float32 once; `bn_sums` then `bn_dz` of the plain
    versions form them twice, a pass more over each (B, k, N, C) tensor.
    With a group the column sums and the count behind E[dy] and E[dy zhat]
    are the global batch's; dgamma and dbeta are this process's sums."""
    axes = tuple(range(z.dim() - 1))
    m = z[..., 0].numel()
    inv = torch.rsqrt(var + EPS)
    zhat = (z.float() - mean) * inv
    dy32 = dy.float()
    s1 = dy32.sum(axes)                                  # dbeta
    s2 = (dy32 * zhat).sum(axes)                         # dgamma
    g1, g2 = s1, s2
    if group is not None:
        tot = comm.psum(torch.cat([s1, s2, s1.new_full((1,), float(m))]),
                        group)
        g1, g2, m = tot[:s1.numel()], tot[s1.numel():-1], tot[-1]
    dz = (inv * gamma) * (dy32 - g1 / m - zhat * (g2 / m))
    return dz.to(dy.dtype), s2, s1


def _bwd_kernels(x, idx, e, zs, dtaps, ws, gammas, betas, moments, dws, dgs,
                 dbs):
    """Stages 4..1 through the three backward kernels, in the order of the
    JAX package's `_bwd_pallas`; fills dws/dgs/dbs[0:4] and returns dx."""
    s = {3: bwd_reduce(zs[3], dtaps[3], *moments[3], gammas[3], betas[3])}
    dz = None
    for i in (3, 2, 1):
        dz, dws[i], s[i - 1] = bwd_stage(
            zs[i], dtaps[i], *moments[i], gammas[i], betas[i], s[i], ws[i],
            zs[i - 1], *moments[i - 1], gammas[i - 1], betas[i - 1],
            dtaps[i - 1], dznext=dz, wnext=ws[i + 1] if i < 3 else None)
        dgs[i], dbs[i] = s[i][1], s[i][0]
    dws[0], dq, dscat = bwd_edge(zs[0], dtaps[0], *moments[0], gammas[0],
                                 betas[0], s[0], dz, ws[1], e, ws[0], idx)
    dgs[0], dbs[0] = s[0][1], s[0][0]
    return (dq + dscat).to(x.dtype)


class DGCNNTrain(torch.autograd.Function):
    """apply(x, k, dtype, posenc_k, group, w1..w5, g1..g5, b1..b5)."""

    @staticmethod
    def forward(ctx, x, k, dtype, posenc_k, group, *params):
        ctx.group = group
        ws, gammas, betas = params[:5], params[5:10], params[10:]
        z, e, idx, alpha = graph_stage1(x, ws[0], k, dtype, posenc_k)
        zs, taps, moments = [], [], []
        h = e
        for i in range(4):
            if i > 0:
                z = torch.matmul(h, ws[i].to(dtype))
            mean, var = _moments(z, group)
            h = torch.relu(bn_apply(z, mean, var, gammas[i], betas[i]))
            zs.append(z)
            moments.append((mean, var))
            taps.append(h.amax(dim=1))                   # (B, N, C_i)
        cat = torch.cat(taps, dim=-1)                    # (B, N, 512)
        z5 = torch.matmul(cat, ws[4].to(dtype))
        mean5, var5 = _moments(z5, group)
        out = torch.relu(bn_apply(z5, mean5, var5, gammas[4], betas[4]))
        moments.append((mean5, var5))
        flat = [m for mv in moments for m in mv]
        ctx.save_for_backward(x, idx, e, *zs, z5, *taps, *params, *flat)
        ctx.mark_non_differentiable(*flat)
        if alpha is not None:
            ctx.mark_non_differentiable(alpha)
        return (out, *flat, alpha)

    @staticmethod
    def backward(ctx, dout, *_):
        saved = ctx.saved_tensors
        x, idx, e = saved[:3]
        zs, z5, taps = saved[3:7], saved[7], saved[8:12]
        ws, gammas, betas = saved[12:17], saved[17:22], saved[22:27]
        mv = saved[27:]
        moments = [(mv[2 * i], mv[2 * i + 1]) for i in range(5)]
        group = ctx.group
        _refuse_bwd_kernels(group)
        dt = z5.dtype
        dout = dout.to(dt)

        # stage 5, (B, N, 512) -> (B, N, emb)
        mean5, var5 = moments[4]
        dy5 = relu_vjp(dout, bn_apply(z5, mean5, var5, gammas[4], betas[4]))
        dz5, dg5, db5 = _stage_bwd(dy5, z5, mean5, var5, gammas[4], group)
        cat = torch.cat(taps, dim=-1)
        dws, dgs, dbs = [None] * 5, [None] * 5, [None] * 5
        dws[4] = mm32(cat.flatten(0, 1).t(), dz5.flatten(0, 1))
        dgs[4], dbs[4] = dg5, db5
        dcat = torch.matmul(dz5, ws[4].to(dt).t())
        dtaps = torch.split(dcat, [t.shape[-1] for t in taps], dim=-1)

        if BWD_KERNELS and bwd_kernels_take(zs[0].shape[1], zs[0].shape[2],
                                            group):
            dx = _bwd_kernels(x, idx, e, zs, dtaps, ws, gammas, betas,
                              moments, dws, dgs, dbs)
            return (dx, None, None, None, None, *dws, *dgs, *dbs)

        # stages 4..1, (B, k, N, C)
        hs = [e] + [torch.relu(bn_apply(zs[i], *moments[i], gammas[i],
                                          betas[i])) for i in range(4)]
        dz_next = None
        for i in range(3, -1, -1):
            mean, var = moments[i]
            dh = max_vjp(dtaps[i], hs[i + 1])
            if dz_next is not None:
                dh = dh + torch.matmul(dz_next, ws[i + 1].to(dt).t())
            dy = relu_vjp(dh, bn_apply(zs[i], mean, var, gammas[i], betas[i]))
            dz, dgs[i], dbs[i] = _stage_bwd(dy, zs[i], mean, var, gammas[i],
                                            group)
            dws[i] = mm32(hs[i].flatten(0, 2).t(), dz.flatten(0, 2))
            dz_next = dz

        # edge rows -> dx: the neighbour half scatters, the centre half sums
        dx = None
        if ctx.needs_input_grad[0]:
            de = mm32(dz_next, ws[0].to(dt).t())         # (B, k, N, 6) f32
            dq, dscat = edge_vjp(de, idx)
            dx = (dq + dscat).to(x.dtype)
        return (dx, None, None, None, None, *dws, *dgs, *dbs)


def dgcnn_train(x: torch.Tensor, ws: Sequence[torch.Tensor],
                gammas: Sequence[torch.Tensor], betas: Sequence[torch.Tensor],
                k: int = 20, dtype: torch.dtype = torch.bfloat16,
                posenc_k: int = 0, group=None):
    """Differentiable DGCNN training forward.

    x (B, N, 3) float32; ws: five float32 kernels [(6,64), (64,64), (64,128),
    (128,256), (512,emb)]; gammas/betas: five BatchNorm scale/bias vectors;
    `group` the data-parallel group (None: this process's batch).
    Returns (features (B, N, emb) in `dtype`, five (batch mean, batch var)
    float32 pairs, alpha (B, N, posenc_k) float32 or None)."""
    _refuse_bwd_kernels(group)
    out, *flat, alpha = DGCNNTrain.apply(x, k, dtype, posenc_k, group, *ws,
                                         *gammas, *betas)
    moments = [(flat[2 * i], flat[2 * i + 1]) for i in range(5)]
    return out, moments, alpha
