"""GMMReg: the OGMM registration network.

DGCNN features -> geometric position encoding -> anchor-conditioned
self-attention -> cross-attention -> overlap head -> second self-attention
-> overlap-weighted Sinkhorn-EM clustering -> soft GMM matching -> weighted
Procrustes [-> batched ICP], plus the clustering contrastive loss `clu`.

In eval mode every per-cloud stage is a per-sample map, so src and tgt run
stacked as one (2B, N, .) batch (`stack_eval`, on by default). In training
they run per cloud, src then tgt, so that every BatchNorm takes the
statistics of one cloud and updates its running statistics twice a step, as
the JAX package (and the original) does; `stack_train=True` stacks them in
training too, and each BatchNorm then takes the statistics of both clouds
at once and updates once. The rule is the JAX package's
(`ogmm_tpu/nn/gmmreg.py:273`): stacked when (stack_eval and not training)
or (stack_train and training). The network body computes in cfg.dtype;
geometry (kNN, FPS, clustering, Procrustes, ICP) is always float32.

FPS anchors: one FPS a cloud serves the three attention stages, sharing
one loop with the clustering's centre-start FPS where km_clusters equals
n_clusters (`fps_combined`). `recompute_anchors=True` runs a new FPS for
each stage, as the original does, and the clustering its own centre FPS
(`_fps`). `remat=True` recomputes the activations of the three attention
blocks and the four conv heads in the backward instead of storing them
(`_remat`).

Above N = 1024 (`share_graph`) one kNN graph of k = gnn_k serves DGCNN and
the position encoding, as in the JAX package (`ogmm_tpu/nn/gmmreg.py:154`,
`:196-219`): one coordinate gather feeds the DGCNN edges and the angles of
its pos_k-prefix, with the centroid of the cloud in its original row order.
Above N = 4096 that graph is built and used in Morton-sorted row space
(`ops.common.knn_self_vspace`) and only the features and angles are
un-sorted; `dgcnn_vspace=False` keeps original order (the JAX package's
control).

The overlap head builds the dense (B, N, N) similarity, or streams its
softmax through the `wproject` kernel above B N N = 64 Mi elements or with
`overlap_stream=True` (`overlap_route`): the indoor request's dense matrix
would take 4.9 GB a pair. Training takes the same route; the streamed head's
gradient recomputes the softmax by query chunks (`ops.stream.wproject`, the
JAX package's recompute VJP), so no (N, N) matrix is stored.

Point-sharded eval (`sp_group`, the JAX package's `sp_axis`,
`ogmm_tpu/nn/gmmreg.py:95-131`): the processes of the group each hold a
block of the points of src and tgt (`forward(..., full_src=, full_tgt=)`
gives the whole clouds beside them; `parallel/sp.py` drives it). Per-point
work stays local; FPS, the clustering's initial centres, the kNN targets
and the ICP target read the whole clouds, which every process holds; what
crosses processes is small: the anchor gathers (`index_points_sp`), the
InstanceNorm, EM, Procrustes and ICP moments, and one all-gather of the
l2-normalised features and raw overlap scores for the overlap head, which
then streams local queries against the whole other cloud. Eval and the
stacked path only; the kNN graph is always the cross graph of the local
rows against the whole cloud, in global ids.

Data-parallel training: `bn_group` (set with `nn.layers.set_bn_group`) is
the data-parallel group, each process holding a block of the batch; the
FPS random starts are then drawn for the global batch and each process
keeps its rows', so that the step is that of one process on the global
batch.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ogmm_tpu_torch.configs import ModelConfig, torch_dtype
from ogmm_tpu_torch.core.procrustes import rigid_transform
from ogmm_tpu_torch.losses import clu_loss
from ogmm_tpu_torch.nn.attention import PositionEncoding, TransformerBlock
from ogmm_tpu_torch.nn.dgcnn import DGCNN
from ogmm_tpu_torch.nn.layers import BN, ConvHead
from ogmm_tpu_torch.ops.common import (DENSE_ELEMS, cos_similarity,
                                       gather_neighbors, index_points,
                                       index_points_sp, knn, knn_self_vspace,
                                       l2_normalize, matmul32)
from ogmm_tpu_torch.ops.cuda_dgcnn import KERNEL_MAX_N
from ogmm_tpu_torch.ops.cuda_stream import wproject_stream_lse, wproject_takes
from ogmm_tpu_torch.ops.fps import farthest_point_sample, fps_combined
from ogmm_tpu_torch.ops.gmm import wkeans_plus
from ogmm_tpu_torch.ops.icp import icp_point_to_point
from ogmm_tpu_torch.ops.sinkhorn import sinkhorn
from ogmm_tpu_torch.ops.stream import wproject, wproject_stream_lse_plain
from ogmm_tpu_torch.parallel import comm


def gmm_svd(src_nodes, tgt_nodes, src_desc, tgt_desc, src_pi, tgt_pi,
            is_sk: bool = False, softmax_temp: float = 0.05):
    """Match two GMMs by feature similarity and solve the rigid transform.
    Returns (rot (B,3,3), trans (B,3), src_corr (B,K,3), tgt_nodes)."""
    similarity = cos_similarity(src_desc, tgt_desc)           # (B, K, K)
    if is_sk:
        cost = 2.0 * (1.0 - similarity)
        scores = sinkhorn(cost, p=src_pi, q=tgt_pi, epsilon=1e-2, max_iter=30)[0]
        scores = torch.nan_to_num(scores, nan=1e-4)
        scores = scores / scores.sum(dim=-1, keepdim=True).clamp_min(1e-4)
    else:
        scores = torch.softmax(similarity / softmax_temp, dim=2)
    src_corr = matmul32(scores, tgt_nodes)
    weight = scores.sum(dim=-1)
    rot, trans = rigid_transform(src_nodes, src_corr, weight)
    return rot, trans[..., 0], src_corr, tgt_nodes


def share_graph(n: int) -> bool:
    """Whether clouds of n points build one kNN graph for DGCNN and the
    position encoding: above the fused kernels' envelope of N = 1024, the
    JAX package's rule (`ogmm_tpu/nn/gmmreg.py:154`; GMMReg already
    requires pos_k <= gnn_k)."""
    return n > KERNEL_MAX_N


def overlap_route(B: int, N: int, M: int, D: int, dtype: torch.dtype,
                  overlap_stream: bool | None) -> str:
    """'dense', 'stream' or 'chunked' for the overlap head of B pairs of N
    and M points with D features. It streams its softmax with
    `overlap_stream`, or with None above B N M = 64 Mi elements, the JAX
    package's rule (`ogmm_tpu/nn/gmmreg.py:141-144`): through the wproject
    kernel where it takes D and the type, else through its plain version
    (query chunks, the JAX package's `wproject_chunked`)."""
    stream = B * N * M > DENSE_ELEMS if overlap_stream is None else overlap_stream
    if not stream:
        return "dense"
    return "stream" if wproject_takes(D, dtype) else "chunked"


def _remat(module: nn.Module, *args):
    """module(*args) through `torch.utils.checkpoint` (non-reentrant): its
    activations are recomputed in the backward instead of stored, the
    counterpart of the JAX package's `nn.remat`
    (`ogmm_tpu/nn/gmmreg.py:229-242`). The recompute runs the module in
    training mode again, which would move each BatchNorm's running
    statistics a second time; it runs with the BatchNorms' `update_stats`
    off, so each moves once a forward, as under `nn.remat`. The batch
    statistics the recompute normalises with are those of the first run (the
    same inputs), so its outputs are the same bits."""
    calls = []

    def run(*a):
        if not calls:
            calls.append(True)
            return module(*a)
        bns = [m for m in module.modules() if isinstance(m, BN)]
        for m in bns:
            m.update_stats = False
        try:
            return module(*a)
        finally:
            for m in bns:
                m.update_stats = True

    return checkpoint(run, *args, use_reentrant=False)


def _norm32(x: torch.Tensor) -> torch.Tensor:
    """l2-normalise with float32 accumulation, back in x's type."""
    return l2_normalize(x.float()).to(x.dtype)


class GMMReg(nn.Module):
    """Call: (src, tgt) -> (rot, trans, src_overlap, tgt_overlap, clu), with
    src/tgt (B, N, 3) float32 clouds of equal point count. `refine=True`
    appends the batched ICP (point-to-point; `ops.icp.refine_registration`
    also has point-to-plane). FPS anchors start at a random point drawn
    from `generator`, at index 0 without one (the order of the draws:
    `_fps`).

    `loop_kernels` (off by default; ROADMAP.md A.9 decides) runs FPS and
    the ICP each as one kernel launch and the attention blocks' MLPs in eval
    through the fused kernel (`PointMLP.fuse_eval`), on a CUDA device and
    within each kernel's envelope; the weights are the same either way.

    `sp_group` makes the forward point-sharded over that process group (see
    the module's docstring); `bn_group` is the data-parallel group of
    training."""

    def __init__(self, cfg: ModelConfig = ModelConfig(),
                 loop_kernels: bool = False, sp_group=None):
        super().__init__()
        if cfg.pos_k <= 0 or cfg.pos_k > cfg.gnn_k:
            raise ValueError(f"cfg.pos_k must be in 1..gnn_k, got {cfg.pos_k}")
        self.cfg = cfg
        self.loop_kernels = loop_kernels
        self.sp_group = sp_group
        self.bn_group = None
        D = cfg.emb_dims
        dt = torch_dtype(cfg.dtype)
        self.compute_dtype = dt
        # the config keeps the JAX option's None; only False changes the route
        self.dgcnn = DGCNN(D, cfg.gnn_k, dt, cfg.dgcnn_fused_train is not False,
                           cfg.dgcnn_fused_edges is True)
        self.pos_enc = PositionEncoding(D, dt)
        self.sattn1 = TransformerBlock(D, cfg.num_heads, dt, loop_kernels, sp_group)
        self.cattn = TransformerBlock(D, cfg.num_heads, dt, loop_kernels, sp_group)
        self.sattn2 = TransformerBlock(D, cfg.num_heads, dt, loop_kernels, sp_group)
        self.conv1 = ConvHead(D, D, 2 * D, deep=True, dtype=dt)
        self.conv2 = ConvHead(D + 2, D, 2 * D, deep=True, dtype=dt)
        self.proj = ConvHead(D, 1, D // 2, deep=False, dtype=dt)
        self.overlap = ConvHead(D, 1, D // 2, deep=True, dtype=dt)
        self.eval()

    def forward(self, src: torch.Tensor, tgt: torch.Tensor,
                refine: bool = False,
                generator: torch.Generator | None = None,
                full_src: torch.Tensor | None = None,
                full_tgt: torch.Tensor | None = None):
        """`full_src`, `full_tgt` (B, N_full, 3): the whole clouds of which
        src and tgt hold this process's rows, given with `sp_group` only."""
        cfg = self.cfg
        B, N, _ = src.shape
        if tgt.shape[1] != N:
            raise ValueError("the overlap head mixes src/tgt point axes and "
                             "requires equal point counts")
        both = torch.cat([src, tgt], dim=0).float()          # (2B, N, 3)
        full = None
        if self.sp_group is not None:
            full = self._check_sharded(full_src, full_tgt)
        elif full_src is not None or full_tgt is not None:
            raise ValueError("full_src/full_tgt come with sp_group only")
        anchor_ids, center_ids = self._fps(both if full is None else full,
                                           generator)
        stacked = cfg.stack_train if self.training else cfg.stack_eval
        if stacked:
            rot, trans, o_all, clu = self._forward_stacked(
                both, anchor_ids, center_ids, full)
        else:
            rot, trans, o_all, clu = self._forward_per_cloud(
                both, anchor_ids, center_ids)
        if refine:
            init = torch.cat([rot, trans.unsqueeze(-1)], dim=-1)
            rot, trans = icp_point_to_point(
                both[:B], (both if full is None else full)[B:], init,
                threshold=2.0 * cfg.overlap_radius, max_iter=cfg.icp_iters,
                use_kernel=self.loop_kernels, group=self.sp_group)
        return rot, trans, o_all[:B], o_all[B:], clu

    def _check_sharded(self, full_src, full_tgt) -> torch.Tensor:
        """The refusals of the point-sharded forward, the JAX package's
        (`ogmm_tpu/nn/gmmreg.py:95-131`, `:273-276`, `nn/dgcnn.py:170-177`);
        returns the whole clouds stacked, (2B, N_full, 3)."""
        cfg = self.cfg
        if self.training:
            raise ValueError("sp_group is an eval/serving contract: batch "
                             "statistics over a point shard are not the "
                             "training semantics")
        if full_src is None or full_tgt is None:
            raise ValueError("sp_group needs the whole clouds (full_src, "
                             "full_tgt) beside this process's rows")
        if full_src.shape[1] != full_tgt.shape[1]:
            raise ValueError("full_src and full_tgt need the same point count")
        if not cfg.stack_eval:
            raise ValueError("sp_group requires the stacked eval path "
                             "(stack_eval=True, the serving default)")
        if cfg.dgcnn_fused_edges is True:
            raise ValueError("dgcnn_fused_edges=True needs the whole cloud: "
                             "the edges kernel is not run on a point shard")
        return torch.cat([full_src, full_tgt], dim=0).float()

    def _starts(self, both, generator):
        """The FPS random starts of the 2B clouds (src rows first) in data-
        parallel training: the draw of one process over the global batch of
        the `bn_group`, this process's rows of it; None elsewhere (the FPS
        then draws from `generator` itself)."""
        group = self.bn_group
        if group is None or generator is None:
            return None
        b, n = both.shape[0] // 2, both.shape[1]
        w, r = comm.axis_size(group), comm.axis_index(group)
        draw = torch.randint(0, n, (2 * b * w,), generator=generator,
                             device=generator.device).to(both.device)
        return torch.cat([draw[r * b:(r + 1) * b],
                          draw[(w + r) * b:(w + r + 1) * b]])

    def _fps(self, both, generator):
        """The anchor ids of the three attention stages (random start) and
        the clustering-init ids (centre start, None where the clustering
        runs its own FPS) of the 2B clouds; every row is independent, so one
        loop serves src and tgt. The starts are drawn from `generator` as
        one (2B,) draw a loop, src rows first: with `recompute_anchors` one
        draw for each stage in stage order, else one draw."""
        cfg = self.cfg
        km, lk = cfg.km_clusters, self.loop_kernels
        if cfg.recompute_anchors:
            return tuple(farthest_point_sample(
                both, km, generator=generator, use_kernel=lk,
                start=self._starts(both, generator)) for _ in range(3)), None
        start = self._starts(both, generator)
        if km == cfg.n_clusters:
            # anchors and clustering init share one FPS loop
            ids, center_ids = fps_combined(both, km, generator, lk, start)
        else:
            ids = farthest_point_sample(both, km, generator=generator,
                                        use_kernel=lk, start=start)
            center_ids = None
        return (ids,) * 3, center_ids

    def _block(self, module, *args):
        """A transformer block or conv head: through `_remat` in training
        with cfg.remat, else called directly."""
        if self.cfg.remat and self.training:
            return _remat(module, *args)
        return module(*args)

    def _encode(self, clouds, full=None):
        """DGCNN features (B, N, D) and the angle features (B, N, pos_k) of
        (B, N, 3) clouds, or None for the angles where the route makes none
        (the position encoding then makes them itself). With the whole
        clouds `full` (point-sharded forward) the graph is the cross graph of
        the local rows against them, in global ids, and the angles take the
        whole clouds' centroid."""
        cfg = self.cfg
        pk = cfg.pos_k
        if full is not None:
            nbr = gather_neighbors(full, knn(clouds, full, cfg.gnn_k))
            return self.dgcnn(clouds, with_posenc_alpha=pk, nbr_xyz=nbr,
                              posenc_centroid=full.mean(dim=1, keepdim=True))
        if not share_graph(clouds.shape[1]):
            return self.dgcnn(clouds, with_posenc_alpha=pk)
        # the angles' centroid sums the rows in original order in either
        # row space (the JAX package measured 0.1 deg of drift from the
        # sorted-order sum)
        cen = clouds.mean(dim=1, keepdim=True)
        if cfg.dgcnn_vspace is False:
            nbr = gather_neighbors(clouds, knn(clouds, clouds, cfg.gnn_k))
            return self.dgcnn(clouds, with_posenc_alpha=pk, nbr_xyz=nbr,
                              posenc_centroid=cen)
        xs, idx, inv = knn_self_vspace(clouds, cfg.gnn_k)
        f, a = self.dgcnn(xs, with_posenc_alpha=pk,
                          nbr_xyz=gather_neighbors(xs, idx), posenc_centroid=cen)
        if inv is not None:
            f, a = index_points(f, inv), index_points(a, inv)
        return f, a

    def _overlap_scores(self, src_f, tgt_f, src_o, tgt_o):
        """The overlap head's similarity-weighted projections of both
        directions; direction 2 weights the SOURCE-axis-indexed scores by
        the column softmax, a quirk of the original kept on purpose. The
        streamed route computes the same as two `wproject` calls, the
        second with the roles of the clouds swapped; its gradient comes
        from the chunked recompute of `ops.stream.wproject`."""
        B, N, D = src_f.shape
        route = overlap_route(B, N, tgt_f.shape[1], D, src_f.dtype,
                              self.cfg.overlap_stream)
        if route != "dense":
            proj = (wproject_stream_lse if route == "stream"
                    else wproject_stream_lse_plain)
            src_n, tgt_n = _norm32(src_f), _norm32(tgt_f)
            src_wo = wproject(src_n, tgt_n, src_o, proj)
            tgt_wo = wproject(tgt_n, src_n, tgt_o, proj)
            return src_wo.to(src_f.dtype), tgt_wo.to(tgt_f.dtype)
        sim = matmul32(_norm32(src_f).float(),
                       _norm32(tgt_f).float().transpose(1, 2))   # (B, N, N)
        src_wo = torch.matmul(torch.softmax(sim, dim=-1), src_o.float())
        tgt_wo = torch.matmul(torch.softmax(sim, dim=1).transpose(1, 2),
                              tgt_o.float())
        return src_wo.to(src_f.dtype), tgt_wo.to(tgt_f.dtype)

    def _overlap_scores_sharded(self, f_all, o_all):
        """The overlap head of the point-sharded forward: one all-gather of
        the l2-normalised features and the raw scores of the 2B clouds along
        the points, then each direction streams this process's queries
        against the whole other cloud (the wproject kernel where it takes
        D and the type, else its plain version), the values the scores of
        the query's own cloud on the key axis, as in `_overlap_scores`."""
        B2, _, D = f_all.shape
        B = B2 // 2
        group = self.sp_group
        fn_loc = _norm32(f_all)
        fn_full = comm.all_gather(fn_loc, group, dim=1)
        o_full = comm.all_gather(o_all, group, dim=1)
        proj = (wproject_stream_lse if wproject_takes(D, f_all.dtype)
                else wproject_stream_lse_plain)
        src_wo = proj(fn_loc[:B], fn_full[B:], o_full[:B])[0]
        tgt_wo = proj(fn_loc[B:], fn_full[:B], o_full[B:])[0]
        return src_wo.to(f_all.dtype), tgt_wo.to(f_all.dtype)

    def _solve(self, both, f_all, o_all, center_ids, full=None):
        """Clustering, GMM matching and the clustering loss of the 2B clouds
        (src rows first); each cloud is clustered on its own. In the
        point-sharded forward the initial centres come from the whole
        clouds `full`."""
        cfg = self.cfg
        B = both.shape[0] // 2
        group = None if full is None else self.sp_group
        init_nodes = None
        if full is not None:
            if center_ids is None:
                center_ids = farthest_point_sample(
                    full, cfg.n_clusters, is_center=True,
                    use_kernel=self.loop_kernels)
            init_nodes, center_ids = index_points(full, center_ids), None
        g_all, pi_all, n_all, nf_all = wkeans_plus(
            both, f_all, o_all, cfg.n_clusters, iters=cfg.em_iters,
            tau=cfg.tau, init_ids=center_ids, use_kernel=self.loop_kernels,
            init_nodes=init_nodes, group=group)
        rot, trans, _, _ = gmm_svd(n_all[:B], n_all[B:], nf_all[:B], nf_all[B:],
                                   pi_all[:B], pi_all[B:], is_sk=cfg.is_sk,
                                   softmax_temp=cfg.softmax_temp)
        # the mean over 2B clouds is the mean of the src and tgt losses
        clu = clu_loss(both, n_all, f_all, g_all, tau=0.1, group=group)
        return rot, trans, o_all, clu

    def _forward_stacked(self, both, anchor_ids, center_ids, full=None):
        """src and tgt as one (2B, N, .) batch; anchor_ids holds the ids of
        the three stages. With the whole clouds `full` the point-sharded
        forward: `both` holds this process's rows."""
        cfg = self.cfg
        blk = self._block
        B, N, _ = both.shape
        B //= 2
        if full is None:
            gather, centroid = index_points, None
        else:
            group = self.sp_group
            gather = lambda a, i: index_points_sp(a, i, group)
            centroid = full.mean(dim=1, keepdim=True)

        feats, alpha = self._encode(both, full)
        anchor0 = gather(feats, anchor_ids[0])
        t_all = feats + self.pos_enc(both, cfg.pos_k, alpha=alpha,
                                     centroid=centroid)
        t_all = blk(self.conv1, blk(self.sattn1, t_all, anchor0) + t_all)

        anchor1 = gather(t_all, anchor_ids[1])
        swapped = torch.cat([anchor1[B:], anchor1[:B]], dim=0)
        f_all = blk(self.cattn, t_all, swapped) + t_all

        o_all = blk(self.proj, f_all)                        # (2B, N, 1)
        if full is None:
            wo = self._overlap_scores(f_all[:B], f_all[B:], o_all[:B],
                                      o_all[B:])
        else:
            wo = self._overlap_scores_sharded(f_all, o_all)
        fo_all = blk(self.conv2, torch.cat([f_all, torch.cat(wo), o_all], dim=-1))
        o_all = torch.sigmoid(blk(self.overlap, fo_all).float()).reshape(2 * B, N)

        anchor2 = gather(f_all, anchor_ids[2])
        f_all = (blk(self.sattn2, f_all, anchor2) + f_all).float()
        return self._solve(both, f_all, o_all, center_ids, full)

    def _forward_per_cloud(self, both, anchor_ids, center_ids):
        """Every module on src, then on tgt (the training default)."""
        cfg = self.cfg
        blk = self._block
        B, N, _ = both.shape
        B //= 2
        pk = cfg.pos_k
        clouds = (both[:B], both[B:])
        ids = [(a[:B], a[B:]) for a in anchor_ids]           # [stage][cloud]
        enc = [self._encode(c) for c in clouds]
        t = [f + self.pos_enc(c, pk, alpha=a) for c, (f, a) in zip(clouds, enc)]
        t = [blk(self.conv1, blk(self.sattn1, ti, index_points(f, i)) + ti)
             for ti, (f, _), i in zip(t, enc, ids[0])]
        anchor1 = [index_points(ti, i) for ti, i in zip(t, ids[1])]
        f = [blk(self.cattn, t[0], anchor1[1]) + t[0],
             blk(self.cattn, t[1], anchor1[0]) + t[1]]
        o = [blk(self.proj, fi) for fi in f]
        wo = self._overlap_scores(f[0], f[1], o[0], o[1])
        fo = [blk(self.conv2, torch.cat([fi, woi, oi], dim=-1))
              for fi, woi, oi in zip(f, wo, o)]
        o_all = torch.cat([torch.sigmoid(blk(self.overlap, x).float()).reshape(B, N)
                           for x in fo], dim=0)
        f_all = torch.cat([(blk(self.sattn2, fi, index_points(fi, i)) + fi).float()
                           for fi, i in zip(f, ids[2])], dim=0)
        return self._solve(both, f_all, o_all, center_ids)
