"""Point-sharded (sequence-parallel) serving of one large registration pair.

Batch parallelism cannot cut the latency of the indoor request, one pair of
about 35,000 points. This module shards the point axis instead: the
processes of a `torch.distributed` group each take a contiguous block of
the rows of src and tgt and run one GMMReg eval forward (and ICP) together,
the counterpart of the JAX package's `ogmm_tpu/parallel/sp.py` (there a
`shard_map` over a device mesh). Per-point work (DGCNN edge stages, the
position encoding, the attention queries, the heads, the EM
responsibilities, ICP correspondences) stays with the process that owns
the rows; the xyz clouds (420 KB a cloud) are held whole by every process,
so kNN targets, FPS, the clustering's initial centres and the ICP target
need no communication. What crosses processes is small: the anchor gathers,
the InstanceNorm / EM / Sinkhorn-column / Procrustes / ICP moments, one
all-gather of the l2-normalised features and raw overlap scores, and the
1-NN combine (`nn/gmmreg.py`, `ops/common.py:index_points_sp`, `nn1_sp`).

Every process calls the returned function with the whole clouds; each
keeps its rows, and the overlaps come back assembled to (B, N) on every
process. Eval only: batch statistics over a point block are not the
training semantics (training shards the batch: `train/distributed.py`).
Two processes on one card check the arithmetic and the shard-shaped
kernels; they say nothing about scaling across cards.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ogmm_tpu_torch.parallel import comm


def sp_mesh(n_devices: Optional[int] = None):
    """The process group of the point axis: the default group (all
    processes), or a new group of the first `n_devices` ranks (every
    process must call it). Needs `torch.distributed` initialised."""
    if not dist.is_initialized():
        raise RuntimeError("sp_mesh needs torch.distributed initialised "
                           "(train.distributed.init_distributed, or "
                           "parallel.launch.run_ranks)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"n_devices={n} is not in 1..{world}")
    if n == world:
        return dist.group.WORLD
    return dist.new_group(list(range(n)))


def make_sp_eval(model, cfg, group, is_test: bool = False):
    """The point-sharded eval forward of GMMReg `model` (its weights, read
    once, and its `loop_kernels`) over `group`: `fn(src, tgt) -> (rot,
    trans, src_o, tgt_o, clu)`, src and tgt the whole (B, N, 3) clouds with
    N divisible by the group's size; rot, trans and clu are the same on
    every process and the overlaps (B, N) are assembled. `is_test` appends
    ICP. `group=None` runs `model` itself, unsharded."""
    from ogmm_tpu_torch.nn.gmmreg import GMMReg
    if cfg.model_name != "GMMReg" or not isinstance(model, GMMReg):
        raise NotImplementedError("sharded serving implements the GMMReg "
                                  "forward")
    if not cfg.model.stack_eval:
        raise ValueError("sp serving runs the stacked eval path "
                         "(stack_eval=True)")
    w, r = comm.axis_size(group), comm.axis_index(group)
    sharded = model
    if group is not None:
        device = next(model.parameters()).device
        sharded = GMMReg(cfg.model, model.loop_kernels, sp_group=group)
        sharded.load_state_dict(model.state_dict(), strict=True)
        sharded.to(device).eval()

    @torch.no_grad()
    def fn(src: torch.Tensor, tgt: torch.Tensor):
        n = src.shape[1]
        if n % w:
            raise ValueError(
                f"point count {n} must divide by the group size {w} (crop "
                f"or pad the clouds: the data pipeline's fixed n_points "
                f"gives static shapes)")
        if tgt.shape[1] != n:
            raise ValueError(
                f"sp eval needs src and tgt with the same point count (the "
                f"stacked eval path and the overlap head require it); got "
                f"src N={n}, tgt N={tgt.shape[1]}")
        if group is None:
            return sharded(src, tgt, refine=is_test)
        lo, hi = r * n // w, (r + 1) * n // w
        rot, trans, so, to, clu = sharded(
            src[:, lo:hi], tgt[:, lo:hi], refine=is_test, full_src=src,
            full_tgt=tgt)
        return (rot, trans, comm.all_gather(so, group, dim=1),
                comm.all_gather(to, group, dim=1), clu)

    return fn


def sp_eval(model, cfg, src, tgt, group=None, is_test: bool = False):
    """One-shot `make_sp_eval` over `group` (default: `sp_mesh()`)."""
    if group is None:
        group = sp_mesh()
    return make_sp_eval(model, cfg, group, is_test)(src, tgt)
