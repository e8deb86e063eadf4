"""Train and eval steps and the epoch loop.

A train step is the per-cloud training forward, the loss, its gradients,
one Adam update and, unless it is the light step, the metric suite of the
batch (`core.metrics.dcp_metrics`). GMMReg trains on the composite loss
(`losses.composite_loss`); DeepGMR, whose forward gives only a pose, on the
pose loss alone (`losses.dcp_loss`, clu 0), as in the JAX package. The eval
step is the eval forward with ICP, the same loss and the metrics. Batches
are dictionaries in the JAX package's loader format (`BATCH_KEYS`, numpy
arrays or tensors); the steps move them to the model's device. Metrics stay
on the device until an epoch ends.

Data parallelism (`TrainState.group`, `train/distributed.py`): every
process is given the same global batch and keeps its block of rows; the
BatchNorm statistics are the global batch's, the averaged gradients are
all-reduced after the backward (one flat all-reduce, so every process
applies the same update), and the loss and the per-sample metrics are
gathered: a step returns the global batch's. The eval step splits the rows
too (blocks may differ by one) and gathers its metrics.

`Trainer(profile_dir=D)` traces epoch 0's steps [5, 10) with
`torch.profiler` (the host, and the card's kernels when the state lives on
one), each step inside `record_function("train")`, the counterparts of the
JAX trainer's `jax.profiler` window and `StepTraceAnnotation`, and writes a
Chrome trace into D (`train_steps_5_10.pt.trace.json`, with `_rank<r>` under
a data-parallel group of more than one process). An epoch that ends inside
the window closes it there (a torch profiler left open loses its trace).
"""
from __future__ import annotations

import logging
import math
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from ogmm_tpu_torch.configs import Config
from ogmm_tpu_torch.core.metrics import dcp_metrics, summarize_metrics
from ogmm_tpu_torch.losses import (composite_loss, dcp_loss,
                                   overlap_labels_device)
from ogmm_tpu_torch.parallel import comm
from ogmm_tpu_torch.train.distributed import assemble_global_batch
from ogmm_tpu_torch.train.state import TrainState

logger = logging.getLogger("ogmm_tpu_torch")

BATCH_KEYS = ("src_xyz", "tgt_xyz", "src_overlap", "tgt_overlap",
              "transform_gt")


def make_mesh(cfg: Optional[Config] = None):
    """The data-parallel group: the default process group once
    `torch.distributed` is initialised (`init_distributed`), else None (one
    process). The JAX package's 1-D 'dp' mesh."""
    import torch.distributed as dist
    return dist.group.WORLD if dist.is_initialized() else None


def _device_batch(batch, device, group=None) -> Dict[str, torch.Tensor]:
    """The batch's tensors on `device`; with a group this process's block
    of the global batch's rows."""
    return assemble_global_batch({k: batch[k] for k in BATCH_KEYS}, device,
                                 comm.axis_size(group), comm.axis_index(group))


def _average_gradients(model: torch.nn.Module, group) -> None:
    """Replace every gradient by its mean over the group: one all-reduce of
    all gradients flattened, the same sum on every process."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = comm.psum(torch.cat([g.reshape(-1) for g in grads]), group)
    flat /= comm.axis_size(group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def _labels(cfg: Config, b: Dict[str, torch.Tensor]):
    """(src, tgt, rot_gt, trans_gt, src_overlap, tgt_overlap); with
    `device_overlap` the labels come from the ground truth on the device,
    and tgt_overlap = src_overlap as in the original unless
    `fix_tgt_overlap`."""
    src, tgt = b["src_xyz"], b["tgt_xyz"]
    g = b["transform_gt"]
    rot_gt, trans_gt = g[..., :3, :3], g[..., :3, 3]
    so, to = b["src_overlap"], b["tgt_overlap"]
    if cfg.train.device_overlap:
        so, to = overlap_labels_device(src, tgt, rot_gt, trans_gt,
                                       thresh=cfg.train.overlap_thresh)
        if not cfg.data.fix_tgt_overlap:
            to = so
    return src, tgt, rot_gt, trans_gt, so, to


def _loss(cfg: Config, out, src, tgt, rot_gt, trans_gt, so, to):
    if cfg.model_name == "DeepGMR":
        rot, trans = out
        return dcp_loss(rot, rot_gt, trans, trans_gt)
    t = cfg.train
    rot, trans, src_o, tgt_o, clu = out
    return composite_loss(
        rot, trans, clu, src_o, tgt_o, rot_gt, trans_gt, so, to, src, tgt,
        w_dcp=t.w_dcp, w_clu=t.w_clu, w_overlap=t.w_overlap,
        w_welsch=t.w_welsch, welsch_alpha=t.mu, welsch_topk=t.n_keypoints)


def train_loss(state: TrainState, cfg: Config, batch):
    """The training forward and the loss of one batch, before any
    gradient: (loss, (rot, trans, clu, inputs)) with inputs the device
    tensors (src, tgt, rot_gt, trans_gt, src_overlap, tgt_overlap); clu is
    0 for DeepGMR. With a data-parallel group all of it is this process's
    block of the batch (the BatchNorms still see the global batch)."""
    model = state.model.train()
    inputs = _labels(cfg, _device_batch(batch, state.device, state.group))
    src, tgt = inputs[:2]
    if cfg.model_name == "DeepGMR":
        out = model(src, tgt)
        clu = torch.zeros((), device=src.device)
    else:
        out = model(src, tgt, generator=state.generator)
        clu = out[4]
    loss = _loss(cfg, out, *inputs)
    return loss, (out[0], out[1], clu, inputs)


def make_train_step(cfg: Config, with_metrics: bool = True):
    """Returns step(state, batch) -> metrics, one optimizer update of
    `state` in place. `with_metrics=False` is the light step: loss and clu
    only, no metric suite. Under `state.group` the metrics are the global
    batch's, on every process."""

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        group = state.group
        loss, (rot, trans, clu, inputs) = train_loss(state, cfg, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            _average_gradients(state.model, group)
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        src, tgt, rot_gt, trans_gt = inputs[:4]
        metrics = (dcp_metrics(src, tgt, rot_gt, trans_gt, rot.detach(),
                               trans.detach()) if with_metrics else {})
        metrics = {k: comm.all_gather(v, group) for k, v in metrics.items()}
        w = comm.axis_size(group)
        B = rot.shape[0] * w
        metrics["loss"] = (comm.psum(loss.detach(), group) / w).expand(B)
        metrics["clu_loss"] = (comm.psum(clu.detach(), group) / w).expand(B)
        return metrics

    return step


def make_eval_step(cfg: Config, is_test: bool = True):
    """Returns step(state, batch) -> metrics: the eval forward (with ICP when
    `is_test`), the model's loss and the metric suite; under `state.group`
    each process takes a block of the rows and the metrics are gathered."""

    @torch.no_grad()
    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model = state.model
        was_training = model.training
        model.eval()
        group = state.group
        n = len(batch["src_xyz"])
        if group is not None:
            if n < comm.axis_size(group):
                raise ValueError(f"an eval batch of {n} rows gives a process "
                                 f"of {comm.axis_size(group)} no row")
            lo, hi = comm.row_range(n, group)
            batch = {k: batch[k][lo:hi] for k in BATCH_KEYS}
        try:
            inputs = _labels(cfg, _device_batch(batch, state.device))
            src, tgt, rot_gt, trans_gt = inputs[:4]
            out = model(src, tgt, refine=is_test)
            loss = _loss(cfg, out, *inputs)
        finally:
            model.train(was_training)
        rot, trans = out[:2]
        metrics = dcp_metrics(src, tgt, rot_gt, trans_gt, rot, trans)
        metrics["loss"] = loss.expand(rot.shape[0])
        return {k: comm.gather_rows(v, n, group) for k, v in metrics.items()}

    return step


def _summarize(acc) -> Dict[str, float]:
    return summarize_metrics({k: torch.cat(v).cpu().numpy()
                              for k, v in acc.items()})


class Trainer:
    """Epoch loop: train and eval interleaved, the best checkpoint by
    `pcab_dist`, pairs per second (and a card: the global batch's pairs over
    the processes of `state.group`). Give the `checkpointer` to one process
    only (the CLI: rank 0); every process takes the same decisions from the
    gathered metrics."""

    PROFILE_WINDOW = (5, 10)   # epoch 0's steps traced with `profile_dir`

    def __init__(self, cfg: Config, state: TrainState, checkpointer=None,
                 profile_dir: Optional[str] = None):
        self.cfg = cfg
        self.state = state
        self.checkpointer = checkpointer
        self.profile_dir = profile_dir
        self.train_step = make_train_step(cfg)
        # loss-only step between the strides of the metric suite
        self.metrics_every = max(1, cfg.train.metrics_every)
        self.train_step_light = (make_train_step(cfg, with_metrics=False)
                                 if self.metrics_every > 1 else None)
        self.eval_step = make_eval_step(cfg)
        self.best = {"pcab_dist": math.inf}
        self.history = []

    def _sync(self):
        if self.state.device.type == "cuda":
            torch.cuda.synchronize(self.state.device)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.state.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof, stop: int) -> str:
        """Close the window after step stop - 1 and write its trace."""
        self._sync()
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        name = f"train_steps_{self.PROFILE_WINDOW[0]}_{stop}"
        if comm.axis_size(self.state.group) > 1:
            name += f"_rank{comm.axis_index(self.state.group)}"
        path = os.path.join(self.profile_dir, name + ".pt.trace.json")
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
        return path

    def train_epoch(self, epoch: int, loader) -> Dict[str, float]:
        acc = defaultdict(list)
        n_pairs = 0
        prof = None
        first, last = self.PROFILE_WINDOW
        t0 = time.perf_counter()
        for i, batch in enumerate(loader):
            if self.profile_dir and epoch == 0:
                if i == first:
                    prof = self._start_profile()
                elif i == last and prof is not None:
                    self._stop_profile(prof, i)
                    prof = None
            with torch.profiler.record_function("train"):
                step_fn = (self.train_step if self.train_step_light is None
                           or i % self.metrics_every == 0
                           else self.train_step_light)
                for k, v in step_fn(self.state, batch).items():
                    acc[k].append(v)
            n_pairs += len(batch["src_xyz"])
        if prof is not None:                 # the epoch ended in the window
            self._stop_profile(prof, i + 1)
        self._sync()
        summary = _summarize(acc)
        self._rates(summary, n_pairs, t0)
        logger.info("Epoch %-4d Mean-Loss: %.4f r_mae:%.4f t_mae:%.4f "
                    "recall:%.4f | %.1f pairs/s/chip", epoch, summary["loss"],
                    summary.get("r_mae", math.nan),
                    summary.get("t_mae", math.nan),
                    summary.get("n_correct", math.nan),
                    summary["pairs_per_sec_per_chip"])
        return summary

    def _rates(self, summary, n_pairs: int, t0: float) -> None:
        summary["pairs_per_sec"] = n_pairs / (time.perf_counter() - t0)
        summary["pairs_per_sec_per_chip"] = (
            summary["pairs_per_sec"] / comm.axis_size(self.state.group))

    def eval_epoch(self, epoch: int, loader) -> Dict[str, float]:
        acc = defaultdict(list)
        n_pairs = 0
        t0 = time.perf_counter()
        for batch in loader:
            for k, v in self.eval_step(self.state, batch).items():
                acc[k].append(v)
            n_pairs += len(batch["src_xyz"])
        self._sync()
        summary = _summarize(acc)
        self._rates(summary, n_pairs, t0)
        logger.info("Eval  %-4d Mean-Loss: %.4f r_mae:%.4f t_mae:%.4f "
                    "recall:%.4f | %.1f pairs/s/chip", epoch, summary["loss"],
                    summary["r_mae"], summary["t_mae"], summary["n_correct"],
                    summary["pairs_per_sec_per_chip"])
        return summary

    def fit(self, train_loader, test_loader, epochs: Optional[int] = None):
        """Train for `epochs` (cfg.train.epochs), evaluating every
        `eval_every`-th epoch and the last; periodic saves every
        `save_every` epochs and a save whenever `pcab_dist` improves."""
        epochs = epochs if epochs is not None else self.cfg.train.epochs
        every = max(1, self.cfg.train.eval_every)
        for epoch in range(epochs):
            train_summary = self.train_epoch(epoch, train_loader)
            if (self.checkpointer is not None
                    and (epoch + 1) % self.cfg.train.save_every == 0):
                self.checkpointer.save_periodic(self.state, epoch)
            if (epoch + 1) % every and epoch != epochs - 1:
                self.history.append({"train": train_summary})
                continue
            val_summary = self.eval_epoch(epoch, test_loader)
            self.history.append({"train": train_summary, "val": val_summary})
            if val_summary["pcab_dist"] < self.best["pcab_dist"]:
                self.best = {k: val_summary[k] for k in
                             ("pcab_dist", "r_mae", "t_mae",
                              "clip_chamfer_dist", "n_correct")}
                if self.checkpointer is not None:
                    self.checkpointer.save_best(self.state, epoch)
        return self.history
