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
"""
from __future__ import annotations

import logging
import math
import time
from collections import defaultdict
from typing import Dict, Optional

import torch

from ogmm_tpu_torch.configs import Config
from ogmm_tpu_torch.core.metrics import dcp_metrics, summarize_metrics
from ogmm_tpu_torch.losses import (composite_loss, dcp_loss,
                                   overlap_labels_device)
from ogmm_tpu_torch.train.state import TrainState

logger = logging.getLogger("ogmm_tpu_torch")

BATCH_KEYS = ("src_xyz", "tgt_xyz", "src_overlap", "tgt_overlap",
              "transform_gt")


def _device_batch(batch, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(batch[k]).to(device=device, dtype=torch.float32)
            for k in BATCH_KEYS}


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
    0 for DeepGMR."""
    model = state.model.train()
    inputs = _labels(cfg, _device_batch(batch, state.device))
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
    only, no metric suite."""

    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        loss, (rot, trans, clu, inputs) = train_loss(state, cfg, batch)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        src, tgt, rot_gt, trans_gt = inputs[:4]
        metrics = (dcp_metrics(src, tgt, rot_gt, trans_gt, rot.detach(),
                               trans.detach()) if with_metrics else {})
        B = rot.shape[0]
        metrics["loss"] = loss.detach().expand(B)
        metrics["clu_loss"] = clu.detach().expand(B)
        return metrics

    return step


def make_eval_step(cfg: Config, is_test: bool = True):
    """Returns step(state, batch) -> metrics: the eval forward (with ICP when
    `is_test`), the model's loss and the metric suite."""

    @torch.no_grad()
    def step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        model = state.model
        was_training = model.training
        model.eval()
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
        return metrics

    return step


def _summarize(acc) -> Dict[str, float]:
    return summarize_metrics({k: torch.cat(v).cpu().numpy()
                              for k, v in acc.items()})


class Trainer:
    """Epoch loop: train and eval interleaved, the best checkpoint by
    `pcab_dist`, pairs per second."""

    def __init__(self, cfg: Config, state: TrainState, checkpointer=None):
        self.cfg = cfg
        self.state = state
        self.checkpointer = checkpointer
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

    def train_epoch(self, epoch: int, loader) -> Dict[str, float]:
        acc = defaultdict(list)
        n_pairs = 0
        t0 = time.perf_counter()
        for i, batch in enumerate(loader):
            step_fn = (self.train_step if self.train_step_light is None
                       or i % self.metrics_every == 0
                       else self.train_step_light)
            for k, v in step_fn(self.state, batch).items():
                acc[k].append(v)
            n_pairs += len(batch["src_xyz"])
        self._sync()
        summary = _summarize(acc)
        summary["pairs_per_sec"] = n_pairs / (time.perf_counter() - t0)
        logger.info("Epoch %-4d Mean-Loss: %.4f r_mae:%.4f t_mae:%.4f "
                    "recall:%.4f | %.1f pairs/s", epoch, summary["loss"],
                    summary.get("r_mae", math.nan),
                    summary.get("t_mae", math.nan),
                    summary.get("n_correct", math.nan),
                    summary["pairs_per_sec"])
        return summary

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
        summary["pairs_per_sec"] = n_pairs / (time.perf_counter() - t0)
        logger.info("Eval  %-4d Mean-Loss: %.4f r_mae:%.4f t_mae:%.4f "
                    "recall:%.4f | %.1f pairs/s", epoch, summary["loss"],
                    summary["r_mae"], summary["t_mae"], summary["n_correct"],
                    summary["pairs_per_sec"])
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
