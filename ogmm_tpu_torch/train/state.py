"""Train state and the optimizer of the original recipe.

Adam(lr 1e-4, weight_decay 1e-4) with the learning rate multiplied by 0.1 at
epochs 75, 150 and 200. `torch.optim.Adam(weight_decay=w)` adds w * param to
the gradient before the moment updates (L2, not the decoupled AdamW): the
same update as the JAX package's `add_decayed_weights` then `adam`. The
milestones become step counts through `steps_per_epoch`, and the schedule is
stepped once per update, so update i (from 0) runs at lr * gamma^(number of
milestones <= i), as `optax.piecewise_constant_schedule` gives.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ogmm_tpu_torch.api import build_model, init_weights
from ogmm_tpu_torch.configs import Config
from ogmm_tpu_torch.nn.layers import set_bn_group
from ogmm_tpu_torch.ops.dispatch import resolve_device


@dataclasses.dataclass
class TrainState:
    """Everything a training run carries from step to step; the steps
    update it in place."""
    model: torch.nn.Module             # GMMReg or DeepGMR
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    # random starts of the anchor FPS; None starts every cloud at index 0
    generator: Optional[torch.Generator]
    step: int = 0
    # the data-parallel process group (None: one process); see
    # train/distributed.py
    group: Optional[Any] = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def make_optimizer(params, cfg: Config, steps_per_epoch: int):
    """(Adam with L2 weight decay, its milestone schedule in steps)."""
    t = cfg.train
    opt = torch.optim.Adam(params, lr=t.lr, weight_decay=t.weight_decay)
    sched = torch.optim.lr_scheduler.MultiStepLR(
        opt, milestones=[int(m) * steps_per_epoch for m in t.lr_milestones],
        gamma=t.lr_gamma)
    return opt, sched


def create_train_state(cfg: Config, steps_per_epoch: int,
                       seed: Optional[int] = None,
                       device: str | torch.device | None = None,
                       state_dict: Optional[dict] = None,
                       group=None) -> TrainState:
    """The model `cfg.model_name` names with seeded weights (or
    `state_dict`) in training mode on the card (or on `device`), its
    optimizer and schedule, and a generator for the anchor starts (GMMReg),
    all from `seed` (cfg.train.seed by default). With a data-parallel
    `group` every process builds the same state, and the model's
    BatchNorms take the group's global batch statistics."""
    device = resolve_device(device)
    seed = cfg.train.seed if seed is None else seed
    model = build_model(cfg)
    if state_dict is None:
        init_weights(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(state_dict, strict=True)
    model.to(device).train()
    opt, sched = make_optimizer(model.parameters(), cfg, steps_per_epoch)
    gen = torch.Generator().manual_seed(seed + 1)
    set_bn_group(model, group)
    return TrainState(model, opt, sched, gen, group=group)
