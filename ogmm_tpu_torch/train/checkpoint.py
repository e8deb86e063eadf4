"""Checkpoints of a training run, and weights in the JAX package's format.

A checkpoint (`save_checkpoint`, a `torch.save` file) holds the whole train
state: the model's parameters and running statistics, the optimizer's
moments, the schedule, the step count, the state of the anchor generator and
the Config as JSON. `export_weights` writes the weights-only `.npz` of the
JAX package (keys `params/...` and `batch_stats/...`, the Config under
`__config__`), which its `train.checkpoint.load_weights` and this module's
`load_weights` (that is, `weights.load_weights`) both read.
"""
from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ogmm_tpu_torch.configs import Config, config_from_dict, config_to_dict
from ogmm_tpu_torch.train.state import TrainState
from ogmm_tpu_torch.weights import flat_variables, load_weights  # noqa: F401


def save_checkpoint(path: str, state: TrainState,
                    cfg: Optional[Config] = None) -> None:
    torch.save({
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "scheduler": state.scheduler.state_dict(),
        "step": state.step,
        "generator": (None if state.generator is None
                      else state.generator.get_state()),
        "config": None if cfg is None else json.dumps(config_to_dict(cfg)),
    }, path)


def restore_checkpoint(path: str, state: TrainState) -> Optional[Config]:
    """Load a checkpoint into `state` in place; returns its Config (or
    None)."""
    ck = torch.load(path, map_location=state.device, weights_only=False)
    state.model.load_state_dict(ck["model"], strict=True)
    state.optimizer.load_state_dict(ck["optimizer"])
    state.scheduler.load_state_dict(ck["scheduler"])
    state.step = ck["step"]
    if ck["generator"] is not None:
        if state.generator is None:
            state.generator = torch.Generator()
        state.generator.set_state(ck["generator"].cpu())
    return None if ck["config"] is None else config_from_dict(
        json.loads(ck["config"]))


def export_weights(model: torch.nn.Module, path: str,
                   cfg: Optional[Config] = None) -> None:
    """Write the model's weights as the JAX package's `.npz` (the inverse
    of `weights.convert_variables`); the model's class names its map."""
    arrays = flat_variables(model.state_dict(), type(model).__name__)
    if cfg is not None:
        arrays["__config__"] = np.frombuffer(
            json.dumps(config_to_dict(cfg)).encode(), np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


class CheckpointManager:
    """<root>/checkpoints/<model_name>/models/: the best checkpoint
    (`optim_model.pt`), periodic ones (`model_<epoch>.pt`) and the Config
    (`config.json`)."""

    def __init__(self, root: str, cfg: Config, model_name: str = "GMMReg"):
        self.dir = self._models_dir(root, model_name)
        os.makedirs(self.dir, exist_ok=True)
        self.cfg = cfg
        self.save_config(cfg)

    @staticmethod
    def _models_dir(root: str, model_name: str) -> str:
        return os.path.abspath(
            os.path.join(root, "checkpoints", model_name, "models"))

    @property
    def config_path(self) -> str:
        return os.path.join(self.dir, "config.json")

    def save_config(self, cfg: Config) -> None:
        """Write the Config beside the checkpoints, refusing to overwrite a
        record whose `model` section or `model_name` differs: a run resumed
        at the same path would read the stored weights as another model.
        Changed `data` and `train` sections (a new learning rate, more
        epochs) update the record."""
        prev = self.load_config()
        if prev is not None:
            prev_d, cfg_d = config_to_dict(prev), config_to_dict(cfg)
            if (prev_d["model"] != cfg_d["model"]
                    or prev_d["model_name"] != cfg_d["model_name"]):
                raise ValueError(
                    f"refusing to overwrite {self.config_path}: the existing "
                    "checkpoint was trained with another model config, whose "
                    "weights would be read as this one's. Use a fresh "
                    "model_path, or delete the old checkpoint directory.")
            if prev_d == cfg_d:
                return
        with open(self.config_path, "w") as f:
            json.dump(config_to_dict(cfg), f, indent=1)

    def load_config(self) -> Optional[Config]:
        return self.read_config_at(self.dir)

    @staticmethod
    def read_config_at(models_dir: str) -> Optional[Config]:
        """The Config saved in `models_dir`, or None; reads only (creates no
        directory, for mistyped or read-only paths)."""
        path = os.path.join(models_dir, "config.json")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            return config_from_dict(json.load(f))

    def path(self, name: str) -> str:
        return os.path.join(self.dir, f"{name}.pt")

    def save_best(self, state: TrainState, epoch: int) -> None:
        save_checkpoint(self.path("optim_model"), state, self.cfg)

    def save_periodic(self, state: TrainState, epoch: int) -> None:
        save_checkpoint(self.path(f"model_{epoch + 1:04d}"), state, self.cfg)

    def has_best(self) -> bool:
        return os.path.exists(self.path("optim_model"))

    def restore(self, state: TrainState,
                name: str = "optim_model") -> Optional[Config]:
        return restore_checkpoint(self.path(name), state)
