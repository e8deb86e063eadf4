"""High-level inference API: register point-cloud pairs with one call.

    reg = Registrar(cfg)                         # seeded random weights
    reg = Registrar(configs.serve())             # the serving preset
    reg = Registrar.from_weights("weights.npz")  # weights exported by the
                                                 # JAX package or the CLI
    reg = Registrar.from_checkpoint("runs")      # the CLI's best checkpoint
    reg = registrar_from_torch_checkpoint("model.pt")  # the original code's
    R, t, src_overlap, tgt_overlap = reg(src, tgt)
    reg.export_weights("weights.npz")            # read by both packages
    fn = reg.sharded(group)                      # one request over the
    R, t, src_overlap, tgt_overlap = fn(src, tgt)  # processes of a group

`cfg.model_name` picks the model: GMMReg (`nn.gmmreg`) or DeepGMR
(`nn.deepgmr`, whose overlap outputs are ones). Runs on the CUDA device
unless `device="cpu"` is passed; without a CUDA device and without that
request it raises. `loop_kernels=True` runs FPS, the ICP and the attention
MLPs (GMMReg), or the ICP (DeepGMR), through their whole-loop and fused
kernels. The request's refinement is point-to-point ICP; `ops.icp` also
has point-to-plane (`refine_registration(..., pl=True)`) and the grid
1-NN (`use_grid=True`) for a caller that refines the returned pose itself.

Weights cross between the two packages as the `.npz` of `export_weights`:
the JAX package's orbax checkpoints are not read here (the card's machine
has no JAX).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ogmm_tpu_torch.configs import Config, config_to_dict, mnet
from ogmm_tpu_torch.core import se3
from ogmm_tpu_torch.nn.deepgmr import DeepGMR
from ogmm_tpu_torch.nn.dgcnn import DGCNN
from ogmm_tpu_torch.nn.gmmreg import GMMReg
from ogmm_tpu_torch.ops.dispatch import resolve_device


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded initialisation: matrices normal with variance 1/fan_in, biases
    zero; BatchNorm parameters and statistics keep their defaults."""
    def normal_(p, fan_in):
        p.copy_(torch.randn(p.shape, generator=generator) / fan_in ** 0.5)

    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                normal_(m.weight, m.in_features)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, DGCNN):
                for i in range(1, 6):
                    w = getattr(m, f"w{i}")              # (in, out)
                    normal_(w, w.shape[0])


def build_model(cfg: Config, loop_kernels: bool = False) -> torch.nn.Module:
    """The model `cfg.model_name` names, with fresh weights, in eval mode."""
    if cfg.model_name == "GMMReg":
        return GMMReg(cfg.model, loop_kernels)
    if cfg.model_name == "DeepGMR":
        return DeepGMR(cfg.model, loop_kernels)
    raise ValueError(f"unknown model {cfg.model_name!r}")


class Registrar:
    """Registration frontend around one GMMReg or DeepGMR in eval mode.

    `refine=True` (the default of a call) appends point-to-point ICP with
    the gate 2 cfg.model.overlap_radius and cfg.model.icp_iters trips. What
    else refinement can do lives in `ops.icp` and takes the returned pose:
    point-to-plane (`refine_registration(..., pl=True)`, normals from the
    target's k-NN) and the grid 1-NN (`use_grid=True`) for sparse large
    targets."""

    def __init__(self, cfg: Optional[Config] = None,
                 state_dict: Optional[dict] = None, seed: int = 0,
                 device: str | torch.device | None = None,
                 loop_kernels: bool = False):
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else mnet()
        self.model = build_model(self.cfg, loop_kernels)
        if state_dict is None:
            init_weights(self.model, torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()

    @classmethod
    def from_weights(cls, path: str, cfg: Optional[Config] = None,
                     device: str | torch.device | None = None,
                     loop_kernels: bool = False) -> "Registrar":
        """Restore from a weights-only .npz exported by the JAX package or
        by `train.export_weights` (params + batch_stats + embedded config;
        `cfg` replaces the embedded one)."""
        from ogmm_tpu_torch.weights import load_weights
        state, saved = load_weights(
            path, None if cfg is None else cfg.model_name)
        if cfg is None:
            if saved is None:
                raise ValueError(
                    f"{path!r} embeds no config; pass cfg= explicitly")
            cfg = saved
        return cls(cfg, state_dict=state, device=device,
                   loop_kernels=loop_kernels)

    @classmethod
    def from_checkpoint(cls, model_path: str, cfg: Optional[Config] = None,
                        name: str = "optim_model", model_name: str = "GMMReg",
                        override_config: bool = False,
                        device: str | torch.device | None = None,
                        loop_kernels: bool = False) -> "Registrar":
        """Serve a checkpoint the port's trainer wrote:
        `<model_path>/checkpoints/<model>/models/<name>.pt` with the
        `config.json` beside it. `cfg=None` takes the saved config; a cfg
        that differs from it raises ValueError naming the sections, unless
        `override_config` (to change options that do not touch the
        weights). A missing config (with cfg=None) or checkpoint raises
        FileNotFoundError; nothing is created on disk."""
        from ogmm_tpu_torch.train.checkpoint import CheckpointManager
        models = CheckpointManager._models_dir(
            model_path, cfg.model_name if cfg is not None else model_name)
        saved = CheckpointManager.read_config_at(models)
        if cfg is None:
            if saved is None:
                raise FileNotFoundError(
                    f"no config.json under {models!r}; pass cfg= explicitly")
            cfg = saved
        elif saved is not None and not override_config:
            saved_d, cfg_d = config_to_dict(saved), config_to_dict(cfg)
            if saved_d != cfg_d:
                diff = [k for k in ("model", "data", "train", "model_name")
                        if saved_d.get(k) != cfg_d.get(k)]
                raise ValueError(
                    f"cfg differs from the checkpoint's saved config in the "
                    f"sections {diff}; pass cfg=None to use the saved one, or "
                    f"override_config=True to use yours")
        path = os.path.join(models, f"{name}.pt")
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint {name!r} under {models!r}")
        ck = torch.load(path, map_location="cpu", weights_only=True)
        return cls(cfg, state_dict=ck["model"], device=device,
                   loop_kernels=loop_kernels)

    def export_weights(self, path: str) -> None:
        """Write the weights and the config as the `.npz` that both
        packages' `load_weights` (and `from_weights`) read."""
        from ogmm_tpu_torch.train.checkpoint import export_weights
        export_weights(self.model, path, self.cfg)

    def _as_input(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.asarray(a, dtype=np.float32))
        return a.to(device=self.device, dtype=torch.float32)

    @torch.no_grad()
    def __call__(self, src, tgt, refine: bool = True):
        """Register src onto tgt: (B, N, 3) and (B, M, 3) arrays or tensors
        -> (rot (B,3,3), trans (B,3), src_overlap (B,N), tgt_overlap (B,M))
        on this Registrar's device. `refine=True` appends the batched ICP.
        DeepGMR predicts no overlap: its overlaps are ones."""
        src, tgt = self._as_input(src), self._as_input(tgt)
        out = self.model(src, tgt, refine=refine)
        if isinstance(self.model, DeepGMR):
            ones = torch.ones(src.shape[:2], device=self.device)
            return (*out, ones, torch.ones(tgt.shape[:2], device=self.device))
        rot, trans, src_o, tgt_o, _ = out
        return rot, trans, src_o, tgt_o

    def sharded(self, group=None, refine: bool = True):
        """Point-sharded (sequence-parallel) forward over the processes of a
        `torch.distributed` group (default: all of them,
        `parallel.sp_mesh()`): `fn(src, tgt) -> (rot, trans, src_overlap,
        tgt_overlap)` computes ONE request together, each process owning a
        block of the points, the whole clouds given to every process. It
        cuts the latency of a single large pair (the indoor request: B = 1,
        about 35,000 points), which batch parallelism cannot. GMMReg only,
        as in the JAX package. See `parallel/sp.py`."""
        if self.cfg.model_name != "GMMReg":
            raise NotImplementedError(
                "sharded serving implements the GMMReg forward")
        from ogmm_tpu_torch.parallel import make_sp_eval, sp_mesh
        if group is None:
            group = sp_mesh()
        inner = make_sp_eval(self.model, self.cfg, group, is_test=refine)

        def fn(src, tgt):
            rot, trans, src_o, tgt_o, _ = inner(self._as_input(src),
                                                self._as_input(tgt))
            return rot, trans, src_o, tgt_o

        return fn

    def transform(self, rot, trans, points):
        """Apply the predicted rigid transform to (B, N, 3) points."""
        pose = torch.cat([rot, trans.unsqueeze(-1)], dim=-1)
        return se3.transform(pose, self._as_input(points))


def registrar_from_torch_checkpoint(path: str, cfg: Optional[Config] = None,
                                    device: str | torch.device | None = None
                                    ) -> Registrar:
    """Serve a `.pt` state_dict saved by the original PyTorch code, of the
    model `cfg.model_name` names (`mnet()` by default), through
    `compat.load_torch_checkpoint`."""
    from ogmm_tpu_torch.compat import load_torch_checkpoint
    cfg = cfg if cfg is not None else mnet()
    state = load_torch_checkpoint(path, num_heads=cfg.model.num_heads,
                                  emb_dims=cfg.model.emb_dims,
                                  model_name=cfg.model_name)
    return Registrar(cfg, state_dict=state, device=device)
