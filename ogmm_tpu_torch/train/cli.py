"""Training command line of the port:

    python -m ogmm_tpu_torch.train --dataset synthetic --epochs 2 --batch_size 8
    python -m ogmm_tpu_torch.train --root /data --dataset modelnet
    python -m ogmm_tpu_torch.train --preset indoor --dataset 7scene --root /data
    python -m ogmm_tpu_torch.train --model DeepGMR --dataset modelnetdv \
        --root synthetic:64
    torchrun --nproc_per_node=G -m ogmm_tpu_torch.train --multihost ...

The flags are those of the JAX package's `train.py` for what this package
implements, plus `--device` (the card by default; `--device cpu` runs the
plain PyTorch path on the CPU). It builds the Config from the ModelNet or
indoor preset and the flags, the loaders, the train state (restored
from the run's best checkpoint when there is one), then runs `Trainer.fit`
or, with `--eval_only`, one eval epoch, and with `--export_weights` writes
the best weights as the JAX package's `.npz`.

`--profile_dir D` traces epoch 0's train steps [5, 10) with torch.profiler
and writes a Chrome trace into D (`Trainer`).

`--multihost` joins the process group torchrun describes
(`train.distributed.init_distributed`; on a single-process run it does
nothing) and trains data-parallel: each process loads the same global batch
(the same seed) and keeps its block of rows, the loader runs one thread
(the training split's worker threads would make the samples depend on
thread order, and the processes must partition one global batch exactly
once), and only process 0 writes logs, checkpoints and exported weights.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

from ogmm_tpu_torch import configs

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="OGMM training on an NVIDIA GPU")
    p.add_argument("--preset", type=str, default="mnet",
                   choices=["mnet", "indoor"])
    p.add_argument("--root", type=str, default="synthetic")
    p.add_argument("--dataset", type=str, default=None,
                   help="modelnet|modelnetcp|modelnetdv|synthetic|7scene|"
                        "icl_nuim")
    p.add_argument("--model", type=str, default=None,
                   choices=["GMMReg", "DeepGMR"])
    p.add_argument("--n_points", type=int, default=None)
    p.add_argument("--noise_type", type=str, default=None)
    p.add_argument("--rot_mag", type=float, default=None)
    p.add_argument("--trans_mag", type=float, default=None)
    p.add_argument("--emb_dims", type=int, default=None)
    p.add_argument("--n_clusters", type=int, default=None)
    p.add_argument("--km_clusters", type=int, default=None)
    p.add_argument("--num_heads", type=int, default=None)
    p.add_argument("--gnn_k", type=int, default=None)
    p.add_argument("--dtype", type=str, default=None,
                   choices=["float32", "bfloat16"],
                   help="network-body compute dtype (geometry stays fp32)")
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--test_batch_size", type=int, default=None)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--eval_every", type=int, default=None,
                   help="test-split eval every k-th epoch (the last always)")
    p.add_argument("--metrics_every", type=int, default=None,
                   help="metric suite every k-th train step")
    p.add_argument("--model_path", type=str, default=None)
    p.add_argument("--steps_per_epoch", type=int, default=None,
                   help="cap optimizer steps per epoch (smoke runs)")
    p.add_argument("--eval_only", action="store_true")
    p.add_argument("--export_weights", type=str, default=None,
                   help="after fit, write the best weights as one .npz "
                        "(params, batch statistics, config)")
    p.add_argument("--device_overlap", action="store_true",
                   help="ground-truth overlap labels made on the device in "
                        "the step (7scene/icl_nuim: no host labels, at the "
                        "dataset's radius)")
    p.add_argument("--device", type=str, default=None,
                   help="torch device; the CUDA card by default")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of epoch 0's steps "
                        "[5, 10) into this directory")
    p.add_argument("--multihost", action="store_true")
    return p.parse_args(argv)


def build_config(args) -> configs.Config:
    """The ModelNet or indoor preset with the flags' overrides."""
    cfg = configs.indoor() if args.preset == "indoor" else configs.mnet()
    if args.model is not None:
        cfg = cfg.replace(model_name=args.model)
    model_kw, data_kw, train_kw = {}, {}, {}
    for k in ("emb_dims", "n_clusters", "km_clusters", "num_heads", "gnn_k",
              "dtype"):
        if getattr(args, k) is not None:
            model_kw[k] = getattr(args, k)
    for k in ("root", "dataset", "n_points", "noise_type", "rot_mag",
              "trans_mag"):
        if getattr(args, k) is not None:
            data_kw[k] = getattr(args, k)
    if args.root == "synthetic" and args.dataset is None:
        data_kw["dataset"] = "synthetic"
    for k in ("batch_size", "test_batch_size", "epochs", "lr", "seed",
              "metrics_every", "eval_every", "model_path"):
        if getattr(args, k) is not None:
            train_kw[k] = getattr(args, k)
    if args.device_overlap:
        train_kw["device_overlap"] = True
        dataset = data_kw.get("dataset", cfg.data.dataset)
        # each dataset's host-label radius (data/realdata.py)
        train_kw["overlap_thresh"] = 0.075 if dataset == "icl_nuim" else 0.05
    return cfg.replace(model=dataclasses.replace(cfg.model, **model_kw),
                       data=dataclasses.replace(cfg.data, **data_kw),
                       train=dataclasses.replace(cfg.train, **train_kw))


class CappedLoader:
    """Wraps a loader to yield at most n batches per epoch (smoke runs)."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __iter__(self):
        for i, b in enumerate(self.loader):
            if i >= self.n:
                break
            yield b

    def __len__(self):
        return min(self.n, len(self.loader))


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args)
    group, owned = None, False
    if args.multihost:
        import torch.distributed as dist
        from ogmm_tpu_torch.train.distributed import init_distributed
        from ogmm_tpu_torch.train.trainer import make_mesh
        was = dist.is_initialized()
        if init_distributed(device=args.device):
            group, owned = make_mesh(cfg), not was
    try:
        return _main(args, cfg, group)
    finally:
        if owned:
            import torch.distributed as dist
            dist.destroy_process_group()


def _main(args, cfg, group):
    import torch
    from ogmm_tpu_torch.core.metrics import print_metrics
    from ogmm_tpu_torch.data import data_loader
    from ogmm_tpu_torch.ops.dispatch import resolve_device
    from ogmm_tpu_torch.parallel import comm
    from ogmm_tpu_torch.train import (CheckpointManager, Trainer,
                                      create_train_state, export_weights,
                                      restore_checkpoint)

    rank, world = comm.axis_index(group), comm.axis_size(group)
    if world > 1:
        cfg = cfg.replace(data=dataclasses.replace(cfg.data, num_workers=1))
    device = resolve_device(args.device)
    if device.type == "cuda" and group is not None and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    log_dir = os.path.join(cfg.train.model_path, cfg.model_name)
    if rank == 0:
        os.makedirs(log_dir, exist_ok=True)
        handlers = [logging.FileHandler(os.path.join(log_dir, "train.log")),
                    logging.StreamHandler(sys.stdout)]
    else:
        handlers = [logging.StreamHandler(sys.stderr)]
    logging.basicConfig(
        level=logging.INFO if rank == 0 else logging.WARNING,
        format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
        handlers=handlers, force=True)
    logger = logging.getLogger("ogmm_tpu_torch")
    logger.info("device: %s; process %d of %d", device, rank, world)
    logger.info("config: %s", json.dumps(configs.config_to_dict(cfg)))

    train_loader, test_loader = data_loader(cfg)
    if args.steps_per_epoch:
        train_loader = CappedLoader(train_loader, args.steps_per_epoch)
        test_loader = CappedLoader(test_loader, max(1, args.steps_per_epoch // 4))
    steps_per_epoch = max(1, len(train_loader))

    state = create_train_state(cfg, steps_per_epoch, device=device,
                               group=group)
    # process 0 writes; every process reads the best checkpoint and takes
    # the same decisions
    ckpt = (CheckpointManager(cfg.train.model_path, cfg, cfg.model_name)
            if rank == 0 else None)
    best_path = os.path.join(CheckpointManager._models_dir(
        cfg.train.model_path, cfg.model_name), "optim_model.pt")
    if os.path.exists(best_path):
        restore_checkpoint(best_path, state)
        logger.info("restored the train state from %s", best_path)

    trainer = Trainer(cfg, state, checkpointer=ckpt,
                      profile_dir=args.profile_dir)
    if args.eval_only:
        print_metrics(trainer.eval_epoch(0, test_loader),
                      title=f"{cfg.model_name} eval", log=logger.info)
    else:
        trainer.fit(train_loader, test_loader, epochs=cfg.train.epochs)
        if args.export_weights and rank == 0:
            best = state
            if ckpt.has_best():
                best = create_train_state(cfg, steps_per_epoch, device=device)
                ckpt.restore(best)
            export_weights(best.model, args.export_weights, cfg)
            logger.info("exported the weights to %s", args.export_weights)
    return trainer
