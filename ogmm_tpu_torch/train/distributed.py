"""Multi-process initialisation and per-process batches of data-parallel
training, the counterpart of the JAX package's `ogmm_tpu/train/distributed.py`.

Data parallelism here is W processes, one a card, joined by a
`torch.distributed` group: each process loads the same global batch (same
seed) and keeps its contiguous block of rows; the BatchNorm statistics are
those of the global batch (`nn.layers.set_bn_group`) and the gradients are
averaged over the group after the backward (`train.trainer`), so the step
equals the single-process step on the global batch, as the JAX trainer's
global semantics give. Launch it with torchrun:

    torchrun --nproc_per_node=G -m ogmm_tpu_torch.train --multihost ...

`init_distributed` reads torchrun's environment; on a single-process run it
does nothing.
"""
from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("ogmm_tpu_torch")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: str | torch.device | None = None,
                     timeout_s: float = 600.0) -> bool:
    """Join the default process group if a multi-process environment is
    present. The arguments default from torchrun's environment
    (MASTER_ADDR:MASTER_PORT, WORLD_SIZE, RANK; LOCAL_RANK picks the card);
    the coordinator address may be host:port or an init-method URL. NCCL on
    the card, gloo where `device` asks for the CPU. Returns True if the
    group is initialised (also when it already was), False on a
    single-process run, where nothing is done."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        logger.info("single-process run; torch.distributed not initialised")
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator address, the number "
            "of processes and this process's rank (MASTER_ADDR/MASTER_PORT, "
            "WORLD_SIZE, RANK as torchrun sets them)")
    from ogmm_tpu_torch.ops.dispatch import resolve_device
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=url, world_size=num_processes,
                            rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("torch.distributed initialised: process %d of %d (%s)",
                dist.get_rank(), dist.get_world_size(), dist.get_backend())
    return True


def _process(process_count, process_index):
    live = dist.is_initialized()
    n = (dist.get_world_size() if live else 1) if process_count is None \
        else process_count
    idx = (dist.get_rank() if live else 0) if process_index is None \
        else process_index
    return n, idx


def shard_batch_for_process(batch, global_batch_size: int,
                            process_count: Optional[int] = None,
                            process_index: Optional[int] = None):
    """This process's contiguous row block of a host batch: rows
    [idx per, (idx + 1) per) with per = global_batch_size // n. The count
    and the index default to the live group's; they are parameters so that
    the slicing is testable without processes."""
    n, idx = _process(process_count, process_index)
    if n == 1:
        return batch
    per = global_batch_size // n
    lo = idx * per
    return {k: v[lo:lo + per] for k, v in batch.items()}


def assemble_global_batch(batch, device,
                          process_count: Optional[int] = None,
                          process_index: Optional[int] = None):
    """Host batch -> this process's rows as float32 tensors on `device`.
    Every process loads the same global batch, so slicing by rank
    partitions it exactly once, provided the rows split evenly: a global
    batch that does not divide by the process count has no contiguous
    layout with equal blocks (the JAX package's non-contiguous-layout
    error) and raises."""
    n, idx = _process(process_count, process_index)
    global_b = len(next(iter(batch.values())))
    if global_b % n:
        raise ValueError(
            f"a global batch of {global_b} rows does not split into {n} equal "
            f"contiguous blocks (one a process); choose a batch size that "
            f"divides by the number of processes")
    local = shard_batch_for_process(batch, global_b, n, idx)
    return {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
            for k, v in local.items()}
