"""Run one function in W processes joined by `torch.distributed`.

    results = run_ranks(fn, world=2, backend="gloo", device="cpu", args=(x,))

Each process is started fresh (`spawn`), keeps one PyTorch thread, joins the
process group through a `file://` rendezvous in a temporary directory of its
own (no TCP port, so that runs side by side never collide), calls
`fn(rank, world, device, *args)` and hands its return value back by pickle.
`fn` must be importable by name (a module-level function of a module that
the child can import). The rendezvous and every collective time out after
`timeout` seconds and the parent waits at most that long for the processes
to end: a hung rank fails the call instead of hanging it.

device "cpu" keeps the tensors on the CPU; "cuda" puts rank r on card
r mod (number of cards), so W ranks share one card where there is one.
"""
from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp


def _child(rank, world, backend, device, init_file, fn, args, out, timeout):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    try:
        dist.init_process_group(backend, init_method=f"file://{init_file}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            res = fn(rank, world, dev, *args)
        finally:
            dist.destroy_process_group()
        with open(out, "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world: int, backend: str = "gloo", device: str = "cpu",
              args: tuple = (), timeout: float = 300.0) -> list:
    """[fn(0, world, device, *args), ..., fn(world - 1, ...)], each in a
    process of its own; raises RuntimeError with the child's traceback if a
    rank fails, TimeoutError if the ranks do not end within `timeout`
    seconds (then every rank is killed)."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ogmm_ranks_") as tmp:
        init_file = os.path.join(tmp, "rendezvous")
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(world)]
        procs = [ctx.Process(target=_child, args=(
            r, world, backend, device, init_file, fn, args, outs[r], timeout))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            # a rank that failed leaves the others waiting in a collective:
            # stop them all as soon as one ends with an error
            while (any(p.is_alive() for p in procs)
                   and time.monotonic() < deadline
                   and not any(p.exitcode for p in procs)):
                time.sleep(0.05)
            hung = [r for r, p in enumerate(procs) if p.is_alive()
                    and not any(q.exitcode for q in procs)]
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        errors = [open(o + ".err").read() for o in outs
                  if os.path.exists(o + ".err")]
        if errors:
            raise RuntimeError(f"a rank of {world} failed:\n" + errors[0])
        if hung:
            raise TimeoutError(f"ranks {hung} of {world} did not end within "
                               f"{timeout} s")
        for r, p in enumerate(procs):
            if p.exitcode != 0 or not os.path.exists(outs[r]):
                raise RuntimeError(f"rank {r} of {world} ended with exit code "
                                   f"{p.exitcode} and no result")
        results = []
        for o in outs:
            with open(o, "rb") as f:
                results.append(pickle.load(f))
        return results
