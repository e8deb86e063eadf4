#!/usr/bin/env python3
"""Scaling of the port's distribution over the cards of one host.

    python3 scripts/dist_scaling.py [--worlds 1,2,4] [--reps 5]
    python3 scripts/dist_scaling.py --rehearse     # the CPU, gloo, tiny widths

For each world size W (one process a card, NCCL, started by
`ogmm_tpu_torch.parallel.launch.run_ranks`):
  - the point-sharded indoor request, `Registrar(configs.indoor()).sharded()`
    (B=1, N=35,000, float32 body, seeded weights; a synthetic height field
    against a rigid copy), without and with ICP: the host ms of each call
    (synchronised, the ranks started together by a barrier), and its answer
    against world 1's (rotation in degrees, translation, overlaps);
  - the data-parallel train step, `configs.mnet()` at its float32 body and
    bf16, 24 pairs of 717 points a card (a global batch of 24 W): host ms a
    step and pairs a second a card.
Prints the card's name and power limit and one JSON object on the last line.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ogmm_tpu_torch import configs  # noqa: E402
from ogmm_tpu_torch.api import Registrar  # noqa: E402
from ogmm_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from ogmm_tpu_torch.train import create_train_state, make_train_step  # noqa: E402


def _surface(rs, n):
    u = rs.rand(1, n, 2)
    z = 0.3 * np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    return (np.concatenate([u, z], -1) + 0.01 * rs.randn(1, n, 3)).astype(np.float32)


def _rotations(rs, b):
    q, r = np.linalg.qr(rs.randn(b, 3, 3))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    q[np.linalg.det(q) < 0, :, 0] *= -1
    return q.astype(np.float32)


def _pair(rs, n):
    src = _surface(rs, n)
    rot = _rotations(rs, 1)
    tgt = np.einsum("bij,bnj->bni", rot, src)[:, rs.permutation(n)]
    return src, (tgt + 0.1).astype(np.float32)


def _batch(rs, b, n):
    src = (rs.randn(b, n, 3) * 0.3).astype(np.float32)
    rot = _rotations(rs, b)
    trans = rs.uniform(-0.3, 0.3, (b, 3)).astype(np.float32)
    tgt = (np.einsum("bij,bnj->bni", rot, src) + trans[:, None]).astype(np.float32)
    third = n // 3
    tgt[:, :third] = (rs.randn(b, third, 3) * 0.3 + 1.0).astype(np.float32)
    gt = np.concatenate([rot, trans[:, :, None]], -1)
    ones = np.ones((b, n), np.float32)
    return {"src_xyz": src, "tgt_xyz": tgt, "src_overlap": ones,
            "tgt_overlap": ones, "transform_gt": gt}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, reps, device):
    """fn's last output and the host ms of each of `reps` calls, the ranks
    started together by a barrier before each."""
    import torch.distributed as dist
    fn()
    _sync(device)
    host, out = [], None
    for _ in range(reps):
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        _sync(device)
        host.append((time.perf_counter() - t0) * 1e3)
    return out, host


def _rank(rank, world, device, shapes, reps):
    """One process: the sharded request without and with ICP, then the
    data-parallel step at both bodies."""
    import torch.distributed as dist
    group = dist.group.WORLD
    over = shapes["model"]
    cfg = configs.indoor()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **over))
    reg = Registrar(cfg, seed=0, device=device)
    src, tgt = (torch.tensor(a, device=device)
                for a in _pair(np.random.RandomState(0), shapes["n_indoor"]))
    out = {}
    for refine in (False, True):
        fn = reg.sharded(group, refine=refine)
        res, host = _timed(lambda: fn(src, tgt), reps, device)
        out[f"sp_{refine}"] = {"host_ms": host,
                               "out": [o.float().cpu() for o in res]}
    per = shapes["batch_per_card"]
    batch = _batch(np.random.RandomState(1), per * world, shapes["n_points"])
    for dt in ("float32", "bfloat16"):
        c = configs.mnet(model=configs.ModelConfig(dtype=dt, **shapes["mnet"]))
        state = create_train_state(c, 10, seed=0, device=device, group=group)
        step = make_train_step(c)
        _, host = _timed(lambda: step(state, batch), reps, device)
        out[f"dp_{dt}"] = {"host_ms": host}
    return out


def _rot_deg(a, b):
    m = a.double().transpose(1, 2) @ b.double()
    s = torch.stack([m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0],
                     m[:, 1, 0] - m[:, 0, 1]], -1).norm(dim=-1) / 2
    c = (m.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2
    return torch.rad2deg(torch.atan2(s, c)).max().item()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--worlds", default=None,
                   help="world sizes, default 1, 2, 4 up to the cards")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--rehearse", action="store_true",
                   help="the CPU over gloo at tiny widths (checks the script)")
    a = p.parse_args()
    if a.rehearse:
        backend, device, cards = "gloo", "cpu", 4
        shapes = {"model": dict(emb_dims=32, n_clusters=8, km_clusters=8,
                                num_heads=2, gnn_k=8, pos_k=4, em_iters=2,
                                icp_iters=2),
                  "mnet": dict(emb_dims=32, n_clusters=8, km_clusters=8,
                               num_heads=2, gnn_k=8),
                  "n_indoor": 4200, "batch_per_card": 2, "n_points": 64}
    else:
        if not torch.cuda.is_available():
            sys.exit("dist_scaling: no CUDA device")
        from ogmm_tpu_torch.ops import dispatch
        dispatch.build_kernels()         # once, before any rank starts
        backend, device, cards = "nccl", "cuda", torch.cuda.device_count()
        shapes = {"model": {}, "mnet": {}, "n_indoor": 35000,
                  "batch_per_card": 24, "n_points": 717}
    worlds = ([int(w) for w in a.worlds.split(",")] if a.worlds
              else [w for w in (1, 2, 4) if w <= cards])
    res, ref = {}, None
    for w in worlds:
        t0 = time.perf_counter()
        ranks = run_ranks(_rank, w, backend=backend, device=device,
                          args=(shapes, a.reps), timeout=900)
        row = {"seconds": time.perf_counter() - t0}
        for refine in (False, True):
            key = f"sp_{refine}"
            host = [min(r[key]["host_ms"]) for r in ranks]
            out = ranks[0][key]["out"]
            entry = {"host_ms_rank0": ranks[0][key]["host_ms"],
                     "best_ms_slowest_rank": max(host)}
            if ref is not None:
                want = ref[key]
                entry["rot_deg_vs_world1"] = _rot_deg(out[0], want[0])
                entry["trans_vs_world1"] = (out[1] - want[1]).abs().max().item()
                entry["overlap_vs_world1"] = max(
                    (out[2] - want[2]).abs().max().item(),
                    (out[3] - want[3]).abs().max().item())
            row[key] = entry
        for dt in ("float32", "bfloat16"):
            key = f"dp_{dt}"
            best = max(min(r[key]["host_ms"]) for r in ranks)
            row[key] = {"host_ms_rank0": ranks[0][key]["host_ms"],
                        "best_ms_slowest_rank": best,
                        "pairs_per_sec_per_card":
                            shapes["batch_per_card"] / best * 1e3}
        if ref is None:
            ref = {k: ranks[0][k]["out"] for k in ("sp_False", "sp_True")}
        res[w] = row
        print(f"world {w}: sharded request best {row['sp_False']['best_ms_slowest_rank']:.2f} "
              f"/ {row['sp_True']['best_ms_slowest_rank']:.2f} ms with ICP; step "
              f"{row['dp_float32']['best_ms_slowest_rank']:.2f} ms float32, "
              f"{row['dp_bfloat16']['best_ms_slowest_rank']:.2f} ms bf16 "
              f"({row['dp_bfloat16']['pairs_per_sec_per_card']:.1f} pairs/s a card)",
              flush=True)
    if not a.rehearse:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"backend": backend, "shapes": shapes, "worlds": res}))


if __name__ == "__main__":
    main()
