"""The plain FPS loop of the serving path on the card, in two orders of the
squared distance: the `sum(-1)` loop that `ops/fps.py` ran before the FPS
kernel was ported (written out below as it was), and the loop that runs now
(`ops.cuda_fps.fps_reference`, x, y, z added in that order, the kernel's
order). The stage is `fps_combined` of the refined request: 24 clouds of
717 points and rotated, shifted, permuted copies of them, 128 steps, 96
rows (no generator: random starts at index 0, as `Registrar` calls it).
The ids are also compared on 48 clouds with a duplicated point.

    python3 scripts/fps_plain_loop.py [--reps 20] [--seed 0]

Prints, for each loop, the stage time by CUDA events and by the host clock
(mean of `reps` calls, rounds in the order old, new, new, old), the device
kernels of one call (`torch.profiler`), and how many ids differ between the
two loops and between the new loop and the `fps` kernel, on both inputs. One JSON line at
the end carries the same with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ogmm_tpu_torch.ops import cuda_fps  # noqa: E402
from ogmm_tpu_torch.ops import fps as ops_fps  # noqa: E402


def sum_loop(xyz, npoint, distance, farthest):
    """The FPS recurrence as `ops/fps.py:_fps_loop` had it, `sum(-1)`."""
    B = xyz.shape[0]
    ids = torch.empty(B, npoint, dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(npoint):
        ids[:, i] = farthest
        centroid = xyz[rows, farthest].unsqueeze(1)
        dist = ((xyz - centroid) ** 2).sum(-1)
        distance = torch.minimum(distance, dist)
        farthest = distance.argmax(dim=-1)
    return ids


def stage(both, loop, npoint=128):
    """`fps_combined`'s default route with the given loop."""
    B, N, _ = both.shape
    d_c, s_c = ops_fps._center_state(both)
    ids = loop(torch.cat([both, both]), npoint,
               torch.cat([both.new_full((B, N), 1e10), d_c]),
               torch.cat([torch.zeros(B, dtype=torch.long, device=both.device),
                          s_c]))
    return ids[:B], ids[B:]


def time_stage(fn, reps):
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / reps,
            (time.perf_counter() - t0) / reps * 1e3)


def device_kernels(fn):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA for e in p.events())


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("fps_plain_loop: no CUDA device")
    rs = np.random.RandomState(args.seed)
    src = rs.randn(24, 717, 3) * 0.3
    q = np.linalg.qr(rs.randn(24, 3, 3))[0]
    rot = q * np.sign(np.linalg.det(q))[:, None, None]      # proper rotations
    tgt = (np.einsum("bij,bnj->bni", rot, src)
           + rs.uniform(-0.3, 0.3, (24, 1, 3)))[:, rs.permutation(717)]
    both = torch.from_numpy(np.concatenate([src, tgt]).astype(np.float32)).cuda()
    dup = torch.from_numpy(rs.randn(48, 717, 3).astype(np.float32) * 0.3).cuda()
    dup[:, 358] = dup[:, 1]                  # a duplicated point: exact ties
    loops = {"sum_loop": sum_loop, "fps_reference": cuda_fps.fps_reference}
    calls = {k: (lambda f=f: stage(both, f)) for k, f in loops.items()}
    for fn in calls.values():
        fn()
    res = {k: {"device_ms": [], "host_ms": []} for k in loops}
    for k in ("sum_loop", "fps_reference", "fps_reference", "sum_loop"):
        dev, host = time_stage(calls[k], args.reps)
        res[k]["device_ms"].append(dev)
        res[k]["host_ms"].append(host)
    for k in loops:
        res[k]["device_kernels"] = device_kernels(calls[k])
    for name, x in (("request", both), ("duplicated", dup)):
        old, new = (torch.cat(stage(x, f)) for f in loops.values())
        kern = torch.cat(ops_fps.fps_combined(x, 128, use_kernel=True))
        res[name] = {"ids": old.numel(),
                     "ids_differ_sum_loop": int((old != new).sum()),
                     "rows_differ_sum_loop": int((old != new).any(-1).sum()),
                     "ids_differ_kernel": int((kern != new).sum())}
    res["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    for k in loops:
        print(f"{k}: {res[k]['device_ms']} ms (CUDA events), {res[k]['host_ms']} "
              f"ms (host clock), {res[k]['device_kernels']} device kernels a call")
    for name in ("request", "duplicated"):
        r = res[name]
        print(f"{name} clouds: ids differing from the sum(-1) loop: "
              f"{r['ids_differ_sum_loop']} of {r['ids']} "
              f"({r['rows_differ_sum_loop']} of 96 rows); from the kernel: "
              f"{r['ids_differ_kernel']}")
    print(res["card"])
    print(json.dumps(res))


if __name__ == "__main__":
    main()
