#!/usr/bin/env python3
"""Where the time of one serving request, or one train step, of the
PyTorch/CUDA port goes.

    python3 scripts/torch_port_profile.py [--train [--bwd_kernels]]
                                          [--loop_kernels]
                                          [--n_points N] [--out DIR]
                                          (default N=717, profile_out/)
    python3 scripts/torch_port_profile.py --preset indoor [--fused_edges]
                                          [--n_points N]

Needs one CUDA device. Runs GMMReg at B=24, N=717 (or --n_points: 1433 is
ModelNet40's 2048-point clouds cropped to 0.70, the shared-graph route),
emb 512, K=128 with a bf16 body and seeded random weights (with --preset
indoor: the indoor request, B=1, N=35,000, K=16, on bench.py's synthetic
fragment against a rigid copy of it), and prints, for a request without and
with ICP (or, with --train, for a train step with the metric suite and the
overlap labels made on the device): the host-clock time per call, the
device-busy time and idle share from `torch.profiler`, the number of device
kernels launched, the ten device kernels with the most time, and the time
of each kernel of `ogmm_tpu_torch/csrc`. Also times
the stages of the forward (with --train: forward and loss, backward, the
optimizer, the metrics) with CUDA events. `--bwd_kernels` turns on
`ops.dgcnn_train.BWD_KERNELS`, so that the DGCNN backward runs through its
three CUDA kernels instead of plain PyTorch. `--loop_kernels` builds the
Registrar with `loop_kernels=True`, so that FPS, ICP and the attention MLPs
run as one kernel launch each. `--fused_edges` sets dgcnn_fused_edges=True
(with --preset indoor: the stage chain through the edges kernel). One JSON
line at the end
carries the same numbers with the card's name and power limit.
"""
import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ogmm_tpu_torch import configs  # noqa: E402
from ogmm_tpu_torch.api import Registrar  # noqa: E402

B = 24
CSRC = os.path.join(ROOT, "ogmm_tpu_torch", "csrc")


def own_kernel_names():
    """Names of the __global__ functions in the port's CUDA sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__\w+__\([^)]*\)\s*)*(\w+)\s*\(")
    names = set()
    for f in os.listdir(CSRC):
        with open(os.path.join(CSRC, f)) as fh:
            names.update(pat.findall(fh.read()))
    return names


def device_time_us(evt):
    return getattr(evt, "device_time_total", None) or getattr(
        evt, "cuda_time_total", 0.0)


def profile_call(fn, reps=3):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        ms, cnt = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + device_time_us(e) / 1e3, cnt + 1)
    busy_ms = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    own = own_kernel_names()
    ours = [kv for kv in ranked
            if re.match(r"(?:void )?(\w+)", kv[0]).group(1) in own]
    return {
        "wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "device_kernels": len(kernels),
        "top": [{"name": k[:80], "ms": v[0], "count": v[1]}
                for k, v in ranked[:10]],
        "port_kernels": [{"name": k[:80], "ms": v[0], "count": v[1]}
                         for k, v in ours],
    }


def indoor_pair(rs, n):
    """bench.py's synthetic indoor fragment and a copy of it turned 20
    degrees about z, shifted and permuted."""
    u = rs.rand(1, n, 2).astype(np.float32)
    z = np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    src = (np.concatenate([u, 0.3 * z], -1) + 0.01 * rs.randn(1, n, 3)).astype(np.float32)
    a = np.radians(20.0)
    rot = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]], np.float32)
    tgt = src @ rot.T + np.array([0.1, -0.05, 0.02], np.float32)
    return src, tgt[:, rs.permutation(n)].astype(np.float32)


def stage_times(reg, src, tgt):
    """CUDA-event time of the model's stages, by wrapping its submodules."""
    model = reg.model
    spans = {}

    def timed(name, fn):
        def wrapper(*a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **kw)
            end.record()
            spans.setdefault(name, []).append((start, end))
            return out
        return wrapper

    import ogmm_tpu_torch.nn.gmmreg as g
    saved = {k: getattr(g, k) for k in ("fps_combined", "wkeans_plus", "gmm_svd",
                                        "icp_point_to_point", "knn",
                                        "knn_self_vspace",
                                        "wproject_stream_lse")}
    for k, fn in saved.items():
        setattr(g, k, timed(k, fn))
    fwd = {}
    for name in ("dgcnn", "pos_enc", "sattn1", "cattn", "sattn2", "conv1",
                 "conv2", "proj", "overlap"):
        mod = getattr(model, name)
        fwd[name] = mod.forward
        mod.forward = timed(name, mod.forward)
    try:
        reg(src, tgt, refine=True)
        torch.cuda.synchronize()
    finally:
        for k, fn in saved.items():
            setattr(g, k, fn)
        for name, fn in fwd.items():
            getattr(model, name).forward = fn
    return {k: sum(s.elapsed_time(e) for s, e in v) for k, v in spans.items()}


def train_phase_times(state, cfg, batch, reps=3):
    """CUDA-event time of the phases of a train step, mean of `reps`."""
    from ogmm_tpu_torch.core.metrics import dcp_metrics
    from ogmm_tpu_torch.train import train_loss
    names = ("forward_and_loss", "backward", "optimizer", "metrics")
    spans = {k: 0.0 for k in names}
    for _ in range(reps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        ev[0].record()
        loss, (rot, trans, _, inputs) = train_loss(state, cfg, batch)
        ev[1].record()
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        ev[2].record()
        state.optimizer.step()
        state.scheduler.step()
        ev[3].record()
        dcp_metrics(*inputs[:4], rot.detach(), trans.detach())
        ev[4].record()
        torch.cuda.synchronize()
        for i, k in enumerate(names):
            spans[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    return spans


def report(key, r):
    print(f"{key}: {r['wall_ms']:.2f} ms per call on the host clock, "
          f"device busy {r['device_busy_ms']:.2f} ms (idle share "
          f"{r['device_idle_share']:.2f}), {r['device_kernels']} device kernels")
    for t in r["top"]:
        print(f"    {t['ms']:8.3f} ms  x{t['count']:<5d} {t['name']}")
    print("  the port's own kernels:")
    for t in r["port_kernels"]:
        print(f"    {t['ms']:8.3f} ms  x{t['count']:<5d} {t['name']}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--train", action="store_true",
                    help="profile a train step instead of a request")
    ap.add_argument("--bwd_kernels", action="store_true",
                    help="with --train: the DGCNN backward through its kernels")
    ap.add_argument("--n_points", type=int, default=None,
                    help="points a cloud (above 1024: the shared kNN graph; "
                         "default 717, 35000 with --preset indoor)")
    ap.add_argument("--preset", choices=["mnet", "indoor"], default="mnet")
    ap.add_argument("--loop_kernels", action="store_true",
                    help="FPS, ICP and the attention MLPs through their kernels")
    ap.add_argument("--fused_edges", action="store_true",
                    help="dgcnn_fused_edges=True: the DGCNN stage chain of the "
                         "indoor request through the edges kernel")
    args = ap.parse_args()
    indoor = args.preset == "indoor"
    N = args.n_points or (35000 if indoor else 717)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if args.loop_kernels and args.train:
        sys.exit("--loop_kernels switches the serving path; profile it without "
                 "--train")
    if indoor and args.train:
        sys.exit("--preset indoor profiles the request only: indoor training "
                 "is not ported yet (ROADMAP.md, queue A item 5)")
    rs = np.random.RandomState(0)
    if indoor:
        cfg = configs.indoor()
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype="bfloat16"))
        src, tgt = indoor_pair(rs, N)
    else:
        cfg = configs.mnet(model=configs.ModelConfig(dtype="bfloat16"))
        src = (rs.randn(B, N, 3) * 0.3).astype(np.float32)
        tgt = src[:, rs.permutation(N)] + 0.05
    if args.fused_edges:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    dgcnn_fused_edges=True))
    result = {"shape": {"B": src.shape[0], "N": N}, "preset": args.preset,
              "bwd_kernels": args.bwd_kernels, "loop_kernels": args.loop_kernels,
              "fused_edges": args.fused_edges}
    if args.train:
        from ogmm_tpu_torch.ops import dgcnn_train
        from ogmm_tpu_torch.train import create_train_state, make_train_step
        dgcnn_train.BWD_KERNELS = args.bwd_kernels
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    device_overlap=True))
        state = create_train_state(cfg, steps_per_epoch=100, seed=0)
        gt = np.tile(np.eye(3, 4, dtype=np.float32), (B, 1, 1))
        gt[:, :, 3] = 0.05
        ones = np.ones((B, N), np.float32)
        batch = {"src_xyz": src, "tgt_xyz": src + 0.05, "src_overlap": ones,
                 "tgt_overlap": ones, "transform_gt": gt}
        step = make_train_step(cfg)
        result["train_step"] = r = profile_call(lambda: step(state, batch))
        report("train_step", r)
        result["stages_ms"] = train_phase_times(state, cfg, batch)
        print("phases (CUDA events, mean of 3 train steps):")
    else:
        reg = Registrar(cfg, seed=0, loop_kernels=args.loop_kernels)
        for refine in (False, True):
            key = "forward_icp" if refine else "forward"
            result[key] = r = profile_call(
                lambda: reg(src, tgt, refine=refine))
            report(key, r)
        result["stages_ms"] = stage_times(reg, src, tgt)
        print("stages (CUDA events, one request with ICP):")
    for k, v in sorted(result["stages_ms"].items(), key=lambda kv: -kv[1]):
        print(f"    {v:8.3f} ms  {k}")
    result["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    os.makedirs(args.out, exist_ok=True)
    name = ("torch_port_profile" if not args.train
            else "torch_port_profile_train_bwd_kernels" if args.bwd_kernels
            else "torch_port_profile_train")
    name += "_indoor" if indoor else ""
    name += "_loop_kernels" if args.loop_kernels else ""
    name += "_fused_edges" if args.fused_edges else ""
    name += "" if N == (35000 if indoor else 717) else f"_n{N}"
    name += ".json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
