#!/usr/bin/env python3
"""Where the time of one serving request, or one train step, of the
PyTorch/CUDA port goes.

    python3 scripts/torch_port_profile.py [--train [--bwd_kernels]]
                                          [--loop_kernels] [--gnn_k K]
                                          [--n_points N] [--out DIR]
                                          (default N=717, profile_out/)
    python3 scripts/torch_port_profile.py --preset indoor [--fused_edges]
                                          [--n_points N]
    python3 scripts/torch_port_profile.py --preset indoor --train
                                          [--dtype float32] [--batch B] [--fit]
    python3 scripts/torch_port_profile.py --model DeepGMR [--train]
                                          [--loop_kernels] [--n_points N]
    python3 scripts/torch_port_profile.py --preset serve [--n_points N]
    python3 scripts/torch_port_profile.py [--preset indoor] [--n_points N]
                                          --refine plane|grid
    python3 scripts/torch_port_profile.py --probe knn_stream [--parent DIR]
    python3 scripts/torch_port_profile.py --probe icp
    python3 scripts/torch_port_profile.py --probe bwd_edge
    python3 scripts/torch_port_profile.py --probe knn [--parent DIR]
    python3 scripts/torch_port_profile.py --probe graph_stage1 [--parent DIR]
    python3 scripts/torch_port_profile.py --probe nn1 [--parent DIR]
    python3 scripts/torch_port_profile.py --probe bwd_reduce [--parent DIR]
    python3 scripts/torch_port_profile.py --probe fps [--parent DIR]
    python3 scripts/torch_port_profile.py --probe posenc_angles [--parent DIR]
    python3 scripts/torch_port_profile.py --probe dgcnn_eval [--dtype float32]
                                          [--parent DIR]
    python3 scripts/torch_port_profile.py --probe wproject [--parent DIR]

Needs one CUDA device. Runs GMMReg at B=24, N=717 (or --n_points: 1433 is
ModelNet40's 2048-point clouds cropped to 0.70, the shared-graph route),
emb 512, K=128 with a bf16 body (`--dtype float32`: the float32 body that
`configs.mnet()` gives by default) and seeded random weights (with --preset
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
(with --preset indoor: the stage chain through the edges kernel). With
--preset indoor --train: one indoor train step of `configs.indoor()` at B
pairs (`--batch`, default 2) of N=35,000, the streamed overlap head trained
through its chunked recompute, with its peak device memory and the device
time of the head's backward; `--fit` instead takes one step at B = 1..8
until one does not fit the card. With --model DeepGMR:
`Registrar(configs.mnet(model_name="DeepGMR"))` (its float32 body; --dtype
does not apply) at the modelnetdv geometry, B=24 pairs of N=768 (or
--n_points) source points against 2N target points (a rotated copy and as
many other points), the stages being the backbone and the clustering head
on each cloud, the moments, the alignment and ICP; with --train its train
step. `--preset serve`: `configs.serve()` (6 EM trips, bf16 body) in place
of the bf16 `mnet` request. `--refine plane|grid`: after the forward, the
returned pose refined as a caller would, point-to-plane
(`ops.icp.refine_registration(..., pl=True)`, normals from the target's
k=16 kNN) or point-to-point through the grid 1-NN (`use_grid=True`, the cap
the densest cell needs, a multiple of 32), profiled as forward + refinement
and as the refinement alone from a fixed pose. One JSON line at the end
carries the same numbers with the card's name and power limit.

`--probe` times variants of one kernel beside it, built from its source with
a line changed (not shipped, never on a path), to say where its time goes:
`knn_stream` at the indoor graph (2, 35,000, k=20, sorted, cull, diagonal
order): the kernel with its `visits` counters, a build whose insertion only
replaces the last entry (its lists never fill, so it writes no index: the
insertion's cost and the merge's writes), and with
`--parent DIR` (a `git archive` of a commit whose `knn_stream.cu` still has
the one-thread-a-query `stream_kernel`) that kernel built with the same
counters; `icp` at (24, 717), (24, 1433) and (48, 717), 30 trips: the
launch of `cuda_icp.icp_plan` and the same rows at other cluster sizes with
the occupancy calculator's count of clusters at once, the plan's launch
with a target of 8 points (what a trip costs without the search) and a
build with one power-iteration step (the 4x4 solve's share); `bwd_edge` at
one backward's stage-1 call (24, 20, 717, 64), bf16 and float32, on a kNN
graph of random clouds: the device time of each `__global__` it launches;
`knn` at the N=1433 request's (48, 1433, 1433, 20) and the unfused step's
(24, 717, 717, 20): the kernel, and with `--parent DIR` (a `git archive` of
a commit whose `knn.cu` still has the warp-a-query `knn_kernel`) that
kernel and a build of it without its k selection rounds (it writes each
query's candidate count instead of the indices); `graph_stage1` at one train
step's call (24, 717, k=20, pk=5), bf16 and float32: the ms between CUDA
events and the device ms of each `__global__` (the selection and the edge
pass apart), the outputs against the plain version, and with `--parent DIR`
the same for that tree's `graph_stage1.cu` with its outputs compared bit for
bit; then the same selection in `dgcnn_eval` (48, 717, k=20, emb 512) and
`posenc_angles` (24, 717, k=5); `nn1` at the four shapes its paths launch
((24, 512, 717) the Welsch loss, (24, 128, 717) the clustering, (24, 717,
717) the metrics, (24, 1433, 1433) the N=1433 ICP trips): the wrapper's
call and its plan, every (lanes, queries a thread) pair `csrc/nn1.cu`
compiles with its device ms, and with `--parent DIR` that tree's `nn1.cu`,
each bit-equal to the plain version; then the same at three shapes whose
queries leave SMs without a block ((4, 16, 2048) the C.1 check's
clustering, (1, 128, 717) and (1, 717, 717) requests of one cloud);
`posenc_angles` at the unfused step's (24, 717, k=5): the ms between CUDA
events and the device ms of each kernel the call launches, the wrapper's
plan, the outputs against the plain version (indices identical, angles), the
variants of `POSENC_VARIANTS` (the cloud staged and nothing else, the first
pass alone, no buffer, the points below the threshold inserted at once) and
with `--parent DIR` that tree's kernel with the centroid's `mean` launch its
wrapper makes, all timed in turns;
`dgcnn_eval` at the request's (48, 717, k=20, emb 512) in `--dtype`: the ms
between CUDA events, the device ms of each `__global__` (the selection, the
stage chain, the head), the error against the plain version, the variants of
`DGCNN_VARIANTS` (the float32 stage kernel at two row tiles at a time in
stage 4), the rate of `mma.sync` m16n8k8 TF32 alone on the card
(`MMA_RATE`: independent products only, at 8, 16 and 32 warps an SM), and
with `--parent DIR` that tree's kernel on the same operands;
`wproject` at the indoor head's call (1, 35000, 35000, D=512), float32 and
bf16: the ms between CUDA events and the device ms of each `__global__`
(the projection, the merge), out and lse against the plain version, a
relaunch bit-equal, the plain version's and `scaled_dot_product_attention`'s
(MATH) times, the TFLOP/s of tensor-core products; for float32 the variants
of `WPROJECT_VARIANTS` (the key tiles in plain order, scale-d from the chunk
index) with ptxas's report of each build, and with `--parent DIR` that
tree's kernel, all timed in turns.
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


def refiner(how, reg, src, tgt):
    """fn(rot, trans) refining a returned pose of reg's request on (src,
    tgt): point-to-plane ('plane') or point-to-point through the grid 1-NN
    ('grid', its cap the densest cell's count rounded up to 32)."""
    from ogmm_tpu_torch.core import se3
    from ogmm_tpu_torch.ops.grid_nn import build_grid
    from ogmm_tpu_torch.ops.icp import icp_point_to_point, refine_registration
    m = reg.cfg.model
    s, t = reg._as_input(src), reg._as_input(tgt)
    if how == "plane":
        return lambda rot, trans: refine_registration(
            s, t, rot, trans, m.overlap_radius, m.icp_iters, pl=True)
    thr = 2.0 * m.overlap_radius
    occ = build_grid(t, thr).max_occupancy.max().item()
    cap = -(-occ // 32) * 32

    def fn(rot, trans):
        return icp_point_to_point(s, t, se3.integrate(rot, trans), thr,
                                  m.icp_iters, use_grid=True, grid_cap=cap)
    fn.cap = cap
    return fn


def stage_times(reg, src, tgt):
    """CUDA-event time of the model's stages, by wrapping its submodules
    and the functions its module looks up at call time."""
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

    if type(model).__name__ == "DeepGMR":
        import ogmm_tpu_torch.nn.deepgmr as g
        fns = ("gmm_params", "gmm_register", "icp_point_to_point")
        subs = ("backbone", "cluster")
    else:
        import ogmm_tpu_torch.nn.gmmreg as g
        fns = ("fps_combined", "wkeans_plus", "gmm_svd", "icp_point_to_point",
               "knn", "knn_self_vspace", "wproject_stream_lse")
        subs = ("dgcnn", "pos_enc", "sattn1", "cattn", "sattn2", "conv1",
                "conv2", "proj", "overlap")
    saved = {k: getattr(g, k) for k in fns}
    for k, fn in saved.items():
        setattr(g, k, timed(k, fn))
    fwd = {}
    for name in subs:
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


def indoor_train_batch(rs, batch, n):
    """`batch` pairs of bench.py's synthetic fragment against a copy turned
    20 degrees about z, shifted and permuted, with the true poses."""
    pairs = [indoor_pair(rs, n) for _ in range(batch)]
    a = np.radians(20.0)
    gt = np.array([[np.cos(a), -np.sin(a), 0, 0.1], [np.sin(a), np.cos(a), 0, -0.05],
                   [0, 0, 1, 0.02]], np.float32)
    ones = np.ones((batch, n), np.float32)
    return {"src_xyz": np.concatenate([p[0] for p in pairs]),
            "tgt_xyz": np.concatenate([p[1] for p in pairs]),
            "src_overlap": ones, "tgt_overlap": ones,
            "transform_gt": np.tile(gt, (batch, 1, 1))}


def indoor_train(args, n, rs):
    """One indoor train step (`configs.indoor()`, labels made in the step):
    host ms, device busy and idle share, kernels, peak device memory, the
    phases, and the device time of the overlap head's backward (the chunked
    recompute `ops.stream.wproject_bwd`, CUDA events around each call). With
    --fit: one step at B = 1..8 until one does not fit the card."""
    from ogmm_tpu_torch.ops import stream
    from ogmm_tpu_torch.train import create_train_state, make_train_step
    cfg = configs.indoor()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=args.dtype),
                      train=dataclasses.replace(cfg.train, device_overlap=True))

    def one(batch_size):
        state = create_train_state(cfg, steps_per_epoch=100, seed=0)
        step = make_train_step(cfg)
        batch = indoor_train_batch(rs, batch_size, n)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        return state, step, batch, (time.perf_counter() - t0) * 1e3

    result = {"shape": {"B": args.batch, "N": n}, "preset": "indoor",
              "dtype": args.dtype, "train": True}
    if args.fit:
        fits = []
        for b in range(1, 9):
            try:
                _, _, _, ms = one(b)
                peak = torch.cuda.max_memory_allocated() / 2 ** 30
                fits.append({"B": b, "fits": True, "first_step_ms": ms,
                             "peak_gib": peak})
                print(f"B={b}: fits, peak {peak:.2f} GiB, first step {ms:.0f} ms")
            except torch.cuda.OutOfMemoryError as e:
                fits.append({"B": b, "fits": False,
                             "error": str(e).splitlines()[0][:200]})
                print(f"B={b}: does not fit ({str(e).splitlines()[0][:120]})")
                break
            finally:
                torch.cuda.empty_cache()
        result["fit"] = fits
        result["largest_B"] = max((f["B"] for f in fits if f["fits"]), default=0)
    else:
        state, step, batch, _ = one(args.batch)
        torch.cuda.reset_peak_memory_stats()
        result["train_step"] = r = profile_call(lambda: step(state, batch))
        r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        report("train_step", r)
        spans = []
        bwd = stream.wproject_bwd

        def timed(*a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = bwd(*a, **kw)
            end.record()
            spans.append((start, end))
            return out
        stream.wproject_bwd = timed
        try:
            result["stages_ms"] = train_phase_times(state, cfg, batch)
        finally:
            stream.wproject_bwd = bwd
        result["head_backward_ms"] = sum(s.elapsed_time(e) for s, e in spans) / 3
        result["head_backward_calls"] = len(spans) // 3
        print(f"peak device memory {r['peak_gib']:.2f} GiB; the head's backward "
              f"{result['head_backward_ms']:.2f} ms a step on the device "
              f"({result['head_backward_calls']} calls)")
        print("phases (CUDA events, mean of 3 train steps):")
        for k, v in sorted(result["stages_ms"].items(), key=lambda kv: -kv[1]):
            print(f"    {v:8.3f} ms  {k}")
    result["card"] = _card()
    os.makedirs(args.out, exist_ok=True)
    name = (f"torch_port_profile_train_indoor_b{args.batch}" if not args.fit
            else "torch_port_profile_train_indoor_fit")
    name += "_f32.json" if args.dtype == "float32" else ".json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


def report(key, r):
    print(f"{key}: {r['wall_ms']:.2f} ms per call on the host clock, "
          f"device busy {r['device_busy_ms']:.2f} ms (idle share "
          f"{r['device_idle_share']:.2f}), {r['device_kernels']} device kernels")
    for t in r["top"]:
        print(f"    {t['ms']:8.3f} ms  x{t['count']:<5d} {t['name']}")
    print("  the port's own kernels:")
    for t in r["port_kernels"]:
        print(f"    {t['ms']:8.3f} ms  x{t['count']:<5d} {t['name']}")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _variant(source, edits, name, out, ptxas_report=False):
    """`source` with each (old, new) of `edits` replaced once, built with
    the package's nvcc flags (and the headers beside `source`) into out/,
    loaded with ctypes; with `ptxas_report`, ptxas's report (registers,
    spills, warnings) printed."""
    import ctypes
    from ogmm_tpu_torch.ops import dispatch
    with open(source) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: {source} has no line {old[:60]!r}")
        text = text.replace(old, new, 1)
    os.makedirs(out, exist_ok=True)
    cu, so = os.path.join(out, name + ".cu"), os.path.join(out, name + ".so")
    with open(cu, "w") as f:
        f.write(text)
    subprocess.run([dispatch._nvcc(), *dispatch.NVCC_FLAGS,
                    *(("-Xptxas", "-v") if ptxas_report else ()), "-I",
                    os.path.dirname(os.path.abspath(source)), "-o", so, cu],
                   check=True)
    return ctypes.CDLL(so)


ONLY_K20 = ("    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)\n"
            "    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)\n"
            "    CASE(17) CASE(18) CASE(19) CASE(20) CASE(21) CASE(22) CASE(23) CASE(24)\n"
            "    CASE(25) CASE(26) CASE(27) CASE(28) CASE(29) CASE(30) CASE(31) CASE(32)")
# the one-thread-a-query kernel (the design before this one) with the counters of the
# kernel that replaced it: tiles searched, their most over blocks, and
# (8 queries, 64 points) units of distances formed
PARENT_COUNTERS = [
    ("              float* __restrict__ d_out, int N, int M, int diag, int stretch,\n"
     "              float gate) {",
     "              float* __restrict__ d_out, int* __restrict__ visits, int N, int M,\n"
     "              int diag, int stretch, float gate) {\n  int searched = 0, units = 0;"),
    ("    const int m0 = phys * STM, len = min(STM, M - m0);\n    __syncthreads();",
     "    const int m0 = phys * STM, len = min(STM, M - m0);\n"
     "    ++searched; units += 8 * ((len + 63) / 64);\n    __syncthreads();"),
    ("  if (!valid) return;\n  const size_t row = (size_t)b * N + n;",
     "  if (visits != nullptr && tid == 0) {\n    atomicAdd(visits, searched);\n"
     "    atomicMax(visits + 1, searched);\n    atomicAdd(visits + 2, units);\n  }\n"
     "  if (!valid) return;\n  const size_t row = (size_t)b * N + n;"),
    ("                                 const float* lb, long long* idx, int B, int N,\n"
     "                                 int M, int k, int diag, int stretch,",
     "                                 const float* lb, long long* idx, int* visits,\n"
     "                                 int B, int N, int M, int k, int diag, int stretch,"),
    ("(src, tgt, lb, idx, nullptr, N, \\\n"
     "                                               M, diag, stretch, INFINITY);",
     "(src, tgt, lb, idx, nullptr, visits, \\\n"
     "                                               N, M, diag, stretch, INFINITY);"),
    (ONLY_K20, "    CASE(20)")]


# knn_lanes.cuh (inlined into the source) with an insertion that only
# replaces a list's last entry: its lists never fill, so it writes no index
NO_INSERTION = [
    ('#include "knn_lanes.cuh"', open(os.path.join(CSRC, "knn_lanes.cuh")).read()),
    ("      insert<K>(kd, ki, dist_fma(qx, qy, qz, qq, ts[NL * jj]), idx0 + NL * jj);",
     "      { const float cd = dist_fma(qx, qy, qz, qq, ts[NL * jj]);\n"
     "        const int ci = idx0 + NL * jj;\n"
     "        if (before(cd, ci, kd[K - 1], ki[K - 1])) { kd[K - 1] = cd; ki[K - 1] = ci; } }")]


def probe_knn_stream(args):
    import ctypes
    from ogmm_tpu_torch.ops import cuda_stream, stream
    from ogmm_tpu_torch.ops.common import index_points
    rs = np.random.RandomState(7)
    u = rs.rand(2, 35000, 2).astype(np.float32)
    z = np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    pts = np.concatenate([u, 0.3 * z], -1) + 0.01 * rs.randn(2, 35000, 3)
    x = torch.tensor(pts.astype(np.float32), device="cuda")
    x = index_points(x, stream.morton_order(x))
    lb = stream.tile_pair_bounds(x)
    want = stream.knn_stream_plain(x, x, 20)
    builds = {"no insertion": _variant(
        os.path.join(CSRC, "knn_stream.cu"),
        [(ONLY_K20, "    CASE(20)"), *NO_INSERTION], "knn_stream_no_insertion", args.out)}
    if args.parent:
        builds["parent"] = _variant(
            os.path.join(args.parent, "ogmm_tpu_torch", "csrc", "knn_stream.cu"),
            PARENT_COUNTERS, "knn_stream_parent_counted", args.out)
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    result = {}
    for name in ("kernel", *builds):
        for cull in (True, False):
            visits = torch.zeros(3, dtype=torch.int32, device="cuda")
            kw = dict(diag_order=True, cull_lb=lb) if cull else {}
            if name == "kernel":
                run = lambda v=None: cuda_stream.knn_stream(x, x, 20, visits=v, **kw)
            else:
                fn = builds[name].knn_stream_launch
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
                idx = torch.empty(2, 35000, 20, dtype=torch.int64, device="cuda")

                def run(v=None, fn=fn, idx=idx, cull=cull):
                    code = fn(ptr(x), ptr(x), ptr(lb if cull else None), ptr(idx),
                              ptr(v), 2, 35000, 35000, 20, int(cull), 1, None)
                    if code:
                        raise RuntimeError(f"launch failed: {code}")
                    return idx
            if name != "kernel":
                idx.fill_(-1)     # a variant that writes no index is not identical
            same = torch.equal(run(visits), want)
            ms = _cuda_ms(run, 10 if cull else 3)
            tiles, most, units = visits.tolist()
            key = f"{name}{'' if cull else ', no cull'}"
            result[key] = {"ms": ms, "indices_identical": same,
                           "tile_pairs_searched": tiles / lb.numel(),
                           "most_tiles_a_block": most,
                           "distance_pairs_formed": units * 512 / (2 * 35000 ** 2)}
            print(f"knn_stream {key}: {ms:.4f} ms, indices identical {same}, "
                  f"searched {tiles / lb.numel():.4f} of the tile pairs, the most "
                  f"one block searched {most} of {lb.shape[2]}, distances formed "
                  f"for {units * 512 / (2 * 35000 ** 2):.4f} of the pairs")
    return result


def probe_icp(args):
    import ctypes
    from ogmm_tpu_torch.ops import cuda_icp, dispatch
    from ogmm_tpu_torch.ops.cuda_stream import _sm_count
    lib = dispatch.load_kernel("icp")
    one_step = _variant(os.path.join(CSRC, "icp.cu"),
                        [("#define PI_ITERS 30", "#define PI_ITERS 1")],
                        "icp_one_power_step", args.out)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    rs = np.random.RandomState(3)
    thr2 = 0.07 ** 2
    sms = _sm_count(0)
    result = {}
    for b, n in ((24, 717), (24, 1433), (48, 717)):
        src = torch.tensor((rs.randn(b, n, 3) * 0.3).astype(np.float32), device="cuda")
        tgt = (src + 0.003 * torch.randn_like(src))[:, torch.randperm(n, device="cuda")]
        a = 0.05
        pose = torch.zeros(b, 3, 4, device="cuda")
        pose[:, 0, 0] = pose[:, 1, 1] = float(np.cos(a))
        pose[:, 0, 1], pose[:, 1, 0] = -float(np.sin(a)), float(np.sin(a))
        pose[:, 2, 2], pose[:, 0, 3] = 1.0, 0.02
        plan = cuda_icp.icp_plan(b, n, n, sms)
        runs = [(f"C={c}", lib, cuda_icp.icp_cluster_plan(c, n, n), n)
                for c in sorted({2, 4, 5, 8, plan.cluster})]
        runs += [("plan, a target of 8 points", lib, plan, 8),
                 ("plan, one power step", one_step, plan, n)]
        for label, l, p, m in runs:
            out = torch.empty(b, 3, 4, device="cuda")
            first = torch.empty(b, n, dtype=torch.int32, device="cuda")
            fn = l.icp_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
                           + [ctypes.c_int] * 6 + [ctypes.c_void_p])

            def run(fn=fn, p=p, m=m, out=out, first=first):
                code = fn(ptr(src), ptr(tgt), ptr(pose), ptr(out), ptr(first), b, n,
                          m, thr2, 30, *p, None)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
            ms = _cuda_ms(run, 10)
            key = f"({b}, {n}, {n}) {label}"
            result[key] = {"ms": ms, "plan": p._asdict(),
                           "clusters_at_once": cuda_icp.max_active_clusters(p)}
            print(f"icp {key}: {ms:.4f} ms; {p.cluster} blocks a cloud, "
                  f"{p.threads} threads, the card holds "
                  f"{result[key]['clusters_at_once']} such clusters at once")
    return result


def _profile_groups(fn, reps):
    """Device ms a call of each kernel fn launches, by name (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key[:90]: device_time_us(e) / 1e3 / reps for e in prof.key_averages()
            if device_time_us(e) > 0}


def probe_bwd_edge(args):
    from ogmm_tpu_torch.ops import cuda_dgcnn_bwd, cuda_knn
    rs = np.random.RandomState(5)
    b, n, c, k = 24, 717, 64, 20
    dev = "cuda"
    x = torch.tensor((rs.randn(b, n, 3) * 0.3).astype(np.float32), device=dev)
    idx = cuda_knn.knn_reference(x, x, k)
    result = {}
    for dt in (torch.bfloat16, torch.float32):
        g = lambda *s, scale=1.0: torch.tensor(
            (rs.randn(*s) * scale).astype(np.float32), device=dev)
        z1 = g(b, k, n, c).to(dt)
        mean, var = z1.float().mean((0, 1, 2)), z1.float().var((0, 1, 2))
        args_ = (z1, g(b, n, c, scale=0.1).to(dt), mean, var,
                 torch.tensor(rs.uniform(0.5, 1.5, c).astype(np.float32), device=dev),
                 g(c, scale=0.1), g(2, c, scale=10.0), g(b, k, n, c, scale=0.01).to(dt),
                 g(c, c, scale=0.125), g(b, k, n, 6, scale=0.3).to(dt),
                 g(6, c, scale=0.4), idx)
        run = lambda: cuda_dgcnn_bwd.bwd_edge(*args_)
        key = "bf16" if dt == torch.bfloat16 else "float32"
        result[key] = {"ms": _cuda_ms(run, 20), "device_ms": _profile_groups(run, 20)}
        print(f"bwd_edge {key}: {result[key]['ms']:.4f} ms a call; device ms of "
              f"each kernel: {result[key]['device_ms']}")
    return result


# the warp-a-query knn_kernel without its k rounds of warp argmin: the
# threshold pass and the candidate pass run, and lane 0 writes the count
NO_SELECTION = [
    ("    long long* out = idx_out + ((size_t)b * N + n) * k;\n    if (cnt <= CAP) {",
     "    long long* out = idx_out + ((size_t)b * N + n) * k;\n"
     "    if (lane == 0) out[0] = cnt;\n    if (false) {"),
    ("    } else {\n      float pd = -CUDART_INF_F;",
     "    } else if (false) {\n      float pd = -CUDART_INF_F;")]


def probe_knn(args):
    import ctypes
    from ogmm_tpu_torch.ops import cuda_knn
    rs = np.random.RandomState(6)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    builds = {}
    if args.parent:
        src = os.path.join(args.parent, "ogmm_tpu_torch", "csrc", "knn.cu")
        builds["parent"] = _variant(src, [], "knn_parent", args.out)
        builds["parent, no selection"] = _variant(src, NO_SELECTION,
                                                  "knn_parent_no_selection", args.out)
    result = {}
    for b, n, k in ((48, 1433, 20), (24, 717, 20)):
        x = torch.tensor((rs.randn(b, n, 3) * 0.3).astype(np.float32), device="cuda")
        x[:, n // 2] = x[:, 1]
        want = cuda_knn.knn_reference(x, x, k)
        runs = {"kernel": lambda: cuda_knn.knn(x, x, k)}
        for name, lib in builds.items():
            fn = lib.knn_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            idx = torch.full((b, n, k), -1, dtype=torch.int64, device="cuda")

            def run(fn=fn, idx=idx):
                code = fn(ptr(x), ptr(x), ptr(idx), b, n, n, k, None)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
                return idx
            runs[name] = run
        for name, run in runs.items():
            same = torch.equal(run(), want)
            ms = _cuda_ms(run, 20)
            device = _profile_groups(run, 10)
            key = f"({b}, {n}, {n}, k={k}) {name}"
            result[key] = {"ms": ms, "device_ms": device, "indices_identical": same}
            print(f"knn {key}: {ms:.4f} ms, indices identical {same}, device {device}")
    return result


def _parent_lib(args, name):
    """The parent tree's build of csrc/<name>.cu (its own headers), or None."""
    if not args.parent:
        return None
    return _variant(os.path.join(args.parent, "ogmm_tpu_torch", "csrc", f"{name}.cu"),
                    [], f"{name}_parent", args.out)


def _timed(label, run, reps=20):
    """ms between CUDA events and device ms of each __global__ of run()."""
    ms = _cuda_ms(run, reps)
    device = _profile_groups(run, reps)
    print(f"{label}: {ms:.4f} ms between calls; device ms of each kernel: {device}")
    return {"ms": ms, "device_ms": device}


def _interleaved(runs, rounds=3, reps=10):
    """ms between CUDA events of each of several builds' calls, taken in
    turns (round r times every build before round r + 1: a card that warms
    up or slows down over a probe moves all of them alike), the least of the
    rounds, and the device ms of each __global__ of each."""
    times = {label: [] for label in runs}
    for _ in range(rounds):
        for label, run in runs.items():
            times[label].append(_cuda_ms(run, reps))
    res = {}
    for label, run in runs.items():
        res[label] = {"ms": min(times[label]), "ms_rounds": times[label],
                      "device_ms": _profile_groups(run, reps)}
        print(f"  {label}: {res[label]['ms']:.4f} ms between calls (rounds "
              f"{[round(t, 4) for t in times[label]]}); device ms of each kernel: "
              f"{res[label]['device_ms']}")
    return res


def probe_graph_stage1(args):
    import ctypes
    from ogmm_tpu_torch.ops import cuda_dgcnn_train, cuda_posenc
    from ogmm_tpu_torch.ops.cuda_dgcnn import dgcnn_eval
    rs = np.random.RandomState(8)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    from ogmm_tpu_torch.ops import dispatch
    parent = _parent_lib(args, "graph_stage1")
    edge_eu = {u: _variant(os.path.join(CSRC, "graph_stage1.cu"),
                           [("#define EU 2 ", f"#define EU {u} ")],
                           f"graph_stage1_eu{u}", args.out) for u in (1, 4)}
    b, n, k, pk = 24, 717, 20, 5
    x = torch.tensor((rs.randn(b, n, 3) * 0.3).astype(np.float32), device="cuda")
    x[:, n // 2] = x[:, 1]                    # a duplicated point: exact ties
    w1 = torch.tensor((rs.randn(6, 64) / np.sqrt(6)).astype(np.float32), device="cuda")
    result = {}
    for dt in (torch.bfloat16, torch.float32):
        key = "bf16" if dt == torch.bfloat16 else "float32"
        got = cuda_dgcnn_train.graph_stage1(x, w1, k, dt, pk)
        want = cuda_dgcnn_train.graph_stage1_reference(x, w1, k, dt, pk)
        r = _timed(f"graph_stage1 ({b}, {n}, k={k}, pk={pk}) {key}",
                   lambda: cuda_dgcnn_train.graph_stage1(x, w1, k, dt, pk))
        r.update(idx_identical=torch.equal(got[2], want[2]),
                 e_identical=torch.equal(got[1], want[1]),
                 z1_max_abs_err=(got[0].float() - want[0].float()).abs().max().item(),
                 alpha_max_abs_err=(got[3] - want[3]).abs().max().item())
        print(f"  against the plain version: {r}")
        if parent is not None:
            fn = parent.graph_stage1_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            w = w1.to(dt).contiguous()
            outs = (torch.empty(b, k, n, 64, dtype=dt, device="cuda"),
                    torch.empty(b, k, n, 6, dtype=dt, device="cuda"),
                    torch.empty(b, n, k, dtype=torch.int32, device="cuda"),
                    torch.empty(b, n, pk, dtype=torch.float32, device="cuda"))

            def run_parent(fn=fn, w=w, outs=outs, dt=dt):
                z1, e, idx, alpha = outs
                code = fn(ptr(x), ptr(w), ptr(idx), ptr(alpha), ptr(z1), ptr(e),
                          b, n, k, pk, int(dt == torch.bfloat16), None)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
                return outs
            p = run_parent()
            r["parent"] = _timed(f"  the parent's kernel {key}", run_parent)
            r["bit_equal_to_parent"] = {
                name: torch.equal(a, c) for name, a, c in
                zip(("z1", "e", "idx", "alpha"), got, p)}
            print(f"  bit-equal to the parent's outputs: {r['bit_equal_to_parent']}")
        # the edge pass with one and four rows a thread a step (EU), and at
        # 2 and 4 blocks an SM: its device time
        r["edge_variants"] = {}
        w = w1.to(dt).contiguous()
        outs = (torch.empty(b, k, n, 64, dtype=dt, device="cuda"),
                torch.empty(b, k, n, 6, dtype=dt, device="cuda"),
                torch.empty(b, n, k, dtype=torch.int32, device="cuda"),
                torch.empty(b, n, pk, dtype=torch.float32, device="cuda"))
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for label, lib, blocks in (
                ("EU 1", edge_eu[1], 3 * sms), ("EU 4", edge_eu[4], 3 * sms),
                ("2 blocks an SM", dispatch.load_kernel("graph_stage1"), 2 * sms),
                ("4 blocks an SM", dispatch.load_kernel("graph_stage1"), 4 * sms)):
            fn = lib.graph_stage1_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

            def run_variant(fn=fn, blocks=blocks, dt=dt):
                z1, e, idx, alpha = outs
                code = fn(ptr(x), ptr(w), ptr(idx), ptr(alpha), ptr(z1), ptr(e),
                          b, n, k, pk, int(dt == torch.bfloat16), blocks, None)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
                return outs
            same = all(torch.equal(a, c) for a, c in zip(run_variant(), got))
            edge = sum(v for name, v in _profile_groups(run_variant, 20).items()
                       if "edge_stage1" in name)
            r["edge_variants"][label] = {"edge_ms": edge, "bit_equal": same}
            print(f"  edge pass {label}: {edge:.4f} ms on the device, bit-equal {same}")
        result[key] = r
    # the selection the DGCNN eval kernel and the angle kernel share with it
    x48 = torch.tensor((rs.randn(2 * b, n, 3) * 0.3).astype(np.float32), device="cuda")
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, 512)]
    ws = [torch.tensor((rs.randn(*d) / np.sqrt(d[0])).astype(np.float32), device="cuda")
          for d in dims]
    aff = [(torch.ones(d[1], device="cuda"), torch.zeros(d[1], device="cuda"))
           for d in dims]
    result["dgcnn_eval (48, 717, k=20) bf16"] = _timed(
        "dgcnn_eval (48, 717, k=20, emb 512) bf16",
        lambda: dgcnn_eval(x48, ws, aff, k, torch.bfloat16, pk), 10)
    result["posenc_angles (24, 717, k=5)"] = _timed(
        "posenc_angles (24, 717, k=5)", lambda: cuda_posenc.posenc_angles(x, pk), 50)
    return result


NN1_SHAPES = ((24, 512, 717), (24, 128, 717), (24, 717, 717), (24, 1433, 1433))
# shapes whose queries leave SMs without a block: the C.1 check's clustering
# at B = 4, a request of one cloud
NN1_FEW_QUERIES = ((4, 16, 2048), (1, 128, 717), (1, 717, 717))
# the (lanes, queries a thread) pairs csrc/nn1.cu compiles (NN1_PLANS)
NN1_COMPILED = ((4, 2), (8, 2), (16, 2), (16, 1))


def probe_nn1(args):
    import ctypes
    from ogmm_tpu_torch.ops import cuda_knn
    rs = np.random.RandomState(9)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    parent = _parent_lib(args, "nn1")
    result = {}
    for b, nq, m in NN1_SHAPES + NN1_FEW_QUERIES:
        tgt = torch.tensor((rs.randn(b, m, 3) * 0.3).astype(np.float32), device="cuda")
        src = torch.tensor((rs.randn(b, nq, 3) * 0.3).astype(np.float32), device="cuda")
        src[:, 0] = tgt[:, 3]                 # an exact hit: the clamp
        got = cuda_knn.nn1(src, tgt)
        want = cuda_knn.nn1_reference(src, tgt)
        key = f"({b}, {nq}, {m})"
        r = _timed(f"nn1 {key}", lambda: cuda_knn.nn1(src, tgt), 50)
        r["bit_equal_to_plain"] = all(torch.equal(a, c) for a, c in zip(got, want))
        if hasattr(cuda_knn, "nn1_plan"):
            r["plan"] = cuda_knn.nn1_plan(b, nq, torch.cuda.get_device_properties(
                0).multi_processor_count)._asdict()
            r["plans"] = {}
            print(f"  the wrapper's plan: {r['plan']}; every compiled plan:")
            for lanes, rows in NN1_COMPILED:
                plan = cuda_knn.nn1_plan_with(b, nq, lanes, rows)
                run = lambda plan=plan: cuda_knn._nn1_cuda(src, tgt, plan)
                same = all(torch.equal(a, c) for a, c in zip(run(), want))
                label = f"lanes {lanes}, rows {rows}"
                r["plans"][label] = p = {
                    "ms": _cuda_ms(run, 50), "identical": same,
                    "device_ms": sum(_profile_groups(run, 50).values())}
                print(f"    {label}: {p['device_ms']:.4f} ms on the device, "
                      f"{p['ms']:.4f} between calls, bit-equal to plain {same}")
        if parent is not None:
            fn = parent.nn1_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            d = torch.empty(b, nq, device="cuda")
            i = torch.empty(b, nq, dtype=torch.int64, device="cuda")

            def run_parent(fn=fn, d=d, i=i, src=src, tgt=tgt, b=b, nq=nq, m=m):
                code = fn(ptr(src), ptr(tgt), ptr(d), ptr(i), b, nq, m, None)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
                return d, i
            p = run_parent()
            r["parent"] = _timed(f"  the parent's kernel {key}", run_parent, 50)
            r["bit_equal_to_parent"] = all(torch.equal(a, c) for a, c in zip(got, p))
        print(f"  {key}: bit-equal to the plain version {r['bit_equal_to_plain']}"
              + (f", to the parent {r['bit_equal_to_parent']}" if parent else ""))
        result[key] = r
    return result


def _stats(z):
    """Batch statistics of z over every axis but the last, float32."""
    zf = z.float()
    return zf.mean((0, 1, 2)), zf.var((0, 1, 2), unbiased=False)


def probe_bwd_reduce(args):
    import ctypes
    from ogmm_tpu_torch.ops import cuda_dgcnn_bwd as bwd
    rs = np.random.RandomState(10)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    parent = _parent_lib(args, "dgcnn_bwd")
    b, k, n = 24, 20, 717
    result = {}
    for dt, c in ((torch.bfloat16, 256), (torch.float32, 256),
                  (torch.bfloat16, 128), (torch.bfloat16, 64)):
        g = lambda *s, scale=1.0: torch.tensor(
            (rs.randn(*s) * scale).astype(np.float32), device="cuda")
        z = g(b, k, n, c).to(dt)
        z[:, 3] = z[:, 1]                     # tied maxima over k
        mean, var = _stats(z)
        gamma = torch.tensor(rs.uniform(0.5, 1.5, c).astype(np.float32), device="cuda")
        beta = g(c, scale=0.1)
        dtap = g(b, n, c, scale=0.1).to(dt)
        ins = (z, dtap, mean, var, gamma, beta)
        key = f"({b}, {k}, {n}, {c}) {'bf16' if dt == torch.bfloat16 else 'float32'}"
        got, again = bwd.bwd_reduce(*ins), bwd.bwd_reduce(*ins)
        want = bwd.bwd_reduce_reference(*ins)
        r = _timed(f"bwd_reduce {key}", lambda: bwd.bwd_reduce(*ins), 50)
        r.update(max_abs_err=(got - want).abs().max().item(),
                 max_abs_plain=want.abs().max().item(),
                 relaunch_bit_equal=torch.equal(got, again))
        print(f"  against the plain version: max abs err {r['max_abs_err']:.3g} "
              f"(max |plain| {r['max_abs_plain']:.3g}), relaunch bit-equal "
              f"{r['relaunch_bit_equal']}")
        if parent is not None:
            fn = parent.bwd_reduce_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
            part = torch.empty(parent.dgcnn_bwd_row_blocks(b, n), 2, c, device="cuda")
            s = torch.empty(2, c, device="cuda")

            def run_parent(fn=fn, part=part, s=s, dt=dt, c=c):
                bn = bwd._bn_pack(mean, var, gamma, beta, dt)
                code = fn(ptr(z), ptr(dtap), ptr(bn), ptr(part), ptr(s), b, n, c,
                          int(dt == torch.bfloat16), None)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
                return s
            p = run_parent().clone()
            r["parent"] = _timed(f"  the parent's kernel {key}", run_parent, 50)
            r["parent_max_abs_err"] = (p - want).abs().max().item()
            r["max_abs_diff_to_parent"] = (got - p).abs().max().item()
            print(f"  the parent against the plain version {r['parent_max_abs_err']:.3g}, "
                  f"against this tree {r['max_abs_diff_to_parent']:.3g}")
        result[key] = r
    return result


# fps_combined's 2B rows of 717 (the N=717 request), the indoor request's
# 4 rows of 35,000 at its km_clusters steps and at 128
FPS_SHAPES = ((48, 717, 128), (2, 35000, 16), (2, 35000, 128))


def probe_fps(args):
    import ctypes
    from ogmm_tpu_torch.ops import cuda_fps
    from ogmm_tpu_torch.ops.fps import _center_state
    rs = np.random.RandomState(11)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    parent = _parent_lib(args, "fps")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {}
    for b, n, steps in FPS_SHAPES:
        x = torch.tensor((rs.randn(b, n, 3) * 0.3).astype(np.float32), device="cuda")
        x[:, n // 2] = x[:, 1]                # a duplicated point: exact ties
        d_c, s_c = _center_state(x)
        start = torch.tensor(rs.randint(0, n, b), device="cuda")
        xs = torch.cat([x, x])
        dist = torch.cat([torch.full_like(d_c, 1e10), d_c])
        st = torch.cat([start, s_c])
        rows = 2 * b
        want = cuda_fps.fps_reference(xs, steps, dist, st)
        key = f"({rows}, {n}, {steps})"
        run = lambda: cuda_fps.fps(xs, steps, dist, st)
        r = _timed(f"fps {key}", run, 50)
        r["ids_identical"] = torch.equal(run(), want)
        if hasattr(cuda_fps, "fps_plan"):
            r["plan"] = cuda_fps.fps_plan(rows, n, sms)._asdict()
            r["plans"] = {}
            print(f"  the wrapper's plan: {r['plan']}; every compiled plan:")
            for plan in cuda_fps.compiled_plans(rows, n, sms):
                forced = lambda plan=plan: cuda_fps._fps_cuda(xs, steps, dist, st, plan)
                same = torch.equal(forced(), want)
                label = (f"{plan.route}, cluster {plan.cluster}, threads "
                         f"{plan.threads}, P {plan.points}")
                r["plans"][label] = p = {
                    "ms": _cuda_ms(forced, 50), "identical": same,
                    "device_ms": sum(_profile_groups(forced, 50).values())}
                print(f"    {label}: {p['device_ms']:.4f} ms on the device, "
                      f"{p['ms']:.4f} between calls, ids identical {same}")
        if parent is not None:
            fn = parent.fps_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            ids = torch.empty(rows, steps, dtype=torch.int64, device="cuda")

            def run_parent(fn=fn, ids=ids, rows=rows, n=n, steps=steps):
                d = dist.clone()
                code = fn(ptr(xs), ptr(d), ptr(st), ptr(ids), rows, n, steps, None)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
                return ids
            r["parent"] = _timed(f"  the parent's kernel {key}", run_parent, 50)
            r["parent_ids_identical"] = torch.equal(run_parent(), want)
        print(f"  {key}: ids identical to the plain loop {r['ids_identical']}"
              + (f", the parent's {r['parent_ids_identical']}" if parent else ""))
        result[key] = r
    return result


def probe_posenc_angles(args):
    import ctypes
    from ogmm_tpu_torch.ops import cuda_knn, cuda_posenc
    rs = np.random.RandomState(12)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    parent = _parent_lib(args, "posenc_angles")
    b, n, k = 24, 717, 5
    x = torch.tensor((rs.randn(b, n, 3) * 0.3).astype(np.float32), device="cuda")
    x[:, n // 2] = x[:, 1]                    # a duplicated point: exact ties
    want = cuda_posenc.posenc_angles_reference(x, k)
    want_idx = cuda_knn.knn_reference(x, x, k)
    key = f"({b}, {n}, k={k})"
    r = {}
    idx = torch.empty(b, n, k, dtype=torch.int32, device="cuda")
    got = cuda_posenc._posenc_angles_cuda(x, k, idx=idx)
    r.update(indices_identical=torch.equal(idx.long(), want_idx),
             max_abs_err=(got - want).abs().max().item())
    print(f"posenc_angles {key} against the plain version: indices identical "
          f"{r['indices_identical']}, max abs err {r['max_abs_err']:.3g}")
    # the wrapper's call, the variants and the parent, timed in turns
    runs = {"this tree": lambda: cuda_posenc.posenc_angles(x, k)}
    r["plan"] = cuda_posenc.posenc_plan(b, n, k)._asdict()
    print(f"  the wrapper's plan: {r['plan']}")
    source = os.path.join(CSRC, "posenc_angles.cu")
    text = open(source).read()
    ks = cuda_posenc.posenc_plan(b, n, k)
    for label, edits in POSENC_VARIANTS:
        if not all(old in text for old, _ in edits):
            continue
        lib = _variant(source, edits, "posenc_" + re.sub(r"\W+", "_", label), args.out)
        fn = lib.posenc_angles_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        alpha = torch.empty(b, n, k, device="cuda")

        def run_variant(fn=fn, alpha=alpha):
            code = fn(ptr(x), ptr(alpha), None, b, n, k, ks.K, ks.lanes, None)
            if code:
                raise RuntimeError(f"launch failed: {code}")
            return alpha
        runs[label] = run_variant
    if parent is not None:
        fn = parent.posenc_angles_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        alpha = torch.empty(b, n, k, device="cuda")

        def run_parent(fn=fn, alpha=alpha):
            centroid = x.mean(dim=1, keepdim=True)
            code = fn(ptr(x), ptr(centroid), ptr(alpha), None, b, n, k,
                      cuda_knn.knn_compiled_k(k), None)
            if code:
                raise RuntimeError(f"launch failed: {code}")
            return alpha
        r["parent_max_abs_err"] = (run_parent() - want).abs().max().item()
        runs["parent"] = run_parent
    for label, res in _interleaved(runs, reps=50).items():
        r.setdefault(label, {}).update(res)
    return {key: r}


# builds of csrc/posenc_angles.cu with a line changed, to say where the lanes
# kernel's time goes (their outputs are not all the function's): the cloud
# staged and the centroid summed, nothing else; the first pass alone; the
# second pass without its buffer; the points at or below the threshold
# inserted as they come (a source without the line is skipped)
POSENC_VARIANTS = (
    ("the cloud staged, nothing else",
     [("  __syncthreads();\n  const float4 qp", "  __syncthreads();\n  if (kout > 0) return;\n  const float4 qp")]),
    ("the first pass alone",
     [("  const float thr = valid ? fmaxf(t, 1e-12f) : -CUDART_INF_F;   // past N: none",
       "  const float thr = valid ? fmaxf(t, 1e-12f) : -CUDART_INF_F;\n"
       "  if (thr < -1.f) alpha[0] = t;\n  if (kout > 0) return;")]),
    ("no buffer", [("      if (cnt < PCAP) buf[cnt * PT] = m;\n      ++cnt;",
                    "      cnt += m >> 30;")]),
    ("the points at or below T inserted at once",
     [("      if (cnt < PCAP) buf[cnt * PT] = m;\n      ++cnt;",
       "      insert<K>(kd, ki, dist_fma(qx, qy, qz, qq, tp[m]), m);")]))


# builds of csrc/dgcnn_eval.cu with a line changed: the float32 stage kernel
# at two 8-row tiles at a time in stage 4 (a source without the line is
# skipped)
DGCNN_VARIANTS = (("float32, stage 4 two row tiles at a time",
                   [("#define TPI4 4 ", "#define TPI4 2 ")]),)


# the card's rate of mma.sync m16n8k8 TF32 alone: each warp issues 8
# independent chains of products, nothing else (what the float32 stage
# chain and head could reach at most with this instruction)
MMA_RATE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void mma_rate_kernel(float* out, int iters) {
  const uint32_t a0 = 0x3f800000u + (threadIdx.x << 13), b0 = 0x3f000000u + (threadIdx.x << 14);
  uint32_t a[4] = {a0, a0 ^ 0x2000u, a0 ^ 0x4000u, a0 ^ 0x6000u};
  float acc[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
                   "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
                   : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b0 ^ 0x2000u));
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_rate_launch(float* out, int blocks, int threads, int iters) {
  mma_rate_kernel<<<blocks, threads>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def probe_mma_rate(out_dir):
    """TFLOP/s of mma.sync m16n8k8 TF32 alone at 8, 16 and 32 warps an SM."""
    import ctypes
    from ogmm_tpu_torch.ops import dispatch
    os.makedirs(out_dir, exist_ok=True)
    cu, so = os.path.join(out_dir, "mma_rate.cu"), os.path.join(out_dir, "mma_rate.so")
    with open(cu, "w") as f:
        f.write(MMA_RATE)
    subprocess.run([dispatch._nvcc(), *dispatch.NVCC_FLAGS, "-o", so, cu], check=True)
    fn = ctypes.CDLL(so).mma_rate_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out, iters, res = torch.empty(sms * 4 * 256, device="cuda"), 4096, {}
    for per_sm in (1, 2, 4):
        blocks = sms * per_sm
        ms = _cuda_ms(lambda: fn(out.data_ptr(), blocks, 256, iters), 5)
        flops = blocks * 8 * iters * 8 * 2.0 * 16 * 8 * 8
        res[f"{8 * per_sm} warps an SM"] = {"ms": ms, "tflops": flops / ms / 1e9}
    print(f"mma.sync m16n8k8 tf32 alone: {res}")
    return res


def probe_dgcnn_eval(args):
    import ctypes
    from ogmm_tpu_torch.ops import cuda_dgcnn
    rs = np.random.RandomState(13)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())
    dt = torch.float32 if args.dtype == "float32" else torch.bfloat16
    b, n, k, emb, pk = 48, 717, 20, 512, 5
    x = torch.tensor((rs.randn(b, n, 3) * 0.3).astype(np.float32), device="cuda")
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]
    ws = [torch.tensor((rs.randn(*d) / np.sqrt(d[0])).astype(np.float32), device="cuda")
          for d in dims]
    aff = [(torch.tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32), device="cuda"),
            torch.tensor((rs.randn(d[1]) * 0.1).astype(np.float32), device="cuda"))
           for d in dims]
    want, want_alpha = cuda_dgcnn.dgcnn_eval_reference(x, ws, aff, k, dt, pk)
    key = f"({b}, {n}, k={k}, emb {emb}) {args.dtype}"
    run = lambda: cuda_dgcnn.dgcnn_eval(x, ws, aff, k, dt, pk)
    r = _timed(f"dgcnn_eval {key}", run, 10)
    out, alpha = run()
    r.update(max_abs_err=(out.float() - want.float()).abs().max().item(),
             alpha_max_abs_err=(alpha - want_alpha).abs().max().item(),
             max_abs_plain=want.float().abs().max().item())
    print(f"  against the plain version: {r['max_abs_err']:.3g} (max |plain| "
          f"{r['max_abs_plain']:.3g}), alpha {r['alpha_max_abs_err']:.3g}")
    ops = cuda_dgcnn._kernel_operands("dgcnn_eval", ws, aff, k, dt)

    def launcher(lib, label):
        fn = lib.dgcnn_eval_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        idx = torch.empty(b, n, k, dtype=torch.int32, device="cuda")
        al = torch.empty(b, n, pk, device="cuda")
        cat = torch.empty(b * n, 512, dtype=dt, device="cuda")
        o = torch.empty(b, n, emb, dtype=dt, device="cuda")

        def go():
            code = fn(ptr(x), *[ptr(t) for group in ops for t in group], ptr(idx),
                      ptr(al), ptr(cat), ptr(o), b, n, emb, k, pk,
                      int(dt == torch.bfloat16), None)
            if code:
                raise RuntimeError(f"{label}: launch failed: {code}")
            return o
        got = go()
        r[label] = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
                    "bit_equal_to_this_tree": torch.equal(got, out)}
        print(f"  {label}: against the plain version {r[label]['max_abs_err']:.3g}, "
              f"bit-equal to this tree's kernel {r[label]['bit_equal_to_this_tree']}")
        return go
    # this tree's call, the variants and the parent, timed in turns
    runs = {"this tree": run}
    source = os.path.join(CSRC, "dgcnn_eval.cu")
    text = open(source).read()
    for label, edits in DGCNN_VARIANTS:
        if dt == torch.float32 and all(old in text for old, _ in edits):
            name = "dgcnn_eval_" + re.sub(r"\W+", "_", label)
            runs[label] = launcher(_variant(source, edits, name, args.out), label)
    parent = _parent_lib(args, "dgcnn_eval")
    if parent is not None:
        runs["parent"] = launcher(parent, "parent")
    for label, res in _interleaved(runs).items():
        r.setdefault(label, {}).update(res)
    if dt == torch.float32:
        r["mma_rate"] = probe_mma_rate(args.out)
    return {key: r}


# variants of csrc/wproject.cu's float32 kernel (not shipped, never on a
# path): the key tiles in plain order (every rotation 0: the blocks spread
# over all of k at once); the A fragments split before the waits; and, for
# timing only (their results are wrong), the producer's split skipped (the
# planes hold what they held), q not loaded (ones), both, and one TF32
# product a k8 step instead of three
_WP_LOOP = "      for (int w = pt; w < 2 * FK; w += 128) {"
_WP_LOAD = """      const float4 x = r != nullptr
          ? __ldg(reinterpret_cast<const float4*>(r + f0 + 8 * t) + u)
          : make_float4(0.f, 0.f, 0.f, 0.f);"""
_WP_ONES = """      const float4 x = r != nullptr ? make_float4(1.f, 1.f, 1.f, 1.f)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);"""
_WP_NOTE = """        // the A fragments, split right before the fence: no divergent path
        // (the waits' spin loops) between their writes and the products;
        // a[i] of step st is row g + 8 (i & 1), feature 8 t + 2 st + (i >> 1)
"""
_WP_SPLIT = """#pragma unroll
        for (int st = 0; st < 4; ++st)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float x = qr[8 * (i & 1) + 2 * st + (i >> 1)];
            qh[st][i] = tf32(x);
            ql[st][i] = tf32(__fsub_rn(x, __uint_as_float(qh[st][i])));
          }
"""
_WP_WAITS = """        mbar_wait(&kfull[s], sph);
        turn_wait(cw);
"""
WPROJECT_VARIANTS = [
    ("key tiles in plain order",
     [("  const long long i = block_of((long long)tile * n_kt + n_kt - 1, T, G);\n"
       "  return (int)((n_kt - share_start(i, T, G) % n_kt) % n_kt);",
       "  return 0;")]),
    ("A fragments split before the waits",
     [(_WP_WAITS + _WP_NOTE + _WP_SPLIT, _WP_SPLIT + _WP_WAITS)]),
    ("no split (timing only)", [(_WP_LOOP, _WP_LOOP.replace("2 * FK", "0"))]),
    ("no q loads (timing only)", [(_WP_LOAD, _WP_ONES)]),
    ("k by TMA alone (timing only)",
     [(_WP_LOAD, _WP_ONES), (_WP_LOOP, _WP_LOOP.replace("2 * FK", "0"))]),
    ("one product a step (timing only)",
     [("          wgmma_rs_n256_tf32(acc, qh[st], desc_k(lo + st * 32), 1);\n", ""),
      ("          wgmma_rs_n256_tf32(acc, qh[st], desc_k(hi + st * 32), 1);\n", "")])]


def probe_wproject(args):
    """The projection at the indoor head's call (1, 35000, 35000, D=512),
    float32 and bf16, on l2-normalised noisy copies (chip_smoke.py's
    features): ms between CUDA events and device ms of each __global__,
    out and lse against the plain version, a relaunch bit-equal, the
    plain version's and scaled_dot_product_attention's (MATH) times; for
    float32 the variants of WPROJECT_VARIANTS and, with --parent, that
    tree's kernel, all timed in turns; ptxas's report of each build."""
    import ctypes
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from ogmm_tpu_torch.ops import cuda_stream, dispatch, stream
    ptr = lambda t: ctypes.c_void_p(None if t is None else t.data_ptr())
    rs = np.random.RandomState(17)
    n, d = 35000, 512
    dispatch.build_kernels(("wproject",), verbose=True)
    base = torch.tensor(rs.randn(1, n, d).astype(np.float32), device="cuda")
    q32 = base + 0.3 * torch.randn_like(base)
    k32 = base[:, torch.randperm(n, device="cuda")] + 0.3 * torch.randn_like(base)
    q32, k32 = (a / a.norm(dim=-1, keepdim=True) for a in (q32, k32))
    v = torch.tensor(rs.randn(1, n, 1).astype(np.float32), device="cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k = q32.to(dt), k32.to(dt)
        key = f"(1, {n}, {n}, D={d}) {dt}"
        run = lambda q=q, k=k: cuda_stream.wproject_stream_lse(q, k, v)
        out, lse = run()
        ro, rl = stream.wproject_stream_lse_plain(q, k, v)
        again = run()
        r = {"max_abs_err_out": (out - ro).abs().max().item(),
             "max_abs_err_lse": (lse - rl).abs().max().item(),
             "relaunch_bit_equal": torch.equal(out, again[0]) and torch.equal(lse, again[1])}
        print(f"wproject {key}: against the plain version out "
              f"{r['max_abs_err_out']:.3g}, lse {r['max_abs_err_lse']:.3g}; a "
              f"relaunch bit-equal {r['relaunch_bit_equal']}")
        bf16 = dt == torch.bfloat16
        blocks, slots = cuda_stream.wproject_plan(1, n, n, sms, cuda_stream.wproject_keys(dt))
        part = torch.empty(blocks * slots * 3 * cuda_stream.WPROJECT_ROWS, device="cuda")

        def launcher(lib, label, q=q, k=k, bf16=bf16, blocks=blocks, slots=slots,
                     part=part, out=out, ro=ro):
            fn = lib.wproject_launch
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            o, l = torch.empty_like(out), torch.empty_like(out)

            def go():
                code = fn(ptr(q), ptr(k), ptr(v), ptr(o), ptr(l), ptr(part), 1, n, n,
                          d, int(bf16), blocks, slots, None)
                if code:
                    raise RuntimeError(f"{label}: launch failed: {code}")
                return o
            go()
            torch.cuda.synchronize()
            r[label] = {"max_abs_err_out": (o - ro).abs().max().item(),
                        "bit_equal_to_this_tree": torch.equal(o, out)}
            print(f"  {label}: against the plain version {r[label]['max_abs_err_out']:.3g}, "
                  f"bit-equal to this tree's kernel {r[label]['bit_equal_to_this_tree']}")
            return go
        runs = {"this tree": run}
        source = os.path.join(CSRC, "wproject.cu")
        if not bf16:
            for label, edits in WPROJECT_VARIANTS:
                name = "wproject_" + re.sub(r"\W+", "_", label)
                runs[label] = launcher(_variant(source, edits, name, args.out, True), label)
        parent = _parent_lib(args, "wproject")
        if parent is not None:
            runs["parent"] = launcher(parent, "parent")
        for label, res_ in _interleaved(runs).items():
            r.setdefault(label, {}).update(res_)
        r["plain_ms"] = _cuda_ms(lambda q=q, k=k: stream.wproject_stream_lse_plain(q, k, v), 2)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sargs = (q.unsqueeze(1), k.unsqueeze(1), v.to(dt).unsqueeze(1))
        with sdpa_kernel([SDPBackend.MATH]), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            r["sdpa_math_ms"] = _cuda_ms(lambda: sdpa(*sargs, scale=1.0), 2)
        torch.cuda.empty_cache()
        flops = 2.0 * n * n * d * (1 if bf16 else 3)
        r["tensor_tflops"] = flops / r["this tree"]["ms"] / 1e9
        print(f"  plain {r['plain_ms']:.3f} ms, scaled_dot_product_attention (MATH) "
              f"{r['sdpa_math_ms']:.3f} ms; this tree {r['tensor_tflops']:.1f} TFLOP/s "
              f"of {'bf16' if bf16 else 'TF32 (three products)'} products")
        res[key] = r
    return res


PROBES = {"knn_stream": probe_knn_stream, "icp": probe_icp,
          "bwd_edge": probe_bwd_edge, "knn": probe_knn,
          "graph_stage1": probe_graph_stage1, "nn1": probe_nn1,
          "bwd_reduce": probe_bwd_reduce, "fps": probe_fps,
          "posenc_angles": probe_posenc_angles, "dgcnn_eval": probe_dgcnn_eval,
          "wproject": probe_wproject}


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
    ap.add_argument("--preset", choices=["mnet", "serve", "indoor"], default="mnet")
    ap.add_argument("--refine", choices=["plane", "grid"], default=None,
                    help="refine the returned pose point-to-plane or through "
                         "the grid 1-NN (see above)")
    ap.add_argument("--model", choices=["GMMReg", "DeepGMR"], default="GMMReg",
                    help="DeepGMR: the modelnetdv geometry, N against 2N "
                         "points (default N=768), float32 body")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16",
                    help="the network body's type (float32 is configs.mnet()'s "
                         "default; bfloat16 keeps earlier profiles comparable)")
    ap.add_argument("--loop_kernels", action="store_true",
                    help="FPS, ICP and the attention MLPs through their kernels")
    ap.add_argument("--fused_edges", action="store_true",
                    help="dgcnn_fused_edges=True: the DGCNN stage chain of the "
                         "indoor request through the edges kernel")
    ap.add_argument("--gnn_k", type=int, default=None,
                    help="the DGCNN's neighbours (default: the preset's)")
    ap.add_argument("--batch", type=int, default=2,
                    help="with --preset indoor --train: pairs a step")
    ap.add_argument("--fit", action="store_true",
                    help="with --preset indoor --train: one step at B = 1..8, "
                         "its peak memory, up to the first that does not fit")
    ap.add_argument("--probe", choices=tuple(PROBES), default=None,
                    help="time the kernel beside variants of it (see above)")
    ap.add_argument("--parent", default=None,
                    help="with --probe knn_stream, knn, graph_stage1, nn1, "
                         "bwd_reduce, fps, posenc_angles, dgcnn_eval or "
                         "wproject: a tree of the commit with the kernel's "
                         "earlier design")
    args = ap.parse_args()
    if args.probe:
        if not torch.cuda.is_available():
            sys.exit("needs a CUDA device")
        result = {"probe": args.probe, "result": PROBES[args.probe](args),
                  "card": _card()}
        print(json.dumps(result))
        return
    indoor = args.preset == "indoor"
    dgmr = args.model == "DeepGMR"
    N = args.n_points or (35000 if indoor else 768 if dgmr else 717)
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    if dgmr and (indoor or args.bwd_kernels or args.fused_edges):
        sys.exit("--model DeepGMR profiles the ModelNet geometry; "
                 "--preset indoor, --bwd_kernels and --fused_edges do not apply")
    if args.loop_kernels and args.train:
        sys.exit("--loop_kernels switches the serving path; profile it without "
                 "--train")
    if args.fit and not (indoor and args.train):
        sys.exit("--fit needs --preset indoor --train")
    if args.refine and (args.train or dgmr):
        sys.exit("--refine refines a GMMReg request; profile it without "
                 "--train and --model DeepGMR")
    rs = np.random.RandomState(0)
    if indoor and args.train:
        return indoor_train(args, N, rs)
    if indoor:
        cfg = configs.indoor()
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=args.dtype))
        src, tgt = indoor_pair(rs, N)
    elif dgmr:
        cfg = configs.mnet(model_name="DeepGMR")
        src = (rs.randn(B, N, 3) * 0.3).astype(np.float32)
        tgt = np.concatenate([src + 0.05, rs.randn(B, N, 3) * 0.3], axis=1)
        tgt = tgt[:, rs.permutation(2 * N)].astype(np.float32)
    else:
        cfg = (configs.serve() if args.preset == "serve" else configs.mnet())
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, dtype=args.dtype))
        src = (rs.randn(B, N, 3) * 0.3).astype(np.float32)
        tgt = src[:, rs.permutation(N)] + 0.05
    if args.fused_edges:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    dgcnn_fused_edges=True))
    if args.gnn_k:
        cfg = cfg.replace(model=dataclasses.replace(cfg.model, gnn_k=args.gnn_k))
    result = {"shape": {"B": src.shape[0], "N": N, "M": tgt.shape[1]},
              "preset": args.preset, "model": args.model,
              "dtype": "float32" if dgmr else args.dtype,
              "bwd_kernels": args.bwd_kernels, "loop_kernels": args.loop_kernels,
              "fused_edges": args.fused_edges, "gnn_k": cfg.model.gnn_k}
    if args.train:
        from ogmm_tpu_torch.ops import dgcnn_train
        from ogmm_tpu_torch.train import create_train_state, make_train_step
        dgcnn_train.BWD_KERNELS = args.bwd_kernels
        # DeepGMR's loss reads no overlap labels
        cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                    device_overlap=not dgmr))
        state = create_train_state(cfg, steps_per_epoch=100, seed=0)
        gt = np.tile(np.eye(3, 4, dtype=np.float32), (B, 1, 1))
        gt[:, :, 3] = 0.05
        ones = np.ones((B, N), np.float32)
        batch = {"src_xyz": src, "tgt_xyz": tgt if dgmr else src + 0.05,
                 "src_overlap": ones, "tgt_overlap": np.ones(tgt.shape[:2], np.float32),
                 "transform_gt": gt}
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
        if args.refine:
            refine_with = refiner(args.refine, reg, src, tgt)
            key = f"forward_{args.refine}"
            result[key] = r = profile_call(
                lambda: refine_with(*reg(src, tgt, refine=False)[:2]))
            report(key, r)
            pose = reg(src, tgt, refine=False)[:2]
            key = f"{args.refine}_alone"
            result[key] = r = profile_call(lambda: refine_with(*pose))
            report(key, r)
            result["grid_cap"] = getattr(refine_with, "cap", None)
        result["stages_ms"] = stage_times(reg, src, tgt)
        print("stages (CUDA events, one request with ICP):")
    for k, v in sorted(result["stages_ms"].items(), key=lambda kv: -kv[1]):
        print(f"    {v:8.3f} ms  {k}")
    result["card"] = _card()
    os.makedirs(args.out, exist_ok=True)
    name = ("torch_port_profile" if not args.train
            else "torch_port_profile_train_bwd_kernels" if args.bwd_kernels
            else "torch_port_profile_train")
    name += "_indoor" if indoor else ""
    name += "_deepgmr" if dgmr else ""
    name += "_loop_kernels" if args.loop_kernels else ""
    name += "_fused_edges" if args.fused_edges else ""
    name += "_serve" if args.preset == "serve" else ""
    name += f"_refine_{args.refine}" if args.refine else ""
    name += f"_k{args.gnn_k}" if args.gnn_k else ""
    name += "" if N == (35000 if indoor else 768 if dgmr else 717) else f"_n{N}"
    name += "_f32" if args.dtype == "float32" and not dgmr else ""
    name += ".json"
    with open(os.path.join(args.out, name), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
