#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device and `nvcc`; exits non-zero without them. Phases, each
fatal on failure:

  1. build   every CUDA kernel of `ogmm_tpu_torch/csrc` (parallel `nvcc`)
  2. kernels each kernel's wrapper against its plain PyTorch version on the
             card, at the shapes the main paths give it (serving: 2B=48
             clouds of 717 points, emb 512, K=128; training: B=24 clouds of
             717 points, 1-NN queries of 512, 128 and 717 points, and the
             five DGCNN backward calls of a real backward in float32 and
             bf16, each launched twice and compared bit for bit), with the
             limits stated below, and timed beside its plain version and its
             bound; dgcnn_eval's selection launch and its stage chain
             with the head timed apart (torch.profiler), sinkhorn_em's time
             a pass and the clouds the card runs at once
  3. serve   `Registrar` at B=24, N=717, emb 512, K=128, bf16 body, seeded
             random weights: a few requests with and without ICP; the launch
             counts of the kernels over one request; the same requests with
             the kernels swapped for their plain versions, compared on the
             overlap scores and the refined rotation
  4. train   `make_train_step` at the same shape and body with the DGCNN
             backward kernels on (`ops.dgcnn_train.BWD_KERNELS`): a warm-up
             step, one step with the launch counts, ten timed steps with the
             switch on and ten with it off (and the peak device memory of
             each); finite loss and gradients, every parameter and running
             statistic moved; one step from the same state with the switch
             on and off (loss bit-equal, gradients close), and through the
             kernels and their plain versions; one `make_eval_step` with ICP
  5. cli     `python -m ogmm_tpu_torch.train` (cli.main) on synthetic
             ModelNet at the same shape with the switch on: three steps, an
             eval batch, a checkpoint, every kernel of that path launched
  6. check   ICP on a small input recovers a known pose
  7. knn, posenc_angles   the kNN and angle kernels against their plain
             versions (identical indices; angles within 1e-5) at the shapes
             of the large-cloud and unfused paths, with ties and a cross kNN
  8. serve_large   `Registrar` at B=24, N=1433 (ModelNet40's 2048 points
             cropped to 0.70), bf16 body: the shared kNN graph, the unfused
             DGCNN, the EM kernel, ICP's 1-NN kernel at M=1433; launch
             counts, request times, kernels against plain versions
  9. train_large   `make_train_step` at B=24, N=1433: launch counts, step
             times, peak device memory, every parameter moved
 10. train_unfused the N=717 step with `dgcnn_fused_train=False`: the kNN and
             angle kernels twice a step, the loss against the plain versions
 11. c1      the shapes the port raised on before it routed by shape:
             `Registrar` at gnn_k=16 and at n_clusters=16 (N=2048), `nn1` at
             M=8192; the launch counts show each route
 12. knn_stream, nn1_stream, wproject, dgcnn_edges   the streamed kernels
             and the edges kernel against their plain versions at the indoor
             shapes (2 clouds of 35,000 points, k=20; an ICP trip at
             (1, 35000, 35000) with the cull and the gate; the clustering's
             (2, 16, 35000); the overlap head at (1, 35000, 35000, D=512)
             bf16) and at small awkward ones (N not a multiple of the tile,
             M just above 4096, k=1, coincident points, float32)
 13. indoor  `Registrar(configs.indoor(...))` at B=1, N=35,000, K=16, bf16
             body, on bench.py's synthetic surface with a rigid copy as
             target: with and without ICP, and with dgcnn_fused_edges=True;
             launches, request times, peak memory, rotation and overlap
             scores against the same request through the plain versions
 14. pointmlp, fps, icp   the fused attention MLP, the FPS chain and the
             whole-loop ICP against their plain versions at the refined
             request's calls (48 clouds of 717, 1024 -> 1024 -> 512 bf16;
             96 rows of 717, 128 steps; 24 pairs of 717, 30 trips) and at
             awkward ones (float32, N not a multiple of the tile; N = 1433
             and 35,000 with tied distances; N != M, a cloud without
             inliers, M = 4096): FPS ids and ICP's first-trip
             correspondences identical, poses and outputs within limits
 15. serve_loops   the refined N=717 request of phase 3 through a
             Registrar with `loop_kernels=True` (FPS, ICP and the three
             attention MLPs through their kernels) beside one without, on
             the same weights: launches (fps 1, pointmlp 3, icp 1), request
             times of both, peak memory, rotation and overlap scores against
             the one without and against the plain versions

`python3 chip_smoke.py --only PHASE[,PHASE...]` runs the named phases
(build always runs; the names are those of PHASES below) and prints their
results without the kernels line.

Prints the request and step times, one JSON object {"kernels": [...]} on a
line of its own, the `nvidia-smi` name and power limit, and as the last line
{"ok": true, "device": {...}}.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")

try:
    from ogmm_tpu_torch import configs
    from ogmm_tpu_torch.api import Registrar
    from ogmm_tpu_torch.core import se3
    from ogmm_tpu_torch.nn import dgcnn as nn_dgcnn
    from ogmm_tpu_torch.ops import cuda_knn, cuda_stream, dispatch, stream
    from ogmm_tpu_torch.ops import cuda_em, cuda_fps, cuda_icp, cuda_mlp
    from ogmm_tpu_torch.ops import fps as ops_fps
    from ogmm_tpu_torch.nn import gmmreg as nn_gmmreg
    from ogmm_tpu_torch.ops import dgcnn_train as ops_dgcnn_train
    from ogmm_tpu_torch.ops import gmm as ops_gmm
    from ogmm_tpu_torch.ops.common import (gather_neighbors, index_points,
                                           sq_norm3)
    from ogmm_tpu_torch.ops.cuda_dgcnn import (STAGES, dgcnn_edges,
                                               dgcnn_edges_reference,
                                               dgcnn_eval,
                                               dgcnn_eval_reference)
    from ogmm_tpu_torch.ops.cuda_dgcnn_bwd import (bwd_edge, bwd_edge_reference,
                                                  bwd_reduce,
                                                  bwd_reduce_reference,
                                                  bwd_stage,
                                                  bwd_stage_reference)
    from ogmm_tpu_torch.ops.cuda_dgcnn_train import (graph_stage1,
                                                     graph_stage1_reference)
    from ogmm_tpu_torch.ops.cuda_em import sinkhorn_em, sinkhorn_em_reference
    from ogmm_tpu_torch.ops import common as ops_common
    from ogmm_tpu_torch.ops import cuda_posenc
    from ogmm_tpu_torch.ops.cuda_knn import (knn, knn_reference, nn1,
                                             nn1_reference)
    from ogmm_tpu_torch.ops.cuda_posenc import (posenc_angles,
                                                posenc_angles_reference)
    from ogmm_tpu_torch.ops.fps import farthest_point_sample
    from ogmm_tpu_torch.ops.icp import icp_point_to_point
    from ogmm_tpu_torch.train import (create_train_state, make_eval_step,
                                      make_train_step, train_loss)
    from ogmm_tpu_torch.train import cli
except ImportError as e:
    sys.exit(f"chip_smoke: the package ogmm_tpu_torch is missing: {e}")

DEV = torch.device("cuda")
B, N, EMB, K, KNN, POS_K = 24, 717, 512, 128, 20, 5
N_LARGE = 1433           # ModelNet40's 2048-point clouds cropped to 0.70
N_INDOOR = 35000         # an indoor fragment (7-Scenes, ICL-NUIM) cropped

# published peaks of one H100 SXM
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}

# limits, kernel against plain version on the card
LIM_DGCNN_F32 = 1e-4     # same float32 arithmetic, other summation order
LIM_DGCNN_BF16 = 0.0625  # outputs up to ~8: a few bf16 ulps (2^-7 relative)
LIM_ALPHA = 1e-5         # cosines from float32 coordinates
LIM_EM_1 = 1e-4          # one EM trip: exp of arguments scaled by 1/eps = 100
LIM_EM_10_NODES = 1e-2   # ten trips drift apart chaotically: consumed
LIM_EM_10_PI = 1e-3      # outputs only, cloud extent ~1
LIM_Z1_F32 = 1e-5        # six float32 products, other summation order
LIM_Z1_BF16 = 0.0313     # one bf16 rounding of values up to ~4: one ulp
LIM_NN1_D = 0.0          # same float32 arithmetic in the same order
LIM_POSENC = 1e-5        # cosines from float32 coordinates, centroid summed
#                          in another order
LIM_WPROJECT = 1e-4      # out (|v| < 5) and lse (~10.5): float32 sums of
#                          35,000 terms and of 512 products in another order
LIM_UNFUSED_LOSS = 1e-3  # the unfused step, kNN and angle kernels against
#                          their plain versions (every other kernel the same)
# DGCNN backward kernels, as a share of max|plain| of each output
LIM_BWD_F32 = 1e-4       # same float32 arithmetic, other summation order
LIM_BWD_DZ_BF16 = 2.0 ** -6  # two bf16 ulps at the largest dz: a rounded
#                          cotangent (dz W^T) may land one ulp off
LIM_BWD_SUM_BF16 = 2e-2  # dW, S, dq, dscat: float32 sums of bf16 products
#                          over 344,160 rows in another order
LIM_MLP_F32 = 1e-4       # the fused PointMLP: float32 sums of 1024 products
#                          and moments over 717 rows in another order
LIM_MLP_BF16 = 0.0625    # outputs up to ~4: a z or h rounded one bf16 ulp
#                          apart moves out by a few ulps
LIM_ICP_POSE = 1e-4      # 30 ICP trips: the moments summed in another order
#                          (the first trip's correspondences are identical)
# limits, serving forward with kernels against the same with plain versions
LIM_OVERLAP = 0.05       # sigmoid scores after a bf16 body
LIM_ROT_DEG = 1.0        # median angle between the two refined rotations
# limits, one train step with kernels against the same with plain versions:
# the ten EM trips drift apart chaotically (as above), which moves the
# cluster features and the pose, so loss and gradients agree to a share
LIM_STEP_LOSS = 0.02     # relative difference of the loss
LIM_STEP_GRAD = 0.2      # |g_kernel - g_plain| / |g_plain| over all params
# one train step with the backward kernels on against off, from one state:
# the forward is the same, the backward rounds in other places
LIM_BWD_STEP_GRAD = 0.05


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_ms(fn, reps, groups):
    """Device ms a call of each group of the kernels that fn launches, from
    torch.profiler: {label: ms}; a group is a tuple of kernel-name parts."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {label: 0.0 for label in groups}
    for evt in prof.key_averages():
        for label, names in groups.items():
            if any(name in evt.key for name in names):
                out[label] += evt.device_time_total / 1e3 / reps
    return out


def angle_deg(a, b):
    c = (torch.einsum("bij,bij->b", a, b) - 1) / 2
    return torch.rad2deg(torch.acos(c.clamp(-1, 1)))


def make_pairs(rs, batch, n_points):
    """Clouds and rotated, shifted, permuted copies of them."""
    return rigid_copies(rs, (rs.randn(batch, n_points, 3) * 0.3).astype(np.float32))


def rigid_copies(rs, src):
    """src and rotated (up to ~30 degrees an axis), shifted, permuted copies
    of its clouds: (src, tgt, rot, trans)."""
    from math import cos, sin
    batch, n_points, _ = src.shape
    rots = []
    for _ in range(batch):
        a, b, c = rs.uniform(-0.5, 0.5, 3)
        rx = np.array([[1, 0, 0], [0, cos(a), -sin(a)], [0, sin(a), cos(a)]])
        ry = np.array([[cos(b), 0, sin(b)], [0, 1, 0], [-sin(b), 0, cos(b)]])
        rz = np.array([[cos(c), -sin(c), 0], [sin(c), cos(c), 0], [0, 0, 1]])
        rots.append(rz @ ry @ rx)
    rot = np.stack(rots).astype(np.float32)
    trans = rs.uniform(-0.3, 0.3, (batch, 3)).astype(np.float32)
    tgt = np.einsum("bij,bnj->bni", rot, src) + trans[:, None]
    tgt = tgt[:, rs.permutation(n_points)].astype(np.float32)
    return src, tgt, rot, trans


# ------------------------------------------------------------------ kernels

def check_dgcnn(rs):
    x = torch.tensor(rs.randn(2 * B, N, 3).astype(np.float32) * 0.3, device=DEV)
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, EMB)]
    ws = [torch.tensor(rs.randn(*d).astype(np.float32) / np.sqrt(d[0]),
                       device=DEV) for d in dims]
    aff = [(torch.tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32), device=DEV),
            torch.tensor(rs.randn(d[1]).astype(np.float32) * 0.1, device=DEV))
           for d in dims]
    errs = {}
    for dt, lim in ((torch.float32, LIM_DGCNN_F32), (torch.bfloat16, LIM_DGCNN_BF16)):
        out, alpha = dgcnn_eval(x, ws, aff, KNN, dt, POS_K)
        torch.cuda.synchronize()
        ref, ralpha = dgcnn_eval_reference(x, ws, aff, KNN, dt, POS_K)
        assert out.dtype == dt and out.shape == (2 * B, N, EMB)
        err = (out.float() - ref.float()).abs().max().item()
        aerr = (alpha - ralpha).abs().max().item()
        print(f"dgcnn_eval {dt}: max|kernel - plain| = {err:.3g} (limit {lim}), "
              f"alpha {aerr:.3g} (limit {LIM_ALPHA}), max|plain| = "
              f"{ref.float().abs().max().item():.3g}")
        assert torch.isfinite(out.float()).all() and err <= lim and aerr <= LIM_ALPHA
        again, _ = dgcnn_eval(x, ws, aff, KNN, dt, POS_K)
        assert torch.equal(out, again), "dgcnn_eval: two launches differ"
        errs[dt] = max(err, aerr)
    bf = torch.bfloat16
    ms = cuda_ms(lambda: dgcnn_eval(x, ws, aff, KNN, bf, POS_K), 10)
    ms32 = cuda_ms(lambda: dgcnn_eval(x, ws, aff, KNN, torch.float32, POS_K), 5)
    plain = cuda_ms(lambda: dgcnn_eval_reference(x, ws, aff, KNN, bf, POS_K), 2)
    # the selection launch and the stage chain with its head, apart
    split = launch_ms(lambda: dgcnn_eval(x, ws, aff, KNN, bf, POS_K), 10, {
        "knn_alpha_ms": ("knn_alpha_kernel",),
        "stage_chain_ms": ("dgcnn_stage_mma_kernel", "dgcnn_head_kernel")})
    print(f"dgcnn_eval bf16 (2B={2 * B}, N={N}, k={KNN}, emb {EMB}): {ms:.4f} ms; "
          f"knn_alpha_kernel {split['knn_alpha_ms']:.4f} ms, stage chain and "
          f"head {split['stage_chain_ms']:.4f} ms (device, torch.profiler)")
    rows = 2 * B * N
    stage_macs = 6 * 64 + 64 * 64 + 64 * 128 + 128 * 256
    flops_bf16 = 2.0 * rows * (KNN * stage_macs + sum(STAGES) * EMB)
    # a distance is 8 operations; each of the k selection passes compares
    # every entry of the row once
    flops_f32 = rows * N * (8.0 + KNN)
    nbytes = (x.numel() * 4 + sum(w.numel() for w in ws) * 2
              + rows * EMB * 2 + rows * POS_K * 4)
    t_ops = flops_bf16 / PEAK_FLOPS["bf16"] + flops_f32 / PEAK_FLOPS["f32"]
    t_bytes = nbytes / PEAK_BYTES
    return {
        "name": "dgcnn_eval", "route": "cuda",
        "source": "ogmm_tpu_torch/csrc/dgcnn_eval.cu",
        "replaces": "ogmm_tpu/ops/pallas_dgcnn.py:229",
        "max_abs_err": errs[bf], "max_abs_err_f32": errs[torch.float32],
        "ms": ms, "ms_f32": ms32, "plain_ms": plain, **split,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def check_em(rs):
    xyz = torch.tensor(rs.randn(2 * B, N, 3).astype(np.float32) * 0.3, device=DEV)
    o = torch.tensor(rs.rand(2 * B, N).astype(np.float32), device=DEV)
    o = o / o.sum(-1, keepdim=True)
    n0 = index_points(xyz, farthest_point_sample(xyz, K, is_center=True))
    g1, p1, m1 = sinkhorn_em(xyz, o, n0, iters=1)
    torch.cuda.synchronize()
    g2, p2, m2 = sinkhorn_em_reference(xyz, o, n0, iters=1)
    err1 = max((a - b).abs().max().item() for a, b in ((g1, g2), (p1, p2), (m1, m2)))
    print(f"sinkhorn_em 1 trip: max|kernel - plain| over gamma, pi, nodes = "
          f"{err1:.3g} (limit {LIM_EM_1})")
    assert torch.isfinite(g1).all() and err1 <= LIM_EM_1
    g1, p1, m1 = sinkhorn_em(xyz, o, n0, iters=10)
    torch.cuda.synchronize()
    g2, p2, m2 = sinkhorn_em_reference(xyz, o, n0, iters=10)
    e_nodes = (m1 - m2).abs().max().item()
    e_pi = (p1 - p2).abs().max().item()
    print(f"sinkhorn_em 10 trips: nodes {e_nodes:.3g} (limit {LIM_EM_10_NODES}), "
          f"pi {e_pi:.3g} (limit {LIM_EM_10_PI}), mean|gamma diff| "
          f"{(g1 - g2).abs().mean().item():.3g}")
    assert torch.isfinite(g1).all() and e_nodes <= LIM_EM_10_NODES and e_pi <= LIM_EM_10_PI
    again = sinkhorn_em(xyz, o, n0, iters=10)
    assert all(torch.equal(a, b) for a, b in zip((g1, p1, m1), again)), \
        "sinkhorn_em: two launches differ"
    ms = cuda_ms(lambda: sinkhorn_em(xyz, o, n0, iters=10), 10)
    plain = cuda_ms(lambda: sinkhorn_em_reference(xyz, o, n0, iters=10), 2)
    # 10 EM trips of a log-domain, 9 direct and a gamma pass each
    per_pass = ms / (10 * (10 + 1))
    # the same call on half the clouds and on one: a launch of more clouds
    # than the card holds at once (one cluster of blocks each) runs in waves
    by_clouds = {c: cuda_ms(lambda c=c: sinkhorn_em(xyz[:c], o[:c], n0[:c], iters=10), 10)
                 for c in (B, 1)}
    print(f"sinkhorn_em (2B={2 * B}, N={N}, K={K}, 10 x 10 trips): {ms:.4f} ms, "
          f"{per_pass * 1e3:.2f} us a pass; {B} clouds {by_clouds[B]:.4f} ms, one "
          f"{by_clouds[1]:.4f} ms ({ms / by_clouds[1]:.2f}x); the occupancy "
          f"calculator's clusters at once: {cuda_em.max_clusters(N, K)}")
    # operations for each entry of the (N, K) plan and EM trip: 12 for the
    # cost, 14 for the log-domain trip, 4 for each of the 9 direct trips,
    # 12 for gamma and the M-step sums
    flops = 2.0 * B * N * K * 10 * (12 + 14 + 9 * 4 + 12)      # 2B clouds
    nbytes = 2 * B * 4 * (N * 3 + N + K * 3 + N * K + K + K * 3)
    t_ops, t_bytes = flops / PEAK_FLOPS["f32"], nbytes / PEAK_BYTES
    return {
        "name": "sinkhorn_em", "route": "cuda",
        "source": "ogmm_tpu_torch/csrc/sinkhorn_em.cu",
        "replaces": "ogmm_tpu/ops/pallas_em.py:331",
        "max_abs_err": err1, "max_abs_err_nodes_10_trips": e_nodes,
        "ms": ms, "ms_per_pass": per_pass, f"ms_{B}_clouds": by_clouds[B],
        "ms_1_cloud": by_clouds[1], "plain_ms": plain,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def check_graph_stage1(rs):
    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=DEV)
    w1 = torch.tensor(rs.randn(6, 64).astype(np.float32) / np.sqrt(6), device=DEV)
    errs = {}
    for dt, lim in ((torch.float32, LIM_Z1_F32), (torch.bfloat16, LIM_Z1_BF16)):
        z1, e, idx, alpha = graph_stage1(x, w1, KNN, dt, POS_K)
        torch.cuda.synchronize()
        rz1, re, ridx, ralpha = graph_stage1_reference(x, w1, KNN, dt, POS_K)
        assert z1.shape == (B, KNN, N, 64) and z1.dtype == dt
        same_idx = torch.equal(idx, ridx)
        same_e = torch.equal(e, re)
        err = (z1.float() - rz1.float()).abs().max().item()
        aerr = (alpha - ralpha).abs().max().item()
        print(f"graph_stage1 {dt}: idx identical {same_idx}, e identical "
              f"{same_e}, max|z1 kernel - plain| = {err:.3g} (limit {lim}), "
              f"alpha {aerr:.3g} (limit {LIM_ALPHA}), max|z1| = "
              f"{rz1.float().abs().max().item():.3g}")
        assert same_idx and same_e and err <= lim and aerr <= LIM_ALPHA
        assert torch.isfinite(z1.float()).all()
        errs[dt] = max(err, aerr)
    bf = torch.bfloat16
    ms = cuda_ms(lambda: graph_stage1(x, w1, KNN, bf, POS_K), 20)
    ms32 = cuda_ms(lambda: graph_stage1(x, w1, KNN, torch.float32, POS_K), 10)
    plain = cuda_ms(lambda: graph_stage1_reference(x, w1, KNN, bf, POS_K), 2)
    rows = B * N
    flops_f32 = rows * N * (8.0 + KNN)       # distances, selection passes
    flops_bf16 = 2.0 * rows * KNN * 6 * 64   # stage-1 products
    nbytes = (x.numel() * 4 + w1.numel() * 4
              + rows * KNN * (64 + 6) * 2 + rows * KNN * 4 + rows * POS_K * 4)
    t_ops = flops_bf16 / PEAK_FLOPS["bf16"] + flops_f32 / PEAK_FLOPS["f32"]
    t_bytes = nbytes / PEAK_BYTES
    return {
        "name": "graph_stage1", "route": "cuda",
        "source": "ogmm_tpu_torch/csrc/graph_stage1.cu",
        "replaces": "ogmm_tpu/ops/pallas_dgcnn_train.py:484",
        "max_abs_err": errs[bf], "max_abs_err_f32": errs[torch.float32],
        "ms": ms, "ms_f32": ms32, "plain_ms": plain,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def check_nn1(rs):
    tgt = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=DEV)
    worst = 0.0
    for nq in (512, 128, N):                 # Welsch, clustering, metrics
        src = torch.tensor(rs.randn(B, nq, 3).astype(np.float32) * 0.3, device=DEV)
        src[:, 0] = tgt[:, 3]                # an exact hit: the clamp
        d, i = nn1(src, tgt)
        torch.cuda.synchronize()
        rd, ri = nn1_reference(src, tgt)
        err = (d - rd).abs().max().item()
        same = torch.equal(i, ri)
        print(f"nn1 ({nq} x {N}): indices identical {same}, max|d kernel - "
              f"plain| = {err:.3g} (limit {LIM_NN1_D})")
        assert same and err <= LIM_NN1_D and torch.isfinite(d).all()
        worst = max(worst, err)
    ms = cuda_ms(lambda: nn1(src, tgt), 50)
    plain = cuda_ms(lambda: nn1_reference(src, tgt), 10)
    flops = B * N * N * (8.0 + 1)            # distance and compare a pair
    nbytes = B * (N * 12 + N * 12 + N * (4 + 8))
    t_ops, t_bytes = flops / PEAK_FLOPS["f32"], nbytes / PEAK_BYTES
    return {
        "name": "nn1", "route": "cuda",
        "source": "ogmm_tpu_torch/csrc/nn1.cu",
        "replaces": "ogmm_tpu/ops/pallas_knn.py:187",
        "max_abs_err": worst, "ms": ms, "plain_ms": plain,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


BWD = {"bwd_reduce": (bwd_reduce, bwd_reduce_reference, 327),
       "bwd_stage": (bwd_stage, bwd_stage_reference, 378),
       "bwd_edge": (bwd_edge, bwd_edge_reference, 413)}


def bwd_calls(rs, dtype):
    """The five backward calls (reduce, stage 4, 3, 2, edge) of one DGCNN
    training forward and backward of B clouds at full width, recorded with
    their arguments while the plain versions run them."""
    calls = []

    def record(name):
        def fn(*a, **kw):
            calls.append((name, a, kw))
            return BWD[name][1](*a, **kw)
        return fn

    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=DEV)
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, EMB)]
    ws = [torch.tensor(rs.randn(*d).astype(np.float32) / np.sqrt(d[0]),
                       device=DEV, requires_grad=True) for d in dims]
    gs = [torch.tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32), device=DEV)
          for d in dims]
    bs = [torch.tensor(rs.randn(d[1]).astype(np.float32) * 0.1, device=DEV)
          for d in dims]
    saved = {name: getattr(ops_dgcnn_train, name) for name in BWD}
    switch = ops_dgcnn_train.BWD_KERNELS
    try:
        for name in BWD:
            setattr(ops_dgcnn_train, name, record(name))
        ops_dgcnn_train.BWD_KERNELS = True
        out, _, _ = ops_dgcnn_train.dgcnn_train(x, ws, gs, bs, KNN, dtype)
        wvec = torch.tensor(rs.randn(B, N, EMB).astype(np.float32), device=DEV)
        (out.float() * wvec).sum().backward()
    finally:
        for name, fn in saved.items():
            setattr(ops_dgcnn_train, name, fn)
        ops_dgcnn_train.BWD_KERNELS = switch
    torch.cuda.synchronize()
    assert [c[0] for c in calls] == ["bwd_reduce"] + ["bwd_stage"] * 3 + ["bwd_edge"]
    return calls


def _outs(name, out):
    return [out] if name == "bwd_reduce" else list(out)


def bwd_work(name, a, kw):
    """(bytes, product flops, elementwise flops) one call needs: each input
    read once, each output written once."""
    z = a[0]
    s = z.element_size()
    m, C = z[..., 0].numel(), z.shape[-1]
    rows = z.shape[0] * z.shape[2]
    if name == "bwd_reduce":
        return (m * C * s + rows * C * s + 6 * C * 4 + 2 * C * 4, 0.0,
                14.0 * m * C)
    if name == "bwd_stage":
        cin = a[8].shape[-1]
        cn = 0 if kw["dznext"] is None else kw["dznext"].shape[-1]
        nbytes = (m * (2 * C + cin + cn) * s + rows * (C + cin) * s
                  + 4 * (C * cin + C * cn + 2 * C + 8 * C + 8 * cin + cin * C + 2 * cin))
        return nbytes, 2.0 * m * (C * cn + 2 * C * cin), m * (16.0 * C + 14.0 * cin)
    # edge: z1, dz2, e, idx, dtap in; dW1, dq, dscat out
    nbytes = (m * (2 * C + 6) * s + m * 4 + rows * C * s
              + 4 * (2 * C * C + 12 * C + 6 * C + 2 * rows * 3))
    return nbytes, 2.0 * m * (C * C + 2 * 6 * C), m * (16.0 * C + 12.0)


def check_dgcnn_bwd(rs):
    """The three backward kernels against their plain versions on the
    arguments of a real backward at B=24, N=717, float32 and bf16; two
    launches bit for bit; times of one backward (one cloud) beside the
    plain versions and the bound."""
    errs = {name: {} for name in BWD}
    timed = {}
    for dt in (torch.float32, torch.bfloat16):
        calls = bwd_calls(rs, dt)
        for name, a, kw in calls:
            kern, plain, _ = BWD[name]
            got, again = _outs(name, kern(*a, **kw)), _outs(name, kern(*a, **kw))
            torch.cuda.synchronize()
            ref = _outs(name, plain(*a, **kw))
            for i, (g, g2, r) in enumerate(zip(got, again, ref)):
                assert torch.equal(g, g2), f"{name}: two launches differ"
                assert g.shape == r.shape and g.dtype == r.dtype, name
                assert torch.isfinite(g.float()).all(), name
                scale = r.float().abs().max().item()
                err = (g.float() - r.float()).abs().max().item()
                lim = (LIM_BWD_F32 if dt == torch.float32 else
                       LIM_BWD_DZ_BF16 if (name == "bwd_stage" and i == 0)
                       else LIM_BWD_SUM_BF16) * scale
                print(f"{name} {dt} output {i}: max|kernel - plain| = {err:.3g} "
                      f"(limit {lim:.3g}), max|plain| = {scale:.3g}")
                assert err <= lim, (name, dt, i)
                errs[name][dt] = max(errs[name].get(dt, 0.0), err)
        timed[dt] = calls
    entries = []
    for name, (kern, plain, line) in BWD.items():
        def run(fn, dt, name=name):
            for n_, a, kw in timed[dt]:
                if n_ == name:
                    fn(*a, **kw)
        bf = torch.bfloat16
        ms = cuda_ms(lambda: run(kern, bf), 10)
        ms32 = cuda_ms(lambda: run(kern, torch.float32), 5)
        plain_ms = cuda_ms(lambda: run(plain, bf), 3)
        work = [bwd_work(name, a, kw) for n_, a, kw in timed[bf] if n_ == name]
        nbytes = sum(w[0] for w in work)
        t_ops = (sum(w[1] for w in work) / PEAK_FLOPS["bf16"]
                 + sum(w[2] for w in work) / PEAK_FLOPS["f32"])
        t_bytes = nbytes / PEAK_BYTES
        entries.append({
            "name": name, "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/dgcnn_bwd.cu",
            "replaces": f"ogmm_tpu/ops/pallas_dgcnn_train.py:{line}",
            "calls_per_backward": len(work),
            "max_abs_err": errs[name][bf],
            "max_abs_err_f32": errs[name][torch.float32],
            "ms": ms, "ms_f32": ms32, "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
        })
        print(f"{name}: {ms:.3f} ms bf16, {ms32:.3f} ms fp32, plain {plain_ms:.3f} ms, "
              f"bound {entries[-1]['bound_ms']:.4f} ms ({entries[-1]['bound_by']}), "
              f"{len(work)} call(s) of one backward")
    return entries


# -------------------------------------------------------------------- serve

class plain_versions:
    """Swap the kernels' wrappers for their plain versions where the model
    looks them up, for the comparison run only."""

    SWAPS = ((nn_dgcnn, "dgcnn_eval", dgcnn_eval_reference),
             (ops_gmm, "sinkhorn_em", sinkhorn_em_reference),
             (ops_dgcnn_train, "graph_stage1", graph_stage1_reference),
             (cuda_knn, "nn1", nn1_reference),
             (cuda_stream, "knn_stream", stream.knn_stream_plain),
             (cuda_stream, "nn1_stream", stream.nn1_stream_plain),
             (nn_gmmreg, "wproject_stream_lse", stream.wproject_stream_lse_plain),
             (nn_dgcnn, "dgcnn_edges", dgcnn_edges_reference),
             (cuda_knn, "knn", knn_reference),
             (cuda_posenc, "posenc_angles", posenc_angles_reference),
             (ops_dgcnn_train, "bwd_reduce", bwd_reduce_reference),
             (ops_dgcnn_train, "bwd_stage", bwd_stage_reference),
             (ops_dgcnn_train, "bwd_edge", bwd_edge_reference),
             (cuda_fps, "fps", cuda_fps.fps_reference),
             (cuda_icp, "icp_fused", cuda_icp.icp_fused_reference),
             (cuda_mlp, "pointmlp_eval", cuda_mlp.pointmlp_eval_reference))

    def __init__(self, names=None):
        self.swaps = [sw for sw in self.SWAPS if names is None or sw[1] in names]

    def __enter__(self):
        self.saved = [getattr(m, name) for m, name, _ in self.swaps]
        for m, name, plain in self.swaps:
            setattr(m, name, plain)

    def __exit__(self, *exc):
        for (m, name, _), fn in zip(self.swaps, self.saved):
            setattr(m, name, fn)


def serve(rs):
    cfg = configs.mnet(model=configs.ModelConfig(dtype="bfloat16"))
    assert (cfg.model.emb_dims, cfg.model.n_clusters, cfg.model.gnn_k,
            cfg.model.num_heads) == (EMB, K, KNN, 4)
    reg = Registrar(cfg, seed=0, device=DEV)
    requests = [make_pairs(rs, B, N) for _ in range(3)]
    reg(requests[0][0], requests[0][1], refine=True)      # warm up
    torch.cuda.synchronize()

    dispatch.reset_launch_counts()
    src, tgt, _, _ = requests[0]
    rot, trans, so, to = reg(src, tgt, refine=True)
    torch.cuda.synchronize()
    launches = dict(dispatch.launch_counts)
    print("kernel launches in one request:", launches)
    for name in ("dgcnn_eval", "sinkhorn_em", "nn1"):
        assert launches[name] > 0, launches
    assert rot.shape == (B, 3, 3) and trans.shape == (B, 3)
    assert so.shape == (B, N) and to.shape == (B, N)

    times = {}
    outs = {}
    for refine in (False, True):
        t0 = time.perf_counter()
        for src, tgt, _, _ in requests:
            outs[refine] = reg(src, tgt, refine=refine)
        torch.cuda.synchronize()
        times[refine] = (time.perf_counter() - t0) / len(requests) * 1e3
        for o in outs[refine]:
            assert torch.isfinite(o).all()
        r = outs[refine][0]
        eye = torch.eye(3, device=DEV).expand(B, 3, 3)
        assert (r @ r.transpose(1, 2) - eye).abs().max() < 1e-4
        assert ((outs[refine][2] >= 0) & (outs[refine][2] <= 1)).all()
    print(f"request of {B} pairs: {times[False]:.2f} ms without ICP, "
          f"{times[True]:.2f} ms with ICP (host clock, synchronised)")

    # the same last request through the plain versions
    src, tgt, _, _ = requests[-1]
    with plain_versions():
        before = dict(dispatch.launch_counts)
        p_rot, p_trans, p_so, p_to = reg(src, tgt, refine=True)
        assert dict(dispatch.launch_counts) == before
    k_rot, k_trans, k_so, k_to = outs[True]
    d_o = max((k_so - p_so).abs().max().item(), (k_to - p_to).abs().max().item())
    ang = angle_deg(k_rot, p_rot)
    print(f"kernel path against plain path: overlap scores {d_o:.3g} (limit "
          f"{LIM_OVERLAP}), refined rotation median {ang.median().item():.3g} deg "
          f"(limit {LIM_ROT_DEG}), max {ang.max().item():.3g} deg")
    assert d_o <= LIM_OVERLAP and ang.median().item() <= LIM_ROT_DEG
    return launches, times


# -------------------------------------------------------------------- train

def make_batch(rs, n_points=N):
    """A training batch in the loader's format; the overlap labels are made
    in the step (device_overlap) from the ground truth."""
    src, tgt, rot, trans = make_pairs(rs, B, n_points)
    # a third of each target replaced by points off the source: partial
    # overlap, so that the labels are not all 1
    third = n_points // 3
    tgt[:, :third] = (rs.randn(B, third, 3) * 0.3 + 1.0).astype(np.float32)
    gt = np.concatenate([rot, trans[:, :, None]], axis=-1)
    ones = np.ones((B, n_points), np.float32)
    return {"src_xyz": src, "tgt_xyz": tgt, "src_overlap": ones,
            "tgt_overlap": ones, "transform_gt": gt}


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _step_grads(state, cfg, batch):
    """Loss and gradients of one step from `state` (anchors from index 0),
    on a copy of the model: the running statistics of `state` stay."""
    import copy
    probe = copy.copy(state)
    probe.model = copy.deepcopy(state.model)
    probe.generator = None
    for p in probe.model.parameters():
        p.grad = None
    loss, _ = train_loss(probe, cfg, batch)
    loss.backward()
    return loss.item(), _grads(probe.model)


def _rel(a, b):
    num = sum(((a[n] - b[n]).float() ** 2).sum() for n in b)
    den = sum((b[n].float() ** 2).sum() for n in b)
    return (num / den).sqrt().item()


def train(rs):
    cfg = configs.mnet(model=configs.ModelConfig(dtype="bfloat16"))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, device_overlap=True),
                      data=dataclasses.replace(cfg.data, fix_tgt_overlap=True))
    state = create_train_state(cfg, steps_per_epoch=100, seed=0, device=DEV)
    step = make_train_step(cfg)
    batches = [make_batch(rs) for _ in range(4)]
    before = {n: t.detach().clone() for n, t in state.model.state_dict().items()}

    ops_dgcnn_train.BWD_KERNELS = True
    step(state, batches[0])                               # warm up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    metrics = step(state, batches[1])
    torch.cuda.synchronize()
    launches = dict(dispatch.launch_counts)
    print("kernel launches in one train step:", launches)
    for name in ("graph_stage1", "nn1", "sinkhorn_em"):
        assert launches[name] > 0, launches
    # the training forward runs per cloud: one backward for src, one for tgt
    assert (launches["bwd_reduce"], launches["bwd_stage"],
            launches["bwd_edge"]) == (2, 6, 2), launches
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics

    # ten timed steps with the backward kernels, ten with the plain backward
    step_ms, peak_mib, losses = {}, {}, []
    for on in (True, False):
        ops_dgcnn_train.BWD_KERNELS = on
        step(state, batches[2])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for i in range(10):
            metrics = step(state, batches[i % len(batches)])
            losses.append(metrics["loss"][0])
        torch.cuda.synchronize()
        step_ms[on] = (time.perf_counter() - t0) / 10 * 1e3
        peak_mib[on] = torch.cuda.max_memory_allocated() / 2 ** 20
    ops_dgcnn_train.BWD_KERNELS = True
    losses = [v.item() for v in losses]
    print(f"train step of {B} pairs: {step_ms[True]:.2f} ms with the backward "
          f"kernels, {step_ms[False]:.2f} ms with the plain backward (host "
          f"clock, synchronised, ten steps each); peak device memory "
          f"{peak_mib[True]:.0f} / {peak_mib[False]:.0f} MiB; losses "
          f"{[round(v, 4) for v in losses]}")
    assert all(np.isfinite(losses))
    for n, p in state.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
    after = state.model.state_dict()
    unchanged = [n for n in before if torch.equal(before[n], after[n])]
    assert not unchanged, f"not moved by training: {unchanged}"
    print(f"all {len(before)} parameters and running statistics moved")

    # one step from the same state with the backward kernels on and off
    batch = batches[2]
    k_loss, k_grads = _step_grads(state, cfg, batch)
    ops_dgcnn_train.BWD_KERNELS = False
    o_loss, o_grads = _step_grads(state, cfg, batch)
    ops_dgcnn_train.BWD_KERNELS = True
    d_bwd = _rel(k_grads, o_grads)
    print(f"train step, backward kernels on against off: loss {k_loss!r} / "
          f"{o_loss!r}; gradients relative {d_bwd:.3g} (limit {LIM_BWD_STEP_GRAD})")
    assert k_loss == o_loss and d_bwd <= LIM_BWD_STEP_GRAD

    # the same step from the same state through the plain versions
    with plain_versions():
        counts = dict(dispatch.launch_counts)
        p_loss, p_grads = _step_grads(state, cfg, batch)
        assert dict(dispatch.launch_counts) == counts
    d_loss = abs(k_loss - p_loss) / abs(p_loss)
    d_grad = _rel(k_grads, p_grads)
    print(f"train step, kernels against plain versions: loss {k_loss:.5f} / "
          f"{p_loss:.5f}, relative {d_loss:.3g} (limit {LIM_STEP_LOSS}); "
          f"gradients relative {d_grad:.3g} (limit {LIM_STEP_GRAD})")
    assert d_loss <= LIM_STEP_LOSS and d_grad <= LIM_STEP_GRAD

    ev = make_eval_step(cfg)(state, batches[3])
    torch.cuda.synchronize()
    assert all(torch.isfinite(v).all() for v in ev.values()), ev
    print("eval step with ICP: " + ", ".join(
        f"{k} {v.mean().item():.4g}" for k, v in ev.items()))
    return launches, {"step_ms_bwd_kernels": step_ms[True],
                      "step_ms_plain_bwd": step_ms[False],
                      "peak_mib_bwd_kernels": peak_mib[True],
                      "peak_mib_plain_bwd": peak_mib[False],
                      "grad_rel_on_off": d_bwd, "losses": losses}


# ---------------------------------------------------------------------- cli

def run_cli():
    """`python -m ogmm_tpu_torch.train` on the card at full width with the
    backward kernels on: synthetic ModelNet (crop, 717 points), B=24,
    emb 512, K=128, bf16, one epoch of three steps and one eval batch."""
    ops_dgcnn_train.BWD_KERNELS = True
    with tempfile.TemporaryDirectory() as tmp:
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["--dataset", "synthetic", "--root", "synthetic:200",
                            "--dtype", "bfloat16", "--batch_size", str(B),
                            "--test_batch_size", str(B), "--epochs", "1",
                            "--steps_per_epoch", "3", "--model_path", tmp])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(dispatch.launch_counts)
        saved = os.path.exists(os.path.join(tmp, "checkpoints", "GMMReg",
                                            "models", "optim_model.pt"))
    rec = trainer.history[-1]
    print(f"CLI: {trainer.state.step} steps and an eval batch in {secs:.1f} s "
          f"(data pipeline included), train loss {rec['train']['loss']:.4f}, "
          f"eval loss {rec['val']['loss']:.4f}, checkpoint written {saved}; "
          f"launches {launches}")
    assert trainer.state.step == 3 and saved
    assert np.isfinite(rec["train"]["loss"]) and np.isfinite(rec["val"]["loss"])
    assert trainer.state.device.type == "cuda"
    # every kernel of the N=717 training path; the kNN and angle kernels
    # serve the large-cloud and unfused routes
    other = {"knn", "posenc_angles", *INDOOR_KERNELS, *LOOP_KERNELS}
    for name in set(dispatch.KERNELS) - other:
        assert launches[name] > 0, launches
    assert all(launches[name] == 0 for name in other), launches
    assert (launches["bwd_reduce"], launches["bwd_stage"],
            launches["bwd_edge"]) == (6, 18, 6), launches
    return launches, {"seconds": secs, "train_loss": rec["train"]["loss"],
                      "eval_loss": rec["val"]["loss"]}


def check_icp(rs):
    """ICP from a pose 3 degrees off recovers the known pose."""
    src, tgt, rot, trans = make_pairs(rs, 8, 256)
    src, tgt, rot, trans = (torch.tensor(a, device=DEV) for a in (src, tgt, rot, trans))
    d = torch.tensor(rs.uniform(-0.03, 0.03, (8, 3)).astype(np.float32), device=DEV)
    skew = torch.zeros(8, 3, 3, device=DEV)
    skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = -d[:, 2], d[:, 1], -d[:, 0]
    skew = skew - skew.transpose(1, 2)
    init = se3.integrate(torch.linalg.matrix_exp(skew) @ rot, trans)
    r, t = icp_point_to_point(src, tgt, init, 0.07, max_iter=30)
    rre = angle_deg(r, rot).max().item()
    rte = (t - trans).abs().max().item()
    print(f"ICP on a small input: rotation error {rre:.3g} deg, translation "
          f"error {rte:.3g} (limits 0.1 deg, 1e-3)")
    assert rre < 0.1 and rte < 1e-3


# --------------------------------------------- kNN and angle kernels

def _cloud(rs, b, n, dup=True):
    x = torch.tensor(rs.randn(b, n, 3).astype(np.float32) * 0.3, device=DEV)
    if dup:
        x[:, n // 2] = x[:, 1]               # a duplicated point: exact ties
    return x


def _bound(flops_f32, nbytes):
    t_ops, t_bytes = flops_f32 / PEAK_FLOPS["f32"], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_knn(rs):
    """The kNN kernel against its plain version (identical indices) at every
    shape the driven paths give it: the large-cloud request (2B=48 clouds of
    1433 points) and step (B=24 of 1433), the unfused N=717 step's graph
    (k=20) and angles (k=5); and at the kernel's envelope (M=4096), a cross
    kNN, clouds with a duplicated point and with 301 coincident points (more
    candidates at the threshold than the kernel's list holds). Its error is
    the largest |kernel - plain| index over them, 0 when all agree. Timed at
    the first shape (the plain version once: a (48, 1433, 1433) float32
    matrix and 20 passes)."""
    shapes = [(2 * B, N_LARGE, N_LARGE, KNN), (B, N_LARGE, N_LARGE, KNN),
              (B, N, N, KNN), (B, 4096, 4096, KNN), (B, N, N, POS_K),
              (4, 1000, 257, 32), (2, 90, 2000, 1)]
    worst = 0
    for b, n, m, k in shapes + [(2, 600, 600, KNN)]:
        tgt = _cloud(rs, b, m)
        if (b, n) == (2, 600):
            tgt[:, 100:400] = tgt[:, :1]     # 301 coincident points
        src = tgt.clone() if n == m else _cloud(rs, b, n, dup=False)
        got = knn(src, tgt, k)
        torch.cuda.synchronize()
        want = knn_reference(src, tgt, k)
        same = torch.equal(got, want)
        worst = max(worst, (got - want).abs().max().item())
        print(f"knn ({b}, {n}, {m}, k={k}): indices identical {same}")
        assert same and got.dtype == torch.int64
    x = _cloud(rs, 2 * B, N_LARGE)
    ms = cuda_ms(lambda: knn(x, x, KNN), 20)
    plain = cuda_ms(lambda: knn_reference(x, x, KNN), 1)
    x4096 = _cloud(rs, B, 4096)
    ms_4096 = cuda_ms(lambda: knn(x4096, x4096, KNN), 5)
    rows = 2 * B * N_LARGE
    bound, by = _bound(rows * N_LARGE * (8.0 + 1.0),
                       2 * x.numel() * 4 + rows * KNN * 8)
    print(f"knn ({2 * B}, {N_LARGE}, {N_LARGE}, k={KNN}): {ms:.4f} ms, plain "
          f"{plain:.3f} ms, bound {bound:.5f} ms ({by}); ({B}, 4096, 4096, "
          f"k={KNN}) {ms_4096:.4f} ms")
    return {"name": "knn", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/knn.cu",
            "replaces": "ogmm_tpu/ops/pallas_knn.py:74",
            "max_abs_err": float(worst), "ms": ms, "ms_m4096": ms_4096,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def check_posenc_angles(rs):
    """The angle kernel against its plain version at the unfused training
    path's shape (B=24 clouds of 717, k=5) and at N=1024, with a duplicated
    point; max |kernel - plain| <= 1e-5."""
    worst = 0.0
    for b, n in ((B, N), (4, 1024)):
        x = _cloud(rs, b, n)
        got = posenc_angles(x, POS_K)
        torch.cuda.synchronize()
        err = (got - posenc_angles_reference(x, POS_K)).abs().max().item()
        print(f"posenc_angles ({b}, {n}, k={POS_K}): max|kernel - plain| = "
              f"{err:.3g} (limit {LIM_POSENC})")
        assert err <= LIM_POSENC and torch.isfinite(got).all()
        worst = max(worst, err)
    x = _cloud(rs, B, N)
    ms = cuda_ms(lambda: posenc_angles(x, POS_K), 50)
    plain = cuda_ms(lambda: posenc_angles_reference(x, POS_K), 5)
    rows = B * N
    # each distance once and about one compare a candidate, as for knn
    bound, by = _bound(rows * N * (8.0 + 1.0), x.numel() * 4 + rows * POS_K * 4)
    print(f"posenc_angles ({B}, {N}, k={POS_K}): {ms:.4f} ms, plain "
          f"{plain:.3f} ms, bound {bound:.5f} ms ({by})")
    return {"name": "posenc_angles", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/posenc_angles.cu",
            "replaces": "ogmm_tpu/ops/pallas_knn.py:144",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None}


# ------------------------------------------------- the large-cloud paths

def serve_large(rs):
    """`Registrar` on 24 pairs of 1433-point clouds, bf16 body: one kNN graph
    shared by DGCNN and the position encoding, the unfused DGCNN, the EM
    kernel, ICP's 1-NN kernel at M=1433 (30 trips)."""
    cfg = configs.mnet(model=configs.ModelConfig(dtype="bfloat16"))
    reg = Registrar(cfg, seed=0, device=DEV)
    requests = [make_pairs(rs, B, N_LARGE) for _ in range(3)]
    reg(requests[0][0], requests[0][1], refine=True)      # warm up
    torch.cuda.synchronize()
    launches, times, outs = {}, {}, {}
    for refine in (False, True):
        src, tgt, _, _ = requests[0]
        dispatch.reset_launch_counts()
        reg(src, tgt, refine=refine)
        torch.cuda.synchronize()
        launches[refine] = dict(dispatch.launch_counts)
        t0 = time.perf_counter()
        for src, tgt, _, _ in requests:
            outs[refine] = reg(src, tgt, refine=refine)
        torch.cuda.synchronize()
        times[refine] = (time.perf_counter() - t0) / len(requests) * 1e3
        for o in outs[refine]:
            assert torch.isfinite(o).all()
        r = outs[refine][0]
        eye = torch.eye(3, device=DEV).expand(B, 3, 3)
        assert (r @ r.transpose(1, 2) - eye).abs().max() < 1e-4
    print(f"request of {B} pairs at N={N_LARGE}: {times[False]:.2f} ms without "
          f"ICP, {times[True]:.2f} ms with ICP (host clock, synchronised); "
          f"launches {launches[False]} / {launches[True]}")
    # the shared graph once for the 2B stacked clouds, no fused DGCNN, the
    # EM once; the clustering loss's 1-NN once and one a trip of ICP
    expect = {"knn": 1, "sinkhorn_em": 1, "dgcnn_eval": 0, "posenc_angles": 0}
    for refine, n_nn1 in ((False, 1), (True, 1 + cfg.model.icp_iters)):
        got = {name: launches[refine][name] for name in expect}
        assert got == expect and launches[refine]["nn1"] == n_nn1, launches
    src, tgt, _, _ = requests[-1]
    with plain_versions():
        before = dict(dispatch.launch_counts)
        p_rot, _, p_so, p_to = reg(src, tgt, refine=True)
        assert dict(dispatch.launch_counts) == before
    k_rot, _, k_so, k_to = outs[True]
    d_o = max((k_so - p_so).abs().max().item(), (k_to - p_to).abs().max().item())
    ang = angle_deg(k_rot, p_rot)
    print(f"N={N_LARGE} kernel path against plain path: overlap scores {d_o:.3g} "
          f"(limit {LIM_OVERLAP}), refined rotation median "
          f"{ang.median().item():.3g} deg (limit {LIM_ROT_DEG})")
    assert d_o <= LIM_OVERLAP and ang.median().item() <= LIM_ROT_DEG
    return launches[False], {"forward": times[False], "forward_icp": times[True],
                             "launches_icp": launches[True]}


def _train_cfg(**model):
    cfg = configs.mnet(model=configs.ModelConfig(dtype="bfloat16", **model))
    return cfg.replace(train=dataclasses.replace(cfg.train, device_overlap=True),
                       data=dataclasses.replace(cfg.data, fix_tgt_overlap=True))


def train_large(rs, steps=3):
    """`make_train_step` at B=24, N=1433: per cloud one kNN graph of k=20
    shared by DGCNN and the angles, the unfused DGCNN through autograd."""
    cfg = _train_cfg()
    state = create_train_state(cfg, steps_per_epoch=100, seed=0, device=DEV)
    step = make_train_step(cfg)
    batches = [make_batch(rs, N_LARGE) for _ in range(2)]
    before = {n: t.detach().clone() for n, t in state.model.state_dict().items()}
    step(state, batches[0])                               # warm up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    metrics = step(state, batches[1])
    torch.cuda.synchronize()
    launches = dict(dispatch.launch_counts)
    t0 = time.perf_counter()
    losses = [step(state, batches[i % 2])["loss"][0] for i in range(steps)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [v.item() for v in losses]
    print(f"train step of {B} pairs at N={N_LARGE}: {step_ms:.2f} ms (host "
          f"clock, {steps} steps), peak device memory {peak:.0f} MiB, losses "
          f"{[round(v, 4) for v in losses]}, launches {launches}")
    assert launches["knn"] == 2 and launches["graph_stage1"] == 0, launches
    assert launches["dgcnn_eval"] == launches["posenc_angles"] == 0, launches
    assert all(np.isfinite(losses))
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    for n, p in state.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
    after = state.model.state_dict()
    unchanged = [n for n in before if torch.equal(before[n], after[n])]
    assert not unchanged, f"not moved by training: {unchanged}"
    return launches, {"step_ms": step_ms, "peak_mib": peak, "losses": losses}


def train_unfused(rs):
    """The N=717 step with `dgcnn_fused_train=False`: DGCNN builds its graph
    with the kNN kernel and the position encoding takes the angle kernel,
    once a cloud; the loss of one step from the seeded state through those
    two kernels and through their plain versions (the forward from that
    state is deterministic; after steps whose backward adds with atomics the
    EM amplifies the angles' 3e-7 differences by another factor each run)."""
    cfg = _train_cfg(dgcnn_fused_train=False)
    state = create_train_state(cfg, steps_per_epoch=100, seed=0, device=DEV)
    step = make_train_step(cfg)
    batch = make_batch(rs)
    k_loss, _ = _step_grads(state, cfg, batch)
    with plain_versions({"knn", "posenc_angles"}):
        p_loss, _ = _step_grads(state, cfg, batch)
    with plain_versions():
        all_loss, _ = _step_grads(state, cfg, batch)
    step(state, batch)                                    # warm up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    metrics = step(state, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(dispatch.launch_counts)
    assert (launches["knn"], launches["posenc_angles"]) == (2, 2), launches
    assert launches["graph_stage1"] == launches["dgcnn_eval"] == 0, launches
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    d_loss = abs(k_loss - p_loss) / abs(p_loss)
    d_all = abs(k_loss - all_loss) / abs(all_loss)
    print(f"unfused train step at N={N}: {step_ms:.2f} ms, launches {launches}; "
          f"loss {k_loss:.6f} against {p_loss:.6f} through the plain kNN and "
          f"angles (relative {d_loss:.3g}, limit {LIM_UNFUSED_LOSS}) and "
          f"{all_loss:.6f} through every plain version (relative {d_all:.3g}, "
          f"limit {LIM_STEP_LOSS})")
    assert d_loss <= LIM_UNFUSED_LOSS and d_all <= LIM_STEP_LOSS
    return launches, {"step_ms": step_ms, "loss_rel": d_loss}


def check_c1(rs):
    """The shapes the port raised on before it routed by shape."""
    out = {}
    for name, over, b, n, want in (
            ("gnn_k=16", dict(gnn_k=16), B, N,
             {"dgcnn_eval": 1, "knn": 0, "sinkhorn_em": 1}),
            ("n_clusters=16", dict(n_clusters=16), 4, 2048,
             {"dgcnn_eval": 0, "knn": 1, "sinkhorn_em": 1})):
        reg = Registrar(configs.mnet(model=configs.ModelConfig(
            dtype="bfloat16", **over)), seed=0, device=DEV)
        src, tgt, _, _ = make_pairs(rs, b, n)
        reg(src, tgt, refine=False)
        torch.cuda.synchronize()
        dispatch.reset_launch_counts()
        rot, trans, so, _ = reg(src, tgt, refine=True)
        torch.cuda.synchronize()
        launches = dict(dispatch.launch_counts)
        print(f"c1 Registrar {name} (B={b}, N={n}): launches {launches}")
        assert torch.isfinite(rot).all() and torch.isfinite(so).all()
        assert {k: launches[k] for k in want} == want, launches
        out[name] = launches
    src, tgt = _cloud(rs, 2, 512, dup=False), _cloud(rs, 2, 8192)
    dispatch.reset_launch_counts()
    d, i = ops_common.nn1(src, tgt)
    torch.cuda.synchronize()
    rd, ri = nn1_reference(src, tgt)
    print(f"c1 nn1 (2, 512 x 8192): route {ops_common.nn1_route(2, 512, 8192)}, "
          f"launches {dict(dispatch.launch_counts)}, max|d - plain| "
          f"{(d - rd).abs().max().item():.3g}")
    # above M = 4096 the streamed 1-NN kernel, as the JAX package's nn1_stream
    assert dispatch.launch_counts["nn1"] == 0
    assert dispatch.launch_counts["nn1_stream"] == 1
    assert torch.equal(d, rd) and torch.equal(i, ri)
    out["nn1_8192"] = dict(dispatch.launch_counts)
    return out


# ------------------------------------------------- the indoor request's kernels

INDOOR_KERNELS = ("dgcnn_edges", "knn_stream", "nn1_stream", "wproject")


def surface(rs, batch):
    """bench.py's synthetic indoor fragment of N_INDOOR points: a height
    field over the unit square, 0.01 noise."""
    u = rs.rand(batch, N_INDOOR, 2).astype(np.float32)
    z = np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    pts = np.concatenate([u, 0.3 * z], -1)
    return (pts + 0.01 * rs.randn(batch, N_INDOOR, 3)).astype(np.float32)


def _sorted(x):
    return index_points(x, stream.morton_order(x))


def _pair_d(q, t):
    """Fixed-order squared distances of matched rows q, t (..., 3)."""
    inner = q[..., 0] * t[..., 0] + q[..., 1] * t[..., 1] + q[..., 2] * t[..., 2]
    return ((sq_norm3(q) + sq_norm3(t)) - 2.0 * inner).clamp_min(1e-12)


def _needed_pairs(lb, worst, n, m):
    """Distances the cull-exact search of these inputs needs: those of the
    tile pairs whose bound is within the query tile's final worst distance
    (the kernel's test), worst (B, N) the distance each row must reach."""
    tn, tm = stream.TILE_N, stream.TILE_M
    n_t = lb.shape[1]
    w = torch.nn.functional.pad(worst, (0, n_t * tn - n), value=float("-inf"))
    w = w.reshape(worst.shape[0], n_t, tn).amax(dim=-1)
    need = lb <= w.unsqueeze(-1) * (1.0 + 1e-6) + 1e-6
    rows = torch.full((n_t,), float(tn), device=lb.device)
    rows[-1] = n - tn * (n_t - 1)
    cols = torch.full((lb.shape[2],), float(tm), device=lb.device)
    cols[-1] = m - tm * (lb.shape[2] - 1)
    return (need.float() * rows[:, None] * cols[None, :]).sum().item(), \
        need.float().mean().item()


def check_knn_stream(rs):
    """The streamed kNN kernel against its plain version (identical
    indices): the indoor graph (2 clouds of 35,000, k=20) Morton-sorted
    with the cull and the diagonal order as `knn_self_vspace` gives it, and
    without them; unsorted clouds just above M = 4096 with N not a multiple
    of the tile, with and without a cull; a cross query at k=1; 301
    coincident points; N below one tile at k=32."""
    x = _sorted(torch.tensor(surface(rs, 2), device=DEV))
    lb = stream.tile_pair_bounds(x)
    g = _cloud(rs, 2, 4100)
    gs = _sorted(g)
    c = _cloud(rs, 2, 4200)
    c[:, 100:401] = c[:, :1]                 # 301 coincident points
    cs = _sorted(c)
    q = _cloud(rs, 1, 1000, dup=False)
    cases = [("indoor, sorted, cull, diagonal", x, x, KNN,
              dict(diag_order=True, cull_lb=lb)),
             ("indoor, sorted, no cull", x, x, KNN, {}),
             ("M=4100, unsorted", g, g, KNN, {}),
             ("M=4100, unsorted, cull, diagonal", g, g, KNN,
              dict(diag_order=True, cull_lb=stream.tile_pair_bounds(g))),
             ("M=4100, sorted, cull, diagonal", gs, gs, 7,
              dict(diag_order=True, cull_lb=stream.tile_pair_bounds(gs))),
             ("cross (1, 1000, 4097), k=1", q, g[:1, :4097], 1, {}),
             ("301 coincident, sorted, cull", cs, cs, KNN,
              dict(diag_order=True, cull_lb=stream.tile_pair_bounds(cs))),
             ("N=37 below a tile, k=32", g[:, :37], g, 32,
              dict(cull_lb=stream.pair_tile_bounds(g[:, :37], g)))]
    worst = 0
    for name, src, tgt, k, kw in cases:
        got = cuda_stream.knn_stream(src, tgt, k, **kw)
        torch.cuda.synchronize()
        want = stream.knn_stream_plain(src, tgt, k)
        same = torch.equal(got, want)
        worst = max(worst, (got - want).abs().max().item())
        print(f"knn_stream {name} {tuple(src.shape[:2])} x {tgt.shape[1]}, "
              f"k={k}: indices identical {same}")
        assert same and got.dtype == torch.int64
    run = lambda: cuda_stream.knn_stream(x, x, KNN, diag_order=True, cull_lb=lb)
    ms = cuda_ms(run, 10)
    ms_nocull = cuda_ms(lambda: cuda_stream.knn_stream(x, x, KNN), 2)
    ms_graph = cuda_ms(lambda: ops_common.knn_self_vspace(x, KNN), 5)
    plain = cuda_ms(lambda: stream.knn_stream_plain(x, x, KNN), 1)
    idx = run()
    dk = _pair_d(x, index_points(x, idx[..., -1]))
    pairs, share = _needed_pairs(lb, dk, N_INDOOR, N_INDOOR)
    bound, by = _bound(9.0 * pairs, 2 * x.numel() * 4 + idx.numel() * 8)
    full, _ = _bound(9.0 * 2 * N_INDOOR * N_INDOOR, 0)
    print(f"knn_stream (2, {N_INDOOR}, {N_INDOOR}, k={KNN}): {ms:.4f} ms with "
          f"the cull ({ms_nocull:.3f} without; the whole v-space graph with "
          f"the sort and the table {ms_graph:.3f} ms), plain {plain:.2f} ms, "
          f"bound {bound:.5f} ms ({by}; the {share:.4f} of the tile pairs "
          f"the search needs; {full:.4f} ms for every pair)")
    return {"name": "knn_stream", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/knn_stream.cu",
            "replaces": "ogmm_tpu/ops/pallas_stream.py:529",
            "max_abs_err": float(worst), "ms": ms, "ms_no_cull": ms_nocull,
            "ms_vspace_graph": ms_graph, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "bound_ms_every_pair": full,
            "tile_pairs_needed": share, "library_ms": None}


def check_nn1_stream(rs):
    """The streamed 1-NN kernel against its plain version: an ICP trip at
    the indoor shape (Morton-sorted clouds, the moved source 0.6 degrees
    and 0.01 off the target, the cull and the 0.075 gate: identical (d, i)
    on the rows within the gate); the clustering's (2, 16, 35000) and
    awkward shapes without a gate (identical on every row)."""
    src, tgt, rot, trans = rigid_copies(rs, surface(rs, 1))
    src, tgt = _sorted(torch.tensor(src, device=DEV)), _sorted(torch.tensor(tgt, device=DEV))
    a = 0.01
    off = torch.tensor([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]], dtype=torch.float32, device=DEV)
    r = torch.tensor(rot, device=DEV) @ off
    moved = src @ r.transpose(1, 2) + torch.tensor(trans, device=DEV)[:, None] + 0.01
    gate = (2.0 * configs.indoor().model.overlap_radius) ** 2
    lb = stream.pair_tile_bounds(moved, tgt)
    d, i = cuda_stream.nn1_stream(moved, tgt, cull_lb=lb, max_dist_sq=gate,
                                  diag_order=True)
    torch.cuda.synchronize()
    rd, ri = stream.nn1_stream_plain(moved, tgt)
    inside = rd < gate
    same = torch.equal(d[inside], rd[inside]) and torch.equal(i[inside], ri[inside])
    print(f"nn1_stream ICP trip (1, {N_INDOOR}, {N_INDOOR}), gate {gate:.5f}: "
          f"(d, i) identical on the {inside.float().mean().item():.4f} of the "
          f"rows within the gate {same}; the rest report d >= gate "
          f"{bool((d[~inside] >= gate).all())}")
    assert same and bool((d[~inside] >= gate).all())
    big = torch.tensor(surface(rs, 2), device=DEV)
    nodes = index_points(big, torch.randint(0, N_INDOOR, (2, 16), device=DEV)) + 0.003
    g = _cloud(rs, 2, 4097)
    c = _cloud(rs, 1, 4200)
    c[:, 100:401] = c[:, :1]
    cs = _sorted(c)
    for name, q, t, kw in (
            (f"clustering (2, 16, {N_INDOOR})", nodes, big, {}),
            ("(2, 4100, 4097) unsorted", _cloud(rs, 2, 4100, dup=False), g, {}),
            ("301 coincident, sorted, cull", cs, cs,
             dict(cull_lb=stream.tile_pair_bounds(cs), diag_order=True))):
        d2, i2 = cuda_stream.nn1_stream(q, t, **kw)
        torch.cuda.synchronize()
        rd2, ri2 = stream.nn1_stream_plain(q, t)
        same = torch.equal(d2, rd2) and torch.equal(i2, ri2)
        print(f"nn1_stream {name}: (d, i) identical {same}")
        assert same
    run = lambda: cuda_stream.nn1_stream(moved, tgt, cull_lb=lb,
                                         max_dist_sq=gate, diag_order=True)
    ms = cuda_ms(run, 20)
    ms_trip = cuda_ms(lambda: cuda_stream.nn1_stream(
        moved, tgt, cull_lb=stream.pair_tile_bounds(moved, tgt),
        max_dist_sq=gate, diag_order=True), 10)
    ms_nodes = cuda_ms(lambda: cuda_stream.nn1_stream(nodes, big), 10)
    plain = cuda_ms(lambda: stream.nn1_stream_plain(moved, tgt), 2)
    pairs, share = _needed_pairs(lb, rd.clamp_max(gate), N_INDOOR, N_INDOOR)
    bound, by = _bound(9.0 * pairs, 2 * moved.numel() * 4 + N_INDOOR * 12)
    print(f"nn1_stream ICP trip: {ms:.4f} ms ({ms_trip:.4f} with its bound "
          f"table), plain {plain:.2f} ms, bound {bound:.6f} ms ({by}; the "
          f"{share:.4f} of the tile pairs the gated search needs); the "
          f"clustering's call {ms_nodes:.4f} ms")
    return {"name": "nn1_stream", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/knn_stream.cu",
            "replaces": "ogmm_tpu/ops/pallas_stream.py:165",
            "also_replaces": "ogmm_tpu/ops/pallas_stream.py:236",
            "max_abs_err": 0.0, "ms": ms, "ms_with_table": ms_trip,
            "ms_clustering_call": ms_nodes, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "tile_pairs_needed": share,
            "library_ms": None}


def _features(rs, b, n, d, dtype):
    """l2-normalised rows, each k row a noisy copy of a q row: cosine
    similarities up to ~0.9, as matched features give."""
    base = torch.tensor(rs.randn(b, n, d).astype(np.float32), device=DEV)
    q = base + 0.3 * torch.randn_like(base)
    k = base[:, torch.randperm(n, device=DEV)] + 0.3 * torch.randn_like(base)
    l2 = lambda a: (a / a.norm(dim=-1, keepdim=True)).to(dtype)
    return l2(q), l2(k)


def _sdpa(q, k, v):
    """One PyTorch call for the same function, its time and the backends
    that accept these inputs (a yardstick only; the port never calls it)."""
    import warnings
    from torch.nn.attention import SDPBackend, sdpa_kernel
    f = torch.nn.functional.scaled_dot_product_attention
    args = (q.unsqueeze(1), k.unsqueeze(1), v.to(q.dtype).unsqueeze(1))
    ok = []
    for be in (SDPBackend.CUDNN_ATTENTION, SDPBackend.FLASH_ATTENTION,
               SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([be]), warnings.catch_warnings():
                warnings.simplefilter("ignore")   # each refusal's reasons
                f(*args, scale=1.0)
            torch.cuda.synchronize()
            ok.append(be.name)
        except RuntimeError as e:
            print(f"scaled_dot_product_attention, {be.name}: refused "
                  f"({str(e).splitlines()[0][:100]})")
    torch.cuda.empty_cache()
    if not ok:
        return None, ok, None
    out = f(*args, scale=1.0).squeeze(1).float()
    return cuda_ms(lambda: f(*args, scale=1.0), 3), ok, out


def check_wproject(rs):
    """The streamed overlap projection against its plain version: out and
    lse within LIM_WPROJECT at the indoor call (1, 35000, 35000, D=512,
    bf16) and at small awkward shapes (float32, M below one tile, N not a
    multiple of the tile, M just above 4096); timed beside the plain version
    and `scaled_dot_product_attention` with a one-column v."""
    worst = 0.0
    qi, ki = _features(rs, 1, N_INDOOR, EMB, torch.bfloat16)
    vi = torch.tensor(rs.randn(1, N_INDOOR, 1).astype(np.float32), device=DEV)
    small = []
    for b, n, m, d, dt in ((1, 1000, 700, 64, torch.float32),
                           (1, 70, 50, 64, torch.bfloat16),
                           (2, 130, 4100, EMB, torch.bfloat16),
                           (2, 130, 4100, 128, torch.float32)):
        q, _ = _features(rs, b, n, d, dt)
        _, k = _features(rs, b, m, d, dt)
        v = torch.tensor(rs.randn(b, m, 1).astype(np.float32), device=DEV)
        small.append((q, k, v))
    for q, k, v in [(qi, ki, vi)] + small:
        out, lse = cuda_stream.wproject_stream_lse(q, k, v)
        torch.cuda.synchronize()
        rout, rlse = stream.wproject_stream_lse_plain(q, k, v)
        e_out = (out - rout).abs().max().item()
        e_lse = (lse - rlse).abs().max().item()
        print(f"wproject {tuple(q.shape)} x {k.shape[1]} {q.dtype}: out "
              f"{e_out:.3g}, lse {e_lse:.3g} (limit {LIM_WPROJECT}); max|lse| "
              f"{rlse.abs().max().item():.3g}")
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        assert e_out <= LIM_WPROJECT and e_lse <= LIM_WPROJECT
        worst = max(worst, e_out, e_lse)
    ms = cuda_ms(lambda: cuda_stream.wproject_stream_lse(qi, ki, vi), 5)
    plain = cuda_ms(lambda: stream.wproject_stream_lse_plain(qi, ki, vi), 2)
    lib, backends, lib_out = _sdpa(qi, ki, vi)
    lib_err = None if lib_out is None else (
        lib_out - stream.wproject_stream_lse_plain(qi, ki, vi)[0]).abs().max().item()
    nn_ = float(N_INDOOR) * N_INDOOR
    t_ops = 2.0 * nn_ * EMB / PEAK_FLOPS["bf16"] + 4.0 * nn_ / PEAK_FLOPS["f32"]
    t_bytes = (2 * N_INDOOR * EMB * 2 + N_INDOOR * 4 + 2 * N_INDOOR * 4) / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    print(f"wproject (1, {N_INDOOR}, {N_INDOOR}, D={EMB}) bf16: {ms:.3f} ms, "
          f"plain {plain:.2f} ms, bound {bound:.4f} ms (operations); "
          f"scaled_dot_product_attention {lib} ms (backends that take a "
          f"one-column v: {backends}; max|out - plain| {lib_err})")
    return {"name": "wproject", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/wproject.cu",
            "replaces": "ogmm_tpu/ops/pallas_stream.py:823",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib, "library_backends": backends,
            "library_max_abs_err": lib_err}


def check_dgcnn_edges(rs):
    """The edges kernel against its plain version over the indoor graph (2
    clouds of 35,000, k=20, the kernel's own graph), float32 and bf16, with
    the limits of the dgcnn_eval check; and at N=37 (not a multiple of the
    kernel's 8 rows) with k=16."""
    x = _sorted(torch.tensor(surface(rs, 2), device=DEV))
    nbr = gather_neighbors(x, cuda_stream.knn_stream(
        x, x, KNN, diag_order=True, cull_lb=stream.tile_pair_bounds(x)))
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, EMB)]
    ws = [torch.tensor(rs.randn(*d).astype(np.float32) / np.sqrt(d[0]),
                       device=DEV) for d in dims]
    aff = [(torch.tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32), device=DEV),
            torch.tensor(rs.randn(d[1]).astype(np.float32) * 0.1, device=DEV))
           for d in dims]
    xs = x[:1, :37]
    small_nbr = gather_neighbors(xs, ops_common.select_smallest(
        ops_common.square_distance3(xs, xs), 16))
    errs = {}
    for dt, lim in ((torch.float32, LIM_DGCNN_F32), (torch.bfloat16, LIM_DGCNN_BF16)):
        for xx, nb, k in ((x, nbr, KNN), (xs, small_nbr, 16)):
            out = dgcnn_edges(xx, nb, ws, aff, k, dt)
            torch.cuda.synchronize()
            ref = dgcnn_edges_reference(xx, nb, ws, aff, k, dt)
            assert out.dtype == dt and out.shape == ref.shape
            err = (out.float() - ref.float()).abs().max().item()
            print(f"dgcnn_edges {tuple(nb.shape)} {dt}: max|kernel - plain| = "
                  f"{err:.3g} (limit {lim}), max|plain| = "
                  f"{ref.float().abs().max().item():.3g}")
            assert torch.isfinite(out.float()).all() and err <= lim
            errs[dt] = max(errs.get(dt, 0.0), err)
    bf = torch.bfloat16
    ms = cuda_ms(lambda: dgcnn_edges(x, nbr, ws, aff, KNN, bf), 5)
    ms32 = cuda_ms(lambda: dgcnn_edges(x, nbr, ws, aff, KNN, torch.float32), 3)
    plain = cuda_ms(lambda: dgcnn_edges_reference(x, nbr, ws, aff, KNN, bf), 2)
    rows = 2 * N_INDOOR
    stage_macs = 6 * 64 + 64 * 64 + 64 * 128 + 128 * 256
    flops = 2.0 * rows * (KNN * stage_macs + sum(STAGES) * EMB)
    nbytes = x.numel() * 4 + nbr.numel() * 4 + rows * EMB * 2
    t_ops, t_bytes = flops / PEAK_FLOPS["bf16"], nbytes / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    print(f"dgcnn_edges (2, {N_INDOOR}, k={KNN}): {ms:.3f} ms bf16, {ms32:.3f} "
          f"ms float32, plain {plain:.3f} ms, bound {bound:.4f} ms")
    return {"name": "dgcnn_edges", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/dgcnn_eval.cu",
            "replaces": "ogmm_tpu/ops/pallas_dgcnn.py:315",
            "max_abs_err": errs[bf], "max_abs_err_f32": errs[torch.float32],
            "ms": ms, "ms_f32": ms32, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def serve_indoor(rs):
    """`Registrar(configs.indoor(...))` at B=1, N=35,000, K=16, bf16 body:
    bench.py's synthetic fragment against a rigid copy of itself. Launches
    of one request without and with ICP (knn_stream 1 for the 2B stacked
    clouds, wproject 2, nn1_stream 1 for the clustering loss and one a trip
    of ICP), three timed requests of each, the peak device memory, the
    same request through the plain versions, and with dgcnn_fused_edges=True
    (dgcnn_edges 1)."""
    def registrar(**over):
        cfg = configs.indoor()
        return Registrar(cfg.replace(model=dataclasses.replace(
            cfg.model, dtype="bfloat16", **over)), seed=0, device=DEV)

    reg = registrar()
    m = reg.cfg.model
    assert (m.n_clusters, m.km_clusters, m.emb_dims, m.gnn_k) == (16, 16, EMB, KNN)
    requests = [rigid_copies(rs, surface(rs, 1)) for _ in range(3)]
    reg(requests[0][0], requests[0][1], refine=True)        # warm up
    torch.cuda.synchronize()
    launches, times, outs, peak = {}, {}, {}, {}
    for refine in (False, True):
        src, tgt, _, _ = requests[0]
        dispatch.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        reg(src, tgt, refine=refine)
        torch.cuda.synchronize()
        launches[refine] = dict(dispatch.launch_counts)
        peak[refine] = torch.cuda.max_memory_allocated() / 2 ** 20
        t0 = time.perf_counter()
        for src, tgt, _, _ in requests:
            outs[refine] = reg(src, tgt, refine=refine)
        torch.cuda.synchronize()
        times[refine] = (time.perf_counter() - t0) / len(requests) * 1e3
        for o in outs[refine]:
            assert torch.isfinite(o).all()
        r = outs[refine][0]
        assert r.shape == (1, 3, 3) and outs[refine][2].shape == (1, N_INDOOR)
        assert (r @ r.transpose(1, 2) - torch.eye(3, device=DEV)).abs().max() < 1e-4
    print(f"indoor request (B=1, N={N_INDOOR}, K=16, bf16): {times[False]:.2f} ms "
          f"without ICP, {times[True]:.2f} ms with ICP (host clock, three "
          f"requests each); peak device memory {peak[False]:.0f} / "
          f"{peak[True]:.0f} MiB; launches {launches[False]} / {launches[True]}")
    expect = {"knn_stream": 1, "wproject": 2, "dgcnn_edges": 0, "knn": 0,
              "nn1": 0, "dgcnn_eval": 0, "sinkhorn_em": 0, "posenc_angles": 0}
    for refine, n_nn1 in ((False, 1), (True, 1 + m.icp_iters)):
        got = {name: launches[refine][name] for name in expect}
        assert got == expect and launches[refine]["nn1_stream"] == n_nn1, launches

    src, tgt, rot, _ = requests[-1]
    with plain_versions():
        before = dict(dispatch.launch_counts)
        p_rot, _, p_so, p_to = reg(src, tgt, refine=True)
        assert dict(dispatch.launch_counts) == before
    k_rot, _, k_so, k_to = outs[True]
    d_o = max((k_so - p_so).abs().max().item(), (k_to - p_to).abs().max().item())
    ang = angle_deg(k_rot, p_rot).max().item()
    gt = torch.tensor(rot, device=DEV)
    print(f"indoor kernel path against plain path: overlap scores {d_o:.3g} "
          f"(limit {LIM_OVERLAP}), refined rotation {ang:.3g} deg (limit "
          f"{LIM_ROT_DEG}); rotation error against the true pose "
          f"{angle_deg(k_rot, gt).max().item():.3g} deg (random weights)")
    assert d_o <= LIM_OVERLAP and ang <= LIM_ROT_DEG

    reg_e = registrar(dgcnn_fused_edges=True)
    src, tgt, _, _ = requests[0]
    reg_e(src, tgt, refine=False)
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    t0 = time.perf_counter()
    e_rot, _, e_so, e_to = reg_e(src, tgt, refine=True)
    torch.cuda.synchronize()
    e_ms = (time.perf_counter() - t0) * 1e3
    e_launches = dict(dispatch.launch_counts)
    n_rot, _, n_so, n_to = reg(src, tgt, refine=True)
    d_e = max((e_so - n_so).abs().max().item(), (e_to - n_to).abs().max().item())
    ang_e = angle_deg(e_rot, n_rot).max().item()
    print(f"indoor request with dgcnn_fused_edges=True: {e_ms:.2f} ms with ICP, "
          f"launches {e_launches}; against the unfused stage chain: overlap "
          f"{d_e:.3g} (limit {LIM_OVERLAP}), rotation {ang_e:.3g} deg (limit "
          f"{LIM_ROT_DEG})")
    assert e_launches["dgcnn_edges"] == 1 and e_launches["knn_stream"] == 1
    assert d_e <= LIM_OVERLAP and ang_e <= LIM_ROT_DEG
    launches_all = dict(launches[True])
    launches_all["dgcnn_edges"] = e_launches["dgcnn_edges"]
    return launches_all, {"forward": times[False], "forward_icp": times[True],
                          "forward_icp_fused_edges": e_ms,
                          "peak_mib": peak[False], "peak_mib_icp": peak[True],
                          "launches_no_icp": launches[False]}



# ------------------------------------- the whole-loop and fused kernels

LOOP_KERNELS = ("fps", "icp", "pointmlp")


def check_pointmlp(rs):
    """The fused PointMLP against its plain version at the attention blocks'
    call (2B=48 clouds of 717 points, 1024 -> 1024 -> 512, bf16), in float32
    too, and at (3, 90, 128 -> 128 -> 64), N not a multiple of the kernel's
    row tile; timed at the path's call."""
    def inputs(b, n, cin, h, cout):
        w = lambda *sh: torch.tensor(
            rs.randn(*sh).astype(np.float32) / np.sqrt(sh[-1]), device=DEV)
        x = torch.tensor(rs.randn(b, n, cin).astype(np.float32), device=DEV)
        return x, w(h, cin), w(h) * 0.3, w(cout, h), w(cout) * 0.3

    path = inputs(2 * B, N, 2 * EMB, 2 * EMB, EMB)
    errs = {}
    for args in (path, inputs(3, 90, 128, 128, 64)):
        for dt, lim in ((torch.float32, LIM_MLP_F32), (torch.bfloat16, LIM_MLP_BF16)):
            x = args[0].to(dt)
            out = cuda_mlp.pointmlp_eval(x, *args[1:], dt)
            torch.cuda.synchronize()
            ref = cuda_mlp.pointmlp_eval_reference(x, *args[1:], dt)
            assert out.dtype == dt and out.shape == ref.shape
            err = (out.float() - ref.float()).abs().max().item()
            print(f"pointmlp {tuple(x.shape)} -> {out.shape[-1]} {dt}: max|kernel - "
                  f"plain| = {err:.3g} (limit {lim}), max|plain| = "
                  f"{ref.float().abs().max().item():.3g}")
            assert torch.isfinite(out.float()).all() and err <= lim
            errs[dt] = max(errs.get(dt, 0.0), err)
    bf = torch.bfloat16
    xb, x32 = path[0].to(bf), path[0]
    ms = cuda_ms(lambda: cuda_mlp.pointmlp_eval(xb, *path[1:], bf), 10)
    ms32 = cuda_ms(lambda: cuda_mlp.pointmlp_eval(x32, *path[1:], torch.float32), 3)
    plain = cuda_ms(lambda: cuda_mlp.pointmlp_eval_reference(xb, *path[1:], bf), 3)
    rows, cin, h, cout = 2 * B * N, 2 * EMB, 2 * EMB, EMB
    flops_bf16 = 2.0 * rows * (cin * h + h * cout)
    flops_f32 = 10.0 * rows * h                      # moments, normalise, ReLU
    nbytes = 2 * (rows * cin + h * cin + h + cout * h + cout + rows * cout)
    t_ops = flops_bf16 / PEAK_FLOPS["bf16"] + flops_f32 / PEAK_FLOPS["f32"]
    t_bytes = nbytes / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    print(f"pointmlp ({rows // N}, {N}, {cin} -> {h} -> {cout}): {ms:.3f} ms bf16, "
          f"{ms32:.3f} ms float32, plain {plain:.3f} ms, bound {bound:.4f} ms")
    return {"name": "pointmlp", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/pointmlp.cu",
            "replaces": "ogmm_tpu/ops/pallas_mlp.py:84",
            "max_abs_err": errs[bf], "max_abs_err_f32": errs[torch.float32],
            "ms": ms, "ms_f32": ms32, "plain_ms": plain, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def _fps_state(rs, x):
    """fps_combined's 2R rows of R clouds: random starts at distance 1e10,
    centre starts with the distances to the centroid."""
    R, n, _ = x.shape
    d_c, s_c = ops_fps._center_state(x)
    start = torch.tensor(rs.randint(0, n, R), device=DEV)
    return (torch.cat([x, x]), torch.cat([torch.full_like(d_c, 1e10), d_c]),
            torch.cat([start, s_c]))


def check_fps(rs):
    """The FPS kernel against its plain loop, identical ids: fps_combined's
    96 rows of 717 points (the path's call), 2B clouds of 1433, the indoor
    request's 4 rows of 35,000 (distances in L2), each with a duplicated
    point; timed at the path's call and at 35,000."""
    shapes = [(2 * B, N), (2 * B, N_LARGE), (2, N_INDOOR)]
    worst, timed = 0, {}
    for b, n in shapes:
        xs, dist, start = _fps_state(rs, _cloud(rs, b, n))
        got = cuda_fps.fps(xs, K, dist, start)
        torch.cuda.synchronize()
        want = cuda_fps.fps_reference(xs, K, dist, start)
        same = torch.equal(got, want)
        worst = max(worst, (got - want).abs().max().item())
        print(f"fps ({2 * b} rows of {n}, {K} steps): ids identical {same}")
        assert same and got.dtype == torch.int64
        timed[n] = (xs, dist, start)
    xs, dist, start = timed[N]
    ms = cuda_ms(lambda: cuda_fps.fps(xs, K, dist, start), 20)
    plain = cuda_ms(lambda: cuda_fps.fps_reference(xs, K, dist, start), 3)
    xi, di, si = timed[N_INDOOR]
    ms_indoor = cuda_ms(lambda: cuda_fps.fps(xi, K, di, si), 3)
    rows = 4 * B
    # a step: three differences, three squares, two sums, a minimum and a
    # compare a point
    bound, by = _bound(rows * N * K * 10.0, rows * N * 16 + rows * 8 + rows * K * 8)
    print(f"fps ({rows} rows of {N}, {K} steps): {ms:.4f} ms, plain {plain:.3f} ms, "
          f"bound {bound:.5f} ms ({by}); (4 rows of {N_INDOOR}) {ms_indoor:.4f} ms")
    return {"name": "fps", "route": "cuda", "source": "ogmm_tpu_torch/csrc/fps.cu",
            "replaces": "ogmm_tpu/ops/pallas_fps.py:74",
            "max_abs_err": float(worst), "ms": ms, "ms_indoor_rows": ms_indoor,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def _icp_inputs(rs, b, n, m, far=()):
    """Rigid pairs (src of n points, tgt a moved copy cut or padded to m
    points), an init pose about 3 degrees off; the clouds in `far` get a
    target 100 away (no inlier in any trip)."""
    src, tgt, rot, trans = make_pairs(rs, b, n)
    if m > n:
        tgt = np.concatenate([tgt, (rs.randn(b, m - n, 3) * 0.3 + 1).astype(np.float32)], 1)
    src, tgt, rot, trans = (torch.tensor(a, device=DEV) for a in (src, tgt[:, :m], rot, trans))
    for i in far:
        tgt[i] += 100.0
    d = torch.tensor(rs.uniform(-0.03, 0.03, (b, 3)).astype(np.float32), device=DEV)
    skew = torch.zeros(b, 3, 3, device=DEV)
    skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = -d[:, 2], d[:, 1], -d[:, 0]
    skew = skew - skew.transpose(1, 2)
    return src, tgt, se3.integrate(torch.linalg.matrix_exp(skew) @ rot, trans)


def check_icp_kernel(rs):
    """The whole-loop ICP against its plain version, 30 trips at the
    refined request's gate (0.07): the first trip's correspondences
    identical, the final poses within LIM_ICP_POSE; at the path's call (24,
    717, 717), at N=1433, at N != M, with a cloud without inliers (its pose
    kept exactly) and at the envelope M = 4096; timed at the path's call and
    at N=1433."""
    thr2 = (2.0 * configs.ModelConfig().overlap_radius) ** 2
    cases = [(B, N, N, ()), (B, N_LARGE, N_LARGE, ()), (8, N, 600, (3,)),
             (8, 500, 900, ()), (4, 4096, 4096, (0,))]
    worst, timed = 0.0, {}
    for b, n, m, far in cases:
        src, tgt, init = _icp_inputs(rs, b, n, m, far)
        r, t, first = cuda_icp.icp_fused(src, tgt, init, thr2, return_first=True)
        torch.cuda.synchronize()
        rr, rt, rfirst = cuda_icp.icp_fused_reference(src, tgt, init, thr2,
                                                      return_first=True)
        same = torch.equal(first, rfirst)
        err = max((r - rr).abs().max().item(), (t - rt).abs().max().item())
        kept = all(torch.equal(r[i], init[i, :3, :3]) and torch.equal(t[i], init[i, :3, 3])
                   for i in far)
        print(f"icp ({b}, {n}, {m}), 30 trips: first trip's 1-NN identical {same}, "
              f"max|pose kernel - plain| = {err:.3g} (limit {LIM_ICP_POSE}); "
              f"clouds without inliers {list(far)} keep their pose {kept}")
        assert same and kept and err <= LIM_ICP_POSE
        assert torch.isfinite(r).all() and torch.isfinite(t).all()
        worst = max(worst, err)
        timed[(n, m)] = (src, tgt, init)
    ms = cuda_ms(lambda: cuda_icp.icp_fused(*timed[(N, N)], thr2), 10)
    ms_large = cuda_ms(lambda: cuda_icp.icp_fused(*timed[(N_LARGE, N_LARGE)], thr2), 5)
    plain = cuda_ms(lambda: cuda_icp.icp_fused_reference(*timed[(N, N)], thr2), 2)
    # a trip: 8 operations a distance and a compare a pair; moving a point,
    # its moments and covariance about 60
    bound, by = _bound(30 * B * (N * N * 9.0 + N * 60.0), B * (2 * N * 12 + 2 * 48))
    print(f"icp ({B}, {N}, {N}), 30 trips: {ms:.4f} ms, plain {plain:.3f} ms, "
          f"bound {bound:.5f} ms ({by}); ({B}, {N_LARGE}, {N_LARGE}) {ms_large:.4f} ms")
    return {"name": "icp", "route": "cuda", "source": "ogmm_tpu_torch/csrc/icp.cu",
            "replaces": "ogmm_tpu/ops/pallas_icp.py:152",
            "max_abs_err": worst, "ms": ms, "ms_n1433": ms_large,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def serve_loops(rs):
    """The refined request of `serve` (B=24, N=717, bf16) through a
    Registrar with `loop_kernels=True` and one without, on the same weights:
    launches of one request (fps 1, pointmlp 3, icp 1), the request time of
    each on the same requests (on, off, off, on), the peak device memory of
    each, and the refined rotation and overlap scores against the one
    without and against the plain versions."""
    cfg = configs.mnet(model=configs.ModelConfig(dtype="bfloat16"))
    regs = {on: Registrar(cfg, seed=0, device=DEV, loop_kernels=on)
            for on in (True, False)}
    requests = [make_pairs(rs, B, N) for _ in range(3)]
    for reg in regs.values():
        reg(requests[0][0], requests[0][1], refine=True)   # warm up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    regs[True](requests[0][0], requests[0][1], refine=True)
    torch.cuda.synchronize()
    launches = dict(dispatch.launch_counts)
    print("kernel launches in one refined request with loop_kernels:", launches)
    want = {"fps": 1, "pointmlp": 3, "icp": 1, "dgcnn_eval": 1, "sinkhorn_em": 1}
    assert {k: launches[k] for k in want} == want, launches
    times, peak, outs = {True: [], False: []}, {}, {}
    for on in (True, False, False, True):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for src, tgt, _, _ in requests:
            outs[on] = regs[on](src, tgt, refine=True)
        torch.cuda.synchronize()
        times[on].append((time.perf_counter() - t0) / len(requests) * 1e3)
        peak[on] = torch.cuda.max_memory_allocated() / 2 ** 20
        for o in outs[on]:
            assert torch.isfinite(o).all()
        r = outs[on][0]
        eye = torch.eye(3, device=DEV).expand(B, 3, 3)
        assert (r @ r.transpose(1, 2) - eye).abs().max() < 1e-4
    print(f"refined request of {B} pairs: {times[True]} ms with loop_kernels, "
          f"{times[False]} ms without (host clock, three requests a round); "
          f"peak device memory {peak[True]:.0f} / {peak[False]:.0f} MiB")
    src, tgt, _, _ = requests[-1]
    with plain_versions():
        before = dict(dispatch.launch_counts)
        p_rot, _, p_so, p_to = regs[True](src, tgt, refine=True)
        assert dict(dispatch.launch_counts) == before
    k_rot, _, k_so, k_to = outs[True]
    res = {}
    for name, (rot, so, to) in (("loop_kernels off", outs[False][:1] + outs[False][2:]),
                                ("plain versions", (p_rot, p_so, p_to))):
        d_o = max((k_so - so).abs().max().item(), (k_to - to).abs().max().item())
        ang = angle_deg(k_rot, rot)
        print(f"loop_kernels on against {name}: overlap scores {d_o:.3g} (limit "
              f"{LIM_OVERLAP}), refined rotation median {ang.median().item():.3g} "
              f"deg (limit {LIM_ROT_DEG}), max {ang.max().item():.3g} deg")
        assert d_o <= LIM_OVERLAP and ang.median().item() <= LIM_ROT_DEG
        res[name] = {"overlap": d_o, "rot_median_deg": ang.median().item(),
                     "rot_max_deg": ang.max().item()}
    return launches, {"forward_icp_on": times[True], "forward_icp_off": times[False],
                      "peak_mib_on": peak[True], "peak_mib_off": peak[False],
                      "against": res}


PHASES = ("kernels", "serve", "train", "cli", "icp", "serve_large",
          "train_large", "train_unfused", "c1", "indoor_kernels", "indoor",
          "loop_kernels", "serve_loops")


def main():
    only = None
    if len(sys.argv) == 3 and sys.argv[1] == "--only":
        only = set(sys.argv[2].split(","))
        assert only <= set(PHASES), f"phases are {PHASES}"
    elif len(sys.argv) != 1:
        sys.exit(f"usage: chip_smoke.py [--only PHASE[,PHASE...]] ({PHASES})")
    run = lambda phase: only is None or phase in only
    rs = np.random.RandomState(0)
    t0 = time.perf_counter()
    dispatch.build_kernels()
    print(f"built {', '.join(dispatch.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    kernels, out = [], {}
    if run("kernels"):
        kernels += [check_dgcnn(rs), check_em(rs), check_graph_stage1(rs),
                    check_nn1(rs), *check_dgcnn_bwd(rs), check_knn(rs),
                    check_posenc_angles(rs)]
    if run("indoor_kernels"):
        # a generator of their own: the phases of the earlier slices see the
        # data they saw before these were added
        rs_indoor = np.random.RandomState(7)
        kernels += [check_dgcnn_edges(rs_indoor), check_knn_stream(rs_indoor),
                    check_nn1_stream(rs_indoor), check_wproject(rs_indoor)]
    if run("loop_kernels"):
        rs_loops = np.random.RandomState(9)
        kernels += [check_pointmlp(rs_loops), check_fps(rs_loops),
                    check_icp_kernel(rs_loops)]
    # each phase's launches are read right after it ran with the counts at 0;
    # the phases of the earlier slices in their order, then the indoor one
    paths = {}
    for phase, fn in (("serve", serve), ("train", train),
                      ("cli", lambda rs: run_cli()),
                      ("icp", check_icp), ("serve_large", serve_large),
                      ("train_large", train_large),
                      ("train_unfused", train_unfused), ("c1", check_c1),
                      ("indoor", lambda _: serve_indoor(np.random.RandomState(8))),
                      ("serve_loops", lambda _: serve_loops(np.random.RandomState(10)))):
        if not run(phase):
            continue
        res = fn(rs)
        if isinstance(res, tuple):
            paths[phase], out[phase] = res
        elif res is not None:
            out[phase] = res
    out["shape"] = {"B": B, "N": N, "N_large": N_LARGE, "N_indoor": N_INDOOR,
                    "emb": EMB, "K": K}
    print(json.dumps(out))
    if only is None:
        # each kernel's launches on the path it was ported for: the serving
        # forward (N=717) for kernels 1-2, the training step for 3-7, the
        # large-cloud request for the kNN kernel, the unfused step for the
        # angle kernel, the indoor request for kernels 10-13 (dgcnn_edges
        # with dgcnn_fused_edges=True), the refined request with
        # loop_kernels=True for kernels 14-16
        main_path = {"dgcnn_eval": "serve", "sinkhorn_em": "serve",
                     "knn": "serve_large", "posenc_angles": "train_unfused",
                     **{name: "indoor" for name in INDOOR_KERNELS},
                     **{name: "serve_loops" for name in LOOP_KERNELS}}
        for k in kernels:
            name = k["name"]
            k["launches"] = paths[main_path.get(name, "train")][name]
            for phase, launches in paths.items():
                k[f"launches_{phase}"] = launches[name]
        print(json.dumps({"kernels": kernels}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
