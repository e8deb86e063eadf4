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
             bf16, each launched twice and compared bit for bit; the 1-NN
             also at the N=1433 request's ICP trips, 1433 x 1433), with the
             limits stated below, and timed beside its plain version and its
             bound; the kNN graphs of dgcnn_eval, graph_stage1 and
             posenc_angles (the shared selection) identical to the plain
             ones; dgcnn_eval's selection launch and its stage chain with
             the head (bf16; float32: the selection, the 3xTF32 stage chain
             and the head), the angle kernel's launch, and graph_stage1's
             selection and edge pass, timed apart (torch.profiler),
             graph_stage1 and nn1 launched twice and
             compared bit for bit, sinkhorn_em's time a pass and the clouds
             the card runs at once, nn1's device time and time between
             calls at each shape, the device time of each __global__ of the
             bwd_stage calls (stages 4, 3, 2 and the partial sums; bf16 on
             wgmma, float32 on mma.sync in 3xTF32) and of the bwd_edge call
             (bf16: the one pass, its sums, the scatter; float32: the row,
             weight-gradient and scatter kernels)
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
             kernels and their plain versions; one `make_eval_step` with ICP;
             then the float32 body's step (`configs.mnet()`): launches with
             the switch, three steps on and off in turns, one step from the
             same state on against off (loss and gradients within 1e-3)
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
             M=8192; and those it raised on before its routes read the eval
             kernels' envelope (faults C.2, C.3): `Registrar` at emb_dims=96
             (N=717) and with dgcnn_fused_edges=True at gnn_k=33 (N=2048);
             the launch counts show each route
 12. knn_stream, nn1_stream, wproject, dgcnn_edges   the streamed kernels
             and the edges kernel against their plain versions at the indoor
             shapes (2 clouds of 35,000 points, k=20; an ICP trip at
             (1, 35000, 35000) with the cull and the gate; the clustering's
             (2, 16, 35000); the overlap head at (1, 35000, 35000, D=512)
             bf16) and at small awkward ones (N not a multiple of the tile,
             M just above 4096, k=1, coincident points, float32); the kNN
             kernel's visits (tile pairs searched against those needed, the
             heaviest block's tiles, the share of distances formed)
 13. indoor  `Registrar(configs.indoor(...))` at B=1, N=35,000, K=16, bf16
             body, on bench.py's synthetic surface with a rigid copy as
             target: with and without ICP, and with dgcnn_fused_edges=True;
             launches, request times, peak memory, rotation and overlap
             scores against the same request through the plain versions
 14. pointmlp, fps, icp   the fused attention MLP (with the device time of
             its two products and its moments launch, bf16 and float32 (in
             3xTF32, with its weights' TF32 planes), and the eager float32
             chain `PointMLP(fuse_eval=False)` on the same weights), the FPS
             chain and the
             whole-loop ICP against their plain versions at the refined
             request's calls (48 clouds of 717, 1024 -> 1024 -> 512 bf16;
             96 rows of 717, 128 steps; 24 pairs of 717, 30 trips; FPS also
             at the indoor request's 4 rows of 35,000 and 16 steps) and at
             awkward ones (float32, N not a multiple of the tile; N = 1433
             and 35,000 with tied distances, 35,000 at every compiled
             cluster shape near the plan's, 140,000 on the L2 route, an
             all-equal cloud; N != M, a cloud without inliers, M = 4096, 48
             clouds): FPS ids and ICP's first-trip correspondences
             identical, poses and outputs within limits, a relaunch of ICP
             bit-equal, each FPS call's plan and each ICP call's cluster
             shape
 15. serve_loops   the refined N=717 request of phase 3 through a
             Registrar with `loop_kernels=True` (FPS, ICP and the three
             attention MLPs through their kernels) beside one without, on
             the same weights: launches (fps 1, pointmlp 3, icp 1), request
             times of both, peak memory, rotation and overlap scores against
             the one without and against the plain versions; then the same
             at the float32 body `configs.mnet()` gives by default
 16. serve_f32     the request `Registrar(configs.mnet())` gives by default:
             the float32 body at B=24, N=717, emb 512, K=128 (its DGCNN
             through the 3xTF32 stage chain of dgcnn_eval), without and with
             ICP: launches (dgcnn_eval 1, sinkhorn_em 1), request times, peak
             memory, rotation and overlap scores against the plain versions
 17. train_indoor  `make_train_step(configs.indoor())`, float32 body, B=2
             pairs of N=35,000: the streamed overlap head trains through
             the chunked recompute of `ops.stream.wproject`; launches, step
             time, peak memory, no (N, N) allocation, every parameter moved;
             one step against the plain versions; the bf16 step once; the
             CLI (`--preset indoor --dataset 7scene`) on stand-in fragments
             of scripts/gen_indoor_fragments.py, the loader's time a batch.
             Phase 12's wproject entry also times the float32 form at the
             indoor call and the head's backward
 18. deepgmr       the JAX package's second model at its full width,
             `Registrar(configs.mnet(model_name="DeepGMR"))` (emb 512,
             K=128, k=20, float32 body), seeded weights, on modelnetdv test
             batches (B=24 pairs of 768 against 1536 points, the synthetic
             source): requests without and with ICP, loop_kernels off and
             on: launches (dgcnn_eval 1 for src, knn 1 for tgt's graph, nn1
             30 or icp 1), each kernel's __global__ counted by torch.profiler
             beside its wrapper's count, host and CUDA-event times, peak
             memory; the moments and poses against the plain versions; the
             train step (graph_stage1 1, knn 1, nn1 3): step time, peak
             memory, loss and gradients against the plain versions and with
             src's backward through the backward kernels; the CLI
             (`--model DeepGMR --dataset modelnetdv`): three steps, an eval
             batch with ICP, the export served back through
             `Registrar.from_weights`
 19. surface       the rest of the model surface, full width, seeded
             weights: (a) `Registrar(configs.serve())` (6 EM trips, bf16)
             at B=24, N=717 beside the bf16 `mnet` request in turns:
             launches, host and CUDA-event times, device busy time and the
             EM kernel's, peak memory, against the plain versions; (b) the
             CLI of phase 5 into a temporary --model_path, then
             `Registrar.from_checkpoint`, `export_weights` and
             `from_weights`, and `registrar_from_torch_checkpoint` on the
             weights in the original code's key layout, each serving a
             request bit-equal to the trainer's model, and another emb_dims
             refused; (c) `refine_registration(pl=True)` from (a)'s estimate
             and from ~3 degrees off a known pose at (24, 717), (24, 1433)
             and (1, 35000) (normals through knn or knn_stream at k=16,
             trips dense, through nn1 or nn1_stream): launches, times, peak
             memory, against the plain versions, the pose recovered; (d)
             `use_grid=True` at (1, 35000) for both ICPs against the spatial
             route, the densest cell against the cap; (e) recompute_anchors
             with and without loop_kernels, stack_eval=False, a stack_train
             step against the plain versions, a remat step against the step
             without it (loss and statistics bit-equal, peak memory); (f)
             knn at (24, 717, 717, k=16) and knn_stream at (1, 35000, 35000,
             k=16) against their plain versions (`at_surface`)
 20. distributed   distribution over torch.distributed: (a)
             `Registrar.sharded` at world 1 over NCCL (the indoor request,
             B=1, N=35,000, float32 body) against the unsharded request on
             the same pair, with and without ICP and at one EM trip
             (launches, host and busy ms, peak memory); (b) the same at
             world 2, two spawned processes on the one card over gloo, once
             gloo's all_reduce, all_gather and broadcast are seen to take
             CUDA tensors; (c) the data-parallel step at B=24, N=717,
             float32 and bf16, at world 1 and 2 against the single-process
             step on the same 24 pairs, the ranks' parameters and
             statistics bit-equal; (d) `python -m ogmm_tpu_torch.train
             --multihost` under torchrun's environment at world 1; rows
             11-13 at world 2's sharded shapes against their plain versions
             (`at_sp`). Two processes on one card check the arithmetic and
             the shard-shaped kernels, not scaling
 21. envelopes     the kernels past their earlier envelopes, emb 512, K=128,
             4 heads, 10 EM x 10 Sinkhorn trips, seeded weights: (a)
             dgcnn_eval at k = 4, 12, 25, 32 (2B=48 clouds of 717, bf16 and
             float32), dgcnn_edges at k = 12 (2 clouds of 35,000) and 5 (37
             points), graph_stage1 at k = 12 and 32 (24 clouds of 717),
             sinkhorn_em at (8, 5734, 128), (8, 4096, 128) and (8, 2867,
             256) (clusters of 16 blocks) and, above K = 256 (16 or 32
             lanes a row), at (48, 717, 512), (24, 1433, 512), (8, 2000,
             257), (8, 857, 856) and (8, 717, 1023) (per trip and after 10
             trips, relaunched bit-equal, with the cluster size and the
             clusters the card runs at once),
             the five DGCNN backward calls (bwd_reduce, bwd_stage x 3,
             bwd_edge) of a real backward at k = 1, 12, 32 (24 clouds of
             717, bf16 and float32) and at k = 32 over 24 clouds of 1024,
             each launched twice (bit-equal), against its plain version,
             timed beside it and its bound (`at_envelopes` in the kernels
             line); (b) `Registrar(configs.mnet(gnn_k=12))` at B=24, N=717,
             float32 and bf16 (dgcnn_eval 1, sinkhorn_em 1); (c) one train
             step of it with the backward kernels on (graph_stage1 2,
             bwd_reduce 2, bwd_stage 6, bwd_edge 2), its loss bit-equal with
             the switch off and its gradients close, and against the plain
             versions; (d) a request at B=8,
             N=4,096, K=128 (sinkhorn_em 1, the JAX rule's kernel); (e) the
             CLI with --profile_dir for 12 steps: a Chrome trace of steps
             [5, 10) naming the port's kernels; (f) the indoor request at
             gnn_k=12 with dgcnn_fused_edges=True (dgcnn_edges 1); (g)
             `Registrar(configs.mnet(model=ModelConfig(n_clusters=512)))`
             at B=24, N=717, float32 (sinkhorn_em 1, a cluster of 8; host
             and busy ms beside the same request with the plain EM route,
             in turns) and one train step of it (sinkhorn_em 1). Above
             k = 32 (the wide selection of csrc/knn_wide.cuh, the stage
             chain in chunks of 32): part (a) also holds dgcnn_eval and
             graph_stage1 at k = 33, 40, 64 and 717 over 24 clouds of 717
             and at k = 1024 over 8 of 1024, knn at k = 40, 64, 1433 over
             48 clouds of 1433 and at k = 1024 over 8 of 4,096, and
             dgcnn_edges at k = 40 over the indoor cloud against their plain
             versions (indices and e identical, a relaunch bit-equal); (h)
             at gnn_k = 40, the DGCNN authors' ModelNet40 graph: the float32
             and bf16 requests at (24, 717) (dgcnn_eval 1), the request at
             (24, 1433) (knn 1), one train step with the backward kernels
             on (graph_stage1 2, the backward plain), the CLI for three
             steps (graph_stage1 6) and the indoor request with
             dgcnn_fused_edges=True (dgcnn_edges 1, its graph from the plain
             chunked kNN)

`python3 chip_smoke.py --only PHASE[,PHASE...]` runs the named phases
(build always runs; the names are those of PHASES below) and prints their
results without the kernels line.

Prints the request and step times, one JSON object {"kernels": [...]} on a
line of its own, the `nvidia-smi` name and power limit, and as the last line
{"ok": true, "device": {...}}.
"""
import contextlib
import dataclasses
import itertools
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
    from ogmm_tpu_torch.ops import cuda_dgcnn, cuda_em, cuda_fps, cuda_icp, cuda_mlp
    from ogmm_tpu_torch.ops import cuda_dgcnn_bwd
    from ogmm_tpu_torch.ops import fps as ops_fps
    from ogmm_tpu_torch.nn import gmmreg as nn_gmmreg
    from ogmm_tpu_torch.nn.layers import PointMLP
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
N_FPS_L2 = 140000        # FPS rows past what a cluster holds in registers

# published peaks of one H100 SXM
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# float32 operations a (query, point) pair of a k-nearest selection costs at
# the least, at any k: 8 of the distance and a compare (a selection of the k
# smallest need not touch a pair more than once)
PAIR_FLOPS = 9.0

# limits, kernel against plain version on the card
LIM_DGCNN_F32 = 1e-4     # each float32 product as three TF32 products on
#                          the tensor cores (operands split into TF32 high
#                          and low parts: about 2^-22 of each product from
#                          float32), float32 sums in another order
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
# one float32 indoor train step with kernels against the same with plain
# versions: the kNN and 1-NN indices are identical, the head's out and lse
# 1e-6 apart; the ten EM trips amplify that into the loss (as for the
# unfused step), and the step's gradient is piecewise smooth (max over k,
# LeakyReLU, ReLU): at N = 4,300 moving every weight by 1e-7 of its value
# moves the gradients by 4.4e-4 (tests/test_torch_indoor_train.py); the
# gradient limit is about twice that
LIM_INDOOR_LOSS = 1e-3   # relative difference of the loss
LIM_INDOOR_GRAD = 1e-3   # |g_kernel - g_plain| / |g_plain| over all params
# The step is also discontinuous: the clustering loss takes the features of
# the point nearest each cluster mean (ops.gmm.get_local_corrs), and where
# two points lie almost equally near a mean, moving the head's output by a
# quarter of its round-off against the plain version (~2e-8) flips that
# choice and the loss by 6e-4 (a state reached after five float32 steps,
# where the earlier CUDA-core projection kernel flipped it as well). So the
# comparison holds that choice at the plain run's; the kernel run may
# choose otherwise at a near-tie, not at many anchors.
LIM_INDOOR_ANCHOR_FLIPS = 2   # of the 64 anchors (4 clouds x 16 clusters)


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


def device_trace(fn, reps=1):
    """torch.profiler's key averages of the card's activity in reps calls of
    fn. The first kernel records of a session have gone missing on the card
    (all of them, PR 22; a step's first one or two, PR 23): each session
    first runs four spin kernels (`torch.cuda._sleep`) and synchronises,
    and their records are left out. A session whose trace holds no kernel
    at all, though fn launches some, is a lost trace, not a count: it is
    taken again, at most three times, and then raises."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                torch.cuda._sleep(10000)
            torch.cuda.synchronize()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        avgs = [evt for evt in prof.key_averages() if "spin_kernel" not in evt.key]
        if any(evt.self_device_time_total > 0 for evt in avgs):
            return avgs
        print("torch.profiler: a trace without a kernel on the card, taken again",
              file=sys.stderr)
    raise RuntimeError("torch.profiler recorded no kernel on the card in 3 sessions")


def launch_ms(fn, reps, groups):
    """Device ms a call of each group of the kernels that fn launches, from
    torch.profiler: {label: ms}; a group is a tuple of kernel-name parts."""
    fn()
    torch.cuda.synchronize()
    out = {label: 0.0 for label in groups}
    for evt in device_trace(fn, reps):
        key = evt.key.replace(" ", "")
        for label, names in groups.items():
            if any(name.replace(" ", "") in key for name in names):
                out[label] += evt.device_time_total / 1e3 / reps
    return out


def f32_bound(products, other, nbytes):
    """A float32 form's bounds: its operations on the CUDA cores (67
    TFLOP/s), or its products as three TF32 products each on the tensor
    cores (495 TFLOP/s) and the rest on the CUDA cores, each against its
    bytes at 3.35 TB/s."""
    t_bytes = nbytes / PEAK_BYTES
    t_cc = (products + other) / PEAK_FLOPS["f32"]
    t_tc = 3 * products / PEAK_FLOPS["tf32"] + other / PEAK_FLOPS["f32"]
    return {"ms": max(t_cc, t_bytes) * 1e3, "ms_tf32x3": max(t_tc, t_bytes) * 1e3,
            "by": "operations" if t_cc >= t_bytes else "bytes"}


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

def _dgcnn_operands(rs, emb=EMB):
    """The DGCNN's five seeded float32 weights and folded BN (scale, bias)
    pairs, on the card."""
    dims = [(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]
    ws = [torch.tensor(rs.randn(*d).astype(np.float32) / np.sqrt(d[0]),
                       device=DEV) for d in dims]
    aff = [(torch.tensor(rs.uniform(0.5, 1.5, d[1]).astype(np.float32), device=DEV),
            torch.tensor(rs.randn(d[1]).astype(np.float32) * 0.1, device=DEV))
           for d in dims]
    return ws, aff


def check_dgcnn(rs):
    x = torch.tensor(rs.randn(2 * B, N, 3).astype(np.float32) * 0.3, device=DEV)
    ws, aff = _dgcnn_operands(rs)
    errs = {}
    # the graph its selection picks (the shared one of csrc/knn_lanes.cuh)
    graph = torch.empty(2 * B, N, KNN, dtype=torch.int32, device=DEV)
    cuda_dgcnn._dgcnn_eval_cuda(x, ws, aff, KNN, torch.bfloat16, POS_K, idx=graph)
    torch.cuda.synchronize()
    same_graph = torch.equal(graph.long(), knn_reference(x, x, KNN))
    print(f"dgcnn_eval selection (2B={2 * B}, N={N}, k={KNN}): indices identical "
          f"{same_graph}")
    assert same_graph
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
    bf, f32 = torch.bfloat16, torch.float32
    ms = cuda_ms(lambda: dgcnn_eval(x, ws, aff, KNN, bf, POS_K), 10)
    ms32 = cuda_ms(lambda: dgcnn_eval(x, ws, aff, KNN, f32, POS_K), 10)
    plain = cuda_ms(lambda: dgcnn_eval_reference(x, ws, aff, KNN, bf, POS_K), 2)
    plain32 = cuda_ms(lambda: dgcnn_eval_reference(x, ws, aff, KNN, f32, POS_K), 2)
    # the selection launch and the stage chain with its head, apart
    split = launch_ms(lambda: dgcnn_eval(x, ws, aff, KNN, bf, POS_K), 10, {
        "selection_ms": ("knn_kernel",),
        "stage_chain_ms": ("dgcnn_stage_mma_kernel", "dgcnn_head_kernel")})
    # float32: the selection, the 3xTF32 stage chain, the head
    split32 = launch_ms(lambda: dgcnn_eval(x, ws, aff, KNN, f32, POS_K), 10, {
        "selection": ("knn_kernel",), "stage_chain": ("dgcnn_stage_tf32_kernel",),
        "head": ("dgcnn_head_tf32_kernel",)})
    print(f"dgcnn_eval bf16 (2B={2 * B}, N={N}, k={KNN}, emb {EMB}): {ms:.4f} ms; "
          f"the selection (knn_kernel) {split['selection_ms']:.4f} ms, stage chain "
          f"and head {split['stage_chain_ms']:.4f} ms (device, torch.profiler)")
    rows = 2 * B * N
    stage_macs = 6 * 64 + 64 * 64 + 64 * 128 + 128 * 256
    flops_bf16 = 2.0 * rows * (KNN * stage_macs + sum(STAGES) * EMB)
    flops_f32 = rows * N * PAIR_FLOPS
    nbytes = (x.numel() * 4 + sum(w.numel() for w in ws) * 2
              + rows * EMB * 2 + rows * POS_K * 4)
    t_ops = flops_bf16 / PEAK_FLOPS["bf16"] + flops_f32 / PEAK_FLOPS["f32"]
    t_bytes = nbytes / PEAK_BYTES
    # float32: the products on the CUDA cores, or as three TF32 products each
    # on the tensor cores; the selection as above; float32 outputs
    bound32 = f32_bound(flops_bf16, flops_f32, nbytes + rows * EMB * 2
                        + sum(w.numel() for w in ws) * 2)
    print(f"dgcnn_eval float32: {ms32:.4f} ms, plain {plain32:.3f} ms; the selection "
          f"{split32['selection']:.4f} ms, the 3xTF32 stage chain "
          f"{split32['stage_chain']:.4f} ms, the head {split32['head']:.4f} ms "
          f"(device, torch.profiler); bound {bound32['ms_tf32x3']:.4f} ms on the "
          f"tensor cores, {bound32['ms']:.4f} ms on the CUDA cores")
    return {
        "name": "dgcnn_eval", "route": "cuda",
        "source": "ogmm_tpu_torch/csrc/dgcnn_eval.cu",
        "replaces": "ogmm_tpu/ops/pallas_dgcnn.py:229",
        "max_abs_err": errs[bf], "max_abs_err_f32": errs[f32],
        "ms": ms, "ms_f32": ms32, "plain_ms": plain, "plain_ms_f32": plain32,
        **split, "launch_ms_f32": split32,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "bound_ms_f32": bound32, "library_ms": None,
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
        again = graph_stage1(x, w1, KNN, dt, POS_K)
        assert all(torch.equal(a, b) for a, b in zip((z1, e, idx, alpha), again)), \
            "graph_stage1: two launches differ"
        errs[dt] = max(err, aerr)
    bf = torch.bfloat16
    ms = cuda_ms(lambda: graph_stage1(x, w1, KNN, bf, POS_K), 20)
    ms32 = cuda_ms(lambda: graph_stage1(x, w1, KNN, torch.float32, POS_K), 10)
    plain = cuda_ms(lambda: graph_stage1_reference(x, w1, KNN, bf, POS_K), 2)
    # each __global__ apart: the shared selection and the edge pass
    groups = {"selection_ms": ("knn_kernel",), "edge_pass_ms": ("edge_stage1_kernel",)}
    split = launch_ms(lambda: graph_stage1(x, w1, KNN, bf, POS_K), 20, groups)
    split32 = launch_ms(lambda: graph_stage1(x, w1, KNN, torch.float32, POS_K), 20,
                        groups)
    print(f"graph_stage1 ({B}, {N}, k={KNN}): bf16 {ms:.4f} ms, float32 {ms32:.4f} "
          f"ms; on the device (torch.profiler) the selection {split['selection_ms']:.4f}"
          f" / {split32['selection_ms']:.4f} ms, the edge pass "
          f"{split['edge_pass_ms']:.4f} / {split32['edge_pass_ms']:.4f} ms; a "
          f"relaunch bit-equal")
    rows = B * N
    flops_f32 = rows * N * PAIR_FLOPS        # the selection's pairs
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
        "ms": ms, "ms_f32": ms32, "plain_ms": plain, **split,
        "selection_ms_f32": split32["selection_ms"],
        "edge_pass_ms_f32": split32["edge_pass_ms"],
        "bound_ms_f32": f32_bound(flops_bf16, flops_f32,
                                  nbytes + rows * KNN * (64 + 6) * 2),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


def check_nn1(rs):
    """The 1-NN kernel against its plain version at the shapes its paths
    give it: the Welsch loss (512 queries), the clustering (128), the
    metrics (717) against 717 points, the N=1433 request's ICP trips (1433
    x 1433), and check_c1's clustering (4 clouds of 16 nodes against 2048
    points, 4 blocks: the queries leave SMs idle): identical indices,
    distances bit-equal (LIM_NN1_D = 0), a relaunch bit-equal; at each the
    time between calls and the kernel's own device time (a call of ~10 us
    is host-bound)."""
    worst = 0.0
    times = {}
    for b, nq, m in ((B, 512, N), (B, 128, N), (B, N, N), (B, N_LARGE, N_LARGE),
                     (4, 16, 2048)):
        tgt = torch.tensor(rs.randn(b, m, 3).astype(np.float32) * 0.3, device=DEV)
        src = torch.tensor(rs.randn(b, nq, 3).astype(np.float32) * 0.3, device=DEV)
        src[:, 0] = tgt[:, 3]                # an exact hit: the clamp
        d, i = nn1(src, tgt)
        torch.cuda.synchronize()
        rd, ri = nn1_reference(src, tgt)
        err = (d - rd).abs().max().item()
        same = torch.equal(i, ri)
        again = nn1(src, tgt)
        fixed = torch.equal(again[0], d) and torch.equal(again[1], i)
        call = lambda: nn1(src, tgt)
        ms = cuda_ms(call, 50)
        # a profile of ~10 us kernels has come back without their events
        # (0.0 ms); profile again, at most three times
        for _ in range(3):
            device_ms = launch_ms(call, 50, {"nn1": ("nn1_lanes_kernel",)})["nn1"]
            if device_ms > 0:
                break
        times[nq] = (ms, device_ms)
        plan = cuda_knn.nn1_plan(b, nq, cuda_stream._sm_count(0))
        print(f"nn1 ({b}, {nq}, {m}): indices identical {same}, max|d kernel - "
              f"plain| = {err:.3g} (limit {LIM_NN1_D}), a relaunch bit-equal "
              f"{fixed}; {ms:.4f} ms between calls, {device_ms:.4f} ms on the "
              f"device (torch.profiler), {plan}")
        assert same and fixed and err <= LIM_NN1_D and torch.isfinite(d).all()
        worst = max(worst, err)
    src = tgt = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=DEV)
    plain = cuda_ms(lambda: nn1_reference(src, tgt), 10)
    flops = B * N * N * PAIR_FLOPS
    nbytes = B * (N * 12 + N * 12 + N * (4 + 8))
    t_ops, t_bytes = flops / PEAK_FLOPS["f32"], nbytes / PEAK_BYTES
    bound_1433, _ = _bound(B * N_LARGE * N_LARGE * 9.0, B * N_LARGE * 48)
    return {
        "name": "nn1", "route": "cuda",
        "source": "ogmm_tpu_torch/csrc/nn1.cu",
        "replaces": "ogmm_tpu/ops/pallas_knn.py:187",
        "max_abs_err": worst, "ms": times[N][0], "device_ms": times[N][1],
        **{f"ms_q{nq}": t[0] for nq, t in times.items() if nq != N},
        **{f"device_ms_q{nq}": t[1] for nq, t in times.items() if nq != N},
        "bound_ms_q1433": bound_1433, "plain_ms": plain,
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }


BWD = {"bwd_reduce": (bwd_reduce, bwd_reduce_reference, 327),
       "bwd_stage": (bwd_stage, bwd_stage_reference, 378),
       "bwd_edge": (bwd_edge, bwd_edge_reference, 413)}


def bwd_calls(rs, dtype, k=KNN, n=N):
    """The five backward calls (reduce, stage 4, 3, 2, edge) of one DGCNN
    training forward and backward of B clouds of n points at full width
    over a graph of k neighbours, recorded with their arguments while the
    plain versions run them."""
    calls = []

    def record(name):
        def fn(*a, **kw):
            calls.append((name, a, kw))
            return BWD[name][1](*a, **kw)
        return fn

    x = torch.tensor(rs.randn(B, n, 3).astype(np.float32) * 0.3, device=DEV)
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
        out, _, _ = ops_dgcnn_train.dgcnn_train(x, ws, gs, bs, k, dtype)
        wvec = torch.tensor(rs.randn(B, n, EMB).astype(np.float32), device=DEV)
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
    if name == "bwd_reduce":   # z, dtap and four statistics in; S out
        return (m * C * s + rows * C * s + 4 * C * 4 + 2 * C * 4, 0.0,
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


def bwd_compare(calls, dt, errs, tag=""):
    """Each recorded backward call through its kernel, twice (bit for bit),
    against its plain version under the LIM_BWD_* limits; the largest error
    of each kernel into errs[name][dt]."""
    for name, a, kw in calls:
        kern, plain, _ = BWD[name]
        got, again = _outs(name, kern(*a, **kw)), _outs(name, kern(*a, **kw))
        torch.cuda.synchronize()
        ref = _outs(name, plain(*a, **kw))
        for i, (g, g2, r) in enumerate(zip(got, again, ref)):
            assert torch.equal(g, g2), f"{name}{tag}: two launches differ"
            assert g.shape == r.shape and g.dtype == r.dtype, name
            assert torch.isfinite(g.float()).all(), name
            scale = r.float().abs().max().item()
            err = (g.float() - r.float()).abs().max().item()
            lim = (LIM_BWD_F32 if dt == torch.float32 else
                   LIM_BWD_DZ_BF16 if (name == "bwd_stage" and i == 0)
                   else LIM_BWD_SUM_BF16) * scale
            print(f"{name}{tag} {dt} output {i}: max|kernel - plain| = {err:.3g} "
                  f"(limit {lim:.3g}), max|plain| = {scale:.3g}")
            assert err <= lim, (name, tag, dt, i)
            errs[name][dt] = max(errs[name].get(dt, 0.0), err)


def bwd_bound(work, dt):
    """(ms, by) of one backward's calls of a kernel: their bytes at 3.35
    TB/s against their products (bf16 at 989 TFLOP/s; float32 in 3xTF32,
    `f32_bound`) and element work on the CUDA cores."""
    products = sum(w[1] for w in work)
    t_ops = ((3 * products / PEAK_FLOPS["tf32"] if dt == torch.float32
              else products / PEAK_FLOPS["bf16"])
             + sum(w[2] for w in work) / PEAK_FLOPS["f32"])
    t_bytes = sum(w[0] for w in work) / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_dgcnn_bwd(rs):
    """The three backward kernels against their plain versions on the
    arguments of a real backward at B=24, N=717, float32 and bf16; two
    launches bit for bit; times of one backward (one cloud) beside the
    plain versions and the bound."""
    errs = {name: {} for name in BWD}
    timed = {}
    for dt in (torch.float32, torch.bfloat16):
        calls = bwd_calls(rs, dt)
        bwd_compare(calls, dt, errs)
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
        work32 = [bwd_work(name, a, kw) for n_, a, kw in timed[torch.float32]
                  if n_ == name]
        bound, bound_by = bwd_bound(work, bf)
        device = {}
        if name == "bwd_reduce":
            # the one pass (its last block adds the partials), bf16 and float32
            device = launch_ms(lambda: run(kern, bf), 10, {"reduce_ms": ("reduce_kernel",)})
            device.update({f"f32_{k}": v for k, v in launch_ms(
                lambda: run(kern, torch.float32), 5,
                {"reduce_ms": ("reduce_kernel",)}).items()})
        if name == "bwd_stage":
            # each __global__ of the calls (stages 4, 3, 2: the one-pass
            # kernel, bf16 on wgmma, float32 on mma.sync in 3xTF32; the
            # partial sums), device time of one backward
            device = launch_ms(lambda: run(kern, bf), 10, {
                **{f"stage{4 - i}_ms": (f"stage_wgmma_kernel<{c}, {ci}, {cn},",)
                   for i, (c, ci, cn) in enumerate(cuda_dgcnn_bwd.KERNEL_STAGES)},
                "sum_parts_ms": ("sum_parts_kernel",)})
            device.update({f"f32_{k}": v for k, v in launch_ms(
                lambda: run(kern, torch.float32), 5, {
                    **{f"stage{4 - i}_ms": (f"stage_tf32_kernel<{c}, {ci}, {cn},",)
                       for i, (c, ci, cn) in enumerate(cuda_dgcnn_bwd.KERNEL_STAGES)},
                    "sum_parts_ms": ("sum_parts_kernel",)}).items()})
        if name == "bwd_edge":
            # each __global__ of the call: the one pass (bf16 on wgmma, float32
            # on mma.sync in 3xTF32), its partial sums and the scatter
            device = launch_ms(lambda: run(kern, bf), 10, {
                "edge_wgmma_ms": ("edge_wgmma_kernel",),
                "sum_parts_ms": ("sum_parts_kernel",),
                "scatter_ms": ("scatter_kernel",)})
            device.update({f"f32_{k}": v for k, v in launch_ms(
                lambda: run(kern, torch.float32), 5, {
                    "edge_tf32_ms": ("edge_tf32_kernel",),
                    "sum_parts_ms": ("sum_parts_kernel",),
                    "scatter_ms": ("scatter_kernel",)}).items()})
            assert device["f32_edge_tf32_ms"] > 0, "the float32 call ran no edge_tf32_kernel"
        if device:
            print(f"{name} device ms of one backward (torch.profiler):",
                  {k: round(v, 4) for k, v in device.items()})
        entries.append({
            "name": name, "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/dgcnn_bwd.cu",
            "replaces": f"ogmm_tpu/ops/pallas_dgcnn_train.py:{line}",
            "calls_per_backward": len(work), **({"device_ms": device} if device else {}),
            "max_abs_err": errs[name][bf],
            "max_abs_err_f32": errs[name][torch.float32],
            "ms": ms, "ms_f32": ms32, "plain_ms": plain_ms,
            "bound_ms_f32": f32_bound(sum(w[1] for w in work32),
                                      sum(w[2] for w in work32),
                                      sum(w[0] for w in work32)),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
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


class anchors:
    """The clustering loss's anchors (ops.gmm.get_local_corrs: the point
    nearest each cluster mean, a 1-NN without a gradient) of a run:
    `with anchors() as a` records each call's indices in a.idx, `with
    anchors(idx)` hands the recorded indices to the run's calls instead."""

    def __init__(self, idx=None):
        self.replay = idx is not None
        self.idx = list(idx) if self.replay else []

    def __enter__(self):
        self.saved = ops_gmm.nn1
        calls = iter(self.idx)

        def nn1(src, tgt, **kw):
            d, i = self.saved(src, tgt, **kw)
            if self.replay:
                return d, next(calls)
            self.idx.append(i)
            return d, i
        ops_gmm.nn1 = nn1
        return self

    def __exit__(self, *exc):
        ops_gmm.nn1 = self.saved


def _grads(model):
    return {n: p.grad.detach().clone() for n, p in model.named_parameters()}


def _train_probe(state, cfg, batch):
    """Loss, gradients and buffers (the running statistics after it) of one
    step from `state` (anchors from index 0) on a copy of the model, and the
    step's peak device memory in MiB: the running statistics of `state`
    stay."""
    import copy
    probe = copy.copy(state)
    probe.model = copy.deepcopy(state.model)
    probe.generator = None
    for p in probe.model.parameters():
        p.grad = None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loss, _ = train_loss(probe, cfg, batch)
    loss.backward()
    torch.cuda.synchronize()
    return (loss.item(), _grads(probe.model),
            {k: b.clone() for k, b in probe.model.named_buffers()},
            torch.cuda.max_memory_allocated() / 2 ** 20)


def _step_grads(state, cfg, batch):
    """Loss and gradients of one step from `state` (`_train_probe`)."""
    return _train_probe(state, cfg, batch)[:2]


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
    f32 = train_f32(batches)
    ops_dgcnn_train.BWD_KERNELS = True
    return launches, {"step_ms_bwd_kernels": step_ms[True],
                      "step_ms_plain_bwd": step_ms[False],
                      "peak_mib_bwd_kernels": peak_mib[True],
                      "peak_mib_plain_bwd": peak_mib[False],
                      "grad_rel_on_off": d_bwd, "losses": losses, "float32": f32}


def train_f32(batches):
    """The same step at the float32 body `configs.mnet()` gives by default
    (its DGCNN backward through the 3xTF32 stage kernel with the switch):
    launches of one step with `BWD_KERNELS` on, step times on and off in
    turns (on, off, off, on; three steps each), and one step from the same
    state on against off, the loss and the gradients within DeepGMR's bar."""
    cfg = configs.mnet()
    assert cfg.model.dtype == "float32"
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, device_overlap=True),
                      data=dataclasses.replace(cfg.data, fix_tgt_overlap=True))
    state = create_train_state(cfg, steps_per_epoch=100, seed=0, device=DEV)
    step = make_train_step(cfg)
    ops_dgcnn_train.BWD_KERNELS = True
    step(state, batches[0])                               # warm up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    step(state, batches[1])
    torch.cuda.synchronize()
    launches = dict(dispatch.launch_counts)
    print("kernel launches in one float32 train step with the switch:", launches)
    assert (launches["bwd_reduce"], launches["bwd_stage"],
            launches["bwd_edge"]) == (2, 6, 2), launches
    step_ms = {True: [], False: []}
    for on in (True, False, False, True):
        ops_dgcnn_train.BWD_KERNELS = on
        step(state, batches[2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(3):
            metrics = step(state, batches[i % len(batches)])
        torch.cuda.synchronize()
        step_ms[on].append((time.perf_counter() - t0) / 3 * 1e3)
        assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    ops_dgcnn_train.BWD_KERNELS = True
    k_loss, k_grads = _step_grads(state, cfg, batches[2])
    ops_dgcnn_train.BWD_KERNELS = False
    o_loss, o_grads = _step_grads(state, cfg, batches[2])
    d_loss = abs(k_loss - o_loss) / abs(o_loss)
    d_grad = _rel(k_grads, o_grads)
    print(f"float32 train step of {B} pairs: {step_ms[True]} ms with the backward "
          f"kernels, {step_ms[False]} ms with the plain backward (host clock, "
          f"synchronised, three steps a round); on against off from one state: "
          f"loss {k_loss!r} / {o_loss!r}, relative {d_loss:.3g} (limit "
          f"{LIM_DGMR_LOSS}); gradients relative {d_grad:.3g} (limit {LIM_DGMR_GRAD})")
    assert d_loss <= LIM_DGMR_LOSS and d_grad <= LIM_DGMR_GRAD
    return {"launches": launches, "step_ms_bwd_kernels": step_ms[True],
            "step_ms_plain_bwd": step_ms[False], "loss_rel_on_off": d_loss,
            "grad_rel_on_off": d_grad}


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
    (k=20) and angles (k=5); and at the kernel's envelope (M=4096), cross
    kNNs (k = 32 and 1, and 7 and 2, which take the next compiled list
    length), clouds with a duplicated point and with 301 coincident points.
    Its error is the largest |kernel - plain| index over them, 0 when all
    agree. Timed at the first shape (the plain version once: a (48, 1433,
    1433) float32 matrix and 20 passes) and at the unfused step's graph."""
    shapes = [(2 * B, N_LARGE, N_LARGE, KNN), (B, N_LARGE, N_LARGE, KNN),
              (B, N, N, KNN), (B, 4096, 4096, KNN), (B, N, N, POS_K),
              (4, 1000, 257, 32), (2, 90, 2000, 1), (3, 70, 40, 7), (2, 50, 3, 2)]
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
    x717 = _cloud(rs, B, N)
    ms_717 = cuda_ms(lambda: knn(x717, x717, KNN), 20)
    rows = 2 * B * N_LARGE
    bound, by = _bound(rows * N_LARGE * PAIR_FLOPS,
                       2 * x.numel() * 4 + rows * KNN * 8)
    bound_717, _ = _bound(B * N * N * PAIR_FLOPS, 2 * x717.numel() * 4 + B * N * KNN * 8)
    print(f"knn ({2 * B}, {N_LARGE}, {N_LARGE}, k={KNN}): {ms:.4f} ms, plain "
          f"{plain:.3f} ms, bound {bound:.5f} ms ({by}); ({B}, 4096, 4096, "
          f"k={KNN}) {ms_4096:.4f} ms; ({B}, {N}, {N}, k={KNN}) {ms_717:.4f} ms, "
          f"bound {bound_717:.5f} ms")
    return {"name": "knn", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/knn.cu",
            "replaces": "ogmm_tpu/ops/pallas_knn.py:74",
            "max_abs_err": float(worst), "ms": ms, "ms_m4096": ms_4096,
            "ms_n717": ms_717, "bound_ms_n717": bound_717,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def check_posenc_angles(rs):
    """The angle kernel against its plain version at the unfused training
    path's shape (B=24 clouds of 717, k=5) and at N=1024, with a duplicated
    point, and at each k the plan routes (1, 8: the lanes kernel; 20, 32:
    the shared selection) with 301 coincident points; max |kernel - plain|
    <= 1e-5, the selected neighbours identical, a relaunch bit-equal. Timed
    at (24, 717, 5) between CUDA events and on the device (each kernel the
    call launches, from torch.profiler)."""
    worst = 0.0
    # the shapes added with the lanes kernel draw from a generator of their
    # own: the later phases see the data they saw before
    rs_k = np.random.RandomState(16)
    for b, n, k in ((B, N, POS_K), (4, 1024, POS_K), (3, 600, 1), (3, 600, 8),
                    (3, 600, 20), (3, 600, 32)):
        x = _cloud(rs if n != 600 else rs_k, b, n)
        if n == 600:
            x[:, 100:400] = x[:, :1]         # 301 coincident points
        got = posenc_angles(x, k)
        torch.cuda.synchronize()
        err = (got - posenc_angles_reference(x, k)).abs().max().item()
        again = torch.equal(got, posenc_angles(x, k))
        # the neighbours the kernel selects, written where a check asks
        idx = torch.empty(b, n, k, dtype=torch.int32, device=DEV)
        cuda_posenc._posenc_angles_cuda(x, k, idx=idx)
        torch.cuda.synchronize()
        same = torch.equal(idx.long(), knn_reference(x, x, k))
        plan = cuda_posenc.posenc_plan(b, n, k)
        print(f"posenc_angles ({b}, {n}, k={k}), {plan.kernel} (K {plan.K}, "
              f"{plan.lanes} lanes, {plan.blocks} blocks): indices identical "
              f"{same}, max|kernel - plain| = {err:.3g} (limit {LIM_POSENC}), "
              f"a relaunch bit-equal {again}")
        assert same and again and err <= LIM_POSENC and torch.isfinite(got).all()
        worst = max(worst, err)
    x = _cloud(rs, B, N)
    ms = cuda_ms(lambda: posenc_angles(x, POS_K), 50)
    plain = cuda_ms(lambda: posenc_angles_reference(x, POS_K), 5)
    device = launch_ms(lambda: posenc_angles(x, POS_K), 50, {
        "lanes_kernel": ("posenc_lanes_kernel",), "shared_selection": ("knn_kernel",),
        "other": ("reduce_kernel", "elementwise", "mean")})
    rows = B * N
    # each distance once and about one compare a candidate, as for knn
    bound, by = _bound(rows * N * PAIR_FLOPS, x.numel() * 4 + rows * POS_K * 4)
    print(f"posenc_angles ({B}, {N}, k={POS_K}): {ms:.4f} ms, plain "
          f"{plain:.3f} ms, bound {bound:.5f} ms ({by}); device ms {device}")
    return {"name": "posenc_angles", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/posenc_angles.cu",
            "replaces": "ogmm_tpu/ops/pallas_knn.py:144",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "launch_ms": device, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


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
             {"dgcnn_eval": 0, "knn": 1, "sinkhorn_em": 1}),
            # C.2: an emb the eval kernel does not take (the JAX package
            # fuses it): the unfused chain, over the kNN kernel's graph
            ("emb_dims=96", dict(emb_dims=96), B, N,
             {"dgcnn_eval": 0, "dgcnn_edges": 0, "knn": 1, "sinkhorn_em": 1}),
            # C.3: dgcnn_fused_edges at k = 33 (the JAX package runs its
            # edges kernel): the edges kernel, in chunks of 32, over the kNN
            # kernel's graph (the wide selection)
            ("gnn_k=33 dgcnn_fused_edges", dict(gnn_k=33, dgcnn_fused_edges=True),
             4, 2048, {"dgcnn_eval": 0, "dgcnn_edges": 1, "knn": 1,
                       "sinkhorn_em": 1})):
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


def surface(rs, batch, n=N_INDOOR):
    """bench.py's synthetic indoor fragment of N_INDOOR (or n) points: a
    height field over the unit square, 0.01 noise."""
    u = rs.rand(batch, n, 2).astype(np.float32)
    z = np.sin(3 * u[..., :1]) * np.cos(2 * u[..., 1:])
    pts = np.concatenate([u, 0.3 * z], -1)
    return (pts + 0.01 * rs.randn(batch, n, 3)).astype(np.float32)


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
    without them, and with the cull at k = 1 and 32; unsorted clouds just
    above M = 4096 with N not a multiple of the tile, with and without a
    cull; a cross query at k=1; 301 coincident points; N below one tile at
    k=32; a relaunch gives the same bits. At the indoor call: the tile pairs
    the kernel searched beside those the search needs, the most tiles one
    block searched, the share of the distance pairs its warps computed
    (the `visits` counters), and the time beside the bound."""
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
              dict(cull_lb=stream.pair_tile_bounds(g[:, :37], g))),
             ("indoor, sorted, cull, diagonal, k=1", x, x, 1,
              dict(diag_order=True, cull_lb=lb)),
             ("indoor, sorted, cull, diagonal, k=32", x, x, 32,
              dict(diag_order=True, cull_lb=lb))]
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
    run = lambda **kw: cuda_stream.knn_stream(x, x, KNN, diag_order=True,
                                              cull_lb=lb, **kw)
    visits = torch.zeros(3, dtype=torch.int32, device=DEV)
    idx = run(visits=visits)
    assert torch.equal(idx, run()), "a relaunch moved bits"
    tiles, most, scans = visits.tolist()
    searched = tiles / lb.numel()
    computed = scans * (stream.TILE_N // 8) * 64 / (2 * N_INDOOR * N_INDOOR)
    ms = cuda_ms(run, 10)
    dev = launch_ms(run, 10, {"knn_stream": ("knn_stream_kernel",)})["knn_stream"]
    ms_nocull = cuda_ms(lambda: cuda_stream.knn_stream(x, x, KNN), 2)
    ms_graph = cuda_ms(lambda: ops_common.knn_self_vspace(x, KNN), 5)
    plain = cuda_ms(lambda: stream.knn_stream_plain(x, x, KNN), 1)
    dk = _pair_d(x, index_points(x, idx[..., -1]))
    pairs, share = _needed_pairs(lb, dk, N_INDOOR, N_INDOOR)
    bound, by = _bound(9.0 * pairs, 2 * x.numel() * 4 + idx.numel() * 8)
    full, _ = _bound(9.0 * 2 * N_INDOOR * N_INDOOR, 0)
    print(f"knn_stream (2, {N_INDOOR}, {N_INDOOR}, k={KNN}): {ms:.4f} ms with "
          f"the cull ({dev:.4f} on the device; {ms_nocull:.3f} without; the "
          f"whole v-space graph with the sort and the table {ms_graph:.3f} ms), "
          f"plain {plain:.2f} ms, bound {bound:.5f} ms ({by}; the {share:.4f} "
          f"of the tile pairs the search needs; {full:.4f} ms for every pair)")
    print(f"knn_stream visits: searched {searched:.4f} of the tile pairs "
          f"({tiles} of {lb.numel()}; needed {share:.4f}), the most one block "
          f"searched {most} of {lb.shape[2]} tiles, the warps computed "
          f"{computed:.4f} of the distance pairs ({scans} (warp, 64-point "
          f"sub-tile) pairs; grid ({lb.shape[1]}, 2) blocks of "
          f"{4 * stream.TILE_N} threads)")
    return {"name": "knn_stream", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/knn_stream.cu",
            "replaces": "ogmm_tpu/ops/pallas_stream.py:529",
            "max_abs_err": float(worst), "ms": ms, "device_ms": dev,
            "ms_no_cull": ms_nocull, "ms_vspace_graph": ms_graph,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "bound_ms_every_pair": full, "tile_pairs_needed": share,
            "tile_pairs_searched": searched, "most_tiles_a_block": most,
            "distance_pairs_computed": computed, "library_ms": None}


def check_nn1_stream(rs):
    """The streamed 1-NN kernel against its plain version: an ICP trip at
    the indoor shape (Morton-sorted clouds, the moved source 0.6 degrees
    and 0.01 off the target, the cull and the 0.075 gate: identical (d, i)
    on the rows within the gate); the clustering's (2, 16, 35000) and
    awkward shapes without a gate (identical on every row): N = 1, 16, 63,
    65 and 4100 against M = 4097 and 35,000, with and without the cull and
    a gate, and 301 coincident points; a relaunch gives the same bits. The
    tile pairs the kernel searched beside those the search needs, and each
    call's launch shape."""
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
    d2, i2 = cuda_stream.nn1_stream(moved, tgt, cull_lb=lb, max_dist_sq=gate,
                                    diag_order=True)
    assert torch.equal(d, d2) and torch.equal(i, i2), "a relaunch moved bits"
    big = torch.tensor(surface(rs, 2), device=DEV)
    nodes = index_points(big, torch.randint(0, N_INDOOR, (2, 16), device=DEV)) + 0.003
    g = _cloud(rs, 2, 4097)
    c = _cloud(rs, 1, 4200)
    c[:, 100:401] = c[:, :1]
    cs = _sorted(c)
    bs = _sorted(big)
    cases = [(f"clustering (2, 16, {N_INDOOR})", nodes, big, {}),
             ("(2, 4100, 4097) unsorted", _cloud(rs, 2, 4100, dup=False), g, {}),
             ("301 coincident, sorted, cull", cs, cs,
              dict(cull_lb=stream.tile_pair_bounds(cs), diag_order=True))]
    for n_q in (1, 16, 63, 65, 4100):
        for t_name, t in (("4097", g), (str(N_INDOOR), bs)):
            q = _sorted(t[:, :n_q] + 0.002)
            cases.append((f"({t.shape[0]}, {n_q}, {t_name})", q, t, {}))
            cases.append((f"({t.shape[0]}, {n_q}, {t_name}), cull, gate", q, t,
                          dict(cull_lb=stream.pair_tile_bounds(q, t),
                               max_dist_sq=0.02 ** 2, diag_order=True)))
    for name, q, t, kw in cases:
        d2, i2 = cuda_stream.nn1_stream(q, t, **kw)
        torch.cuda.synchronize()
        rd2, ri2 = stream.nn1_stream_plain(q, t)
        gate2 = kw.get("max_dist_sq")
        keep = rd2 < gate2 if gate2 is not None else torch.ones_like(rd2, dtype=torch.bool)
        same = torch.equal(d2[keep], rd2[keep]) and torch.equal(i2[keep], ri2[keep])
        chunks, per = cuda_stream.nn1_stream_plan(q.shape[0], q.shape[1], t.shape[1],
                                                  cuda_stream._sm_count(0))
        print(f"nn1_stream {name}: (d, i) identical"
              f"{' within the gate' if gate2 is not None else ''} {same}; "
              f"grid ({-(-q.shape[1] // stream.TILE_N)}, {chunks}, {q.shape[0]}) "
              f"blocks of {4 * stream.TILE_N} threads, {per} target tiles a chunk")
        assert same and (gate2 is None or bool((d2[~keep] >= gate2).all()))
    run = lambda **kw: cuda_stream.nn1_stream(moved, tgt, cull_lb=lb,
                                              max_dist_sq=gate, diag_order=True, **kw)
    ms = cuda_ms(run, 20)
    ms_trip = cuda_ms(lambda: cuda_stream.nn1_stream(
        moved, tgt, cull_lb=stream.pair_tile_bounds(moved, tgt),
        max_dist_sq=gate, diag_order=True), 10)
    ms_nodes = cuda_ms(lambda: cuda_stream.nn1_stream(nodes, big), 10)
    # device time of the kernels alone: the clustering's call is short
    # enough that back-to-back calls time the wrapper's host work
    groups = {"nn1": ("nn1_kernel", "nn1_merge_kernel")}
    dev = launch_ms(run, 20, groups)["nn1"]
    dev_nodes = launch_ms(lambda: cuda_stream.nn1_stream(nodes, big), 20, groups)["nn1"]
    plain = cuda_ms(lambda: stream.nn1_stream_plain(moved, tgt), 2)
    pairs, share = _needed_pairs(lb, rd.clamp_max(gate), N_INDOOR, N_INDOOR)
    visits = torch.zeros(1, dtype=torch.int32, device=DEV)
    run(visits=visits)                  # the tile pairs the kernel searched
    searched = visits.item() / lb.numel()
    nodes_chunks = cuda_stream.nn1_stream_plan(2, 16, N_INDOOR, cuda_stream._sm_count(0))
    bound, by = _bound(9.0 * pairs, 2 * moved.numel() * 4 + N_INDOOR * 12)
    print(f"nn1_stream ICP trip: {ms:.4f} ms ({dev:.4f} ms on the device; "
          f"{ms_trip:.4f} with its bound table), plain {plain:.2f} ms, bound "
          f"{bound:.6f} ms ({by}; the {share:.4f} of the tile pairs the gated "
          f"search needs, the kernel searched {searched:.4f}; grid "
          f"({lb.shape[1]}, 1, 1) blocks of {4 * stream.TILE_N} threads); the "
          f"clustering's call {ms_nodes:.4f} ms ({dev_nodes:.4f} on the device; "
          f"grid (1, {nodes_chunks[0]}, 2) and a merge launch)")
    return {"name": "nn1_stream", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/knn_stream.cu",
            "replaces": "ogmm_tpu/ops/pallas_stream.py:165",
            "also_replaces": "ogmm_tpu/ops/pallas_stream.py:236",
            "max_abs_err": 0.0, "ms": ms, "device_ms": dev,
            "ms_with_table": ms_trip, "ms_clustering_call": ms_nodes,
            "device_ms_clustering_call": dev_nodes, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "tile_pairs_needed": share,
            "tile_pairs_searched": searched, "library_ms": None}


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
    bf16 and float32) and at small awkward shapes in both types (D = 32,
    96 and 512 in float32, M below one tile, N and M not multiples of the
    tiles, M just above 4096, M = 1, B = 3, more units than blocks and
    fewer), a relaunch the same bits; timed beside the plain version and
    `scaled_dot_product_attention` with a one-column v; the launch shape of
    each call; the float32 form's device ms of each __global__."""
    worst = 0.0
    qi, ki = _features(rs, 1, N_INDOOR, EMB, torch.bfloat16)
    vi = torch.tensor(rs.randn(1, N_INDOOR, 1).astype(np.float32), device=DEV)
    small = []
    for b, n, m, d, dt in ((1, 1000, 700, 64, torch.float32),
                           (1, 70, 50, 64, torch.bfloat16),
                           (2, 130, 4100, EMB, torch.bfloat16),
                           (2, 130, 4100, 128, torch.float32),
                           (2, 300, 1, EMB, torch.bfloat16),
                           (1, 129, 65, 256, torch.bfloat16),
                           (3, 1000, 2000, 128, torch.bfloat16),
                           (1, 70, 50, 32, torch.float32),
                           (2, 130, 4100, EMB, torch.float32),
                           (2, 300, 1, 96, torch.float32),
                           (1, 129, 65, 32, torch.float32),
                           (3, 1000, 2000, EMB, torch.float32),
                           (3, 700, 33000, 96, torch.float32)):
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
        again = cuda_stream.wproject_stream_lse(q, k, v)
        same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
        keys = cuda_stream.wproject_keys(q.dtype)
        blocks, slots = cuda_stream.wproject_plan(
            q.shape[0], q.shape[1], k.shape[1], cuda_stream._sm_count(0), keys)
        units = cuda_stream.wproject_units(q.shape[0], q.shape[1], k.shape[1], blocks, keys)
        smem = (cuda_stream.wproject_smem_bytes if q.dtype == torch.bfloat16
                else cuda_stream.wproject_f32_smem_bytes)(q.shape[2])
        shape = (f"; {len(units)} units on {blocks} blocks of 384 threads, "
                 f"tiles of {keys} keys, {smem} B of shared memory, a merge launch")
        print(f"wproject {tuple(q.shape)} x {k.shape[1]} {q.dtype}: out "
              f"{e_out:.3g}, lse {e_lse:.3g} (limit {LIM_WPROJECT}); max|lse| "
              f"{rlse.abs().max().item():.3g}; a relaunch the same bits {same}{shape}")
        assert torch.isfinite(out).all() and torch.isfinite(lse).all()
        assert e_out <= LIM_WPROJECT and e_lse <= LIM_WPROJECT and same
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
    # the float32 form, which the default float32 body's indoor training
    # runs, at the same call; and the head's backward (plain PyTorch, the
    # chunked recompute: four products of N x M x D a call with the
    # forward's, in float32 with TF32 off) in both types
    q32, k32 = qi.float(), ki.float()
    out32, lse32 = cuda_stream.wproject_stream_lse(q32, k32, vi)
    rout32, rlse32 = stream.wproject_stream_lse_plain(q32, k32, vi)
    err32 = max((out32 - rout32).abs().max().item(),
                (lse32 - rlse32).abs().max().item())
    assert err32 <= LIM_WPROJECT, err32
    again32 = cuda_stream.wproject_stream_lse(q32, k32, vi)
    assert torch.equal(out32, again32[0]) and torch.equal(lse32, again32[1])
    ms32 = cuda_ms(lambda: cuda_stream.wproject_stream_lse(q32, k32, vi), 3)
    # each __global__ of the float32 call: the projection (TF32 products,
    # k split into TF32 planes in shared memory: no split pass) and the merge
    split32 = launch_ms(lambda: cuda_stream.wproject_stream_lse(q32, k32, vi), 3, {
        "projection": ("wproject_tf32_kernel",), "merge": ("wproject_merge_kernel",)})
    plain32 = cuda_ms(lambda: stream.wproject_stream_lse_plain(q32, k32, vi), 2)
    lib32, backends32, _ = _sdpa(q32, k32, vi)
    # 2 N M D operations of products (a multiply-add is two, as the peaks
    # count them) and 4 N M of the softmax
    bound32 = f32_bound(2.0 * nn_ * EMB, 4.0 * nn_,
                        2 * N_INDOOR * EMB * 4 + N_INDOOR * 4 + 2 * N_INDOOR * 4)
    g = torch.tensor(rs.randn(1, N_INDOOR, 1).astype(np.float32), device=DEV)
    bwd = {}
    for label, (q, k, o, l) in (("f32", (q32, k32, out32, lse32)),
                                ("bf16", (qi, ki, *cuda_stream.wproject_stream_lse(qi, ki, vi)))):
        bwd[label] = cuda_ms(lambda q=q, k=k, o=o, l=l: stream.wproject_bwd(
            q, k, vi, o, l, g), 2)
    print(f"wproject (1, {N_INDOOR}, {N_INDOOR}, D={EMB}) float32: {ms32:.3f} ms "
          f"(device: the projection {split32['projection']:.3f}, the merge "
          f"{split32['merge']:.4f}), a relaunch the same bits, "
          f"max|kernel - plain| {err32:.3g} (limit {LIM_WPROJECT}), plain "
          f"{plain32:.2f} ms, bound {bound32['ms']:.4f} ms on the CUDA cores "
          f"({bound32['by']}; {bound32['ms_tf32x3']:.4f} in 3xTF32), "
          f"scaled_dot_product_attention {lib32} ms ({backends32}); the head's "
          f"backward (plain PyTorch, chunks of "
          f"{stream.wproject_bwd_chunk(N_INDOOR, N_INDOOR)} rows): "
          f"{bwd['f32']:.2f} ms float32, {bwd['bf16']:.2f} ms bf16 inputs")
    return {"name": "wproject", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/wproject.cu",
            "replaces": "ogmm_tpu/ops/pallas_stream.py:823",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain,
            "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib, "library_backends": backends,
            "library_max_abs_err": lib_err,
            "max_abs_err_f32": err32, "ms_f32": ms32, "launch_ms_f32": split32,
            "plain_ms_f32": plain32,
            "bound_ms_f32": bound32, "library_ms_f32": lib32,
            "library_backends_f32": backends32,
            "head_backward_ms": bwd}


def check_dgcnn_edges(rs):
    """The edges kernel against its plain version over the indoor graph (2
    clouds of 35,000, k=20, the kernel's own graph), float32 and bf16, with
    the limits of the dgcnn_eval check; and at N=37 (not a multiple of the
    kernel's 8 rows) with k=16."""
    x = _sorted(torch.tensor(surface(rs, 2), device=DEV))
    nbr = gather_neighbors(x, cuda_stream.knn_stream(
        x, x, KNN, diag_order=True, cull_lb=stream.tile_pair_bounds(x)))
    ws, aff = _dgcnn_operands(rs)
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
    ms32 = cuda_ms(lambda: dgcnn_edges(x, nbr, ws, aff, KNN, torch.float32), 5)
    plain = cuda_ms(lambda: dgcnn_edges_reference(x, nbr, ws, aff, KNN, bf), 2)
    split32 = launch_ms(lambda: dgcnn_edges(x, nbr, ws, aff, KNN, torch.float32), 5, {
        "stage_chain": ("dgcnn_stage_tf32_kernel",), "head": ("dgcnn_head_tf32_kernel",)})
    rows = 2 * N_INDOOR
    stage_macs = 6 * 64 + 64 * 64 + 64 * 128 + 128 * 256
    flops = 2.0 * rows * (KNN * stage_macs + sum(STAGES) * EMB)
    nbytes = x.numel() * 4 + nbr.numel() * 4 + rows * EMB * 2
    t_ops, t_bytes = flops / PEAK_FLOPS["bf16"], nbytes / PEAK_BYTES
    bound = max(t_ops, t_bytes) * 1e3
    bound32 = f32_bound(flops, 0.0, nbytes + rows * EMB * 2 + sum(w.numel() for w in ws) * 4)
    print(f"dgcnn_edges (2, {N_INDOOR}, k={KNN}): {ms:.3f} ms bf16, {ms32:.3f} "
          f"ms float32 (the 3xTF32 stage chain {split32['stage_chain']:.4f}, the "
          f"head {split32['head']:.4f} on the device), plain {plain:.3f} ms, bound "
          f"{bound:.4f} ms (float32: {bound32['ms_tf32x3']:.4f} on the tensor "
          f"cores, {bound32['ms']:.4f} on the CUDA cores)")
    return {"name": "dgcnn_edges", "route": "cuda",
            "source": "ogmm_tpu_torch/csrc/dgcnn_eval.cu",
            "replaces": "ogmm_tpu/ops/pallas_dgcnn.py:315",
            "max_abs_err": errs[bf], "max_abs_err_f32": errs[torch.float32],
            "ms": ms, "ms_f32": ms32, "plain_ms": plain, "launch_ms_f32": split32,
            "bound_ms": bound, "bound_ms_f32": bound32,
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
    # each __global__ of the bf16 call: the two products and the moments;
    # of the float32 call: the weights' TF32 planes, the two 3xTF32 products
    # and the moments
    device = launch_ms(lambda: cuda_mlp.pointmlp_eval(xb, *path[1:], bf), 10, {
        "z_product_ms": ("mlp_gemm_kernel<256, false>",),
        "moments_ms": ("mlp_moments_kernel",),
        "out_product_ms": ("mlp_gemm_kernel<256, true>",)})
    device.update({f"f32_{k}": v for k, v in launch_ms(
        lambda: cuda_mlp.pointmlp_eval(x32, *path[1:], torch.float32), 5, {
            "planes_ms": ("tf32_planes_kernel",),
            "z_product_ms": ("mlp_tf32_kernel<128, false>",),
            "moments_ms": ("mlp_moments_kernel",),
            "out_product_ms": ("mlp_tf32_kernel<128, true>",)}).items()})
    print("pointmlp device ms (torch.profiler):",
          {k: round(v, 4) for k, v in device.items()})
    # the eager chain the flag replaces: PointMLP(fuse_eval=False) in eval,
    # float32, the same weights (two cuBLAS products and the InstanceNorm)
    chain = PointMLP(2 * EMB, (2 * EMB, EMB), dtype=torch.float32).to(DEV).eval()
    with torch.no_grad():
        for i, (wt, bias) in enumerate(((path[1], path[2]), (path[3], path[4]))):
            getattr(chain, f"dense{i}").weight.copy_(wt)
            getattr(chain, f"dense{i}").bias.copy_(bias)
        chain_out = chain(x32)
        fused = cuda_mlp.pointmlp_eval(x32, *path[1:], torch.float32)
        chain_err = (chain_out - fused).abs().max().item()
        chain_ms = cuda_ms(lambda: chain(x32), 5)
    print(f"pointmlp float32 against the eager chain: max|kernel - chain| = "
          f"{chain_err:.3g} (limit {LIM_MLP_F32}); the chain {chain_ms:.3f} ms")
    assert chain_err <= LIM_MLP_F32
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
            "ms": ms, "ms_f32": ms32, "plain_ms": plain, "device_ms": device,
            "chain_ms_f32": chain_ms, "chain_max_abs_err_f32": chain_err,
            "bound_ms_f32": f32_bound(flops_bf16, flops_f32, 2 * nbytes),
            "bound_ms": bound,
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
    96 rows of 717 points (the path's call, a block a row), 2B clouds of
    1433, the indoor request's 4 rows of 35,000 (a cluster a row, also at
    every compiled cluster shape near the plan's), 4 rows past what a
    cluster holds in registers (the L2 route), each with a duplicated point,
    and an all-equal cloud; each call's plan; timed at the path's call and
    at 35,000, there at K steps and at the indoor request's own km_clusters
    steps."""
    shapes = [(2 * B, N), (2 * B, N_LARGE), (2, N_INDOOR), (2, N_FPS_L2)]
    worst, timed, plans = 0, {}, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, n in shapes:
        xs, dist, start = _fps_state(rs, _cloud(rs, b, n))
        got = cuda_fps.fps(xs, K, dist, start)
        torch.cuda.synchronize()
        want = cuda_fps.fps_reference(xs, K, dist, start)
        same = torch.equal(got, want)
        worst = max(worst, (got - want).abs().max().item())
        plans[n] = cuda_fps.fps_plan(2 * b, n, sms)
        print(f"fps ({2 * b} rows of {n}, {K} steps): ids identical {same}; plan "
              f"{plans[n]._asdict()}")
        assert same and got.dtype == torch.int64
        timed[n] = (xs, dist, start)
    assert plans[N_FPS_L2].route == "l2" and plans[N_INDOOR].cluster > 1
    xs, dist, start = timed[N_INDOOR]
    want = cuda_fps.fps_reference(xs, K, dist, start)
    for plan in cuda_fps.compiled_plans(4, N_INDOOR, sms):
        same = torch.equal(cuda_fps._fps_cuda(xs, K, dist, start, plan), want)
        print(f"fps (4 rows of {N_INDOOR}) at plan {plan._asdict()}: ids identical {same}")
        assert same
    flat = torch.full((4, N_INDOOR, 3), 0.25, device=DEV)   # every distance ties
    for n in (N, N_INDOOR):
        d0 = torch.full((4, n), 1e10, device=DEV)
        s0 = torch.tensor([0, 1, n // 2, n - 1], device=DEV)
        same = torch.equal(cuda_fps.fps(flat[:, :n], K, d0, s0),
                           cuda_fps.fps_reference(flat[:, :n], K, d0, s0))
        print(f"fps (4 equal rows of {n}): ids identical {same}")
        assert same
    xs, dist, start = timed[N]
    ms = cuda_ms(lambda: cuda_fps.fps(xs, K, dist, start), 20)
    plain = cuda_ms(lambda: cuda_fps.fps_reference(xs, K, dist, start), 3)
    xi, di, si = timed[N_INDOOR]
    ms_indoor = cuda_ms(lambda: cuda_fps.fps(xi, K, di, si), 3)
    # the indoor request's own call: fps_combined(both, km_clusters) steps
    k_in = configs.indoor().model.km_clusters
    want_in = cuda_fps.fps_reference(xi, k_in, di, si)
    assert torch.equal(cuda_fps.fps(xi, k_in, di, si), want_in)
    ms_indoor_path = cuda_ms(lambda: cuda_fps.fps(xi, k_in, di, si), 10)
    rows = 4 * B
    # a step: three differences, three squares, two sums, a minimum and a
    # compare a point
    bound, by = _bound(rows * N * K * 10.0, rows * N * 16 + rows * 8 + rows * K * 8)
    # the same bound at the indoor request's 4 rows of 35,000, at K and at
    # the path's own step count
    bound_in, by_in = _bound(4 * N_INDOOR * K * 10.0,
                             4 * N_INDOOR * 16 + 4 * 8 + 4 * K * 8)
    bound_in_path, by_in_path = _bound(4 * N_INDOOR * k_in * 10.0,
                                       4 * N_INDOOR * 16 + 4 * 8 + 4 * k_in * 8)
    print(f"fps ({rows} rows of {N}, {K} steps): {ms:.4f} ms, plain {plain:.3f} ms, "
          f"bound {bound:.5f} ms ({by}); (4 rows of {N_INDOOR}, {K} steps) "
          f"{ms_indoor:.4f} ms, bound {bound_in:.5f} ms ({by_in}); (4 rows of "
          f"{N_INDOOR}, {k_in} steps, the indoor request's call) {ms_indoor_path:.4f} "
          f"ms, bound {bound_in_path:.5f} ms ({by_in_path})")
    return {"name": "fps", "route": "cuda", "source": "ogmm_tpu_torch/csrc/fps.cu",
            "replaces": "ogmm_tpu/ops/pallas_fps.py:74",
            "plan": plans[N]._asdict(), "plan_indoor_rows": plans[N_INDOOR]._asdict(),
            "max_abs_err": float(worst), "ms": ms, "ms_indoor_rows": ms_indoor,
            "bound_ms_indoor_rows": bound_in, "ms_indoor_path": ms_indoor_path,
            "steps_indoor_path": k_in, "bound_ms_indoor_path": bound_in_path,
            "plain_ms": plain,
            "bound_ms": bound, "bound_by": by,
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
    identical, the final poses within LIM_ICP_POSE, a relaunch bit-equal; at
    the path's call (24, 717, 717), at N=1433, at B=48, at N != M, with a
    cloud without inliers (its pose kept exactly) and at the envelope
    M = 4096; each call's cluster shape (`cuda_icp.icp_plan`); timed at the
    path's call and at N=1433."""
    thr2 = (2.0 * configs.ModelConfig().overlap_radius) ** 2
    cases = [(B, N, N, ()), (B, N_LARGE, N_LARGE, ()), (2 * B, N, N, ()),
             (8, N, 600, (3,)), (8, 500, 900, ()), (4, 4096, 4096, (0,))]
    worst, timed = 0.0, {}
    sms = cuda_stream._sm_count(0)
    for b, n, m, far in cases:
        src, tgt, init = _icp_inputs(rs, b, n, m, far)
        r, t, first = cuda_icp.icp_fused(src, tgt, init, thr2, return_first=True)
        r2, t2, first2 = cuda_icp.icp_fused(src, tgt, init, thr2, return_first=True)
        torch.cuda.synchronize()
        rr, rt, rfirst = cuda_icp.icp_fused_reference(src, tgt, init, thr2,
                                                      return_first=True)
        same = torch.equal(first, rfirst)
        again = torch.equal(r, r2) and torch.equal(t, t2) and torch.equal(first, first2)
        err = max((r - rr).abs().max().item(), (t - rt).abs().max().item())
        kept = all(torch.equal(r[i], init[i, :3, :3]) and torch.equal(t[i], init[i, :3, 3])
                   for i in far)
        plan = cuda_icp.icp_plan(b, n, m, sms)
        print(f"icp ({b}, {n}, {m}), 30 trips: first trip's 1-NN identical {same}, "
              f"max|pose kernel - plain| = {err:.3g} (limit {LIM_ICP_POSE}); "
              f"clouds without inliers {list(far)} keep their pose {kept}; a "
              f"relaunch bit-equal {again}; clusters of {plan.cluster} blocks "
              f"({b * plan.cluster} blocks on {sms} SMs; the card holds "
              f"{cuda_icp.max_active_clusters(plan)} such clusters at once), "
              f"{plan.rows} rows a block, {plan.lanes} lanes a row, "
              f"{plan.threads} threads, {plan.smem} B of shared memory")
        assert same and kept and again and err <= LIM_ICP_POSE
        assert torch.isfinite(r).all() and torch.isfinite(t).all()
        worst = max(worst, err)
        timed[(b, n, m)] = (src, tgt, init)
    ms = cuda_ms(lambda: cuda_icp.icp_fused(*timed[(B, N, N)], thr2), 10)
    ms_large = cuda_ms(lambda: cuda_icp.icp_fused(*timed[(B, N_LARGE, N_LARGE)], thr2), 5)
    ms_48 = cuda_ms(lambda: cuda_icp.icp_fused(*timed[(2 * B, N, N)], thr2), 5)
    plain = cuda_ms(lambda: cuda_icp.icp_fused_reference(*timed[(B, N, N)], thr2), 2)
    # a trip: 8 operations a distance and a compare a pair; moving a point,
    # its moments and covariance about 60
    bound, by = _bound(30 * B * (N * N * 9.0 + N * 60.0), B * (2 * N * 12 + 2 * 48))
    print(f"icp ({B}, {N}, {N}), 30 trips: {ms:.4f} ms, plain {plain:.3f} ms, "
          f"bound {bound:.5f} ms ({by}); ({B}, {N_LARGE}, {N_LARGE}) {ms_large:.4f} ms; "
          f"({2 * B}, {N}, {N}) {ms_48:.4f} ms")
    return {"name": "icp", "route": "cuda", "source": "ogmm_tpu_torch/csrc/icp.cu",
            "replaces": "ogmm_tpu/ops/pallas_icp.py:152",
            "max_abs_err": worst, "ms": ms, "ms_n1433": ms_large,
            "ms_b48": ms_48, "cluster": cuda_icp.icp_plan(B, N, N, sms).cluster,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def _loops_ab(cfg, requests, body):
    """The refined request through a Registrar of `cfg` with
    `loop_kernels=True` and one without, on the same weights and
    requests: launches of one request with the flag, request times of both
    (on, off, off, on), peak memory, and the refined rotation and overlap
    scores of the flag's request against the one without and against the
    plain versions."""
    regs = {on: Registrar(cfg, seed=0, device=DEV, loop_kernels=on)
            for on in (True, False)}
    for reg in regs.values():
        reg(requests[0][0], requests[0][1], refine=True)   # warm up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    regs[True](requests[0][0], requests[0][1], refine=True)
    torch.cuda.synchronize()
    launches = dict(dispatch.launch_counts)
    print(f"kernel launches in one refined {body} request with loop_kernels:", launches)
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
    print(f"refined {body} request of {B} pairs: {times[True]} ms with loop_kernels, "
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
        print(f"{body}, loop_kernels on against {name}: overlap scores {d_o:.3g} "
              f"(limit {LIM_OVERLAP}), refined rotation median "
              f"{ang.median().item():.3g} deg (limit {LIM_ROT_DEG}), max "
              f"{ang.max().item():.3g} deg")
        assert d_o <= LIM_OVERLAP and ang.median().item() <= LIM_ROT_DEG
        res[name] = {"overlap": d_o, "rot_median_deg": ang.median().item(),
                     "rot_max_deg": ang.max().item()}
    return launches, {"forward_icp_on": times[True], "forward_icp_off": times[False],
                      "peak_mib_on": peak[True], "peak_mib_off": peak[False],
                      "against": res}


def serve_loops(rs):
    """The refined request of `serve` (B=24, N=717, bf16) through a
    Registrar with `loop_kernels=True` and one without, on the same weights
    (`_loops_ab`): launches of one request (fps 1, pointmlp 3, icp 1), the
    request time of each on the same requests, the peak device memory of
    each, and the refined rotation and overlap scores against the one
    without and against the plain versions; then the same at the float32
    body `configs.mnet()` gives by default (its three attention MLPs through
    the 3xTF32 form of the MLP kernel). The bf16 request's launches are the
    path's."""
    requests = [make_pairs(rs, B, N) for _ in range(3)]
    launches, res = _loops_ab(configs.mnet(model=configs.ModelConfig(dtype="bfloat16")),
                              requests, "bf16")
    launches32, res["float32"] = _loops_ab(configs.mnet(), requests, "float32")
    res["float32"]["launches"] = launches32
    return launches, res


def serve_f32(rs):
    """The request `Registrar(configs.mnet())` gives its users: the float32
    body (the default dtype), B=24, N=717, emb 512, K=128, seeded random
    weights; a few requests without and with ICP, the launches of one
    request (dgcnn_eval 1, sinkhorn_em 1: its DGCNN through the 3xTF32
    stage chain), request times, peak device memory, and rotation and
    overlap scores against the same requests with every kernel swapped for
    its plain version (phase 3's limits)."""
    cfg = configs.mnet()
    assert cfg.model.dtype == "float32"
    assert (cfg.model.emb_dims, cfg.model.n_clusters, cfg.model.gnn_k,
            cfg.model.num_heads) == (EMB, K, KNN, 4)
    reg = Registrar(cfg, seed=0, device=DEV)
    requests = [make_pairs(rs, B, N) for _ in range(3)]
    reg(requests[0][0], requests[0][1], refine=True)      # warm up
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
        assert launches[refine]["dgcnn_eval"] == 1, launches[refine]
        assert launches[refine]["sinkhorn_em"] == 1, launches[refine]
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
    print(f"float32 request of {B} pairs: {times[False]:.2f} ms without ICP, "
          f"{times[True]:.2f} ms with ICP (host clock, synchronised); peak "
          f"device memory {peak[False]:.0f} / {peak[True]:.0f} MiB; launches "
          f"{launches[False]} / {launches[True]}")
    src, tgt, _, _ = requests[-1]
    res = {}
    with plain_versions():
        before = dict(dispatch.launch_counts)
        plain = {refine: reg(src, tgt, refine=refine) for refine in (False, True)}
        assert dict(dispatch.launch_counts) == before
    for refine in (False, True):
        k_rot, _, k_so, k_to = outs[refine]
        p_rot, _, p_so, p_to = plain[refine]
        d_o = max((k_so - p_so).abs().max().item(), (k_to - p_to).abs().max().item())
        ang = angle_deg(k_rot, p_rot)
        key = "forward_icp" if refine else "forward"
        res[key] = {"overlap": d_o, "rot_median_deg": ang.median().item(),
                    "rot_max_deg": ang.max().item()}
        print(f"float32 {key}, kernel path against plain path: overlap scores "
              f"{d_o:.3g} (limit {LIM_OVERLAP}), rotation median "
              f"{ang.median().item():.3g} deg (limit {LIM_ROT_DEG}), max "
              f"{ang.max().item():.3g} deg")
        assert d_o <= LIM_OVERLAP and ang.median().item() <= LIM_ROT_DEG
    return launches[False], {"forward": times[False], "forward_icp": times[True],
                             "launches_icp": launches[True],
                             "peak_mib": peak[False], "peak_mib_icp": peak[True],
                             "against_plain": res}


# -------------------------------------------------------- indoor training

B_INDOOR_TRAIN = 2       # pairs a step (the preset trains 8)


def indoor_batch(rs, batch=B_INDOOR_TRAIN):
    """B pairs of surface() fragments against rigid copies; the labels are
    made in the step (device_overlap)."""
    src, tgt, rot, trans = rigid_copies(rs, surface(rs, batch))
    ones = np.ones(src.shape[:2], np.float32)
    return {"src_xyz": src, "tgt_xyz": tgt, "src_overlap": ones,
            "tgt_overlap": ones,
            "transform_gt": np.concatenate([rot, trans[:, :, None]], axis=-1)}


def _indoor_train_cfg(dtype="float32"):
    cfg = configs.indoor()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, dtype=dtype),
        train=dataclasses.replace(cfg.train, batch_size=B_INDOOR_TRAIN,
                                  device_overlap=True, overlap_thresh=0.05))


def _largest_segment():
    return max((s["total_size"] for s in torch.cuda.memory_snapshot()), default=0)


def train_indoor(rs):
    """Indoor training: `make_train_step(configs.indoor())` with its default
    float32 body at B=2 pairs of N=35,000 points (emb 512, K=16, k=20),
    overlap labels made in the step. The overlap head streams (B N N above
    64 Mi elements) and trains through the chunked recompute of
    `ops.stream.wproject`. (a) a warm-up step, one step with the launch
    counts (knn_stream 2: the self graph of each cloud side; wproject 2:
    both directions of the head; nn1_stream 8: the labels' two directions,
    the Welsch loss's two, the clustering loss and the metrics' three;
    dgcnn_eval, sinkhorn_em, knn and nn1 0), three timed steps, peak device
    memory, and no allocation as large as one (N, N) float32 matrix (the
    caching allocator's largest segment after the steps); finite loss and
    gradients, every parameter and running statistic moved; (b) one step
    from the same state through the kernels and through their plain
    versions, the clustering loss's anchors (the point nearest each cluster
    mean) held at the plain run's: loss within LIM_INDOOR_LOSS, gradients
    within LIM_INDOOR_GRAD, at most LIM_INDOOR_ANCHOR_FLIPS anchors that the
    kernel run would choose otherwise;
    (c) the bf16 body once: step time and peak memory; (d) the CLI on
    stand-in fragments of scripts/gen_indoor_fragments.py: two steps, an
    eval batch with ICP, a checkpoint, and the loader's seconds a batch."""
    t_phase = time.perf_counter()
    cfg = _indoor_train_cfg()
    m = cfg.model
    assert (m.n_clusters, m.emb_dims, m.gnn_k, m.dtype) == (16, EMB, KNN, "float32")
    assert nn_gmmreg.overlap_route(B_INDOOR_TRAIN, N_INDOOR, N_INDOOR, EMB,
                                   torch.float32, m.overlap_stream) == "stream"
    state = create_train_state(cfg, steps_per_epoch=100, seed=0, device=DEV)
    step = make_train_step(cfg)
    batches = [indoor_batch(rs) for _ in range(3)]
    before = {n: t.detach().clone() for n, t in state.model.state_dict().items()}

    torch.cuda.empty_cache()
    step(state, batches[0])                               # warm up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    metrics = step(state, batches[1])
    torch.cuda.synchronize()
    launches = dict(dispatch.launch_counts)
    t0 = time.perf_counter()
    losses = [step(state, batches[i % 3])["loss"][0] for i in range(3)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 3 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    largest = _largest_segment()
    nn_bytes = N_INDOOR * N_INDOOR * 4
    losses = [v.item() for v in losses]
    print(f"indoor train step, {B_INDOOR_TRAIN} pairs of {N_INDOOR} points, "
          f"float32: {step_ms:.1f} ms (host clock, three steps), peak device "
          f"memory {peak:.0f} MiB, largest allocator segment "
          f"{largest / 2 ** 20:.0f} MiB (one (N, N) float32 matrix: "
          f"{nn_bytes / 2 ** 20:.0f} MiB), losses {[round(v, 4) for v in losses]}, "
          f"launches {launches}")
    assert (launches["knn_stream"], launches["wproject"],
            launches["nn1_stream"]) == (2, 2, 8), launches
    assert all(launches[k] == 0 for k in ("dgcnn_eval", "sinkhorn_em", "knn",
                                          "nn1")), launches
    assert largest < nn_bytes, largest
    assert all(np.isfinite(losses))
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    for n, p in state.model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
    after = state.model.state_dict()
    unchanged = [n for n in before if torch.equal(before[n], after[n])]
    assert not unchanged, f"not moved by training: {unchanged}"

    # (b) one step from the same state through the plain versions, on the
    # same side of the clustering loss's anchor choice: the plain run's
    # anchors are handed to the kernel run (the kernel run's own choice, and
    # its differences without the hold, are printed beside)
    batch = batches[2]
    with anchors() as own:
        f_loss, f_grads = _step_grads(state, cfg, batch)
    with plain_versions(), anchors() as plain:
        counts = dict(dispatch.launch_counts)
        p_loss, p_grads = _step_grads(state, cfg, batch)
        assert dict(dispatch.launch_counts) == counts
    with anchors(plain.idx):
        k_loss, k_grads = _step_grads(state, cfg, batch)
    flips = sum(int((a != b).sum()) for a, b in zip(own.idx, plain.idx))
    n_anchors = sum(a.numel() for a in plain.idx)
    d_loss = abs(k_loss - p_loss) / abs(p_loss)
    d_grad = _rel(k_grads, p_grads)
    print(f"indoor train step, kernels against plain versions: loss "
          f"{k_loss:.6f} / {p_loss:.6f}, relative {d_loss:.3g} (limit "
          f"{LIM_INDOOR_LOSS}); gradients relative {d_grad:.3g} (limit "
          f"{LIM_INDOOR_GRAD}); clustering anchors the kernel run picks "
          f"otherwise: {flips} of {n_anchors} (without the hold: loss "
          f"relative {abs(f_loss - p_loss) / abs(p_loss):.3g}, gradients "
          f"{_rel(f_grads, p_grads):.3g})")
    assert flips <= LIM_INDOOR_ANCHOR_FLIPS, flips
    assert d_loss <= LIM_INDOOR_LOSS and d_grad <= LIM_INDOOR_GRAD
    del state, k_grads, p_grads, f_grads
    torch.cuda.empty_cache()

    # (c) the bf16 body once
    cfg16 = _indoor_train_cfg("bfloat16")
    state16 = create_train_state(cfg16, steps_per_epoch=100, seed=0, device=DEV)
    step16 = make_train_step(cfg16)
    step16(state16, batches[0])                           # warm up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m16 = step16(state16, batches[1])
    torch.cuda.synchronize()
    bf16_ms = (time.perf_counter() - t0) * 1e3
    bf16_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    assert torch.isfinite(m16["loss"]).all(), m16
    print(f"indoor train step, bf16 body: {bf16_ms:.1f} ms (one step), peak "
          f"device memory {bf16_peak:.0f} MiB, loss {m16['loss'][0].item():.4f}")
    del state16
    torch.cuda.empty_cache()

    cli_res = run_indoor_cli()
    secs = time.perf_counter() - t_phase
    print(f"train_indoor phase: {secs:.1f} s")
    return launches, {"step_ms": step_ms, "peak_mib": peak,
                      "largest_segment_mib": largest / 2 ** 20,
                      "losses": losses, "loss_rel_plain": d_loss,
                      "grad_rel_plain": d_grad, "anchor_flips": flips,
                      "bf16_step_ms": bf16_ms,
                      "bf16_peak_mib": bf16_peak, "cli": cli_res,
                      "phase_s": secs}


def run_indoor_cli():
    """`python -m ogmm_tpu_torch.train --preset indoor --dataset 7scene` on
    stand-in fragments written by scripts/gen_indoor_fragments.py (one a
    training scene, one for the test split): batch 2, two steps, one eval
    batch with ICP, a checkpoint; host overlap labels from the host library.
    Then the loader alone: seconds a training batch."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "data")
        subprocess.run([sys.executable,
                        os.path.join(here, "scripts", "gen_indoor_fragments.py"),
                        root, "1", "1"], check=True, capture_output=True)
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["--preset", "indoor", "--dataset", "7scene",
                            "--root", root, "--batch_size", "2",
                            "--test_batch_size", "1", "--epochs", "1",
                            "--steps_per_epoch", "2", "--model_path",
                            os.path.join(tmp, "run")])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(dispatch.launch_counts)
        saved = os.path.exists(os.path.join(tmp, "run", "checkpoints", "GMMReg",
                                            "models", "optim_model.pt"))
        from ogmm_tpu_torch.data import data_loader
        train_loader, _ = data_loader(trainer.cfg)
        t0 = time.perf_counter()
        n_batches = 0
        for b in train_loader:
            n_batches += 1
            assert b["src_xyz"].shape == (2, N_INDOOR, 3), b["src_xyz"].shape
            if n_batches == 2:
                break
        per_batch = (time.perf_counter() - t0) / n_batches
    rec = trainer.history[-1]
    print(f"indoor CLI: {trainer.state.step} steps and an eval batch with ICP "
          f"in {secs:.1f} s (data included), train loss "
          f"{rec['train']['loss']:.4f}, eval loss {rec['val']['loss']:.4f}, "
          f"checkpoint written {saved}; the loader {per_batch:.2f} s a batch of "
          f"2 ({trainer.cfg.data.num_workers} threads); launches {launches}")
    assert trainer.state.step == 2 and saved
    assert np.isfinite(rec["train"]["loss"]) and np.isfinite(rec["val"]["loss"])
    assert trainer.state.device.type == "cuda"
    # two steps (2 + 2 + 6 each: no labels made in the step) and an eval
    # batch (the stacked pair's graph and head, the clustering loss, 30 ICP
    # trips, the Welsch loss and the metrics)
    assert (launches["knn_stream"], launches["wproject"],
            launches["nn1_stream"]) == (2 * 2 + 1, 2 * 2 + 2, 2 * 6 + 36), launches
    return {"seconds": secs, "loader_s_per_batch": per_batch,
            "train_loss": rec["train"]["loss"], "eval_loss": rec["val"]["loss"],
            "launches": launches}


# ------------------------------------------------------------------ DeepGMR

B_DV, N_DV, M_DV = 24, 768, 1536   # modelnetdv: src FPS'd to 768, tgt 1536
DV_ROOT = "synthetic:200"          # 100 test shapes (labels >= 20), 100 train
# the __global__ each kernel's wrapper launches on this path (dgcnn_eval and
# graph_stage1 also launch knn_kernel, their selection)
DEEPGMR_GLOBALS = {"dgcnn_eval": "dgcnn_stage_tf32_kernel",
                   "graph_stage1": "edge_stage1_kernel",
                   "nn1": "nn1_lanes_kernel", "icp": "icp_kernel",
                   "knn_kernel": "knn_kernel"}
# limits, DeepGMR with the kernels against the same with the plain versions
# on the card: only src's DGCNN differs (the 3xTF32 stage chain, ~2^-22 of
# each product); tgt's graph (knn) and the 1-NN are identical
LIM_DGMR_MOMENTS = 1e-5   # pi, mu, sigma of both clouds (|mu| < 1)
LIM_DGMR_ROT_DEG = 0.1    # median angle, the rotation without ICP
LIM_DGMR_ICP_DEG = 1.0    # median angle after 30 ICP trips (phase 3's bar)
# one train step: graph_stage1's z1 in another summation order (1e-5),
# through a softmax over 128 clusters and the eigh of Horn's matrix, whose
# gradient goes as one over its eigen gap
LIM_DGMR_LOSS = 1e-3      # relative difference of the loss
LIM_DGMR_GRAD = 1e-3      # |g_kernel - g_plain| / |g_plain| over all params
# the step with src's DGCNN backward through the float32 backward kernels
# against the plain backward: the same forward, sums in another order
LIM_DGMR_BWD_GRAD = 1e-3


def profiled_launches(fn):
    """Launches of each __global__ of DEEPGMR_GLOBALS in one call of fn,
    from torch.profiler's device events."""
    out = {name: 0 for name in DEEPGMR_GLOBALS}
    for evt in device_trace(fn):
        for name, glob in DEEPGMR_GLOBALS.items():
            if glob in evt.key:
                out[name] += evt.count
    return out


def _profiled_disagree(launches, prof):
    """Where the profiler's count of each wrapper's __global__ differs from
    the wrapper's count (knn_kernel runs once for dgcnn_eval, graph_stage1
    and knn each): {name: (profiled, counted)}."""
    want = {name: launches.get(name, 0) for name in ("dgcnn_eval", "graph_stage1", "nn1", "icp")}
    want["knn_kernel"] = sum(launches.get(k, 0) for k in ("dgcnn_eval", "graph_stage1", "knn"))
    return {name: (prof[name], n) for name, n in want.items() if prof[name] != n}


def _check_profiled(fn, launches):
    """One call of fn under torch.profiler counts each wrapper's __global__
    exactly as the wrapper counted its launches. CUPTI has lost records on
    the card (a session without a kernel, PR 22; one kernel of a session,
    PR 23): a session that disagrees is taken again, at most three, and
    the check fails when all three disagree."""
    for _ in range(3):
        prof = profiled_launches(fn)
        bad = _profiled_disagree(launches, prof)
        if not bad:
            return prof
        print(f"torch.profiler: counts {bad} (profiled, launched) disagree, taken again",
              file=sys.stderr)
    raise AssertionError(("profiled launches disagree in 3 sessions", launches, prof))


def _dv_cfg():
    cfg = configs.mnet(model_name="DeepGMR")
    return cfg.replace(
        data=dataclasses.replace(cfg.data, dataset="modelnetdv", root=DV_ROOT),
        train=dataclasses.replace(cfg.train, batch_size=B_DV,
                                  test_batch_size=B_DV))


def rot_diff_deg(a, b):
    """Angle between two rotations from |a - b|_F = 2 sqrt(2) sin(angle / 2),
    in float64: no floor from the float32 trace (angle_deg reads ~0.03
    degrees between a rotation and itself)."""
    f = (a.double() - b.double()).flatten(1).norm(dim=1) / (2 * 2 ** 0.5)
    return torch.rad2deg(2 * torch.asin(f.clamp(max=1.0)))


def _gap(ms):
    """Relative eigen gap of Horn's matrix of each (3, 3) ms."""
    from ogmm_tpu_torch.core.procrustes import _horn_matrix
    ev = torch.linalg.eigvalsh(_horn_matrix(ms.double()))
    return (ev[:, -1] - ev[:, -2]) / ev.abs().amax(-1)


def check_deepgmr_kernels(rs):
    """Each kernel of the DeepGMR path against its plain version at the
    shapes the path gives it: dgcnn_eval float32 at (24, 768) (src, no
    angles), graph_stage1 float32 at (24, 768), knn at (24, 1536, 1536,
    k=20) (tgt's graph), nn1 at (24, 768, 1536) (ICP, the metrics),
    (24, 1536, 768) (the metrics' other way) and (24, 768, 768) (pcab), and
    the whole-loop icp at (24, 768, 1536); each timed beside its plain
    version. Returns {kernel: {...}} for the kernels line."""
    f32 = torch.float32
    out = {}
    x = _cloud(rs, B_DV, N_DV)
    ws, aff = _dgcnn_operands(rs)
    got = dgcnn_eval(x, ws, aff, KNN, f32, 0)
    torch.cuda.synchronize()
    err = (got - dgcnn_eval_reference(x, ws, aff, KNN, f32, 0)).abs().max().item()
    out["dgcnn_eval"] = {
        "shape": [B_DV, N_DV, KNN, EMB], "max_abs_err": err,
        "ms": cuda_ms(lambda: dgcnn_eval(x, ws, aff, KNN, f32, 0), 10),
        "plain_ms": cuda_ms(lambda: dgcnn_eval_reference(x, ws, aff, KNN, f32, 0), 2)}
    assert err <= LIM_DGCNN_F32, err
    z1, e, idx, _ = graph_stage1(x, ws[0], KNN, f32, 0)
    torch.cuda.synchronize()
    rz1, re, ridx, _ = graph_stage1_reference(x, ws[0], KNN, f32, 0)
    err = (z1 - rz1).abs().max().item()
    assert torch.equal(idx, ridx) and torch.equal(e, re) and err <= LIM_Z1_F32
    out["graph_stage1"] = {
        "shape": [B_DV, N_DV, KNN], "max_abs_err": err,
        "ms": cuda_ms(lambda: graph_stage1(x, ws[0], KNN, f32, 0), 20),
        "plain_ms": cuda_ms(lambda: graph_stage1_reference(x, ws[0], KNN, f32, 0), 2)}
    y = _cloud(rs, B_DV, M_DV)
    same = torch.equal(knn(y, y, KNN), knn_reference(y, y, KNN))
    assert same
    out["knn"] = {"shape": [B_DV, M_DV, M_DV, KNN], "max_abs_err": 0,
                  "ms": cuda_ms(lambda: knn(y, y, KNN), 20),
                  "plain_ms": cuda_ms(lambda: knn_reference(y, y, KNN), 1)}
    nn1_res = {}
    for q, t in ((x, y), (y, x), (x, x.flip(1).contiguous())):
        d, i = nn1(q, t)
        torch.cuda.synchronize()
        rd, ri = nn1_reference(q, t)
        assert torch.equal(i, ri) and torch.equal(d, rd)
        key = f"{q.shape[1]}x{t.shape[1]}"
        nn1_res[key] = {"ms": cuda_ms(lambda: nn1(q, t), 50),
                        "plain_ms": cuda_ms(lambda: nn1_reference(q, t), 5)}
    out["nn1"] = {"max_abs_err": 0.0, **nn1_res}
    thr2 = (2.0 * configs.ModelConfig().overlap_radius) ** 2
    src, tgt, init = _icp_inputs(rs, B_DV, N_DV, M_DV)
    r, t_, first = cuda_icp.icp_fused(src, tgt, init, thr2, return_first=True)
    torch.cuda.synchronize()
    rr, rt, rfirst = cuda_icp.icp_fused_reference(src, tgt, init, thr2,
                                                  return_first=True)
    err = max((r - rr).abs().max().item(), (t_ - rt).abs().max().item())
    assert torch.equal(first, rfirst) and err <= LIM_ICP_POSE, err
    out["icp"] = {"shape": [B_DV, N_DV, M_DV], "max_abs_err": err,
                  "ms": cuda_ms(lambda: cuda_icp.icp_fused(src, tgt, init, thr2), 10),
                  "plain_ms": cuda_ms(lambda: cuda_icp.icp_fused_reference(
                      src, tgt, init, thr2), 2)}
    for name, res in out.items():
        print(f"{name} at the DeepGMR path's shapes, kernel against plain: "
              f"{json.dumps(res)}")
    return out


def serve_deepgmr(cfg, requests):
    """Registrar(configs.mnet(model_name="DeepGMR")), seeded weights, on
    modelnetdv test batches: launches (dispatch counts and profiler counts),
    times (host clock and CUDA events) and peak memory of each variant, and
    the kernel path against the plain versions."""
    from ogmm_tpu_torch.nn.deepgmr import cross_covariance
    regs = {on: Registrar(cfg, seed=0, device=DEV, loop_kernels=on)
            for on in (False, True)}
    for reg in regs.values():
        reg(*requests[0], refine=True)                   # warm up
    torch.cuda.synchronize()
    res, outs = {}, {}
    for on in (False, True):
        for refine in (False, True):
            key = ("icp" if refine else "forward") + ("_loops" if on else "")
            reg = regs[on]
            src, tgt = requests[0]
            dispatch.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats()
            reg(src, tgt, refine=refine)
            torch.cuda.synchronize()
            launches = {k: v for k, v in dispatch.launch_counts.items() if v}
            peak = torch.cuda.max_memory_allocated() / 2 ** 20
            prof = _check_profiled(lambda: reg(src, tgt, refine=refine), launches)
            want = {"dgcnn_eval": 1, "knn": 1}
            if refine:
                want.update({"icp": 1} if on else {"nn1": 30})
            assert launches == want, (key, launches)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            host = []
            start.record()
            for src, tgt in requests:
                t0 = time.perf_counter()
                outs[key] = reg(src, tgt, refine=refine)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            torch.cuda.synchronize()
            rot, trans, so, to = outs[key]
            assert rot.shape == (B_DV, 3, 3) and trans.shape == (B_DV, 3)
            assert so.shape == (B_DV, N_DV) and to.shape == (B_DV, M_DV)
            assert torch.isfinite(rot).all() and torch.isfinite(trans).all()
            eye = torch.eye(3, device=DEV).expand(B_DV, 3, 3)
            assert (rot @ rot.transpose(1, 2) - eye).abs().max() < 1e-4
            res[key] = {"host_ms": host,
                        "events_ms": start.elapsed_time(end) / len(requests),
                        "peak_mib": peak, "launches": launches,
                        "profiled": prof}
            print(f"DeepGMR request ({B_DV} pairs, {N_DV} against {M_DV}), "
                  f"{key}: host {[round(v, 2) for v in host]} ms, CUDA events "
                  f"{res[key]['events_ms']:.2f} ms a request, peak "
                  f"{peak:.0f} MiB, launches {launches}, profiled {prof}")
    # the same last request through the plain versions
    src, tgt = requests[-1]
    model = regs[False].model
    x_s = torch.as_tensor(src, device=DEV)
    x_t = torch.as_tensor(tgt, device=DEV)
    with torch.no_grad():
        mom_k = [model.moments(x) for x in (x_s, x_t)]
        with plain_versions():
            before = dict(dispatch.launch_counts)
            mom_p = [model.moments(x) for x in (x_s, x_t)]
            plain = {on: {refine: regs[on](src, tgt, refine=refine)
                          for refine in (False, True)} for on in (False, True)}
            assert dict(dispatch.launch_counts) == before
    d_mom = max((a - b).abs().max().item() for mk, mp in zip(mom_k, mom_p)
                for a, b in zip(mk[1:], mp[1:]))
    ms = cross_covariance(mom_k[0][1], mom_k[0][2], mom_k[1][2], mom_k[1][3])[0]
    gap = _gap(ms)
    print(f"DeepGMR moments (pi, mu, sigma of both clouds), kernels against "
          f"plain: {d_mom:.3g} (limit {LIM_DGMR_MOMENTS}); relative eigen gap "
          f"of Horn's matrix: min {gap.min().item():.3g}, median "
          f"{gap.median().item():.3g}")
    assert d_mom <= LIM_DGMR_MOMENTS
    against = {}
    for on in (False, True):
        for refine in (False, True):
            key = ("icp" if refine else "forward") + ("_loops" if on else "")
            k_rot, k_tr = outs[key][:2]
            p_rot, p_tr = plain[on][refine][:2]
            ang = rot_diff_deg(k_rot, p_rot)
            d_tr = (k_tr - p_tr).abs().max(dim=-1).values
            lim = LIM_DGMR_ICP_DEG if refine else LIM_DGMR_ROT_DEG
            against[key] = {"rot_median_deg": ang.median().item(),
                            "rot_max_deg": ang.max().item(),
                            "trans_median": d_tr.median().item(),
                            "trans_max": d_tr.max().item()}
            print(f"DeepGMR {key}, kernels against plain versions: rotation "
                  f"median {ang.median().item():.3g} deg (limit {lim}), max "
                  f"{ang.max().item():.3g} deg; translation median "
                  f"{d_tr.median().item():.3g}, max {d_tr.max().item():.3g}")
            assert ang.median().item() <= lim
    res["against_plain"] = against
    res["moments_plain"] = d_mom
    res["gap_min"], res["gap_median"] = gap.min().item(), gap.median().item()
    return res


def train_deepgmr(cfg, batches):
    """make_train_step of DeepGMR at B=24, 768 against 1536: a warm-up step,
    one step with the launch counts (graph_stage1 1: src's graph and first
    stage; knn 1: tgt's graph, the unfused chain above N = 1024; nn1 3: the
    metrics' 1-NN both ways and pcab), five timed steps, peak memory, every
    parameter moved; one step from the same state through the kernels and
    through their plain versions; one with src's DGCNN backward through
    the backward kernels (`BWD_KERNELS`, off by default and in the rest of
    this phase) against the plain backward."""
    state = create_train_state(cfg, steps_per_epoch=100, seed=0, device=DEV)
    step = make_train_step(cfg)
    before = {n: t.detach().clone() for n, t in state.model.state_dict().items()}
    step(state, batches[0])                               # warm up
    torch.cuda.synchronize()
    dispatch.reset_launch_counts()
    metrics = step(state, batches[1])
    torch.cuda.synchronize()
    launches = {k: v for k, v in dispatch.launch_counts.items() if v}
    prof = _check_profiled(lambda: step(state, batches[0]), launches)
    assert launches == {"graph_stage1": 1, "knn": 1, "nn1": 3}, launches
    assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(state, batches[i % len(batches)])["loss"][0] for i in range(5)]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / 5 * 1e3
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [v.item() for v in losses]
    assert all(np.isfinite(losses))
    after = state.model.state_dict()
    unchanged = [n for n in before if torch.equal(before[n], after[n])]
    assert not unchanged, f"not moved by training: {unchanged}"
    print(f"DeepGMR train step ({B_DV} pairs, {N_DV} against {M_DV}): "
          f"{step_ms:.2f} ms (host clock, five steps), peak {peak:.0f} MiB, "
          f"losses {[round(v, 5) for v in losses]}, launches {launches}, "
          f"profiled {prof}")
    batch = batches[2]
    dispatch.reset_launch_counts()
    k_loss, k_grads = _step_grads(state, cfg, batch)
    k_launches = {k: v for k, v in dispatch.launch_counts.items() if v}
    assert k_launches == {"graph_stage1": 1, "knn": 1}, k_launches
    with plain_versions():
        counts = dict(dispatch.launch_counts)
        p_loss, p_grads = _step_grads(state, cfg, batch)
        assert dict(dispatch.launch_counts) == counts
    d_loss = abs(k_loss - p_loss) / abs(p_loss)
    d_grad = _rel(k_grads, p_grads)
    print(f"DeepGMR train step (the kernel run launched {k_launches}), "
          f"kernels against plain versions: loss "
          f"{k_loss:.6f} / {p_loss:.6f}, relative {d_loss:.3g} (limit "
          f"{LIM_DGMR_LOSS}); gradients relative {d_grad:.3g} (limit "
          f"{LIM_DGMR_GRAD})")
    assert d_loss <= LIM_DGMR_LOSS and d_grad <= LIM_DGMR_GRAD
    ops_dgcnn_train.BWD_KERNELS = True
    try:
        dispatch.reset_launch_counts()
        b_loss, b_grads = _step_grads(state, cfg, batch)
        b_launches = {k: v for k, v in dispatch.launch_counts.items() if v}
    finally:
        ops_dgcnn_train.BWD_KERNELS = False
    d_bwd = _rel(b_grads, k_grads)
    print(f"DeepGMR train step with BWD_KERNELS (launched {b_launches}) "
          f"against the plain backward: loss {b_loss!r} / {k_loss!r}; "
          f"gradients relative {d_bwd:.3g} (limit {LIM_DGMR_BWD_GRAD})")
    assert b_launches == {"graph_stage1": 1, "knn": 1, "bwd_reduce": 1,
                          "bwd_stage": 3, "bwd_edge": 1}, b_launches
    assert b_loss == k_loss and d_bwd <= LIM_DGMR_BWD_GRAD
    return {"step_ms": step_ms, "peak_mib": peak, "losses": losses,
            "launches": launches, "profiled": prof, "loss_rel_plain": d_loss,
            "grad_rel_plain": d_grad, "bwd_kernels_launches": b_launches,
            "grad_rel_bwd_kernels": d_bwd}


def run_deepgmr_cli(requests):
    """`python -m ogmm_tpu_torch.train --model DeepGMR --dataset modelnetdv`
    on the card: three steps at B=24, an eval batch with ICP, a checkpoint
    under checkpoints/DeepGMR/, `--export_weights`; the export served back
    through Registrar.from_weights, against the trained model's weights."""
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "deepgmr.npz")
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["--model", "DeepGMR", "--dataset", "modelnetdv",
                            "--root", DV_ROOT, "--batch_size", str(B_DV),
                            "--test_batch_size", str(B_DV), "--epochs", "1",
                            "--steps_per_epoch", "3", "--model_path", tmp,
                            "--export_weights", npz])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in dispatch.launch_counts.items() if v}
        saved = os.path.exists(os.path.join(tmp, "checkpoints", "DeepGMR",
                                            "models", "optim_model.pt"))
        served = Registrar.from_weights(npz, device=DEV)
    rec = trainer.history[-1]
    print(f"DeepGMR CLI: {trainer.state.step} steps and an eval batch with ICP "
          f"in {secs:.1f} s (data pipeline included), train loss "
          f"{rec['train']['loss']:.5f}, eval loss {rec['val']['loss']:.5f}, "
          f"checkpoint written {saved}; launches {launches}")
    assert trainer.state.step == 3 and saved
    assert trainer.state.device.type == DEV.type
    assert np.isfinite(rec["train"]["loss"]) and np.isfinite(rec["val"]["loss"])
    # three steps (graph_stage1, knn, nn1 x3 each) and an eval batch
    # (dgcnn_eval, knn, 30 ICP trips, the metrics' three 1-NN)
    assert launches == {"graph_stage1": 3, "knn": 4, "dgcnn_eval": 1,
                        "nn1": 3 * 3 + 30 + 3}, launches
    assert served.cfg.model_name == "DeepGMR"
    trained = Registrar(trainer.cfg, state_dict=trainer.state.model.state_dict(),
                        device=DEV)
    src, tgt = requests[0]
    got, want = served(src, tgt, refine=True), trained(src, tgt, refine=True)
    diff = max((a - b).abs().max().item() for a, b in zip(got, want))
    print(f"DeepGMR export served back through Registrar.from_weights: refined "
          f"poses against the trained model's, max difference {diff:.3g}")
    assert all(torch.isfinite(a).all() for a in got) and diff <= 1e-6
    return {"seconds": secs, "train_loss": rec["train"]["loss"],
            "eval_loss": rec["val"]["loss"], "launches": launches}


def deepgmr(_):
    """The JAX package's second model on the card at its full width,
    `configs.mnet(model_name="DeepGMR")` (emb 512, K=128, k=20, float32
    body: its DGCNN takes no compute type), on the modelnetdv geometry (B=24
    pairs of 768 against 1536 points, the synthetic source): serving,
    training and the CLI."""
    t_phase = time.perf_counter()
    from ogmm_tpu_torch.data import data_loader
    # the default backward (earlier phases turn the switch on)
    bwd_kernels = ops_dgcnn_train.BWD_KERNELS
    ops_dgcnn_train.BWD_KERNELS = False
    cfg = _dv_cfg()
    m = cfg.model
    assert (m.emb_dims, m.n_clusters, m.gnn_k, m.overlap_radius,
            m.icp_iters) == (EMB, K, KNN, 0.035, 30)
    train_loader, test_loader = data_loader(cfg)
    requests = []
    for b in test_loader:
        requests.append((b["src_xyz"], b["tgt_xyz"]))
        if len(requests) == 3:
            break
    batches = []
    for b in train_loader:
        batches.append(b)
        if len(batches) == 3:
            break
    assert requests[0][0].shape == (B_DV, N_DV, 3)
    assert requests[0][1].shape == (B_DV, M_DV, 3)
    kernels = check_deepgmr_kernels(np.random.RandomState(19))
    serving = serve_deepgmr(cfg, requests)
    training = train_deepgmr(cfg, batches)
    # the path's launches: one request of each serving variant and one
    # train step, each counted from 0 right before it ran
    launches = {name: 0 for name in dispatch.KERNELS}
    for counts in [serving[key]["launches"] for key in
                   ("forward", "icp", "forward_loops", "icp_loops")] + [
                       training["launches"]]:
        for name, v in counts.items():
            launches[name] += v
    cli_res = run_deepgmr_cli(requests)
    ops_dgcnn_train.BWD_KERNELS = bwd_kernels
    secs = time.perf_counter() - t_phase
    print(f"deepgmr phase: {secs:.1f} s")
    return launches, {"kernels": kernels, "serve": serving, "train": training,
                      "cli": cli_res, "phase_s": secs}


# ------------------------------------------- the rest of the model surface

LIM_PL_POSE = 1e-4        # point-to-plane, kernels against plain versions:
#                           the same kNN and 1-NN indices, 30 Gauss-Newton
#                           solves of the same sums (as LIM_ICP_POSE)
LIM_RECOVER_DEG = 0.1     # a rigid copy's pose recovered from ~3 degrees
LIM_RECOVER_T = 1e-3      # and 0.01 off (as check_icp)
LIM_GRID_POSE = 1e-4      # the grid route against the spatial route: exact
#                           under the gate, sums in another order
LIM_REMAT_GRAD = 1e-6     # remat against none, from one state: the same
#                           forward, activations recomputed in the backward
GRID_CAP = 32             # candidates a grid cell (the JAX package's default)
N_PL = (N, N_LARGE, N_INDOOR)   # the three point-to-plane shapes


def _timed(fn, reps=3):
    """fn's last output and its host ms a call (each synchronised), its
    CUDA-event ms a call over the same calls, and the peak device memory,
    after a warm-up."""
    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    host = []
    start.record()
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    end.record()
    torch.cuda.synchronize()
    return out, {"host_ms": host, "events_ms": start.elapsed_time(end) / reps,
                 "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}


def _busy_ms(fn, groups=None):
    """Device ms of one call of fn from torch.profiler: every kernel's, and
    the kernels named by each group {label: name part}."""
    fn()
    torch.cuda.synchronize()
    out = {"busy": 0.0, **{label: 0.0 for label in groups or {}}}
    for evt in device_trace(fn):
        ms = evt.self_device_time_total / 1e3
        out["busy"] += ms
        for label, part in (groups or {}).items():
            if part in evt.key:
                out[label] += ms
    return out


def _add_counts(total, counts):
    """Add one run's launch counts into `total`."""
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _counted(fn):
    """fn's output and the launches it made, counted from 0 right before."""
    dispatch.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v for k, v in dispatch.launch_counts.items() if v}


def _start_off(rs, rot, trans):
    """A start pose about 3 degrees (a uniform +-0.03 rad rotation vector)
    and 0.01 off (rot, trans)."""
    b = rot.shape[0]
    d = torch.tensor(rs.uniform(-0.03, 0.03, (b, 3)).astype(np.float32), device=DEV)
    skew = torch.zeros(b, 3, 3, device=DEV)
    skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = -d[:, 2], d[:, 1], -d[:, 0]
    skew = skew - skew.transpose(1, 2)
    dt = torch.tensor(rs.uniform(-0.01, 0.01, (b, 3)).astype(np.float32), device=DEV)
    return torch.linalg.matrix_exp(skew) @ rot, trans + dt


def surface_serve(rs):
    """(a) `Registrar(configs.serve())` (6 EM trips, bf16 body) at B=24,
    N=717 beside `configs.mnet(dtype="bfloat16")` (10 trips), same weights:
    launches, host and CUDA-event times in turns (serve, mnet, mnet, serve),
    device busy time and the EM kernel's, peak memory; the serve request
    against its plain versions."""
    regs = {"serve": Registrar(configs.serve(), seed=0, device=DEV),
            "mnet_bf16": Registrar(configs.mnet(model=configs.ModelConfig(
                dtype="bfloat16")), seed=0, device=DEV)}
    m = regs["serve"].cfg.model
    assert (m.em_iters, m.dtype, m.emb_dims, m.n_clusters, m.icp_iters) == \
        (6, "bfloat16", EMB, K, 30)
    requests = [make_pairs(rs, B, N) for _ in range(3)]
    res = {name: {} for name in regs}
    for name, reg in regs.items():
        for refine in (False, True):
            src, tgt, _, _ = requests[0]
            reg(src, tgt, refine=refine)                  # warm up
            out, launches = _counted(lambda: reg(src, tgt, refine=refine))
            assert launches == {"dgcnn_eval": 1, "sinkhorn_em": 1, "nn1": 1}, launches
            key = "icp" if refine else "forward"
            res[name][key] = {"launches": launches, "host_ms": [], "events_ms": []}
            res[name][key].update(_busy_ms(lambda: reg(src, tgt, refine=refine),
                                           {"em_ms": "em_kernel"}))
    for name in ("serve", "mnet_bf16", "mnet_bf16", "serve"):
        for refine in (False, True):
            key = "icp" if refine else "forward"
            it = itertools.cycle(requests)
            _, t = _timed(lambda: regs[name](*next(it)[:2], refine=refine))
            res[name][key]["host_ms"] += t["host_ms"]
            res[name][key]["events_ms"].append(t["events_ms"])
            res[name][key]["peak_mib"] = t["peak_mib"]
    src, tgt, _, _ = requests[-1]
    outs = {("serve", refine): regs["serve"](src, tgt, refine=refine)
            for refine in (False, True)}
    for name, r in res.items():
        for key, v in r.items():
            print(f"surface (a) {name} {key} ({B} pairs of {N}): host "
                  f"{[round(x, 2) for x in v['host_ms']]} ms, CUDA events "
                  f"{[round(x, 2) for x in v['events_ms']]} ms, busy "
                  f"{v['busy']:.3f} ms (EM {v['em_ms']:.3f}), peak "
                  f"{v['peak_mib']:.0f} MiB, launches {v['launches']}")
    for refine in (False, True):
        rot, trans, so, to = outs["serve", refine]
        assert torch.isfinite(rot).all() and torch.isfinite(trans).all()
        assert ((so >= 0) & (so <= 1)).all()
    with plain_versions():
        before = dict(dispatch.launch_counts)
        p_rot, _, p_so, p_to = regs["serve"](src, tgt, refine=True)
        assert dict(dispatch.launch_counts) == before
    k_rot, _, k_so, k_to = outs["serve", True]
    d_o = max((k_so - p_so).abs().max().item(), (k_to - p_to).abs().max().item())
    ang = angle_deg(k_rot, p_rot)
    print(f"surface (a) serve, kernels against plain versions: overlap "
          f"{d_o:.3g} (limit {LIM_OVERLAP}), refined rotation median "
          f"{ang.median().item():.3g} deg (limit {LIM_ROT_DEG}), max "
          f"{ang.max().item():.3g}")
    assert d_o <= LIM_OVERLAP and ang.median().item() <= LIM_ROT_DEG
    res["serve"]["against_plain"] = {"overlap": d_o,
                                     "rot_median_deg": ang.median().item()}
    est = outs["serve", False]
    return res, (requests[-1], est)


def _original_state_dict(model):
    """The port GMMReg's weights in the original PyTorch code's key layout:
    the inverse of `ogmm_tpu_torch.compat.convert_gmmreg_state_dict`
    (channel-strided heads, 1x1 conv weights), the check's own."""
    from ogmm_tpu_torch.compat import _head_perm
    from ogmm_tpu_torch.weights import flat_variables
    flat = flat_variables(model.state_dict(), "GMMReg")
    tree = {}
    for key, a in flat.items():
        node = tree
        *parts, leaf = key.split("/")
        for p in parts:
            node = node.setdefault(p, {})
        node[leaf] = a
    P, S = tree["params"], tree["batch_stats"]
    sd = {}

    def conv(kernel, ndim=3):
        w = np.ascontiguousarray(kernel.T)
        return w.reshape(*w.shape, *([1] * (ndim - 2)))

    def dense(name, e):
        sd[f"{name}.weight"] = conv(e["kernel"])
        if "bias" in e:
            sd[f"{name}.bias"] = e["bias"]

    def bn(name, p, s):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]
        sd[f"{name}.running_mean"], sd[f"{name}.running_var"] = s["mean"], s["var"]

    dg_p, dg_s = P["DGCNN_0"], S["DGCNN_0"]
    for i in range(1, 6):
        sd[f"emd.conv{i}.weight"] = conv(dg_p[f"w{i}"], 4 if i < 5 else 3)
        bn(f"emd.bn{i}", {"scale": dg_p[f"bn{i}_scale"], "bias": dg_p[f"bn{i}_bias"]},
           {"mean": dg_s[f"bn{i}_mean"], "var": dg_s[f"bn{i}_var"]})
    pe_p, pe_s = P["PositionEncoding_0"], S["PositionEncoding_0"]
    for i, name in enumerate(("pos.conv_dis.0", "pos.conv_dis.3",
                              "pos.conv_ang1.0", "pos.conv_ang2.0")):
        dense(name, pe_p[f"Dense_{i}"])
        head, last = name.rsplit(".", 1)
        bn(f"{head}.{int(last) + 1}", pe_p[f"BN_{i}"]["BatchNorm_0"],
           pe_s[f"BN_{i}"]["BatchNorm_0"])
    inv = np.argsort(_head_perm(EMB, 4))
    for i, name in enumerate(("sattn1", "cattn", "sattn2")):
        tb = P[f"TransformerBlock_{i}"]
        mha = tb["MultiHeadAttention_0"]
        for j in range(3):
            e = mha[f"Dense_{j}"]
            dense(f"{name}.attn.proj.{j}", {"kernel": e["kernel"][:, inv],
                                            "bias": e["bias"][inv]})
        e = mha["Dense_3"]
        dense(f"{name}.attn.merge", {"kernel": e["kernel"][inv, :], "bias": e["bias"]})
        dense(f"{name}.mlp.0", tb["PointMLP_0"]["Dense_0"])
        dense(f"{name}.mlp.3", tb["PointMLP_0"]["Dense_1"])
    for i, (name, deep) in enumerate((("conv1", True), ("conv2", True),
                                      ("proj", False), ("overlap", True))):
        p, s = P[f"ConvHead_{i}"], S.get(f"ConvHead_{i}", {})
        layers = [(0, "Dense_0", "BN_0"), (3, "Dense_1", "BN_1" if deep else None)]
        if deep:
            layers.append((6, "Dense_2", None))
        for idx, dname, bname in layers:
            dense(f"{name}.net.{idx}", p[dname])
            if bname is not None:
                bn(f"{name}.net.{idx + 1}", p[bname]["BatchNorm_0"],
                   s[bname]["BatchNorm_0"])
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def surface_checkpoint(rs):
    """(b) The CLI recipe of phase 5 (synthetic, bf16, B=24, three steps)
    into a temporary --model_path; `Registrar.from_checkpoint` serves a
    request bit-equal to a Registrar of the trainer's own model;
    `export_weights` then `from_weights` bit-equal; a cfg with another
    emb_dims raises; `registrar_from_torch_checkpoint` on the weights
    written in the original code's key layout serves the same request."""
    from ogmm_tpu_torch.api import registrar_from_torch_checkpoint
    ops_dgcnn_train.BWD_KERNELS = True
    src, tgt, _, _ = make_pairs(rs, B, N)
    with tempfile.TemporaryDirectory() as tmp:
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["--dataset", "synthetic", "--root", "synthetic:200",
                            "--dtype", "bfloat16", "--batch_size", str(B),
                            "--test_batch_size", str(B), "--epochs", "1",
                            "--steps_per_epoch", "3", "--model_path", tmp])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in dispatch.launch_counts.items() if v}
        own = Registrar(trainer.cfg, state_dict=trainer.state.model.state_dict(),
                        device=DEV)
        want = own(src, tgt, refine=True)
        t0 = time.perf_counter()
        reg = Registrar.from_checkpoint(tmp, device=DEV)
        load_s = time.perf_counter() - t0
        assert configs.config_to_dict(reg.cfg) == configs.config_to_dict(trainer.cfg)
        same = {"from_checkpoint": all(torch.equal(a, b) for a, b in
                                       zip(reg(src, tgt, refine=True), want))}
        npz = os.path.join(tmp, "w.npz")
        reg.export_weights(npz)
        back = Registrar.from_weights(npz, device=DEV)
        same["export_weights"] = all(torch.equal(a, b) for a, b in
                                     zip(back(src, tgt, refine=True), want))
        wider = trainer.cfg.replace(model=dataclasses.replace(
            trainer.cfg.model, emb_dims=2 * EMB))
        try:
            Registrar.from_checkpoint(tmp, cfg=wider, device=DEV)
            refused = False
        except ValueError as e:
            refused = "model" in str(e)
        pt = os.path.join(tmp, "original.pt")
        torch.save(_original_state_dict(own.model), pt)
        orig = registrar_from_torch_checkpoint(pt, trainer.cfg, device=DEV)
        same["torch_checkpoint"] = all(torch.equal(a, b) for a, b in
                                       zip(orig(src, tgt, refine=True), want))
    print(f"surface (b) checkpoint round trip: the CLI in {secs:.1f} s "
          f"(launches {launches}), from_checkpoint in {load_s:.2f} s; outputs "
          f"bit-equal to the trainer's model: {same}; another emb_dims "
          f"refused: {refused}")
    assert all(same.values()) and refused
    return {"cli_s": secs, "from_checkpoint_s": load_s, "bit_equal": same,
            "refused": refused, "launches_cli": launches}


def _refine_case(rs, name, src, tgt, rot, trans, start, want_launches):
    """refine_registration(pl=True) from `start`: launches, times, peak
    memory, against the plain versions; the recovery of (rot, trans)."""
    from ogmm_tpu_torch.core.metrics import rotation_error, translation_error
    from ogmm_tpu_torch.ops.icp import refine_registration
    voxel = configs.ModelConfig().overlap_radius
    run = lambda: refine_registration(src, tgt, start[0], start[1], voxel, pl=True)
    run()
    (r, t), launches = _counted(run)
    assert launches == want_launches, (name, launches)
    _, times = _timed(run)
    busy = _busy_ms(run)["busy"]
    with plain_versions():
        before = dict(dispatch.launch_counts)
        pr, pt = run()
        assert dict(dispatch.launch_counts) == before
    err = max((r - pr).abs().max().item(), (t - pt).abs().max().item())
    res = {"launches": launches, **times, "busy_ms": busy, "max_abs_err": err}
    if rot is not None:
        res["rot_err_deg"] = rotation_error(r, rot).max().item()
        res["trans_err"] = translation_error(t, trans).max().item()
        res["start_rot_err_deg"] = rotation_error(start[0], rot).max().item()
    print(f"surface (c) point-to-plane {name}: launches {launches}, host "
          f"{[round(x, 2) for x in times['host_ms']]} ms, CUDA events "
          f"{times['events_ms']:.2f} ms, busy {busy:.3f} ms, peak "
          f"{times['peak_mib']:.0f} MiB; against plain versions {err:.3g} "
          f"(limit {LIM_PL_POSE})" + (
              f"; recovered: rotation {res['rot_err_deg']:.3g} deg (from "
              f"{res['start_rot_err_deg']:.3g}; limit {LIM_RECOVER_DEG}), "
              f"translation {res['trans_err']:.3g} (limit {LIM_RECOVER_T})"
              if rot is not None else ""))
    assert err <= LIM_PL_POSE
    if rot is not None:
        assert res["rot_err_deg"] <= LIM_RECOVER_DEG
        assert res["trans_err"] <= LIM_RECOVER_T
    return (r, t), res


def surface_refine(rs, estimate):
    """(c) refine_registration(pl=True): from request (a)'s estimate at B=24,
    N=M=717 (normals through the knn kernel at k=16, 30 dense trips), and
    from ~3 degrees off a known pose on height fields: B=24 at N=M=717 and
    at 1433 (the nn1 kernel each trip) and the indoor B=1, N=M=35,000 (the
    normals through knn_stream, 30 nn1_stream trips with the cull and the
    gate). (d) use_grid=True at the indoor shape for both ICPs against the
    spatial route: poses, the densest cell against GRID_CAP, times."""
    from ogmm_tpu_torch.ops.grid_nn import build_grid
    from ogmm_tpu_torch.ops.icp import (icp_point_to_plane,
                                        icp_point_to_point)
    (src, tgt, _, _), (e_rot, e_trans, _, _) = estimate
    s, t = (torch.as_tensor(a, device=DEV) for a in (src, tgt))
    res = {}
    _, res["estimate_717"] = _refine_case(rs, f"({B}, {N}) from (a)'s estimate",
                                          s, t, None, None, (e_rot, e_trans),
                                          {"knn": 1})
    launches = dict(res["estimate_717"]["launches"])
    indoor = None
    for n in N_PL:
        b = 1 if n == N_INDOOR else B
        src, tgt, rot, trans = rigid_copies(rs, surface(rs, b, n))
        src, tgt, rot, trans = (torch.tensor(a, device=DEV) for a in (src, tgt, rot, trans))
        start = _start_off(rs, rot, trans)
        want = ({"knn_stream": 1, "nn1_stream": 30} if n == N_INDOOR else
                {"knn": 1, "nn1": 30} if n == N_LARGE else {"knn": 1})
        _, res[f"pose_{n}"] = _refine_case(rs, f"({b}, {n}) from 3 degrees off",
                                           src, tgt, rot, trans, start, want)
        _add_counts(launches, res[f"pose_{n}"]["launches"])
        if n == N_INDOOR:
            indoor = src, tgt, rot, trans, start
    src, tgt, rot, trans, start = indoor
    init = se3.integrate(*start)
    thr = 2.0 * configs.ModelConfig().overlap_radius
    occ = build_grid(tgt, thr).max_occupancy.max().item()
    # the grid is exact only while grid_cap holds the densest cell: a cap
    # from the occupancy (a multiple of 32), and the default cap timed too
    cap = -(-occ // GRID_CAP) * GRID_CAP
    grid = {"max_occupancy": occ, "grid_cap": cap, "default_cap": GRID_CAP}
    for pname, icp in (("point", icp_point_to_point), ("plane", icp_point_to_plane)):
        on_grid = lambda c=cap: icp(src, tgt, init, thr, use_grid=True, grid_cap=c)
        (gr, gt_), launches_g = _counted(on_grid)
        (sr, st), launches_s = _counted(lambda: icp(src, tgt, init, thr))
        (cr, ct), _ = _counted(lambda: on_grid(GRID_CAP))
        _, tg = _timed(on_grid)
        _, tc = _timed(lambda: on_grid(GRID_CAP))
        _, ts = _timed(lambda: icp(src, tgt, init, thr))
        err = max((gr - sr).abs().max().item(), (gt_ - st).abs().max().item())
        err_c = max((cr - sr).abs().max().item(), (ct - st).abs().max().item())
        grid[pname] = {"grid": tg, "grid_default_cap": tc, "spatial": ts,
                       "max_abs_err": err, "max_abs_err_default_cap": err_c,
                       "launches_grid": launches_g, "launches_spatial": launches_s,
                       "busy_ms_grid": _busy_ms(on_grid)["busy"],
                       "busy_ms_spatial": _busy_ms(lambda: icp(src, tgt, init, thr))["busy"]}
        print(f"surface (d) grid route, point-to-{pname} at (1, {N_INDOOR}): grid "
              f"cap {cap} {[round(x, 2) for x in tg['host_ms']]} ms (events "
              f"{tg['events_ms']:.2f}, busy {grid[pname]['busy_ms_grid']:.3f}, peak "
              f"{tg['peak_mib']:.0f} MiB, launches {launches_g}); grid cap "
              f"{GRID_CAP} {[round(x, 2) for x in tc['host_ms']]} ms (poses "
              f"{err_c:.3g} from the spatial route's); spatial "
              f"{[round(x, 2) for x in ts['host_ms']]} ms (events "
              f"{ts['events_ms']:.2f}, busy {grid[pname]['busy_ms_spatial']:.3f}, "
              f"peak {ts['peak_mib']:.0f} MiB, launches {launches_s}); poses "
              f"{err:.3g} apart (limit {LIM_GRID_POSE}); densest cell {occ} points")
        assert err <= LIM_GRID_POSE, err
        assert launches_g == ({} if pname == "point" else {"knn_stream": 1}), launches_g
        _add_counts(launches, launches_g)
        _add_counts(launches, launches_s)
    res["grid"] = grid
    return launches, res


def surface_options(rs, requests):
    """(e) The four model options at full width, bf16 body, seeded weights:
    recompute_anchors with and without loop_kernels (fps launches; outputs
    against the default request: the same anchors from index 0), stack_eval
    False against the stacked request, one train step with stack_train
    (against the plain versions) and one with remat (against the step
    without it from the same state: loss and running statistics bit-equal,
    gradients within LIM_REMAT_GRAD; the peak memory of both)."""
    base = configs.ModelConfig(dtype="bfloat16")
    cfg_of = lambda **o: configs.mnet(model=dataclasses.replace(base, **o))
    src, tgt = requests[0][:2]
    res, launches = {}, {}
    add = lambda counts: _add_counts(launches, counts)
    for lk in (False, True):
        ref = Registrar(cfg_of(), seed=0, device=DEV, loop_kernels=lk)
        reg = Registrar(cfg_of(recompute_anchors=True), seed=0, device=DEV,
                        loop_kernels=lk)
        ref(src, tgt, refine=True)
        reg(src, tgt, refine=True)
        want, _ = _counted(lambda: ref(src, tgt, refine=True))
        got, counts = _counted(lambda: reg(src, tgt, refine=True))
        add(counts)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        _, t = _timed(lambda: reg(src, tgt, refine=True))
        key = "recompute_anchors" + ("_loops" if lk else "")
        res[key] = {"launches": counts, "equal_to_default": same, **t}
        print(f"surface (e) {key}: launches {counts}, outputs equal to the "
              f"default request {same}, host {[round(x, 2) for x in t['host_ms']]} ms")
        assert same and counts.get("fps", 0) == (4 if lk else 0), counts
    ref = Registrar(cfg_of(), seed=0, device=DEV)
    reg = Registrar(cfg_of(stack_eval=False), seed=0, device=DEV)
    want = ref(src, tgt, refine=True)
    reg(src, tgt, refine=True)
    got, counts = _counted(lambda: reg(src, tgt, refine=True))
    add(counts)
    d_o = max((got[2] - want[2]).abs().max().item(), (got[3] - want[3]).abs().max().item())
    ang = angle_deg(got[0], want[0])
    _, t = _timed(lambda: reg(src, tgt, refine=True))
    res["stack_eval_false"] = {"launches": counts, "overlap": d_o,
                               "rot_median_deg": ang.median().item(), **t}
    print(f"surface (e) stack_eval=False: launches {counts}; against the stacked "
          f"request: overlap {d_o:.3g} (limit {LIM_OVERLAP}), rotation median "
          f"{ang.median().item():.3g} deg (limit {LIM_ROT_DEG}); host "
          f"{[round(x, 2) for x in t['host_ms']]} ms")
    assert d_o <= LIM_OVERLAP and ang.median().item() <= LIM_ROT_DEG
    assert counts["dgcnn_eval"] == 2, counts

    bwd = ops_dgcnn_train.BWD_KERNELS
    ops_dgcnn_train.BWD_KERNELS = True
    batch = make_batch(rs)
    tcfg = lambda **o: cfg_of(**o).replace(
        train=dataclasses.replace(configs.TrainConfig(), device_overlap=True),
        data=dataclasses.replace(configs.DataConfig(), fix_tgt_overlap=True))
    st_cfg = tcfg(stack_train=True)
    state = create_train_state(st_cfg, steps_per_epoch=100, seed=0, device=DEV)
    _train_probe(state, st_cfg, batch)                          # warm up
    (k_loss, k_grads, _, k_peak), counts = _counted(
        lambda: _train_probe(state, st_cfg, batch))
    add(counts)
    with plain_versions():
        before = dict(dispatch.launch_counts)
        p_loss, p_grads, _, _ = _train_probe(state, st_cfg, batch)
        assert dict(dispatch.launch_counts) == before
    d_loss = abs(k_loss - p_loss) / abs(p_loss)
    d_grad = _rel(k_grads, p_grads)
    res["stack_train"] = {"launches": counts, "loss_rel_plain": d_loss,
                          "grad_rel_plain": d_grad, "peak_mib": k_peak}
    print(f"surface (e) stack_train step: launches {counts}; against the plain "
          f"versions: loss {k_loss:.5f} / {p_loss:.5f}, relative {d_loss:.3g} "
          f"(limit {LIM_STEP_LOSS}), gradients {d_grad:.3g} (limit "
          f"{LIM_STEP_GRAD}); peak {k_peak:.0f} MiB")
    assert counts["graph_stage1"] == 1 and counts["bwd_reduce"] == 1, counts
    assert d_loss <= LIM_STEP_LOSS and d_grad <= LIM_STEP_GRAD
    plain_cfg, remat_cfg = tcfg(), tcfg(remat=True)
    s0 = create_train_state(plain_cfg, steps_per_epoch=100, seed=0, device=DEV)
    s1 = create_train_state(remat_cfg, steps_per_epoch=100, seed=0, device=DEV)
    _train_probe(s0, plain_cfg, batch)                          # warm up
    _train_probe(s1, remat_cfg, batch)
    l0, g0, b0, peak0 = _train_probe(s0, plain_cfg, batch)
    (l1, g1, b1, peak1), counts = _counted(lambda: _train_probe(s1, remat_cfg, batch))
    add(counts)
    worst = _rel(g1, g0)
    stats_equal = all(torch.equal(b0[k], b1[k]) for k in b0)
    res["remat"] = {"launches": counts, "loss": [l0, l1], "loss_equal": l0 == l1,
                    "grad_rel": worst, "stats_equal": stats_equal,
                    "peak_mib": peak1, "peak_mib_without": peak0}
    print(f"surface (e) remat step: launches {counts}; loss {l1!r} / {l0!r} "
          f"without, running statistics equal {stats_equal}, gradients "
          f"{worst:.3g} relative (limit {LIM_REMAT_GRAD}); peak {peak1:.0f} MiB "
          f"against {peak0:.0f} without")
    ops_dgcnn_train.BWD_KERNELS = bwd
    assert l0 == l1 and stats_equal and worst <= LIM_REMAT_GRAD
    return launches, res


def check_surface_kernels(rs):
    """(f) The kNN kernels at the shapes of the point-to-plane normals
    (k=16): knn at (24, 717, 717) and knn_stream at the indoor (1, 35000,
    35000) Morton-sorted with the cull and the diagonal order, each against
    its plain version (identical indices) and timed beside it."""
    out = {}
    x = torch.tensor(surface(rs, B, N), device=DEV)
    got = knn(x, x, 16)
    torch.cuda.synchronize()
    assert torch.equal(got, knn_reference(x, x, 16))
    out["knn"] = {"shape": [B, N, N, 16], "max_abs_err": 0,
                  "ms": cuda_ms(lambda: knn(x, x, 16), 20),
                  "plain_ms": cuda_ms(lambda: knn_reference(x, x, 16), 2)}
    y = _sorted(torch.tensor(surface(rs, 1), device=DEV))
    lb = stream.tile_pair_bounds(y)
    run = lambda: cuda_stream.knn_stream(y, y, 16, diag_order=True, cull_lb=lb)
    got = run()
    torch.cuda.synchronize()
    assert torch.equal(got, stream.knn_stream_plain(y, y, 16))
    out["knn_stream"] = {"shape": [1, N_INDOOR, N_INDOOR, 16], "max_abs_err": 0,
                         "ms": cuda_ms(run, 10),
                         "plain_ms": cuda_ms(lambda: stream.knn_stream_plain(y, y, 16), 1)}
    for name, r in out.items():
        print(f"surface (f) {name} at k=16, kernel against plain (indices "
              f"identical): {json.dumps(r)}")
    return out


def surface_phase(_):
    """The rest of the model surface, at full width on seeded weights:
    (a) the serve preset, (b) the checkpoint round trip, (c) point-to-plane
    refinement, (d) the grid route, (e) the four model options, (f) the kNN
    kernels at k=16. The phase's launches add the counts of each driven
    run, each counted from 0 right before it."""
    t_phase = time.perf_counter()
    rs = np.random.RandomState(20)
    kernels = check_surface_kernels(rs)
    serving, estimate = surface_serve(rs)
    launches = {name: 0 for name in dispatch.KERNELS}
    for name in ("serve", "mnet_bf16"):
        for key in ("forward", "icp"):
            _add_counts(launches, serving[name][key]["launches"])
    ckpt = surface_checkpoint(rs)
    _add_counts(launches, ckpt["launches_cli"])
    r_launches, refined = surface_refine(rs, estimate)
    o_launches, options = surface_options(rs, [estimate[0]])
    _add_counts(launches, r_launches)
    _add_counts(launches, o_launches)
    secs = time.perf_counter() - t_phase
    print(f"surface phase: {secs:.1f} s; launches {launches}")
    return launches, {"kernels": kernels, "serve": serving, "checkpoint": ckpt,
                      "refine": refined, "options": options, "phase_s": secs}


# ------------------------------------------------ distribution (A.7)

# limits, the sharded request against the unsharded one on the same pair
# (float32 body): the two build their kNN graph by other routes (the cross
# graph of each process's rows against the whole cloud, sorted against the
# joint box, against the v-space self graph), sum the InstanceNorm, EM,
# Sinkhorn and Procrustes moments in other orders and all-reduce them; the
# overlap head is the same streamed kernel. So the overlaps agree to
# float32 round-off through ~25 layers, and the EM's ten trips amplify the
# round-off chaotically (ROADMAP.md C, "EM divergence"): the pose is held
# loosely after ten trips, tightly after one, and ICP pulls both to one
# minimum.
LIM_SP_OVERLAP = 1e-3
LIM_SP_ROT_DEG = 1.0      # ten EM trips (phase 3's bar)
LIM_SP_TRANS = 0.05       # ten EM trips, cloud extent ~1
LIM_SP_ROT1_DEG = 0.01    # one EM trip
LIM_SP_ICP_DEG = 0.05     # ten EM trips and 30 ICP trips
# the data-parallel step against the single-process step on the same
# global batch: only the BatchNorm moments' summation order differs (two
# passes over the group against one); the ten EM trips amplify that into
# the loss and the gradients as they do a kernel's round-off (the train
# phase's limits); the running statistics are computed before the EM
LIM_DP_STATS = 1e-3       # relative, each buffer
W_SP = 2                  # processes on the card for part (b)


def _flat(tensors):
    return torch.cat([t.detach().float().reshape(-1).cpu() for t in tensors])


def _dp_step(cfg, batch, group=None):
    """One step from the seeded state (random FPS starts from its generator)
    on the global batch: loss, the gradients, buffers and parameters after
    it (flat, CPU), its launches, host ms of five more steps, busy ms of
    one."""
    st = create_train_state(cfg, 10, seed=0, device=DEV, group=group)
    step = make_train_step(cfg)
    m, launches = _counted(lambda: step(st, batch))
    grads = _flat(torch.zeros_like(p) if p.grad is None else p.grad
                  for p in st.model.parameters())
    bufs = {k: b.detach().float().cpu() for k, b in st.model.named_buffers()}
    params = _flat(st.model.parameters())
    loss = m["loss"][0].item()
    _, t = _timed(lambda: step(st, batch), reps=5)
    busy = _busy_ms(lambda: step(st, batch))["busy"]
    return {"loss": loss, "grads": grads, "bufs": bufs, "params": params,
            "host_ms": t["host_ms"], "busy_ms": busy, "peak_mib": t["peak_mib"],
            "metrics_rows": int(m["loss"].shape[0]), "launches": launches}


def _gloo_cuda_ok(group):
    """all_reduce (sum, max), all_gather and broadcast on CUDA tensors over
    the gloo group, each checked; (ok, message)."""
    import torch.distributed as dist
    r, w = dist.get_rank(group), dist.get_world_size(group)
    try:
        x = torch.full((4,), float(r + 1), device=DEV)
        dist.all_reduce(x, group=group)
        y = torch.full((4,), float(r + 1), device=DEV)
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
        parts = [torch.empty(2, device=DEV) for _ in range(w)]
        dist.all_gather(parts, torch.full((2,), float(r), device=DEV), group=group)
        z = torch.full((3,), float(r + 7), device=DEV)
        dist.broadcast(z, 0, group=group)
        ok = (x.eq(w * (w + 1) / 2).all() and y.eq(w).all()
              and all(p.eq(i).all() for i, p in enumerate(parts))
              and z.eq(7).all() and x.is_cuda and parts[0].is_cuda)
        return bool(ok), "all_reduce (sum, max), all_gather, broadcast on cuda"
    except Exception as e:                       # reported, part (b) left out
        return False, f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"


def _dist_rank(rank, world, device, pair, batch):
    """A process of part (b)/(c) at world W over gloo on the one card: the
    gloo check, the sharded request (forward, with ICP), the step at both
    bodies on this rank's half of the global batch."""
    import torch.distributed as dist
    group = dist.group.WORLD
    ok, msg = _gloo_cuda_ok(group)
    out = {"gloo_ok": ok, "gloo": msg}
    if not ok:
        return out
    ops_dgcnn_train.BWD_KERNELS = False
    reg = Registrar(configs.indoor(), seed=0, device=DEV)
    src, tgt = (torch.tensor(a, device=DEV) for a in pair)
    for refine in (False, True):
        fn = reg.sharded(group, refine=refine)
        fn(src, tgt)                                     # warm up
        res, launches = _counted(lambda: fn(src, tgt))
        _, t = _timed(lambda: fn(src, tgt), reps=2)
        out[f"sp_{refine}"] = {"out": [o.float().cpu() for o in res],
                               "launches": launches, **t}
    out["sp_busy_ms"] = _busy_ms(lambda: fn(src, tgt))["busy"]
    for dt in ("float32", "bfloat16"):
        cfg = configs.mnet(model=configs.ModelConfig(dtype=dt))
        out[f"dp_{dt}"] = _dp_step(cfg, batch, group)
    return out


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_multihost_cli():
    """(d) `python -m ogmm_tpu_torch.train --multihost` under torchrun's
    environment at world 1 (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT set as torchrun sets them), two steps and an eval batch."""
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "ogmm_tpu_torch.train", "--multihost",
             "--dataset", "synthetic", "--root", "synthetic:200",
             "--batch_size", str(B), "--test_batch_size", str(B),
             "--epochs", "1", "--steps_per_epoch", "2", "--model_path", tmp],
            capture_output=True, text=True, timeout=300,
            cwd=os.path.dirname(os.path.abspath(__file__)), env=env)
        secs = time.perf_counter() - t0
        saved = os.path.exists(os.path.join(tmp, "checkpoints", "GMMReg",
                                            "models", "optim_model.pt"))
    tail = (res.stdout + res.stderr).strip().splitlines()[-3:]
    print(f"(d) CLI --multihost under torchrun's environment, world 1: exit "
          f"{res.returncode} in {secs:.1f} s, checkpoint written {saved}; "
          f"{' | '.join(tail)[-400:]}")
    assert res.returncode == 0 and saved, res.stderr[-3000:]
    return {"seconds": secs, "exit": res.returncode}


def _sp_kernel_checks(rs, world=W_SP):
    """Rows 11-13 at the sharded request's shapes at W processes, each
    against its plain version, timed beside it with its bound: the cross
    graph of one process's rows against the whole cloud (1, 35000 / W,
    35000, 20), an ICP trip (1, 35000 / W, 35000) and the clustering's
    (2, 16, 35000 / W), the head's (1, 35000 / W, 35000, 512)."""
    n = N_INDOOR // world
    full = torch.tensor(surface(rs, 1), device=DEV)
    rows = full[:, :n]
    box = (full.amin(dim=1, keepdim=True), full.amax(dim=1, keepdim=True))
    qs = index_points(rows, stream.morton_order(rows, box))
    ts = index_points(full, stream.morton_order(full, box))
    lb = stream.pair_tile_bounds(qs, ts)
    run = lambda: cuda_stream.knn_stream(qs, ts, KNN, diag_order=True,
                                         stretch=world, cull_lb=lb)
    idx = run()
    torch.cuda.synchronize()
    same = torch.equal(idx, stream.knn_stream_plain(qs, ts, KNN))
    assert same, "knn_stream at the sharded shape differs from plain"
    ms = cuda_ms(run, 10)
    plain = cuda_ms(lambda: stream.knn_stream_plain(qs, ts, KNN), 1)
    dk = _pair_d(qs, index_points(ts, idx[..., -1]))
    pairs, share = _needed_pairs(lb, dk, n, N_INDOOR)
    bound, by = _bound(9.0 * pairs, (qs.numel() + ts.numel()) * 4 + idx.numel() * 8)
    knn_at = {"shape": [1, n, N_INDOOR, KNN], "max_abs_err": 0.0, "ms": ms,
              "plain_ms": plain, "bound_ms": bound, "bound_by": by,
              "tile_pairs_needed": share}
    print(f"knn_stream at the sharded shape (1, {n}, {N_INDOOR}, k={KNN}), "
          f"stretch {world}: identical indices {same}; {ms:.4f} ms, plain "
          f"{plain:.2f} ms, bound {bound:.5f} ms ({by}; {share:.4f} of the "
          f"tile pairs needed)")

    # an ICP trip: the process's rows of a cloud moved 0.6 degrees and 0.01
    # off a rigid copy of the whole cloud, both sorted, the cull and the gate
    src, tgt, rot, trans = rigid_copies(rs, surface(rs, 1))
    src = _sorted(torch.tensor(src, device=DEV)[:, :n])
    tgt = _sorted(torch.tensor(tgt, device=DEV))
    a = 0.01
    off = torch.tensor([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                        [0, 0, 1]], dtype=torch.float32, device=DEV)
    r = torch.tensor(rot, device=DEV) @ off
    moved = src @ r.transpose(1, 2) + torch.tensor(trans, device=DEV)[:, None] + 0.01
    gate = (2.0 * configs.indoor().model.overlap_radius) ** 2
    lb1 = stream.pair_tile_bounds(moved, tgt)
    trip = lambda: cuda_stream.nn1_stream(moved, tgt, cull_lb=lb1,
                                          max_dist_sq=gate, diag_order=True,
                                          stretch=world)
    d, i = trip()
    torch.cuda.synchronize()
    rd, ri = stream.nn1_stream_plain(moved, tgt)
    inside = rd < gate
    same1 = (torch.equal(d[inside], rd[inside]) and torch.equal(i[inside], ri[inside])
             and bool((d[~inside] >= gate).all()))
    local = torch.tensor(surface(rs, 2, n), device=DEV)
    means = index_points(local, torch.randint(0, n, (2, 16), device=DEV)) + 0.003
    dc, ic = cuda_stream.nn1_stream(means, local)
    rdc, ric = stream.nn1_stream_plain(means, local)
    same2 = torch.equal(dc, rdc) and torch.equal(ic, ric)
    assert same1 and same2, "nn1_stream at the sharded shapes differs from plain"
    ms1 = cuda_ms(trip, 20)
    ms2 = cuda_ms(lambda: cuda_stream.nn1_stream(means, local), 20)
    plain1 = cuda_ms(lambda: stream.nn1_stream_plain(moved, tgt), 2)
    plain2 = cuda_ms(lambda: stream.nn1_stream_plain(means, local), 2)
    pairs1, share1 = _needed_pairs(lb1, rd.clamp_max(gate), n, N_INDOOR)
    bound1, by1 = _bound(9.0 * pairs1, moved.numel() * 4 + tgt.numel() * 4 + n * 12)
    bound2, by2 = _bound(9.0 * 2 * 16 * n, (means.numel() + local.numel()) * 4 + 2 * 16 * 12)
    nn1_at = {"shape": [1, n, N_INDOOR], "max_abs_err": 0.0, "ms": ms1,
              "plain_ms": plain1, "bound_ms": bound1, "bound_by": by1,
              "tile_pairs_needed": share1,
              "clustering": {"shape": [2, 16, n], "ms": ms2, "plain_ms": plain2,
                             "bound_ms": bound2, "bound_by": by2}}
    print(f"nn1_stream at the sharded shapes: ICP trip (1, {n}, {N_INDOOR}) "
          f"identical within the gate {same1}, {ms1:.4f} ms, plain {plain1:.2f}, "
          f"bound {bound1:.6f} ({by1}); clustering (2, 16, {n}) identical "
          f"{same2}, {ms2:.4f} ms, plain {plain2:.3f}, bound {bound2:.6f} ({by2})")

    # the head: this process's queries against the whole other cloud
    wp = {}
    for dt in (torch.bfloat16, torch.float32):
        q, _ = _features(rs, 1, n, EMB, dt)
        _, k = _features(rs, 1, N_INDOOR, EMB, dt)
        v = torch.tensor(rs.randn(1, N_INDOOR, 1).astype(np.float32), device=DEV)
        out, lse = cuda_stream.wproject_stream_lse(q, k, v)
        torch.cuda.synchronize()
        rout, rlse = stream.wproject_stream_lse_plain(q, k, v)
        err = max((out - rout).abs().max().item(), (lse - rlse).abs().max().item())
        assert err <= LIM_WPROJECT, err
        ms_w = cuda_ms(lambda: cuda_stream.wproject_stream_lse(q, k, v), 5)
        plain_w = cuda_ms(lambda: stream.wproject_stream_lse_plain(q, k, v), 2)
        nm = float(n) * N_INDOOR
        if dt == torch.bfloat16:
            t_ops = 2.0 * nm * EMB / PEAK_FLOPS["bf16"] + 4.0 * nm / PEAK_FLOPS["f32"]
            t_bytes = ((n + N_INDOOR) * EMB * 2 + N_INDOOR * 4 + 2 * n * 4) / PEAK_BYTES
            b_ms, b_by = max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")
        else:
            # the kernel's products are three TF32 products on the tensor
            # cores: its least time is the 3xTF32 bound (the CUDA cores' in
            # `bound_ms_cuda_cores`)
            b = f32_bound(2.0 * nm * EMB, 4.0 * nm,
                          (n + N_INDOOR) * EMB * 4 + N_INDOOR * 4 + 2 * n * 4)
            b_ms, b_by = b["ms_tf32x3"], "operations"
        label = "bf16" if dt == torch.bfloat16 else "f32"
        wp[label] = {"shape": [1, n, N_INDOOR, EMB], "max_abs_err": err,
                     "ms": ms_w, "plain_ms": plain_w, "bound_ms": b_ms,
                     "bound_by": b_by}
        if dt == torch.float32:
            wp[label]["bound_ms_cuda_cores"] = b["ms"]
        print(f"wproject at the sharded shape (1, {n}, {N_INDOOR}, {EMB}) "
              f"{label}: out/lse {err:.3g} from plain (limit {LIM_WPROJECT}); "
              f"{ms_w:.3f} ms, plain {plain_w:.2f}, bound {b_ms:.4f} ({b_by})")
    return {"knn_stream": knn_at, "nn1_stream": nn1_at,
            "wproject": {**wp["bf16"], "f32": wp["f32"]}}


def _rot_diff_deg(a, b):
    """The angle of a^T b in degrees as atan2(|skew part|, (trace - 1) / 2)
    in float64: acos of the trace alone resolves nothing below ~0.03
    degrees, where float32 rotations are orthonormal only to ~1e-7."""
    m = a.double().transpose(1, 2) @ b.double()
    s = torch.stack([m[:, 2, 1] - m[:, 1, 2], m[:, 0, 2] - m[:, 2, 0],
                     m[:, 1, 0] - m[:, 0, 1]], -1).norm(dim=-1) / 2
    c = (m.diagonal(dim1=1, dim2=2).sum(-1) - 1) / 2
    return torch.rad2deg(torch.atan2(s, c))


def _sp_compare(tag, got, want):
    """rotation degrees, translation, overlaps of a sharded request against
    the unsharded one."""
    rot = _rot_diff_deg(got[0].to(DEV), want[0]).max().item()
    tr = (got[1].to(DEV) - want[1]).abs().max().item()
    ov = max((got[2].to(DEV) - want[2]).abs().max().item(),
             (got[3].to(DEV) - want[3]).abs().max().item())
    print(f"{tag} against the unsharded request: rotation {rot:.4g} deg, "
          f"translation {tr:.3g}, overlaps {ov:.3g}")
    return {"rot_deg": rot, "trans": tr, "overlap": ov}


def distributed(rs):
    """Phase `distributed`: (a) the sharded indoor request at world 1 over
    NCCL against the unsharded request on the same pair; (b) the same at
    world 2, two processes on the one card over gloo (after checking that
    gloo's all_reduce, all_gather and broadcast take CUDA tensors); (c) the
    data-parallel train step at B=24, N=717, float32 and bf16, at world 1
    (NCCL) and 2 (gloo, 12 pairs a rank) against the single-process step on
    the same 24 pairs, the ranks' parameters bit-equal; (d) the CLI with
    --multihost under torchrun's environment at world 1; rows 11-13 at the
    sharded shapes against their plain versions. `BWD_KERNELS` is pinned
    off (it raises under a group of more than one process)."""
    import torch.distributed as dist
    from ogmm_tpu_torch.parallel.launch import run_ranks
    t_phase = time.perf_counter()
    saved_bwd = ops_dgcnn_train.BWD_KERNELS
    ops_dgcnn_train.BWD_KERNELS = False
    kernels = _sp_kernel_checks(rs)
    cfg = configs.indoor()
    reg = Registrar(cfg, seed=0, device=DEV)
    pair = rigid_copies(rs, surface(rs, 1))[:2]
    src, tgt = (torch.tensor(a, device=DEV) for a in pair)
    batch = make_batch(rs)
    res = {"kernels": kernels}
    tmp = tempfile.mkdtemp(prefix="ogmm_sp_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0)
    try:
        group = dist.group.WORLD
        # (a) world 1
        ref, sp, launches, t_ref, t_sp, fns = {}, {}, {}, {}, {}, {}
        for refine in (False, True):
            ref[refine], t_ref[refine] = _timed(lambda: reg(src, tgt, refine=refine))
            fn = fns[refine] = reg.sharded(group, refine=refine)
            (sp[refine], launches[refine]) = _counted(lambda: fn(src, tgt))
            _, t_sp[refine] = _timed(lambda: fn(src, tgt))
        busy = {"sharded": _busy_ms(lambda: fns[True](src, tgt))["busy"],
                "unsharded": _busy_ms(lambda: reg(src, tgt, refine=True))["busy"]}
        busy_fwd = _busy_ms(lambda: fns[False](src, tgt))["busy"]
        busy["unsharded_fwd"] = _busy_ms(lambda: reg(src, tgt, refine=False))["busy"]
        expect = {"knn_stream": 1, "wproject": 2}
        for refine, n_nn1 in ((False, 1), (True, 1 + cfg.model.icp_iters)):
            got = dict(launches[refine])
            assert {k: got.get(k, 0) for k in expect} == expect, got
            assert got.get("nn1_stream", 0) == n_nn1, got
            assert set(got) <= {"knn_stream", "wproject", "nn1_stream"}, got
        cmp = {refine: _sp_compare(f"(a) world 1, {'with' if refine else 'without'} ICP",
                                   sp[refine], ref[refine]) for refine in (False, True)}
        cfg1 = cfg.replace(model=dataclasses.replace(cfg.model, em_iters=1))
        reg1 = Registrar(cfg1, seed=0, device=DEV)
        one = _sp_compare("(a) world 1, one EM trip",
                          reg1.sharded(group, refine=False)(src, tgt),
                          reg1(src, tgt, refine=False))
        per_trip = None
        if cmp[False]["rot_deg"] > LIM_SP_ROT1_DEG:
            # the EM trip by trip: where the two start to part
            per_trip = []
            for trips in (2, 3, 4, 6, 8):
                c = cfg.replace(model=dataclasses.replace(cfg.model, em_iters=trips))
                r = Registrar(c, seed=0, device=DEV)
                per_trip.append((trips, _sp_compare(
                    f"(a) world 1, {trips} EM trips",
                    r.sharded(group, refine=False)(src, tgt),
                    r(src, tgt, refine=False))["rot_deg"]))
        print(f"(a) sharded indoor request (B=1, N={N_INDOOR}, float32), world 1 "
              f"over NCCL: launches {launches[False]} / {launches[True]} with ICP; "
              f"host ms {t_sp[False]['host_ms']} / {t_sp[True]['host_ms']} "
              f"(unsharded {t_ref[False]['host_ms']} / {t_ref[True]['host_ms']}); "
              f"busy with ICP {busy['sharded']:.2f} ms (unsharded "
              f"{busy['unsharded']:.2f}), forward {busy_fwd:.2f}; peak "
              f"{t_sp[True]['peak_mib']:.0f} MiB (unsharded {t_ref[True]['peak_mib']:.0f})")
        assert cmp[False]["overlap"] <= LIM_SP_OVERLAP and cmp[True]["overlap"] <= LIM_SP_OVERLAP
        assert cmp[False]["rot_deg"] <= LIM_SP_ROT_DEG and cmp[False]["trans"] <= LIM_SP_TRANS
        assert one["rot_deg"] <= LIM_SP_ROT1_DEG and one["overlap"] <= LIM_SP_OVERLAP
        assert cmp[True]["rot_deg"] <= LIM_SP_ICP_DEG
        res["a"] = {"launches": launches[False], "launches_icp": launches[True],
                    "host_ms": t_sp[False]["host_ms"], "host_ms_icp": t_sp[True]["host_ms"],
                    "events_ms": t_sp[False]["events_ms"],
                    "unsharded_host_ms": t_ref[False]["host_ms"],
                    "unsharded_host_ms_icp": t_ref[True]["host_ms"],
                    "busy_ms_fwd": busy_fwd, "busy_ms_icp": busy["sharded"],
                    "unsharded_busy_ms_icp": busy["unsharded"],
                    "unsharded_busy_ms_fwd": busy["unsharded_fwd"],
                    "peak_mib": t_sp[False]["peak_mib"],
                    "peak_mib_icp": t_sp[True]["peak_mib"],
                    "unsharded_peak_mib_icp": t_ref[True]["peak_mib"],
                    "against_unsharded": cmp[False], "against_unsharded_icp": cmp[True],
                    "one_em_trip": one, "per_trip_rot_deg": per_trip}
        path_launches = {k: launches[True].get(k, 0) for k in dispatch.KERNELS}

        # (c) world 1 and the single-process step
        dp = {}
        for dt in ("float32", "bfloat16"):
            c = configs.mnet(model=configs.ModelConfig(dtype=dt))
            dp[dt] = {"single": _dp_step(c, batch),
                      "w1": _dp_step(c, batch, group)}
        res["c"] = {}
    finally:
        dist.destroy_process_group()

    # (b), (c) world 2: two processes on the one card over gloo
    sp_pair = tuple(np.asarray(a) for a in pair)
    t0 = time.perf_counter()
    ranks = run_ranks(_dist_rank, W_SP, backend="gloo", device="cuda",
                      args=(sp_pair, batch), timeout=600)
    w2_secs = time.perf_counter() - t0
    ok = all(r["gloo_ok"] for r in ranks)
    print(f"(b) gloo on CUDA tensors: {ranks[0]['gloo']}: "
          f"{'works' if ok else 'FAILS'}; world {W_SP} in {w2_secs:.1f} s")
    if ok:
        for refine in (False, True):
            outs = [r[f"sp_{refine}"]["out"] for r in ranks]
            for o in outs[1:]:
                assert all(torch.equal(a, b) for a, b in zip(o, outs[0])), \
                    "the ranks' answers differ"
            c2 = _sp_compare(f"(b) world {W_SP}, {'with' if refine else 'without'} ICP",
                             outs[0], ref[refine])
            lim_rot = LIM_SP_ICP_DEG if refine else LIM_SP_ROT_DEG
            assert c2["overlap"] <= LIM_SP_OVERLAP and c2["rot_deg"] <= lim_rot
            r0 = ranks[0][f"sp_{refine}"]
            res.setdefault("b", {})[f"icp_{refine}"] = {
                "against_unsharded": c2, "launches_rank0": r0["launches"],
                "host_ms": r0["host_ms"], "peak_mib": r0["peak_mib"]}
            print(f"(b) rank 0 launches {r0['launches']}, host ms "
                  f"{r0['host_ms']}, peak {r0['peak_mib']:.0f} MiB")
        res["b"]["busy_ms_icp_rank0"] = ranks[0]["sp_busy_ms"]
        for n_nn1, refine in ((1, False), (1 + cfg.model.icp_iters, True)):
            got = ranks[0][f"sp_{refine}"]["launches"]
            assert got.get("knn_stream") == 1 and got.get("wproject") == 2 \
                and got.get("nn1_stream") == n_nn1, got
    else:
        res["b"] = {"left_out": ranks[0]["gloo"]}
        print("(b) and (c) at world 2 left out: gloo does not take CUDA tensors here")

    for dt, d in dp.items():
        single = d["single"]
        rows = {"world 1": d["w1"]}
        if ok:
            rows[f"world {W_SP}"] = ranks[0][f"dp_{dt}"]
            for r in ranks[1:]:
                assert torch.equal(r[f"dp_{dt}"]["params"], ranks[0][f"dp_{dt}"]["params"])
                assert all(torch.equal(r[f"dp_{dt}"]["bufs"][k], v)
                           for k, v in ranks[0][f"dp_{dt}"]["bufs"].items())
        out_dt = {"single_host_ms": single["host_ms"], "single_busy_ms": single["busy_ms"],
                  "single_peak_mib": single["peak_mib"]}
        for name, w in rows.items():
            loss = abs(w["loss"] - single["loss"]) / abs(single["loss"])
            grad = ((w["grads"] - single["grads"]).norm() / single["grads"].norm()).item()
            stats = max(((w["bufs"][k] - v).norm() / v.norm().clamp_min(1e-12)).item()
                        for k, v in single["bufs"].items())
            print(f"(c) step {dt}, {name}: loss {w['loss']:.6f} against "
                  f"{single['loss']:.6f} ({loss:.3g} relative, limit "
                  f"{LIM_STEP_LOSS}), gradients {grad:.3g} (limit {LIM_STEP_GRAD}), "
                  f"running statistics {stats:.3g} (limit {LIM_DP_STATS}); host ms "
                  f"{[round(x, 2) for x in w['host_ms']]} (single "
                  f"{[round(x, 2) for x in single['host_ms']]}), busy "
                  f"{w['busy_ms']:.2f} (single {single['busy_ms']:.2f}), peak "
                  f"{w['peak_mib']:.0f} MiB, metrics of {w['metrics_rows']} pairs")
            assert w["metrics_rows"] == B
            assert loss <= LIM_STEP_LOSS and grad <= LIM_STEP_GRAD and stats <= LIM_DP_STATS
            out_dt[name.replace(" ", "")] = {
                "loss_rel": loss, "grad_rel": grad, "stats_rel": stats,
                "host_ms": w["host_ms"], "busy_ms": w["busy_ms"],
                "peak_mib": w["peak_mib"]}
        res["c"][dt] = out_dt
    res["c"]["launches_w1_float32"] = dp["float32"]["w1"]["launches"]
    res["c"]["launches_single_float32"] = dp["float32"]["single"]["launches"]
    res["d"] = _run_multihost_cli()
    ops_dgcnn_train.BWD_KERNELS = saved_bwd
    secs = time.perf_counter() - t_phase
    res["phase_s"] = secs
    print(f"distributed phase: {secs:.1f} s")
    return path_launches, res


# ------------------------------------------------------------- envelopes

ENV_DGCNN_KS = (4, 12, 25, 32)   # k the DGCNN eval kernel was not compiled for
ENV_GS1_KS = (12, 32)            # and the training graph's
ENV_EDGES_K = 12
ENV_EM = ((8, 5734, 128), (8, 4096, 128), (8, 2867, 256))   # (clouds, N, K)
# the wide forms (16 lanes a row to K = 512, 32 to 1024): the n_clusters =
# 512 request's 2B = 48 clouds (a cluster of 8), N = 1433 at K = 512, K = 257
# at N = 2000, and the tops of the JAX bound at K = 856 and 1023 (clusters of
# 16)
ENV_EM_WIDE = ((2 * B, N, 512), (B, N_LARGE, 512), (8, 2000, 257), (8, 857, 856),
               (8, N, 1023))
ENV_BWD = ((1, N), (12, N), (32, N), (32, 1024))   # (k, N) of the backward
#                                  kernels, which were compiled for k = 20
ENV_GNN_K = 12                   # the model of parts (b), (c) and (e)
ENV_N_EM = 4096                  # part (d): a request the JAX rule sends to
#                                  its EM kernel past a cluster of 8 blocks
ENV_CLI_ROOT = "synthetic:600"   # 300 train shapes: 12 steps of 24 pairs
ENV_K_WIDE = 512                 # part (g): n_clusters of the wide EM request
# above k = 32 (the wide selection, the stage chain in chunks of 32): rows 1
# and 3 at these k over B clouds of N (k = N the top) and at k = N = 1024
# over 8 clouds; row 8 at (clouds, N, M, k); row 10 at ENV_EDGES_WIDE_KS
# over the indoor cloud and at k = N = 1024 over 8 clouds
ENV_WIDE_KS = (33, 40, 64, N)
ENV_WIDE_TOP = (8, 1024)
ENV_KNN_WIDE = tuple((2 * B, N_LARGE, N_LARGE, k) for k in (33, 40, 64, N_LARGE)) \
    + ((8, 4096, 4096, 1024),)
ENV_EDGES_WIDE_KS = (33, 40, 64)
ENV_GNN_K_WIDE = 40              # part (h): the DGCNN authors' 2048-point
#                                  ModelNet40 graph (WangYueFt/dgcnn, --k=40)


def _stage_bound(points, k, emb, nbytes, selection_ops=0.0):
    """The stage chain's bound at k neighbours (the rows past k that the
    kernel repeats are not work this input needs): its products in bf16 at
    989 TFLOP/s, or in float32 on the CUDA cores / in 3xTF32 (f32_bound),
    plus a selection's float32 operations, against the bytes."""
    stage_macs = 6 * 64 + 64 * 64 + 64 * 128 + 128 * 256
    products = 2.0 * points * (k * stage_macs + sum(STAGES) * emb)
    t_ops = products / PEAK_FLOPS["bf16"] + selection_ops / PEAK_FLOPS["f32"]
    t_bytes = nbytes / PEAK_BYTES
    return ({"bound_ms": max(t_ops, t_bytes) * 1e3,
             "bound_by": "operations" if t_ops >= t_bytes else "bytes"},
            f32_bound(products, selection_ops, nbytes + points * emb * 2))


def env_dgcnn_eval(rs):
    """dgcnn_eval at k outside the earlier compiled set, 2B = 48 clouds of
    717, bf16 and float32, against the plain version; the graph identical."""
    x = torch.tensor(rs.randn(2 * B, N, 3).astype(np.float32) * 0.3, device=DEV)
    ws, aff = _dgcnn_operands(rs)
    res = {}
    for k in ENV_DGCNN_KS:
        pk = min(POS_K, k)
        graph = torch.empty(2 * B, N, k, dtype=torch.int32, device=DEV)
        cuda_dgcnn._dgcnn_eval_cuda(x, ws, aff, k, torch.bfloat16, pk, idx=graph)
        torch.cuda.synchronize()
        assert torch.equal(graph.long(), knn_reference(x, x, k)), f"graph k={k}"
        errs, ms, plain = {}, {}, {}
        for dt, lim in ((torch.float32, LIM_DGCNN_F32), (torch.bfloat16, LIM_DGCNN_BF16)):
            out, alpha = dgcnn_eval(x, ws, aff, k, dt, pk)
            torch.cuda.synchronize()
            ref, ralpha = dgcnn_eval_reference(x, ws, aff, k, dt, pk)
            assert out.dtype == dt and out.shape == (2 * B, N, EMB)
            err = (out.float() - ref.float()).abs().max().item()
            aerr = (alpha - ralpha).abs().max().item()
            assert torch.isfinite(out.float()).all() and err <= lim and aerr <= LIM_ALPHA, \
                (k, dt, err, aerr)
            again, _ = dgcnn_eval(x, ws, aff, k, dt, pk)
            assert torch.equal(out, again), f"dgcnn_eval k={k}: two launches differ"
            name = "bf16" if dt == torch.bfloat16 else "f32"
            errs[name] = max(err, aerr)
            ms[name] = cuda_ms(lambda: dgcnn_eval(x, ws, aff, k, dt, pk), 10)
            plain[name] = cuda_ms(lambda: dgcnn_eval_reference(x, ws, aff, k, dt, pk), 2)
        rows = 2 * B * N
        nbytes = (x.numel() * 4 + sum(w.numel() for w in ws) * 2
                  + rows * EMB * 2 + rows * pk * 4)
        bound, bound32 = _stage_bound(rows, k, EMB, nbytes, rows * N * PAIR_FLOPS)
        res[f"k={k}"] = {"shape": [2 * B, N, k, EMB], "rows_a_point": cuda_dgcnn.stage_rows(k),
                         "max_abs_err": errs["bf16"], "max_abs_err_f32": errs["f32"],
                         "ms": ms["bf16"], "ms_f32": ms["f32"],
                         "plain_ms": plain["bf16"], "plain_ms_f32": plain["f32"],
                         **bound, "bound_ms_f32": bound32}
        print(f"envelopes dgcnn_eval (2B={2 * B}, N={N}, k={k}, "
              f"{cuda_dgcnn.stage_rows(k)} rows a point): graph identical; bf16 "
              f"{ms['bf16']:.4f} ms (plain {plain['bf16']:.3f}, err {errs['bf16']:.3g}, "
              f"limit {LIM_DGCNN_BF16}), float32 {ms['f32']:.4f} ms (plain "
              f"{plain['f32']:.3f}, err {errs['f32']:.3g}, limit {LIM_DGCNN_F32}); "
              f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}), float32 "
              f"{bound32['ms_tf32x3']:.4f} in 3xTF32")
    return res


def env_dgcnn_edges(rs):
    """dgcnn_edges at k = 12 over the indoor graph (2 clouds of 35,000) and
    at N = 37 with k = 5 (8 rows a point), bf16 and float32."""
    x = _sorted(torch.tensor(surface(rs, 2), device=DEV))
    k = ENV_EDGES_K
    nbr = gather_neighbors(x, cuda_stream.knn_stream(
        x, x, k, diag_order=True, cull_lb=stream.tile_pair_bounds(x)))
    ws, aff = _dgcnn_operands(rs)
    xs = x[:1, :37]
    small_nbr = gather_neighbors(xs, ops_common.select_smallest(
        ops_common.square_distance3(xs, xs), 5))
    errs = {}
    for dt, lim in ((torch.float32, LIM_DGCNN_F32), (torch.bfloat16, LIM_DGCNN_BF16)):
        for xx, nb, kk in ((x, nbr, k), (xs, small_nbr, 5)):
            out = dgcnn_edges(xx, nb, ws, aff, kk, dt)
            torch.cuda.synchronize()
            ref = dgcnn_edges_reference(xx, nb, ws, aff, kk, dt)
            err = (out.float() - ref.float()).abs().max().item()
            print(f"envelopes dgcnn_edges {tuple(nb.shape)} {dt}: max|kernel - plain| "
                  f"= {err:.3g} (limit {lim})")
            assert out.dtype == dt and out.shape == ref.shape
            assert torch.isfinite(out.float()).all() and err <= lim
            errs[dt] = max(errs.get(dt, 0.0), err)
    bf, f32 = torch.bfloat16, torch.float32
    ms = cuda_ms(lambda: dgcnn_edges(x, nbr, ws, aff, k, bf), 5)
    ms32 = cuda_ms(lambda: dgcnn_edges(x, nbr, ws, aff, k, f32), 5)
    plain = cuda_ms(lambda: dgcnn_edges_reference(x, nbr, ws, aff, k, bf), 2)
    plain32 = cuda_ms(lambda: dgcnn_edges_reference(x, nbr, ws, aff, k, f32), 2)
    rows = 2 * N_INDOOR
    nbytes = x.numel() * 4 + nbr.numel() * 4 + rows * EMB * 2
    bound, bound32 = _stage_bound(rows, k, EMB, nbytes)
    print(f"envelopes dgcnn_edges (2, {N_INDOOR}, k={k}): {ms:.3f} ms bf16 (plain "
          f"{plain:.3f}), {ms32:.3f} ms float32 (plain {plain32:.3f}); bound "
          f"{bound['bound_ms']:.4f} ms, float32 {bound32['ms_tf32x3']:.4f} in 3xTF32")
    return {"shape": [2, N_INDOOR, k, EMB], "max_abs_err": errs[bf],
            "max_abs_err_f32": errs[f32], "ms": ms, "ms_f32": ms32,
            "plain_ms": plain, "plain_ms_f32": plain32, **bound,
            "bound_ms_f32": bound32}


def env_graph_stage1(rs):
    """graph_stage1 at k = 12 and 32, B = 24 clouds of 717, bf16 and
    float32: exactly k edge rows a point, the graph and e identical."""
    x = torch.tensor(rs.randn(B, N, 3).astype(np.float32) * 0.3, device=DEV)
    w1 = torch.tensor(rs.randn(6, 64).astype(np.float32) / np.sqrt(6), device=DEV)
    res = {}
    for k in ENV_GS1_KS:
        errs, ms = {}, {}
        for dt, lim in ((torch.float32, LIM_Z1_F32), (torch.bfloat16, LIM_Z1_BF16)):
            z1, e, idx, alpha = graph_stage1(x, w1, k, dt, POS_K)
            torch.cuda.synchronize()
            rz1, re, ridx, ralpha = graph_stage1_reference(x, w1, k, dt, POS_K)
            assert z1.shape == (B, k, N, 64) and e.shape == (B, k, N, 6)
            err = (z1.float() - rz1.float()).abs().max().item()
            aerr = (alpha - ralpha).abs().max().item()
            assert torch.equal(idx, ridx) and torch.equal(e, re), (k, dt)
            assert torch.isfinite(z1.float()).all() and err <= lim and aerr <= LIM_ALPHA
            again = graph_stage1(x, w1, k, dt, POS_K)
            assert all(torch.equal(a, b) for a, b in zip((z1, e, idx, alpha), again))
            name = "bf16" if dt == torch.bfloat16 else "f32"
            errs[name] = max(err, aerr)
            ms[name] = cuda_ms(lambda: graph_stage1(x, w1, k, dt, POS_K), 20)
        plain = cuda_ms(lambda: graph_stage1_reference(x, w1, k, torch.bfloat16, POS_K), 2)
        rows = B * N
        flops_f32 = rows * N * PAIR_FLOPS
        flops_bf16 = 2.0 * rows * k * 6 * 64
        nbytes = (x.numel() * 4 + w1.numel() * 4 + rows * k * (64 + 6) * 2
                  + rows * k * 4 + rows * POS_K * 4)
        t_ops = flops_bf16 / PEAK_FLOPS["bf16"] + flops_f32 / PEAK_FLOPS["f32"]
        t_bytes = nbytes / PEAK_BYTES
        res[f"k={k}"] = {"shape": [B, N, k], "max_abs_err": errs["bf16"],
                         "max_abs_err_f32": errs["f32"], "ms": ms["bf16"],
                         "ms_f32": ms["f32"], "plain_ms": plain,
                         "bound_ms": max(t_ops, t_bytes) * 1e3,
                         "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                         "bound_ms_f32": f32_bound(flops_bf16, flops_f32,
                                                   nbytes + rows * k * (64 + 6) * 2)}
        print(f"envelopes graph_stage1 ({B}, {N}, k={k}): idx and e identical, bf16 "
              f"{ms['bf16']:.4f} ms, float32 {ms['f32']:.4f} ms, plain {plain:.3f}, "
              f"err {errs['bf16']:.3g} / {errs['f32']:.3g}; bound "
              f"{res[f'k={k}']['bound_ms']:.4f} ms ({res[f'k={k}']['bound_by']})")
    return res


def env_dgcnn_wide(rs):
    """Rows 1 and 3 above k = 32 (the wide selection, the stage chain in
    chunks of 32): dgcnn_eval and graph_stage1 at each k of ENV_WIDE_KS over
    B = 24 clouds of 717 and at k = N = 1024 over 8 clouds, float32 and
    bf16, against their plain versions: the graph identical, e identical,
    outputs within LIM_DGCNN_* and LIM_Z1_*, the angles within LIM_ALPHA, a
    relaunch bit-equal; timed beside the plain versions and the bounds.
    Returns ({"k=..": entry} of dgcnn_eval, the same of graph_stage1)."""
    res1, res3 = {}, {}
    shapes = [(B, N, k) for k in ENV_WIDE_KS] + [(*ENV_WIDE_TOP, ENV_WIDE_TOP[1])]
    for clouds, n, k in shapes:
        x = _cloud(rs, clouds, n)
        ws, aff = _dgcnn_operands(rs)
        want_idx = knn_reference(x, x, k)
        tag = f"k={k}" + ("" if (clouds, n) == (B, N) else f",N={n}")
        reps = 10 if k <= 64 else 2
        e1 = {"shape": [clouds, n, k, EMB],
              "chunks": [list(c) for c in cuda_dgcnn.stage_chunks(k)]}
        for dt, lim, key in ((torch.float32, LIM_DGCNN_F32, "_f32"),
                             (torch.bfloat16, LIM_DGCNN_BF16, "")):
            graph = torch.empty(clouds, n, k, dtype=torch.int32, device=DEV)
            out, alpha = cuda_dgcnn._dgcnn_eval_cuda(x, ws, aff, k, dt, POS_K, idx=graph)
            torch.cuda.synchronize()
            assert torch.equal(graph.long(), want_idx), f"dgcnn_eval graph {tag}"
            ref, ralpha = dgcnn_eval_reference(x, ws, aff, k, dt, POS_K)
            err = (out.float() - ref.float()).abs().max().item()
            aerr = (alpha - ralpha).abs().max().item()
            del ref
            assert out.dtype == dt and out.shape == (clouds, n, EMB)
            assert torch.isfinite(out.float()).all() and err <= lim and aerr <= LIM_ALPHA, \
                (tag, dt, err, aerr)
            again = dgcnn_eval(x, ws, aff, k, dt, POS_K)
            assert torch.equal(out, again[0]) and torch.equal(alpha, again[1]), \
                f"dgcnn_eval {tag}: two launches differ"
            e1["max_abs_err" + key] = max(err, aerr)
            e1["ms" + key] = cuda_ms(lambda: dgcnn_eval(x, ws, aff, k, dt, POS_K), reps)
            e1["plain_ms" + key] = cuda_ms(
                lambda: dgcnn_eval_reference(x, ws, aff, k, dt, POS_K), 1)
        # bytes: the clouds in, the weights, the bf16 output and the angles out
        rows = clouds * n
        bound, bound32 = _stage_bound(rows, k, EMB, x.numel() * 4 + sum(w.numel() for w in ws) * 2
                                      + rows * EMB * 2 + rows * POS_K * 4, rows * n * PAIR_FLOPS)
        e1.update(bound)
        e1["bound_ms_f32"] = bound32
        res1[tag] = e1
        print(f"envelopes dgcnn_eval ({clouds}, {n}, k={k}, chunks {e1['chunks']}): graph "
              f"identical; bf16 {e1['ms']:.4f} ms (plain {e1['plain_ms']:.3f}, err "
              f"{e1['max_abs_err']:.3g}), float32 {e1['ms_f32']:.4f} ms (plain "
              f"{e1['plain_ms_f32']:.3f}, err {e1['max_abs_err_f32']:.3g}); bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}), float32 "
              f"{bound32['ms_tf32x3']:.4f} in 3xTF32")
        w1 = ws[0]
        e3 = {"shape": [clouds, n, k]}
        for dt, lim, key in ((torch.float32, LIM_Z1_F32, "_f32"),
                             (torch.bfloat16, LIM_Z1_BF16, "")):
            got = graph_stage1(x, w1, k, dt, POS_K)
            torch.cuda.synchronize()
            z1, e, idx, alpha = got
            rz1, re, ridx, ralpha = graph_stage1_reference(x, w1, k, dt, POS_K)
            assert z1.shape == (clouds, k, n, 64) and e.shape == (clouds, k, n, 6)
            assert torch.equal(idx, ridx) and torch.equal(e, re), (tag, dt)
            err = (z1.float() - rz1.float()).abs().max().item()
            aerr = (alpha - ralpha).abs().max().item()
            del rz1, re
            assert torch.isfinite(z1.float()).all() and err <= lim and aerr <= LIM_ALPHA, \
                (tag, dt, err, aerr)
            again = graph_stage1(x, w1, k, dt, POS_K)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                f"graph_stage1 {tag}: two launches differ"
            del got, again, z1, e
            e3["max_abs_err" + key] = max(err, aerr)
            e3["ms" + key] = cuda_ms(lambda: graph_stage1(x, w1, k, dt, POS_K), reps)
        e3["plain_ms"] = cuda_ms(
            lambda: graph_stage1_reference(x, w1, k, torch.bfloat16, POS_K), 1)
        # bytes: the clouds in, bf16 z1 and e, the indices and angles out
        graph_bytes = (x.numel() * 4 + rows * k * (64 + 6) * 2 + rows * k * 4
                       + rows * POS_K * 4)
        flops_f32 = rows * n * PAIR_FLOPS
        flops_bf16 = 2.0 * rows * k * 6 * 64
        t_ops = flops_bf16 / PEAK_FLOPS["bf16"] + flops_f32 / PEAK_FLOPS["f32"]
        t_bytes = graph_bytes / PEAK_BYTES
        e3.update({"bound_ms": max(t_ops, t_bytes) * 1e3,
                   "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                   "bound_ms_f32": f32_bound(flops_bf16, flops_f32,
                                             graph_bytes + rows * k * (64 + 6) * 2)})
        res3[tag] = e3
        print(f"envelopes graph_stage1 ({clouds}, {n}, k={k}): idx and e identical, bf16 "
              f"{e3['ms']:.4f} ms, float32 {e3['ms_f32']:.4f} ms, plain "
              f"{e3['plain_ms']:.3f}, err {e3['max_abs_err']:.3g} / "
              f"{e3['max_abs_err_f32']:.3g}; bound {e3['bound_ms']:.4f} ms ({e3['bound_by']})")
    return res1, res3


def env_knn_wide(rs):
    """Row 8 above k = 32 (the wide selection) at each (clouds, N, M, k) of
    ENV_KNN_WIDE, to k = M and to M = 4096: indices identical to the plain
    version's, a relaunch bit-equal; timed beside the plain version and the
    bound (9 flops a pair; the output's bytes at k = M)."""
    res = {}
    for clouds, n, m, k in ENV_KNN_WIDE:
        x = _cloud(rs, clouds, m)
        got = knn(x, x, k)
        torch.cuda.synchronize()
        want = knn_reference(x, x, k)
        assert got.dtype == torch.int64 and torch.equal(got, want), (clouds, n, m, k)
        assert torch.equal(knn(x, x, k), got), f"knn k={k}: two launches differ"
        del got, want
        plan = cuda_knn.knn_plan(clouds, n, m, k)
        ms = cuda_ms(lambda: knn(x, x, k), 10 if k <= 64 else 3)
        plain = cuda_ms(lambda: knn_reference(x, x, k), 1)
        bound, by = _bound(clouds * n * m * PAIR_FLOPS, 2 * x.numel() * 4 + clouds * n * k * 8)
        tag = f"k={k}" + ("" if (clouds, n) == (2 * B, N_LARGE) else f",N={n}")
        res[tag] = {"shape": [clouds, n, m, k], "warps": plan["threads"] // 32,
                    "smem_bytes": plan["smem"], "max_abs_err": 0.0, "ms": ms,
                    "plain_ms": plain, "bound_ms": bound, "bound_by": by}
        print(f"envelopes knn ({clouds}, {n}, {m}, k={k}; {plan['threads'] // 32} warps, "
              f"{plan['smem']} B): indices identical; {ms:.4f} ms, plain {plain:.3f} ms, "
              f"bound {bound:.5f} ms ({by})")
    return res


def env_edges_wide(rs):
    """Row 10 above k = 32 (the stage chain in chunks of 32) at each k of
    ENV_EDGES_WIDE_KS over the indoor cloud (2 clouds of 35,000; the graph
    from the plain chunked kNN, which the streamed kernel does not take at
    k > 32) and at k = N = 1024 over 8 clouds, float32 and bf16, against
    its plain version, a relaunch bit-equal; timed beside it and the bound."""
    x = _sorted(torch.tensor(surface(rs, 2), device=DEV))
    graph = ops_common.knn(x, x, max(ENV_EDGES_WIDE_KS))   # ascending: its first k
    clouds, n = ENV_WIDE_TOP
    top = _cloud(rs, clouds, n)
    cases = [(f"k={k},indoor", x, graph[..., :k].contiguous(), k) for k in ENV_EDGES_WIDE_KS]
    cases.append((f"k={n},N={n}", top, knn_reference(top, top, n), n))
    del graph
    ws, aff = _dgcnn_operands(rs)
    res = {}
    for tag, xx, idx, k in cases:
        nbr = gather_neighbors(xx, idx)
        entry = {"shape": [xx.shape[0], xx.shape[1], k, EMB],
                 "chunks": [list(c) for c in cuda_dgcnn.stage_chunks(k)]}
        for dt, lim, key in ((torch.float32, LIM_DGCNN_F32, "_f32"),
                             (torch.bfloat16, LIM_DGCNN_BF16, "")):
            out = dgcnn_edges(xx, nbr, ws, aff, k, dt)
            torch.cuda.synchronize()
            ref = dgcnn_edges_reference(xx, nbr, ws, aff, k, dt)
            err = (out.float() - ref.float()).abs().max().item()
            del ref
            assert out.dtype == dt and torch.isfinite(out.float()).all() and err <= lim, \
                (tag, dt, err)
            assert torch.equal(out, dgcnn_edges(xx, nbr, ws, aff, k, dt)), tag
            entry["max_abs_err" + key] = err
            entry["ms" + key] = cuda_ms(lambda: dgcnn_edges(xx, nbr, ws, aff, k, dt), 3)
            entry["plain_ms" + key] = cuda_ms(
                lambda: dgcnn_edges_reference(xx, nbr, ws, aff, k, dt), 1)
        rows = xx.shape[0] * xx.shape[1]
        bound, bound32 = _stage_bound(rows, k, EMB, xx.numel() * 4 + nbr.numel() * 4
                                      + rows * EMB * 2)
        del nbr
        entry.update(bound)
        entry["bound_ms_f32"] = bound32
        res[tag] = entry
        print(f"envelopes dgcnn_edges ({xx.shape[0]}, {xx.shape[1]}, k={k}, chunks "
              f"{entry['chunks']}): bf16 {entry['ms']:.3f} ms (plain {entry['plain_ms']:.3f}, "
              f"err {entry['max_abs_err']:.3g}), float32 {entry['ms_f32']:.3f} ms (plain "
              f"{entry['plain_ms_f32']:.3f}, err {entry['max_abs_err_f32']:.3g}); bound "
              f"{bound['bound_ms']:.4f} ms, float32 {bound32['ms_tf32x3']:.4f} in 3xTF32")
    return res


def env_cli_wide_k():
    """`python -m ogmm_tpu_torch.train --gnn_k 40` with the backward kernels
    on, three steps of 24 pairs and an eval batch: graph_stage1 2 a step,
    the backward plain (no bwd_* launch), dgcnn_eval on the eval batch."""
    saved = ops_dgcnn_train.BWD_KERNELS
    ops_dgcnn_train.BWD_KERNELS = True
    try:
        with tempfile.TemporaryDirectory() as tmp:
            dispatch.reset_launch_counts()
            t0 = time.perf_counter()
            trainer = cli.main(["--dataset", "synthetic", "--root", "synthetic:200",
                                "--gnn_k", str(ENV_GNN_K_WIDE), "--batch_size", str(B),
                                "--test_batch_size", str(B), "--epochs", "1",
                                "--steps_per_epoch", "3", "--model_path", tmp])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = {k: v for k, v in dispatch.launch_counts.items() if v}
    finally:
        ops_dgcnn_train.BWD_KERNELS = saved
    rec = trainer.history[-1]
    assert trainer.state.step == 3 and np.isfinite(rec["train"]["loss"])
    assert launches.get("graph_stage1", 0) == 6 and launches.get("dgcnn_eval", 0) >= 1, launches
    assert not any(launches.get(n, 0) for n in ("bwd_reduce", "bwd_stage", "bwd_edge")), launches
    return launches, {"seconds": secs, "train_loss": rec["train"]["loss"],
                      "eval_loss": rec["val"]["loss"]}


def env_dgcnn_bwd(rs):
    """The five backward calls of a real backward at each (k, N) of ENV_BWD,
    B = 24 clouds, bf16 and float32: each kernel launched twice (bit for
    bit) against its plain version under the LIM_BWD_* limits, and the
    calls of one backward timed beside their plain versions and their bound
    (bytes and operations at this k: the rows past k of a tile are not work
    this input needs). {kernel: {"k=..": entry}}."""
    res = {name: {} for name in BWD}
    for k, n in ENV_BWD:
        tag = f"k={k}" + ("" if n == N else f",N={n}")
        errs = {name: {} for name in BWD}
        calls = {}
        for dt in (torch.float32, torch.bfloat16):
            calls[dt] = bwd_calls(rs, dt, k, n)
            bwd_compare(calls[dt], dt, errs, f" ({tag})")
        for name, (kern, plain, _) in BWD.items():
            entry = {"shape": [B, k, n], "row_class": cuda_dgcnn_bwd.row_class(k),
                     "calls_per_backward": sum(c[0] == name for c in calls[torch.bfloat16])}
            for dt, key in ((torch.bfloat16, ""), (torch.float32, "_f32")):
                mine = [(a, kw) for nm, a, kw in calls[dt] if nm == name]

                def run(fn, mine=mine):
                    for a, kw in mine:
                        fn(*a, **kw)
                entry["ms" + key] = cuda_ms(lambda: run(kern), 10)
                entry["plain_ms" + key] = cuda_ms(lambda: run(plain), 3)
                bound, by = bwd_bound([bwd_work(name, a, kw) for a, kw in mine], dt)
                entry["bound_ms" + key], entry["bound_by" + key] = bound, by
                entry["max_abs_err" + key] = errs[name][dt]
            res[name][tag] = entry
            print(f"envelopes {name} ({B}, {n}, {tag}, class {entry['row_class']}): "
                  f"bf16 {entry['ms']:.4f} ms (plain {entry['plain_ms']:.3f}, bound "
                  f"{entry['bound_ms']:.4f}, {entry['bound_by']}), float32 "
                  f"{entry['ms_f32']:.4f} ms (plain {entry['plain_ms_f32']:.3f}, bound "
                  f"{entry['bound_ms_f32']:.4f}, {entry['bound_by_f32']}); errors "
                  f"{entry['max_abs_err']:.3g} / {entry['max_abs_err_f32']:.3g}")
        del calls
    return res


def _em_trips_chained(xyz, o, n0, trips=10):
    """The kernel's trip t from the plain version's nodes after t - 1 trips,
    against the plain version's trip t from the same nodes: the largest
    difference over gamma, pi and the nodes of each of the trips."""
    nodes, errs = n0, []
    for _ in range(trips):
        got = sinkhorn_em(xyz, o, nodes, iters=1)
        want = sinkhorn_em_reference(xyz, o, nodes, iters=1)
        errs.append(max((a - b).abs().max().item() for a, b in zip(got, want)))
        nodes = want[2]
    return errs


def env_em(rs):
    """sinkhorn_em past a cluster of 8 blocks and above K = 128 (ENV_EM),
    and above K = 256, the wide forms (ENV_EM_WIDE), against the plain
    version: one trip, each of ten trips from the plain version's state
    (LIM_EM_1), ten trips (LIM_EM_10_*), relaunched bit-equal, timed beside
    the plain version and the bound, with the cluster size and the clusters
    the card runs at once. Ten trips of the plain version alone drift apart
    from nodes one float32 ulp away; where that drift passes half a
    LIM_EM_10_* limit (K near N, clusters of one or two points), the
    ten-trip state is no test of the kernel and the per-trip chain holds it
    (the ENV_EM shapes keep the ten-trip limits regardless)."""
    res = {}
    for clouds, n, kk in ENV_EM + ENV_EM_WIDE:
        wide = (clouds, n, kk) in ENV_EM_WIDE
        xyz = torch.tensor(rs.randn(clouds, n, 3).astype(np.float32) * 0.3, device=DEV)
        o = torch.tensor(rs.rand(clouds, n).astype(np.float32), device=DEV)
        o = o / o.sum(-1, keepdim=True)
        n0 = index_points(xyz, farthest_point_sample(xyz, kk, is_center=True))
        cl, at_once = cuda_em.cluster_size(n, kk), cuda_em.max_clusters(n, kk)
        assert at_once >= 1, f"the card runs no cluster of {cl} at (N={n}, K={kk})"
        g1, p1, m1 = sinkhorn_em(xyz, o, n0, iters=1)
        torch.cuda.synchronize()
        g2, p2, m2 = sinkhorn_em_reference(xyz, o, n0, iters=1)
        err1 = max((a - b).abs().max().item() for a, b in ((g1, g2), (p1, p2), (m1, m2)))
        assert torch.isfinite(g1).all() and err1 <= LIM_EM_1, (n, kk, err1)
        chain = _em_trips_chained(xyz, o, n0)
        assert max(chain) <= LIM_EM_1, (n, kk, chain)
        g1, p1, m1 = sinkhorn_em(xyz, o, n0, iters=10)
        torch.cuda.synchronize()
        g2, p2, m2 = sinkhorn_em_reference(xyz, o, n0, iters=10)
        e_nodes = (m1 - m2).abs().max().item()
        e_pi = (p1 - p2).abs().max().item()
        _, p3, m3 = sinkhorn_em_reference(
            xyz, o, torch.nextafter(n0, torch.full_like(n0, 10.0)), iters=10)
        d_nodes = (m3 - m2).abs().max().item()
        d_pi = (p3 - p2).abs().max().item()
        posed = d_nodes <= LIM_EM_10_NODES / 2 and d_pi <= LIM_EM_10_PI / 2
        assert torch.isfinite(g1).all()
        if posed or not wide:
            assert e_nodes <= LIM_EM_10_NODES and e_pi <= LIM_EM_10_PI, \
                (n, kk, e_nodes, e_pi)
        again = sinkhorn_em(xyz, o, n0, iters=10)
        assert all(torch.equal(a, b) for a, b in zip((g1, p1, m1), again)), \
            "sinkhorn_em: two launches differ"
        ms = cuda_ms(lambda: sinkhorn_em(xyz, o, n0, iters=10), 5)
        plain = cuda_ms(lambda: sinkhorn_em_reference(xyz, o, n0, iters=10), 2)
        flops = float(clouds) * n * kk * 10 * (12 + 14 + 9 * 4 + 12)
        nbytes = clouds * 4 * (n * 3 + n + kk * 3 + n * kk + kk + kk * 3)
        t_ops, t_bytes = flops / PEAK_FLOPS["f32"], nbytes / PEAK_BYTES
        res[f"N={n},K={kk}"] = {
            "shape": [clouds, n, kk], "cluster": cl, "clusters_at_once": at_once,
            "lanes_per_row": cuda_em.lanes_per_row(kk),
            "smem_bytes": cuda_em.smem_bytes(n, kk, cl),
            "max_abs_err": err1, "max_abs_err_each_trip": chain,
            "max_abs_err_nodes_10_trips": e_nodes, "max_abs_err_pi_10_trips": e_pi,
            "plain_one_ulp_drift_nodes_10_trips": d_nodes,
            "plain_one_ulp_drift_pi_10_trips": d_pi,
            "ten_trip_limits_held": posed or not wide, "ms": ms,
            "ms_per_pass": ms / (10 * 11), "plain_ms": plain,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}
        print(f"envelopes sinkhorn_em ({clouds}, N={n}, K={kk}, "
              f"{cuda_em.lanes_per_row(kk)} lanes a row): a cluster of {cl} "
              f"blocks ({cuda_em.smem_bytes(n, kk, cl)} B each; the occupancy "
              f"calculator's clusters at once: {at_once}); 1 trip err {err1:.3g}, "
              f"each of 10 trips from the plain state <= {max(chain):.3g} (limit "
              f"{LIM_EM_1}); 10 trips nodes {e_nodes:.3g} pi {e_pi:.3g} (limits "
              f"{LIM_EM_10_NODES}, {LIM_EM_10_PI}{'' if posed or not wide else ', not held'}"
              f"; the plain version from nodes one ulp away: {d_nodes:.3g}, "
              f"{d_pi:.3g}); {ms:.4f} ms, plain {plain:.3f} ms, bound "
              f"{res[f'N={n},K={kk}']['bound_ms']:.4f} ms")
    return res


def _env_cfg(dtype="float32", **model):
    return configs.mnet(model=configs.ModelConfig(dtype=dtype, **model))


def env_serve(cfg, pair, want):
    """One Registrar request on pair (src, tgt, ...) without and with ICP:
    launches (counted from 0 just before the request without ICP), times,
    against the plain versions."""
    reg = Registrar(cfg, seed=0, device=DEV)
    src, tgt = pair[:2]
    reg(src, tgt, refine=True)                         # warm up
    torch.cuda.synchronize()
    out, launches = _counted(lambda: reg(src, tgt, refine=False))
    assert {k: launches.get(k, 0) for k in want} == want, launches
    times = {}
    for refine in (False, True):
        t0 = time.perf_counter()
        outs = reg(src, tgt, refine=refine)
        torch.cuda.synchronize()
        times["forward_icp_ms" if refine else "forward_ms"] = \
            (time.perf_counter() - t0) * 1e3
        assert all(torch.isfinite(o).all() for o in outs)
    with plain_versions():
        before = dict(dispatch.launch_counts)
        p_rot, _, p_so, p_to = reg(src, tgt, refine=False)
        assert dict(dispatch.launch_counts) == before
    k_rot, _, k_so, k_to = out
    d_o = max((k_so - p_so).abs().max().item(), (k_to - p_to).abs().max().item())
    ang = angle_deg(k_rot, p_rot)
    assert d_o <= LIM_OVERLAP and ang.median().item() <= LIM_ROT_DEG, (d_o, ang)
    return launches, {**times, "overlap_vs_plain": d_o,
                      "rot_median_deg_vs_plain": ang.median().item()}


def env_train(rs, cfg, also=None, bwd=True):
    """One train step of cfg at B=24, N=717 with the backward kernels on
    (`BWD_KERNELS`): launches counted from 0 (graph_stage1 2, bwd_reduce 2,
    bwd_stage 6, bwd_edge 2: src and tgt each one backward, and the counts
    `also` asks for; with bwd=False, a graph the backward kernels do not
    take, none of theirs: the backward is plain); from one state
    the loss bit-equal with the switch off and the gradients within
    LIM_BWD_STEP_GRAD, and the step against the plain versions."""
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, device_overlap=True),
                      data=dataclasses.replace(cfg.data, fix_tgt_overlap=True))
    state = create_train_state(cfg, steps_per_epoch=100, seed=0, device=DEV)
    step = make_train_step(cfg)
    batches = [make_batch(rs) for _ in range(2)]
    saved = ops_dgcnn_train.BWD_KERNELS
    ops_dgcnn_train.BWD_KERNELS = True
    try:
        step(state, batches[0])                        # warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics, launches = _counted(lambda: step(state, batches[1]))
        secs = (time.perf_counter() - t0) * 1e3
        assert all(torch.isfinite(v).all() for v in metrics.values()), metrics
        want = {"graph_stage1": 2, "bwd_reduce": 2 * bwd, "bwd_stage": 6 * bwd,
                "bwd_edge": 2 * bwd, **(also or {})}
        assert {k: launches.get(k, 0) for k in want} == want, launches
        k_loss, k_grads = _step_grads(state, cfg, batches[0])
        ops_dgcnn_train.BWD_KERNELS = False
        o_loss, o_grads = _step_grads(state, cfg, batches[0])
        ops_dgcnn_train.BWD_KERNELS = True
        d_bwd = _rel(k_grads, o_grads)
        print(f"envelopes train step, backward kernels on against off: loss "
              f"{k_loss!r} / {o_loss!r}; gradients relative {d_bwd:.3g} (limit "
              f"{LIM_BWD_STEP_GRAD})")
        assert k_loss == o_loss and d_bwd <= LIM_BWD_STEP_GRAD, (k_loss, o_loss, d_bwd)
        with plain_versions():
            p_loss, p_grads = _step_grads(state, cfg, batches[0])
    finally:
        ops_dgcnn_train.BWD_KERNELS = saved
    d_loss = abs(k_loss - p_loss) / abs(p_loss)
    d_grad = _rel(k_grads, p_grads)
    assert d_loss <= LIM_STEP_LOSS and d_grad <= LIM_STEP_GRAD, (d_loss, d_grad)
    return launches, {"step_ms": secs, "loss": k_loss, "loss_off": o_loss,
                      "grad_rel_on_off": d_bwd, "loss_rel_vs_plain": d_loss,
                      "grad_rel_vs_plain": d_grad}


class plain_em_route:
    """Send every EM to the plain route (`ops.gmm.em_plain`), as above the
    kernel's envelope, for the comparison run only."""

    def __enter__(self):
        self.saved = ops_gmm.em_route
        ops_gmm.em_route = lambda *args, **kwargs: "plain"

    def __exit__(self, *exc):
        ops_gmm.em_route = self.saved


def env_serve_wide_em(rs):
    """`Registrar(configs.mnet(model=ModelConfig(n_clusters=512)))` at
    B=24, N=717, float32, full width: the request of env_serve (sinkhorn_em
    1, against the plain versions), then host and busy ms of the forward
    with the EM through the kernel and through the plain route
    (`em_plain`), in turns (kernel, plain, plain, kernel) on the same
    weights, and the plain route's rotation beside the kernel's."""
    cfg = _env_cfg(n_clusters=ENV_K_WIDE)
    pair = make_pairs(rs, B, N)
    launches, out = env_serve(cfg, pair, {"sinkhorn_em": 1, "dgcnn_eval": 1})
    reg = Registrar(cfg, seed=0, device=DEV)
    src, tgt = pair[:2]
    with plain_em_route():
        (p_rot, _, _, _), plain_launches = _counted(lambda: reg(src, tgt, refine=False))
    assert plain_launches.get("sinkhorn_em", 0) == 0, plain_launches
    k_rot = reg(src, tgt, refine=False)[0]
    times = {"kernel": {"host_ms": [], "busy_ms": []},
             "plain_em": {"host_ms": [], "busy_ms": []}}
    for route in ("kernel", "plain_em", "plain_em", "kernel"):
        ctx = plain_em_route() if route == "plain_em" else contextlib.nullcontext()
        with ctx:
            _, t = _timed(lambda: reg(src, tgt, refine=False))
            busy = _busy_ms(lambda: reg(src, tgt, refine=False), {"em_ms": "em_kernel"})
        times[route]["host_ms"] += t["host_ms"]
        times[route]["busy_ms"].append(busy["busy"])
        times[route]["em_kernel_ms"] = busy["em_ms"]
    ang = angle_deg(k_rot, p_rot).median().item()
    for route, v in times.items():
        print(f"envelopes serve n_clusters={ENV_K_WIDE} ({B} pairs of {N}, float32), "
              f"EM {route}: host {[round(x, 2) for x in v['host_ms']]} ms, busy "
              f"{[round(x, 3) for x in v['busy_ms']]} ms (em_kernel "
              f"{v['em_kernel_ms']:.3f})")
    print(f"envelopes serve n_clusters={ENV_K_WIDE}: the plain EM route's rotation "
          f"{ang:.3g} deg from the kernel's (median; not a limit: ten EM trips "
          f"drift apart)")
    return launches, {**out, "cluster": cuda_em.cluster_size(N, ENV_K_WIDE),
                      "by_route": times, "rot_median_deg_plain_route": ang}


def env_cli_profile():
    """`python -m ogmm_tpu_torch.train --profile_dir D` at gnn_k = 12 for
    12 steps of 24 pairs: a Chrome trace of steps [5, 10) in D, naming the
    card's kernels and the steps' "train" ranges."""
    with tempfile.TemporaryDirectory() as tmp:
        prof_dir = os.path.join(tmp, "profile")
        dispatch.reset_launch_counts()
        t0 = time.perf_counter()
        trainer = cli.main(["--dataset", "synthetic", "--root", ENV_CLI_ROOT,
                            "--gnn_k", str(ENV_GNN_K), "--batch_size", str(B),
                            "--test_batch_size", str(B), "--epochs", "1",
                            "--steps_per_epoch", "12", "--model_path",
                            os.path.join(tmp, "run"), "--profile_dir", prof_dir])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: v for k, v in dispatch.launch_counts.items() if v}
        files = os.listdir(prof_dir)
        assert files == ["train_steps_5_10.pt.trace.json"], files
        with open(os.path.join(prof_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
    kernels = {e["name"] for e in events if e.get("cat") == "kernel"}
    ranges = [e for e in events if e.get("name") == "train"
              and e.get("cat") == "user_annotation"]
    named = sorted({n for n in ("knn_kernel", "edge_stage1_kernel", "em_kernel")
                    if any(n in k for k in kernels)})
    print(f"envelopes CLI --profile_dir (gnn_k={ENV_GNN_K}, {trainer.state.step} "
          f"steps of {B}): {secs:.1f} s; the trace holds {len(kernels)} kernel "
          f"names, {len(ranges)} 'train' ranges, the port's {named}")
    assert trainer.state.step == 12 and len(ranges) == 5
    assert named == ["edge_stage1_kernel", "em_kernel", "knn_kernel"], named
    return launches, {"seconds": secs, "trace_kernel_names": len(kernels),
                      "train_ranges": len(ranges)}


def envelopes(rs):
    """The kernels' widened envelopes: (a) each widened kernel against its
    plain version at the new shapes (rows 1, 3, 8 and 10 above k = 32 too);
    (b) `Registrar(configs.mnet(gnn_k=12))`
    at B=24, N=717, float32 and bf16 (dgcnn_eval 1, sinkhorn_em 1); (c)
    one train step of it, float32 and bf16, with the backward kernels on
    (graph_stage1 2, bwd_reduce 2, bwd_stage 6, bwd_edge 2); (d) a request at B=8, N=4,096,
    K=128 (sinkhorn_em 1, a cluster of 16 blocks a cloud); (e) the CLI with
    --profile_dir; (f) the indoor request (float32, B=1, N=35,000) at gnn_k=12
    with dgcnn_fused_edges=True (dgcnn_edges 1). Each part's launches are
    counted from 0 right before it. (g) the n_clusters=512 request (float32,
    B=24, N=717; sinkhorn_em 1, beside the plain EM route) and its train
    step (sinkhorn_em 1). (h) at gnn_k = 40: the float32 and bf16 requests
    at (24, 717) (dgcnn_eval 1), the float32 request at (24, 1433) (knn 1),
    the step with the backward kernels on (graph_stage1 2, the backward
    plain), the CLI (graph_stage1 6 in three steps) and the indoor request
    (float32, B=1, N=35,000) with dgcnn_fused_edges=True (dgcnn_edges 1)."""
    wide1, wide3 = env_dgcnn_wide(rs)
    kernels = {"dgcnn_eval": {**env_dgcnn_eval(rs), **wide1},
               "dgcnn_edges": {"k=12": env_dgcnn_edges(rs), **env_edges_wide(rs)},
               "graph_stage1": {**env_graph_stage1(rs), **wide3},
               "knn": env_knn_wide(rs), "sinkhorn_em": env_em(rs),
               **env_dgcnn_bwd(rs)}
    total, res = {}, {"kernels": kernels}
    indoor = configs.indoor()
    indoor_wide = indoor.replace(model=dataclasses.replace(
        indoor.model, gnn_k=ENV_GNN_K_WIDE, dgcnn_fused_edges=True))
    indoor = indoor.replace(model=dataclasses.replace(
        indoor.model, gnn_k=ENV_GNN_K, dgcnn_fused_edges=True))
    parts = (("serve_k12_f32", lambda: env_serve(
                 _env_cfg(gnn_k=ENV_GNN_K), make_pairs(rs, B, N),
                 {"dgcnn_eval": 1, "sinkhorn_em": 1, "knn": 0})),
             ("serve_k12_bf16", lambda: env_serve(
                 _env_cfg("bfloat16", gnn_k=ENV_GNN_K), make_pairs(rs, B, N),
                 {"dgcnn_eval": 1, "sinkhorn_em": 1, "knn": 0})),
             ("train_k12", lambda: env_train(rs, _env_cfg(gnn_k=ENV_GNN_K))),
             ("train_k12_bf16", lambda: env_train(rs, _env_cfg("bfloat16", gnn_k=ENV_GNN_K))),
             ("serve_n4096", lambda: env_serve(
                 _env_cfg(), make_pairs(rs, 8, ENV_N_EM),
                 {"sinkhorn_em": 1, "dgcnn_eval": 0})),
             ("serve_indoor_k12_edges", lambda: env_serve(
                 indoor, rigid_copies(rs, surface(rs, 1)),
                 {"dgcnn_edges": 1, "knn_stream": 1, "dgcnn_eval": 0})),
             ("cli_profile", env_cli_profile),
             (f"serve_k{ENV_K_WIDE}", lambda: env_serve_wide_em(rs)),
             (f"train_k{ENV_K_WIDE}", lambda: env_train(
                 rs, _env_cfg(n_clusters=ENV_K_WIDE), {"sinkhorn_em": 1})),
             (f"serve_gnn_k{ENV_GNN_K_WIDE}_f32", lambda: env_serve(
                 _env_cfg(gnn_k=ENV_GNN_K_WIDE), make_pairs(rs, B, N),
                 {"dgcnn_eval": 1, "sinkhorn_em": 1, "knn": 0, "posenc_angles": 0})),
             (f"serve_gnn_k{ENV_GNN_K_WIDE}_bf16", lambda: env_serve(
                 _env_cfg("bfloat16", gnn_k=ENV_GNN_K_WIDE), make_pairs(rs, B, N),
                 {"dgcnn_eval": 1, "sinkhorn_em": 1, "knn": 0, "posenc_angles": 0})),
             (f"serve_gnn_k{ENV_GNN_K_WIDE}_n{N_LARGE}", lambda: env_serve(
                 _env_cfg(gnn_k=ENV_GNN_K_WIDE), make_pairs(rs, B, N_LARGE),
                 {"knn": 1, "dgcnn_eval": 0, "sinkhorn_em": 1})),
             (f"train_gnn_k{ENV_GNN_K_WIDE}", lambda: env_train(
                 rs, _env_cfg(gnn_k=ENV_GNN_K_WIDE), bwd=False)),
             (f"cli_gnn_k{ENV_GNN_K_WIDE}", env_cli_wide_k),
             # the graph from the plain chunked kNN (the streamed kernel
             # stops at k = 32), the stage chain through the edges kernel
             (f"serve_indoor_gnn_k{ENV_GNN_K_WIDE}_edges", lambda: env_serve(
                 indoor_wide, rigid_copies(rs, surface(rs, 1)),
                 {"dgcnn_edges": 1, "knn_stream": 0, "dgcnn_eval": 0})))
    for name, fn in parts:
        launches, out = fn()
        print(f"envelopes {name}: launches {launches}; {out}")
        _add_counts(total, launches)
        res[name] = {"launches": launches, **out}
    assert cuda_em.cluster_size(ENV_N_EM, K) == 16
    assert cuda_em.cluster_size(N, ENV_K_WIDE) == 8
    return {name: total.get(name, 0) for name in dispatch.KERNELS}, res


PHASES = ("kernels", "serve", "train", "cli", "icp", "serve_large",
          "train_large", "train_unfused", "c1", "indoor_kernels", "indoor",
          "loop_kernels", "serve_loops", "serve_f32", "train_indoor",
          "deepgmr", "surface", "distributed", "envelopes")


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
                      ("serve_loops", lambda _: serve_loops(np.random.RandomState(10))),
                      ("serve_f32", lambda _: serve_f32(np.random.RandomState(16))),
                      ("train_indoor", lambda _: train_indoor(np.random.RandomState(17))),
                      ("deepgmr", deepgmr), ("surface", surface_phase),
                      ("distributed", lambda _: distributed(np.random.RandomState(21))),
                      ("envelopes", lambda _: envelopes(np.random.RandomState(22)))):
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
            if name in out.get("deepgmr", {}).get("kernels", {}):
                k["at_deepgmr"] = out["deepgmr"]["kernels"][name]
            if name in out.get("surface", {}).get("kernels", {}):
                k["at_surface"] = out["surface"]["kernels"][name]
            if name in out.get("distributed", {}).get("kernels", {}):
                k["at_sp"] = out["distributed"]["kernels"][name]
            if name in out.get("envelopes", {}).get("kernels", {}):
                k["at_envelopes"] = out["envelopes"]["kernels"][name]
        print(json.dumps({"kernels": kernels}))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
