"""Fused eval DGCNN encoder: the CUDA kernel's wrapper and its plain version.

`dgcnn_eval(x, weights, affines)` computes, for every point of (B, N, 3)
clouds: the float32 distance row to its cloud, the k nearest neighbours
(ascending, ties to the lowest index, by argmin-and-mask), the edge rows
[nbr - q, q] (the offset formed in float32, then cast), four
Dense + folded-BN + ReLU stages (6 -> 64 -> 64 -> 128 -> 256) in the compute
dtype with float32 accumulation and a max over k after each, the 512-wide
concat and the final Dense + BN + ReLU; with `posenc_k` also the
position-encoding angles cos(angle(p -> nbr_j, p -> centroid)) of the first
`posenc_k` neighbours from float32 coordinates.

On a CUDA tensor the wrapper launches `csrc/dgcnn_eval.cu` (`kernel_takes`:
k >= 1 and emb a multiple of 64; k <= N <= 1024, the JAX kernel's
envelope); on a CPU tensor it runs `dgcnn_eval_reference`, the plain
PyTorch version of the same arithmetic. The kernel's stage chain is compiled
for `stage_rows(k)` rows a point (STAGE_KS) and fills the rows past k with
the nearest neighbour, which changes no max over a point's rows; above
CHUNK_K neighbours a point's rows go through it in chunks (`stage_chunks`),
their maxes merged, and the selection is `csrc/knn_wide.cuh`'s in place of
the register lists. In float32 the kernel's products run on
the tensor cores as three TF32 products each (the operands split into a TF32
high and low part), about 2^-22 of each product from true float32; the plain
version stays true float32.

`dgcnn_edges(x, nbr, weights, affines)` is the stage chain alone over given
float32 neighbour coordinates nbr (B, N, k, 3), at any N and k: the port of
`dgcnn_edges_pallas`, the second entry point of the same source (the same
k), with `dgcnn_edges_reference` beside it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import (gather_neighbors, posenc_alpha,
                                       select_smallest, square_distance3)

STAGES = (64, 64, 128, 256)
CHUNK_K = 32             # neighbours a point of one stage-chain launch at
#                          most, and of the register-list selection
#                          (csrc/knn_select.cuh:DGCNN_MAX_K)
CHUNK_KS = tuple(range(1, CHUNK_K + 1))   # neighbour counts of one launch
STAGE_KS = (8, 12, 16, 20, 24, 28, 32)   # rows a point the stage chains are
#                          compiled for (csrc/knn_select.cuh:DGCNN_KS)
KERNEL_MAX_N = 1024      # the cloud of dgcnn_eval lives in shared memory
KERNEL_EMB = 64          # the head's output tiles: emb a multiple of 64


def stage_rows(k: int) -> int:
    """The rows a point of k <= CHUNK_K neighbours takes in the stage chains
    (csrc/knn_select.cuh:dgcnn_rows): k rounded up to a multiple of 4, at
    least 8 (an 8-row tensor-core tile spans at most two points)."""
    return max(8, -(-k // 4) * 4)


def stage_chunks(k: int) -> tuple:
    """The stage launches of a graph of k neighbours, mirroring
    `csrc/dgcnn_eval.cu:launch_stages`: (first neighbour, neighbours) of
    each chunk, CHUNK_K at a time in order, the last the rest; each takes
    stage_rows(neighbours) rows a point, and the chunks after the first
    merge their maxes into the concat."""
    return tuple((j0, min(CHUNK_K, k - j0)) for j0 in range(0, k, CHUNK_K))


def kernel_takes(k: int, emb: int) -> bool:
    """The envelope both eval kernels (`dgcnn_eval`, `dgcnn_edges`) share:
    a graph of k >= 1 neighbours and emb a multiple of KERNEL_EMB (the eval
    kernel also needs k <= N <= KERNEL_MAX_N, its routes check it). The
    routes (`nn.dgcnn.fused_route`, `edges_route`) and the wrappers read it,
    so that a route never picks a kernel that refuses the call."""
    return k >= 1 and emb >= KERNEL_EMB and emb % KERNEL_EMB == 0


def fold_weights(weights, affines, dtype: torch.dtype):
    """BN scale folded into the kernels (in float32), then cast: the five
    (Cin, Cout) weights and (Cout,) biases the stage chain uses."""
    ws = [(w.float() * s.float()[None, :]).to(dtype)
          for w, (s, _) in zip(weights, affines)]
    bs = [b.float().to(dtype) for _, b in affines]
    return ws, bs


def run_stages(e: torch.Tensor, ws, bs) -> torch.Tensor:
    """The stage chain over an edge tensor (B, N, k, 6) in the compute dtype
    -> (B, N, emb). Products accumulate in float32 and round to the compute
    dtype before the bias is added, as the kernel does."""
    def stage(h, w, b):
        return torch.relu(torch.matmul(h, w) + b)

    taps = []
    h = e
    for w, b in zip(ws[:4], bs[:4]):
        h = stage(h, w, b)
        taps.append(h.amax(dim=2))
    return stage(torch.cat(taps, dim=-1), ws[4], bs[4])


def dgcnn_eval_reference(x: torch.Tensor, weights, affines, k: int = 20,
                         dtype: torch.dtype = torch.bfloat16,
                         posenc_k: int = 0):
    """Plain PyTorch version of the fused kernel. x (B, N, 3) float32 ->
    (B, N, emb) in `dtype` [, alpha (B, N, posenc_k) float32]."""
    if posenc_k > k:
        raise ValueError(f"posenc_k={posenc_k} must be <= k={k}")
    x = x.float()
    idx = select_smallest(square_distance3(x, x), k)
    nbr = gather_neighbors(x, idx)                       # (B, N, k, 3) f32
    center = x.unsqueeze(2).expand_as(nbr)
    e = torch.cat([nbr - center, center], dim=-1).to(dtype)
    ws, bs = fold_weights(weights, affines, dtype)
    out = run_stages(e, ws, bs)
    if posenc_k:
        return out, posenc_alpha(x, nbr[:, :, :posenc_k])
    return out


def dgcnn_edges_reference(x: torch.Tensor, nbr: torch.Tensor, weights,
                          affines, k: int = 20,
                          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of the edges kernel. x (B, N, 3), nbr (B, N, k,
    3) float32 -> (B, N, emb) in `dtype`."""
    x = x.float()
    if nbr.shape[:3] != (*x.shape[:2], k):
        raise ValueError(f"nbr {tuple(nbr.shape)} is not (B, N, k={k}, 3)")
    center = x.unsqueeze(2).expand_as(nbr)
    e = torch.cat([nbr.float() - center, center], dim=-1).to(dtype)
    ws, bs = fold_weights(weights, affines, dtype)
    return run_stages(e, ws, bs)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _kernel_operands(what, weights, affines, k, dtype):
    """The checks both entry points share, and their operands, one convention
    for both compute types (csrc/dgcnn_eval.cu:dgcnn_eval_launch): stages
    1-4's weights (C_in, C_out), BN scales and biases as given, in float32
    (the kernels fold the scales in), and the head's w5 (512, emb) folded
    in the compute type, with b5 in float32."""
    emb = weights[4].shape[1]
    dims = [tuple(w.shape) for w in weights]
    want = [(6, 64), (64, 64), (64, 128), (128, 256), (512, emb)]
    if dims != want:
        raise ValueError(f"{what} kernel: weight shapes {dims} != {want}")
    if not kernel_takes(k, emb):
        raise ValueError(f"{what} kernel takes k >= 1 and emb a multiple of "
                         f"{KERNEL_EMB}; got k={k}, emb={emb}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} kernel: dtype {dtype} not supported")
    s5 = affines[4][0]
    w5 = (weights[4].float() * s5.float()[None, :]).to(dtype).contiguous()
    return ([w.float().contiguous() for w in weights[:4]] + [w5],
            [s.float().contiguous() for s, _ in affines[:4]],
            [b.float().contiguous() for _, b in affines])


def _concat_scratch(x, dtype):
    """The (B*N, 512) concat the stage launch writes and the head launch
    reads, in the compute type (both routes)."""
    return torch.empty(x.shape[0] * x.shape[1], sum(STAGES), dtype=dtype,
                       device=x.device)


# csrc/dgcnn_eval.cu: the float32 stage kernel's points (QF; half of them
# where QF points' rows do not fit a block, f32_points) and warps (NWF) a
# block, the row strides of its float32 activations (LDF_X, LDF_Y), and the
# shared memory an SM offers a block on an H100
F32_POINTS, F32_WARPS = 8, 8
F32_LD = (68, 132)
SMEM_PER_BLOCK = 232448       # 227 KB
SMEM_PER_SM = 233472          # 228 KB, 1 KB of it reserved for each block
REGS_PER_SM, MAX_REGS = 65536, 255


class F32StagePlan(NamedTuple):
    points: int     # points (QF, or QF / 2) a block
    rows: int       # rows a point, stage_rows(k)
    warps: int      # warps a block
    smem: int       # dynamic shared memory of a block, bytes
    blocks_sm: int  # blocks an SM holds: shared memory, and the registers of
    #                 __launch_bounds__(NWF * 32, 1), which lets a thread
    #                 take all 255
    grid: tuple     # (point blocks, B)


def f32_stage_plan(B: int, N: int, k: int) -> F32StagePlan:
    """The float32 (3xTF32) stage launch of k <= CHUNK_K neighbours a point
    (one chunk of `stage_chunks`) as a pure function of the shapes,
    mirroring `csrc/dgcnn_eval.cu:stage_launch_f32`: QF points a block, or
    QF / 2 where QF points' rows do not fit (`f32_points`); in shared memory
    (`f32_smem`) the activations of its points' stage_rows(k) edge rows each
    in a buffer of LDF_X floats a row and one of two planes of LDF_Y (stage
    3's output split into TF32 high and low parts), and its concat rows; one
    block a point group of a cloud."""
    if k not in CHUNK_KS:
        raise ValueError(f"one stage launch takes 1 <= k <= {CHUNK_K}; got {k}")
    ld_x, ld_y = F32_LD
    rows = stage_rows(k)

    def smem_of(points):
        return 4 * (points * rows * (ld_x + 2 * ld_y) + points * sum(STAGES))

    points = F32_POINTS if smem_of(F32_POINTS) <= SMEM_PER_BLOCK else F32_POINTS // 2
    smem = smem_of(points)
    threads = 32 * F32_WARPS
    blocks = min(SMEM_PER_SM // (smem + 1024), REGS_PER_SM // (threads * MAX_REGS))
    return F32StagePlan(points, rows, F32_WARPS, smem, blocks,
                        (-(-N // points), B))


def _dgcnn_eval_cuda(x, weights, affines, k, dtype, posenc_k, idx=None):
    """The launch; `idx`, an int32 (B, N, k) tensor on the card, takes the
    kNN graph the kernel selects (the checks compare it with the plain
    version's)."""
    B, N, _ = x.shape
    emb = weights[4].shape[1]
    if not k <= N <= KERNEL_MAX_N or posenc_k > k:
        raise ValueError(f"dgcnn_eval kernel takes k <= N <= {KERNEL_MAX_N} "
                         f"and posenc_k <= k; got k={k}, N={N}, "
                         f"posenc_k={posenc_k}")
    x = x.float().contiguous()
    ws, ss, bs = _kernel_operands("dgcnn_eval", weights, affines, k, dtype)
    if idx is None:
        idx = torch.empty(B, N, k, dtype=torch.int32, device=x.device)
    elif idx.shape != (B, N, k) or idx.dtype != torch.int32 or not idx.is_contiguous():
        raise ValueError(f"idx takes the (B, N, k) = {(B, N, k)} int32 graph")
    alpha = torch.empty(B, N, max(posenc_k, 1), dtype=torch.float32,
                        device=x.device)
    cat = _concat_scratch(x, dtype)
    out = torch.empty(B, N, emb, dtype=dtype, device=x.device)
    lib = dispatch.load_kernel("dgcnn_eval")
    fn = lib.dgcnn_eval_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    code = fn(_ptr(x), *[_ptr(w) for w in ws], *[_ptr(s) for s in ss],
              *[_ptr(b) for b in bs], _ptr(idx), _ptr(alpha), _ptr(cat), _ptr(out),
              B, N, emb, k, posenc_k, int(dtype == torch.bfloat16),
              ctypes.c_void_p(dispatch.current_stream(x)))
    dispatch.check_launch(code, "dgcnn_eval")
    dispatch.launch_counts["dgcnn_eval"] += 1
    if posenc_k:
        return out, alpha
    return out


def dgcnn_eval(x: torch.Tensor, weights, affines, k: int = 20,
               dtype: torch.dtype = torch.bfloat16, posenc_k: int = 0):
    """Fused eval DGCNN. weights: 5 float32 kernels [(6,64), (64,64),
    (64,128), (128,256), (512,emb)]; affines: 5 folded BN (scale, bias)
    pairs. Launches the CUDA kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    if x.is_cuda:
        return _dgcnn_eval_cuda(x, weights, affines, k, dtype, posenc_k)
    return dgcnn_eval_reference(x, weights, affines, k, dtype, posenc_k)


def _dgcnn_edges_cuda(x, nbr, weights, affines, k, dtype):
    B, N, _ = x.shape
    emb = weights[4].shape[1]
    if tuple(nbr.shape) != (B, N, k, 3) or N < 1 or nbr.device != x.device:
        raise ValueError(f"dgcnn_edges kernel takes x (B, N, 3) and nbr "
                         f"(B, N, k={k}, 3) on one device; got "
                         f"{tuple(x.shape)}, {tuple(nbr.shape)}")
    x = x.float().contiguous()
    nbr = nbr.float().contiguous()
    ws, ss, bs = _kernel_operands("dgcnn_edges", weights, affines, k, dtype)
    cat = _concat_scratch(x, dtype)
    out = torch.empty(B, N, emb, dtype=dtype, device=x.device)
    fn = dispatch.load_kernel("dgcnn_eval").dgcnn_edges_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    code = fn(_ptr(x), _ptr(nbr), *[_ptr(w) for w in ws], *[_ptr(s) for s in ss],
              *[_ptr(b) for b in bs], _ptr(cat), _ptr(out), B, N, emb, k,
              int(dtype == torch.bfloat16),
              ctypes.c_void_p(dispatch.current_stream(x)))
    dispatch.check_launch(code, "dgcnn_edges")
    dispatch.launch_counts["dgcnn_edges"] += 1
    return out


def dgcnn_edges(x: torch.Tensor, nbr: torch.Tensor, weights, affines,
                k: int = 20, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Eval DGCNN stage chain over given neighbours: x (B, N, 3) and nbr
    (B, N, k, 3) float32 -> (B, N, emb) in `dtype`; weights and affines as
    `dgcnn_eval`. Launches the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if x.is_cuda:
        return _dgcnn_edges_cuda(x, nbr, weights, affines, k, dtype)
    return dgcnn_edges_reference(x, nbr, weights, affines, k, dtype)
