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

On a CUDA tensor the wrapper launches `csrc/dgcnn_eval.cu` (k in KERNEL_KS,
k <= N <= 1024); on a CPU tensor it runs `dgcnn_eval_reference`, the plain
PyTorch version of the same arithmetic.

`dgcnn_edges(x, nbr, weights, affines)` is the stage chain alone over given
float32 neighbour coordinates nbr (B, N, k, 3), at any N: the port of
`dgcnn_edges_pallas`, the second entry point of the same source (k in
KERNEL_KS), with `dgcnn_edges_reference` beside it.
"""
from __future__ import annotations

import ctypes

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import (gather_neighbors, posenc_alpha,
                                       select_smallest, square_distance3)

STAGES = (64, 64, 128, 256)
KERNEL_KS = (8, 16, 20)           # neighbour counts the kernels are
#                                  compiled for (csrc/knn_select.cuh:DGCNN_KS)
KERNEL_MAX_N = 1024      # one distance row lives in a warp's registers


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
    if k not in KERNEL_KS or emb % 64:
        raise ValueError(f"{what} kernel takes k in {KERNEL_KS} and emb a "
                         f"multiple of 64; got k={k}, emb={emb}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} kernel: dtype {dtype} not supported")
    s5 = affines[4][0]
    w5 = (weights[4].float() * s5.float()[None, :]).to(dtype).contiguous()
    return ([w.float().contiguous() for w in weights[:4]] + [w5],
            [s.float().contiguous() for s, _ in affines[:4]],
            [b.float().contiguous() for _, b in affines])


def _concat_scratch(x, dtype):
    """The (B*N, 512) concat the bf16 stage launch writes and its head
    launch reads; the float32 route keeps it on chip."""
    rows = x.shape[0] * x.shape[1] if dtype == torch.bfloat16 else 0
    return torch.empty(rows, sum(STAGES), dtype=dtype, device=x.device)


def _dgcnn_eval_cuda(x, weights, affines, k, dtype, posenc_k):
    B, N, _ = x.shape
    emb = weights[4].shape[1]
    if not k <= N <= KERNEL_MAX_N or posenc_k > k:
        raise ValueError(f"dgcnn_eval kernel takes k <= N <= {KERNEL_MAX_N} "
                         f"and posenc_k <= k; got k={k}, N={N}, "
                         f"posenc_k={posenc_k}")
    x = x.float().contiguous()
    ws, ss, bs = _kernel_operands("dgcnn_eval", weights, affines, k, dtype)
    idx = torch.empty(B, N, k, dtype=torch.int32, device=x.device)
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
