"""The streamed kernels' wrappers: `knn_stream`, `nn1_stream`
(`csrc/knn_stream.cu`) and `wproject_stream_lse` (`csrc/wproject.cu`).

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU tensor it
runs the plain version of `ops/stream.py`. What each kernel takes is written
once, in a `*_takes` function of shapes, which the routes of
`ops/common.py` and `nn/gmmreg.py` read before anything runs:

  knn_stream   3-D points, 1 <= k <= 32 and k <= M, any N and M; with an
               optional cull table (B, ceil(N/64), ceil(M/512)), the
               diagonal-first order and its stretch
  nn1_stream   3-D points, any N and M >= 1; an optional cull table and, with
               it, the gate max_dist_sq
  wproject     q (B, N, D), k (B, M, D) of one type: bf16 with D in
               {64, 128, 256, 512} (q rows held in registers) or float32
               with D a multiple of 32; v (B, M, 1)
"""
from __future__ import annotations

import ctypes
import math

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import STREAM_MAX_K
from ogmm_tpu_torch.ops.stream import (TILE_M, TILE_N, knn_stream_plain,
                                       nn1_stream_plain,
                                       wproject_stream_lse_plain)

WPROJECT_BF16_D = (64, 128, 256, 512)   # csrc/wproject.cu: instantiated widths
WPROJECT_F32_DC = 32                     # and the float32 kernel's chunk


def knn_stream_takes(C: int, M: int, k: int) -> bool:
    return C == 3 and 1 <= k <= min(STREAM_MAX_K, M)


def wproject_takes(D: int, dtype: torch.dtype) -> bool:
    if dtype == torch.bfloat16:
        return D in WPROJECT_BF16_D
    return dtype == torch.float32 and D > 0 and D % WPROJECT_F32_DC == 0


def _ptr(t: torch.Tensor | None) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _points(src, tgt, what):
    B, N, C = src.shape
    M = tgt.shape[1]
    if C != 3 or tuple(tgt.shape) != (B, M, 3) or N < 1:
        raise ValueError(f"{what} kernel takes (B, N, 3) and (B, M, 3) points; "
                         f"got {tuple(src.shape)} and {tuple(tgt.shape)}")
    if tgt.device != src.device:
        raise ValueError(f"{what}: src and tgt lie on different devices")
    return B, N, M, src.float().contiguous(), tgt.float().contiguous()


def _cull(cull_lb, B, N, M, device):
    if cull_lb is None:
        return None
    want = (B, math.ceil(N / TILE_N), math.ceil(M / TILE_M))
    if tuple(cull_lb.shape) != want or cull_lb.device != device:
        raise ValueError(f"cull table of shape {tuple(cull_lb.shape)} on "
                         f"{cull_lb.device}; the kernel's tiles need {want}")
    return cull_lb.float().contiguous()


def _knn_stream_cuda(src, tgt, k, diag_order, stretch, cull_lb):
    B, N, M, src, tgt = _points(src, tgt, "knn_stream")
    if not knn_stream_takes(3, M, k):
        raise ValueError(f"knn_stream kernel takes 1 <= k <= "
                         f"min({STREAM_MAX_K}, M); got k={k}, M={M}")
    lb = _cull(cull_lb, B, N, M, src.device)
    idx = torch.empty(B, N, k, dtype=torch.int64, device=src.device)
    fn = dispatch.load_kernel("knn_stream").knn_stream_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    code = fn(_ptr(src), _ptr(tgt), _ptr(lb), _ptr(idx), B, N, M, k,
              int(diag_order), int(stretch),
              ctypes.c_void_p(dispatch.current_stream(src)))
    dispatch.check_launch(code, "knn_stream")
    dispatch.launch_counts["knn_stream"] += 1
    return idx


def knn_stream(src: torch.Tensor, tgt: torch.Tensor, k: int,
               diag_order: bool = False, stretch: int = 1,
               cull_lb: torch.Tensor | None = None) -> torch.Tensor:
    """kNN with the target streamed: (B, N, 3) x (B, M, 3) -> int64 (B, N,
    k), ascending distance, ties to the lowest index. `cull_lb` is a table
    of `ops.stream.pair_tile_bounds` for the kernel's tiles; it and the
    visiting order (`diag_order`, `stretch`) only decide what the kernel may
    skip, never the result. Launches the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Carries no gradient."""
    if src.is_cuda:
        return _knn_stream_cuda(src, tgt, k, diag_order, stretch, cull_lb)
    return knn_stream_plain(src, tgt, k, cull_lb=cull_lb)


def _nn1_stream_cuda(src, tgt, cull_lb, max_dist_sq, diag_order, stretch):
    B, N, M, src, tgt = _points(src, tgt, "nn1_stream")
    lb = _cull(cull_lb, B, N, M, src.device)
    d = torch.empty(B, N, dtype=torch.float32, device=src.device)
    idx = torch.empty(B, N, dtype=torch.int64, device=src.device)
    fn = dispatch.load_kernel("knn_stream").nn1_stream_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    # the gate only clamps the cull: without a table it has nothing to do
    gate = float("inf") if max_dist_sq is None or lb is None else float(max_dist_sq)
    code = fn(_ptr(src), _ptr(tgt), _ptr(lb), _ptr(d), _ptr(idx), B, N, M,
              gate, int(diag_order), int(stretch),
              ctypes.c_void_p(dispatch.current_stream(src)))
    dispatch.check_launch(code, "nn1_stream")
    dispatch.launch_counts["nn1_stream"] += 1
    return d, idx


def nn1_stream(src: torch.Tensor, tgt: torch.Tensor,
               cull_lb: torch.Tensor | None = None,
               max_dist_sq: float | None = None, diag_order: bool = False,
               stretch: int = 1):
    """1-NN with the target streamed: (B, N, 3) x (B, M, 3) -> (min squared
    distance (B, N), index (B, N) int64), first index among equal minima.
    With `cull_lb` and `max_dist_sq` (the ICP inlier gate), a row whose
    nearest point lies at or beyond the gate may return any index and a
    distance >= the gate; every other row is exact. Launches the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if src.is_cuda:
        return _nn1_stream_cuda(src, tgt, cull_lb, max_dist_sq, diag_order,
                                stretch)
    return nn1_stream_plain(src, tgt, cull_lb, max_dist_sq)


def _wproject_cuda(q, k, v):
    B, N, D = q.shape
    M = k.shape[1]
    if tuple(k.shape) != (B, M, D) or tuple(v.shape) != (B, M, 1) or N < 1 \
            or M < 1:
        raise ValueError(f"wproject kernel takes q (B, N, D), k (B, M, D), "
                         f"v (B, M, 1); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or not wproject_takes(D, q.dtype):
        raise ValueError(f"wproject kernel takes q and k of one type, bf16 "
                         f"with D in {WPROJECT_BF16_D} or float32 with D a "
                         f"multiple of {WPROJECT_F32_DC}; got {q.dtype}, "
                         f"{k.dtype}, D={D}")
    q, k = q.contiguous(), k.contiguous()
    v = v.float().contiguous()
    out = torch.empty(B, N, 1, dtype=torch.float32, device=q.device)
    lse = torch.empty(B, N, 1, dtype=torch.float32, device=q.device)
    fn = dispatch.load_kernel("wproject").wproject_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    code = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), B, N, M, D,
              int(q.dtype == torch.bfloat16),
              ctypes.c_void_p(dispatch.current_stream(q)))
    dispatch.check_launch(code, "wproject")
    dispatch.launch_counts["wproject"] += 1
    return out, lse


def wproject_stream_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax(q k^T) v without the (N, M) matrix, and the row logsumexp:
    q (B, N, D), k (B, M, D), v (B, M, 1) -> out (B, N, 1), lse (B, N, 1),
    float32. Launches the CUDA kernel for a CUDA tensor (no gradient), the
    plain version for a CPU tensor."""
    if q.is_cuda:
        with torch.no_grad():
            return _wproject_cuda(q, k, v)
    return wproject_stream_lse_plain(q, k, v)
