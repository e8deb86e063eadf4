"""Nearest neighbour of 3-D points: the CUDA kernel's wrapper and its plain
version.

`nn1(src, tgt)` gives, for every point of src (B, N, 3), the squared
distance to the nearest point of tgt (B, M, 3), clamped at 1e-12, and that
point's index; among equal minima the first index wins. Distances take the
fixed float32 order of `square_distance3`, in the kernel as here, so the two
pick the same index bit for bit.

On a CUDA tensor the wrapper launches `csrc/nn1.cu` (M <= 4096, the TPU
kernel's envelope); on a CPU tensor it runs `nn1_reference`. Callers reach it
through `ops.common.nn1`.
"""
from __future__ import annotations

import ctypes

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import square_distance3

KERNEL_MAX_M = 4096


@torch.no_grad()
def nn1_reference(src: torch.Tensor, tgt: torch.Tensor):
    """Plain PyTorch version: (B, N, 3) x (B, M, 3) ->
    (min squared distance (B, N) float32, index (B, N) int64)."""
    d = square_distance3(src.float(), tgt.float())
    idx = d.argmin(dim=-1)
    return d.gather(-1, idx.unsqueeze(-1)).squeeze(-1), idx


def _nn1_cuda(src, tgt):
    B, N, C = src.shape
    M = tgt.shape[1]
    if C != 3 or tgt.shape != (B, M, 3):
        raise ValueError(f"nn1 kernel takes (B, N, 3) and (B, M, 3) points; "
                         f"got {tuple(src.shape)} and {tuple(tgt.shape)}")
    if not 1 <= M <= KERNEL_MAX_M or N < 1:
        raise ValueError(f"nn1 kernel takes 1 <= M <= {KERNEL_MAX_M} target "
                         f"points; got N={N}, M={M}")
    src = src.float().contiguous()
    tgt = tgt.float().contiguous()
    d = torch.empty(B, N, dtype=torch.float32, device=src.device)
    idx = torch.empty(B, N, dtype=torch.int64, device=src.device)
    fn = dispatch.load_kernel("nn1").nn1_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    code = fn(*[ctypes.c_void_p(a.data_ptr()) for a in (src, tgt, d, idx)],
              B, N, M, ctypes.c_void_p(dispatch.current_stream(src)))
    dispatch.check_launch(code, "nn1")
    dispatch.launch_counts["nn1"] += 1
    return d, idx


def nn1(src: torch.Tensor, tgt: torch.Tensor):
    """1-NN: (B, N, 3) x (B, M, 3) -> (min squared distance (B, N), index
    (B, N) int64). Launches the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Carries no gradient."""
    if src.is_cuda:
        return _nn1_cuda(src, tgt)
    return nn1_reference(src, tgt)
