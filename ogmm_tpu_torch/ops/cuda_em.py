"""Overlap-weighted Sinkhorn-EM: the CUDA kernel's wrapper and its plain version.

`sinkhorn_em(xyz, o_norm, nodes0)` runs `iters` EM trips per cloud:

  E-step  cost = sqrt(max(d2(xyz, nodes), 1e-12)) / tau; Sinkhorn with row
          marginal p = o_norm + 1e-8 and column marginal q = 1/K + 1e-8:
          trip 1 in the log domain (stabilised row update, column update
          with a 1e-38 floor), trips 2..sk_iters as direct scaling of
          P = exp(log-plan) with the sums floored at 1e-38
  gamma   non-finite -> 0, rows divided by max(row sum, 1e-3)
  M-step  pi = sum_n gamma / N; nodes = gamma^T xyz / (pi N + 1e-5)

Two valid EM implementations drift apart after about 4 trips (near-hard
assignments amplify the last float32 bit), so the kernel is compared with
the plain version per trip (iters=1) and on what the model consumes.

On a CUDA tensor the wrapper launches `csrc/sinkhorn_em.cu` (`kernel_takes`:
K <= 1024 and a cloud's plan in the shared memory of a cluster of 8 blocks,
or of 16 where 8 do not hold it (`cluster_size`): every (N, K) with
K <= min(N, 1024) that the JAX package's rule sends to its kernel, N <= 5,734
at K <= 128, 2,867 at K = 256, 1,433 at K = 512, 717 at K = 1023, and every
such pair with K > N to K = 896); on a CPU tensor it runs
`sinkhorn_em_reference`.

The kernel spreads a plan row over `lanes_per_row(K)` lanes of a warp (8 to
K = 256, 16 to 512, 32 to 1024), each lane holding at most 32 entries of
the row, and pads K to `padded_k(K)` columns (whole chunks of 4 columns on
every lane of a row). A block's shared memory (`smem_bytes`) is its slab of
the plan beside 15 column vectors of the padded K to K = 256 and 11 above
it, where the M-step's sums share the warps' sums' space.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import matmul32, square_distance3

KERNEL_MAX_K = 1024          # 32 lanes a row, 8 chunks of 4 columns a lane
SMEM_BYTES = 227 * 1024      # shared memory a block may use
CLUSTERS = (8, 16)           # blocks a cloud, the smallest that holds the plan


def lanes_per_row(K: int) -> int:
    """The lanes of a warp that hold one plan row
    (csrc/sinkhorn_em.cu:em_form_of): 8 to K = 256, 16 to 512, 32 above."""
    return 8 if K <= 256 else 16 if K <= 512 else 32


def padded_k(K: int) -> int:
    """K padded to whole chunks of 4 columns on each of a row's lanes."""
    step = 4 * lanes_per_row(K)
    return step * -(-K // step)


def smem_bytes(N: int, K: int, cluster: int = 8) -> int:
    """Shared memory of one block of a cluster of `cluster` blocks
    (csrc/sinkhorn_em.cu:em_smem_floats): the slab of ceil(N / cluster)
    plan rows (of the padded K in a cluster of 8 to K = 256, else of
    4 ceil(K / 4) floats), six floats a row (rounded up to a multiple of 4),
    and column vectors of the padded K: the nodes (4), the 4 warps' and two
    alternating block column sums, the M-step sums (4; to K = 256 only,
    above it they share the warps' sums' space) and the column factors."""
    kp = padded_k(K)
    wide = lanes_per_row(K) > 8
    ks = kp if cluster == 8 and not wide else 4 * -(-K // 4)
    rows = -(-N // cluster)
    vectors = 11 if wide else 15
    return 4 * (rows * ks + -(-6 * rows // 4) * 4 + vectors * kp)


def cluster_size(N: int, K: int) -> int | None:
    """The blocks a cloud of N points and K clusters takes: 8 where their
    slabs of the plan fit shared memory, else 16 (a non-portable cluster
    size); None where neither holds it or K > 1024."""
    if not (1 <= K <= KERNEL_MAX_K and N >= 1):
        return None
    return next((c for c in CLUSTERS if smem_bytes(N, K, c) <= SMEM_BYTES), None)


def kernel_takes(N: int, K: int) -> bool:
    """Whether the kernel takes clouds of N points and K clusters: K <= 1024
    and a block's slab of the plan beside its buffers in the shared memory
    of a cluster of 8 or 16 blocks."""
    return cluster_size(N, K) is not None


def _marginal_q(K: int):
    """(q, log q) of the uniform column marginal as float32 values."""
    q = np.float32(1.0 / K + 1e-8)
    return float(q), float(np.log(q))


def sinkhorn_em_reference(xyz: torch.Tensor, o_norm: torch.Tensor,
                          nodes0: torch.Tensor, iters: int = 10,
                          sk_iters: int = 10, tau: float = 1.0,
                          eps: float = 1e-2):
    """Plain PyTorch version of the kernel: (B,N,3), (B,N), (B,K,3) ->
    (gamma (B,N,K), pi (B,K), nodes (B,K,3)), all float32."""
    xyz, nodes = xyz.float(), nodes0.float()
    B, N, _ = xyz.shape
    K = nodes.shape[1]
    p_t = (o_norm.float() + 1e-8).unsqueeze(-1)            # (B, N, 1)
    log_p = p_t.log()
    q_t, log_q = _marginal_q(K)
    gamma = xyz.new_ones(B, N, K)
    pi = xyz.new_full((B, K), 1.0 / K)
    for _ in range(iters):
        cost = square_distance3(xyz, nodes).sqrt() / tau
        lk = -cost / eps
        m = lk.amax(dim=-1, keepdim=True)
        lse = m + (lk - m).exp().sum(-1, keepdim=True).log()
        u = eps * (log_p - lse)                            # (B, N, 1)
        s = ((-cost + u) / eps).exp().sum(1, keepdim=True)
        v = eps * (log_q - (s + 1e-38).log())              # (B, 1, K)
        P = ((-cost + u + v) / eps).exp()
        for _ in range(1, sk_iters):
            P = P * (p_t / P.sum(-1, keepdim=True).clamp_min(1e-38))
            P = P * (q_t / P.sum(1, keepdim=True).clamp_min(1e-38))
        gamma = torch.where(torch.isfinite(P), P, torch.zeros_like(P))
        gamma = gamma / gamma.sum(-1, keepdim=True).clamp_min(1e-3)
        pi = gamma.sum(1) / N
        npi = pi * N + 1e-5
        nodes = matmul32(gamma.transpose(1, 2), xyz) / npi.unsqueeze(-1)
    return gamma, pi, nodes


def _sinkhorn_em_cuda(xyz, o_norm, nodes0, iters, sk_iters, tau, eps):
    B, N, _ = xyz.shape
    K = nodes0.shape[1]
    if not kernel_takes(N, K) or iters < 1 or sk_iters < 1:
        raise ValueError(f"sinkhorn_em kernel takes K <= {KERNEL_MAX_K} with "
                         f"the plan of a cloud in the shared memory of a "
                         f"cluster of {CLUSTERS[-1]} blocks, and iters, "
                         f"sk_iters >= 1; got N={N}, K={K}, iters={iters}, "
                         f"sk_iters={sk_iters}")
    if o_norm.shape != (B, N) or nodes0.shape != (B, K, 3):
        raise ValueError("sinkhorn_em kernel: o_norm must be (B, N) and "
                         "nodes0 (B, K, 3)")
    xyz = xyz.float().contiguous()
    o_norm = o_norm.float().contiguous()
    nodes0 = nodes0.float().contiguous()
    gamma = torch.empty(B, N, K, dtype=torch.float32, device=xyz.device)
    pi = torch.empty(B, K, dtype=torch.float32, device=xyz.device)
    nodes = torch.empty(B, K, 3, dtype=torch.float32, device=xyz.device)
    q_t, log_q = _marginal_q(K)
    lib = dispatch.load_kernel("sinkhorn_em")
    fn = lib.sinkhorn_em_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    code = fn(*[ctypes.c_void_p(t.data_ptr())
                for t in (xyz, o_norm, nodes0, gamma, pi, nodes)],
              B, N, K, cluster_size(N, K), iters, sk_iters, tau, eps, q_t, log_q,
              ctypes.c_void_p(dispatch.current_stream(xyz)))
    dispatch.check_launch(code, "sinkhorn_em")
    dispatch.launch_counts["sinkhorn_em"] += 1
    return gamma, pi, nodes


def max_clusters(N: int, K: int) -> int:
    """How many clouds of (N, K) the card can run at once (one cluster of
    `cluster_size(N, K)` blocks each), by the occupancy calculator
    (cudaOccupancyMaxActiveClusters), not measured; a launch of more clouds
    runs in more than one wave, and 0 means the card cannot run it."""
    out = ctypes.c_int(0)
    fn = dispatch.load_kernel("sinkhorn_em").sinkhorn_em_max_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    dispatch.check_launch(fn(N, K, cluster_size(N, K), ctypes.byref(out)),
                          "sinkhorn_em_max_clusters")
    return out.value


def sinkhorn_em(xyz: torch.Tensor, o_norm: torch.Tensor, nodes0: torch.Tensor,
                iters: int = 10, sk_iters: int = 10, tau: float = 1.0,
                eps: float = 1e-2):
    """Fused EM: (B,N,3) xyz, (B,N) normalised marginal, (B,K,3) initial
    nodes -> (gamma (B,N,K), pi (B,K), nodes (B,K,3)). No gradient path.
    Launches the CUDA kernel for a CUDA tensor, the plain version for a CPU
    tensor."""
    if xyz.is_cuda:
        return _sinkhorn_em_cuda(xyz, o_norm, nodes0, iters, sk_iters,
                                 float(tau), float(eps))
    return sinkhorn_em_reference(xyz, o_norm, nodes0, iters, sk_iters,
                                 float(tau), float(eps))
