"""Log-domain Sinkhorn optimal transport with a fixed number of trips."""
from __future__ import annotations

import torch

from ogmm_tpu_torch.ops.common import l2_normalize, matmul32, square_distance
from ogmm_tpu_torch.parallel import comm


def log_boltzmann_kernel(cost, u, v, epsilon):
    """(-C + u 1^T + 1 v^T) / eps."""
    return (-cost + u.unsqueeze(-1) + v.unsqueeze(-2)) / epsilon


def _lse_rows_sharded(K: torch.Tensor, group) -> torch.Tensor:
    """logsumexp over the row axis (-2) of a row-sharded (B, n_local, M)
    matrix: the maximum over the group first, then the sum of the shifted
    exponentials over the group (the JAX package's pmax/psum pair)."""
    m = comm.pmax(K.amax(dim=-2), group)                  # (B, M)
    s = comm.psum(torch.exp(K - m.unsqueeze(-2)).sum(dim=-2), group)
    return s.log() + m


def sinkhorn(cost: torch.Tensor, p: torch.Tensor | None = None,
             q: torch.Tensor | None = None, epsilon: float = 1e-2,
             max_iter: int = 10, group=None):
    """Entropic OT plan between marginals p (B, N) and q (B, M) for a cost
    (B, N, M). Returns (gamma (B, N, M), mean OT loss scalar).

    With a `group` the row axis is sharded over it: cost and p hold this
    process's rows (p is needed: a uniform default cannot know the global
    N), q is the same on every process, the column update's logsumexp runs
    over the group (`_lse_rows_sharded`), gamma keeps the local rows and the
    loss is the global one."""
    B, N, M = cost.shape
    if p is None:
        if group is not None:
            raise ValueError("sinkhorn(group=...) needs an explicit row "
                             "marginal p: the uniform default cannot know "
                             "the global row count")
        p = cost.new_full((B, N), 1.0 / N)
    if q is None:
        q = cost.new_full((B, M), 1.0 / M)
    log_p = (p + 1e-8).log()
    log_q = (q + 1e-8).log()
    u = torch.zeros_like(p)
    v = torch.zeros_like(q)
    for _ in range(max_iter):
        K = log_boltzmann_kernel(cost, u, v, epsilon)
        u = epsilon * (log_p - torch.logsumexp(K, dim=-1)) + u
        Kt = log_boltzmann_kernel(cost, u, v, epsilon)
        lse_rows = (torch.logsumexp(Kt, dim=-2) if group is None
                    else _lse_rows_sharded(Kt, group))
        v = epsilon * (log_q - lse_rows) + v
    gamma = log_boltzmann_kernel(cost, u, v, epsilon).exp()
    loss = comm.psum((gamma * cost).sum(dim=(-2, -1)), group)
    return gamma, loss.mean()


def contrastsk(x: torch.Tensor, y: torch.Tensor, p: torch.Tensor | None = None,
               epsilon: float = 1e-3, max_iter: int = 30, dst: str = "eu"):
    """Sinkhorn correspondence between two point or feature sets (B, N, D)
    and (B, M, D): cost the squared distance (`dst='eu'`) or 2 - 2 cos.
    `p` weights the y axis (sinkhorn's column marginal), as in the original,
    whose `p` lands in that slot; rows stay uniform. Returns (gamma, loss)."""
    if dst == "eu":
        cost = square_distance(x, y)
    else:
        cost = 2.0 - 2.0 * matmul32(l2_normalize(x), l2_normalize(y).transpose(-1, -2))
    return sinkhorn(cost, p=None, q=p, epsilon=epsilon, max_iter=max_iter)
