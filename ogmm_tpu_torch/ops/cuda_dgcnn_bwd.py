"""Backward of the DGCNN edge stages 4..1 in training: the CUDA kernels'
wrappers and their plain versions.

The stages are z_i = h_{i-1} . W_i (pre-BatchNorm, (B, k, N, C_i) in the
compute dtype), y_i = BN(z_i) with batch statistics, h_i = ReLU(y_i) and the
tap max_k h_i. Given the cotangent of each tap (`dtap`, (B, N, C_i)) the
three functions compute, stage by stage from the last:

  bwd_reduce  the BatchNorm batch-statistic sums of the last stage,
              S = (sum dy, sum dy * zhat) (2, C) float32, where
              dy = ReLU-VJP(max-VJP(dtap)) with h recomputed from z
  bwd_stage   stage i in {4, 3, 2}: dh = max-VJP(dtap) + dz_{i+1} . W_{i+1}^T,
              dz_i = inv gamma (dy - S1/m - zhat S2/m), dW_i = h_{i-1}^T dz_i
              (h_{i-1} recomputed from z_{i-1}), and the sums S_{i-1} of the
              stage below -> (dz_i, dW_i, S_{i-1})
  bwd_edge    stage 1: dz_1 as above, dW_1 = e^T dz_1, de = dz_1 . W_1^T in
              float32, dq = sum_k (de[3:] - de[:3]) and the neighbour
              scatter dscat[idx] += de[:3] -> (dW_1, dq, dscat); dx = dq + dscat

Here m = B k N. The arguments and outputs are those of the JAX package's
kernels (`ogmm_tpu/ops/pallas_dgcnn_train.py:bwd_reduce_pallas`,
`bwd_stage_pallas`, `bwd_edge_pallas`), less the tile and dtype arguments:
the compute dtype is z's.

Rules kept from the JAX function: h is recomputed from z in the compute
dtype exactly as the forward formed it (`bn_apply`), the ReLU cotangent at
exactly 0 is half the incoming one, the max over k sends a tie's cotangent
to the FIRST maximum, sums run in float32, and products take compute-dtype
operands with float32 accumulation, rounded to the compute dtype where the
result is (dz W^T) and kept in float32 where it is not (dW, de).

On a CUDA tensor each wrapper launches its kernel in `csrc/dgcnn_bwd.cu`
(1 <= k <= 32, the stage widths of the DGCNN, k <= N <= 1024 for the stage
and edge kernels, any N for the reduce: `kernels_take`; the graph kernel
takes k up to N, the JAX backward kernels too, and k > 32 is this port's
departure); on a CPU tensor it runs the plain version.
Outside the envelope a wrapper raises; it never runs the plain version on
the card. The source is compiled once a row class (`ROW_CLASSES`: a library
of class KP takes any k <= KP, `row_class`), whose tiles hold KP rows a
point and treat the rows past k as padding (zero-filled, excluded from every
argmax, sum and store). The reduce is one pass over a persistent grid for both
dtypes (`reduce_plan`): only each column's max-over-k argmax row adds to
its sums. The bf16 stage and edge kernels are one pass each on wgmma over a
persistent grid (`bwd_stage_plan`, `bwd_edge_plan`); the float32 stage and
edge kernels one pass each over such a grid with their products on the
tensor cores, each as three TF32 products (a_lo b_hi + a_hi b_lo + a_hi
b_hi), but for the edge kernel's two small products (de, dW_1), float32 FMAs
on the CUDA cores. dz_1 never goes to device memory. Both edge routes end
with the neighbour scatter, a block for each range of `SCATTER_POINTS`
points of a cloud (`scatter_plan`).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.cuda_dgcnn import KERNEL_MAX_N

EPS = 1e-5
# the compiled row classes (rows a point of a tile): a launch of class KP
# takes any graph of k <= KP neighbours, so the kernels k <= the largest
ROW_CLASSES = dispatch.BWD_ROW_CLASSES
KERNEL_MAX_K = max(ROW_CLASSES)
# (C, C_in, C_next) of the stages the stage kernel is compiled for; the
# reduce kernel takes any C of them, the edge kernel (64, 6, 64)
KERNEL_STAGES = ((256, 128, 0), (128, 64, 256), (64, 64, 128))
KERNEL_EDGE = (64, 6, 64)
SMEM_LIMIT = 232_448  # shared memory a block may use on an H100

# the bf16 stage and both edge kernels' plan (csrc/dgcnn_bwd.cu:
# stage_wgmma_kernel, edge_wgmma_kernel, edge_tf32_kernel): tiles of
# `tile_points(k)` points, a persistent grid of at most STAGE_BLOCKS blocks
# of STAGE_THREADS threads; the float32 stage kernel's (stage_tf32_kernel):
# tiles of `f32_tile_points(k)` points, STAGE_WARPS warps a block (the
# float32 edge kernel's too)
STAGE_BLOCKS, STAGE_THREADS = 132, 512
STAGE_WARPS = 16
MAX_TILE_ROWS = 80      # stage 4's bf16 buffers: a tile's rows, at most
# the scatter (csrc/dgcnn_bwd.cu:scatter_kernel): points and warps of a block
SCATTER_POINTS, SCATTER_WARPS = 256, 16
# the float32 stage kernel's weight-gradient chains: tiles a block's
# accumulators take before they are added to its partial (DW_FLUSH)
DW_FLUSH_TILES = 96
# the reduce (csrc/dgcnn_bwd.cu:reduce_kernel): threads of a block, adjacent
# channels a thread
REDUCE_THREADS, REDUCE_CHANNELS = 512, 8


# ----------------------------------------------------------- shared algebra

def bn_apply(z, mean, var, gamma, beta):
    """Normalise in the compute dtype from float32 statistics, rounding
    after the subtract, the multiply and the add."""
    dt = z.dtype
    inv = torch.rsqrt(var + EPS)
    return (z - mean.to(dt)) * (inv * gamma).to(dt) + beta.to(dt)


def relu_vjp(g, y):
    """Cotangent of max(y, 0): g where y > 0, g / 2 where y == 0."""
    return torch.where(y > 0, g, torch.where(y == 0, 0.5 * g,
                                             torch.zeros_like(g)))


def max_vjp(dtap, h):
    """Cotangent of h.amax(dim=1) through the first maximum (integer argmax
    one-hot): (B, N, C) cotangent onto (B, k, N, C)."""
    am = h.argmax(dim=1, keepdim=True)
    return torch.zeros_like(h).scatter_(1, am, dtap.unsqueeze(1))


def mm32(a, b):
    """Product of compute-dtype operands with a float32 result."""
    return torch.matmul(a.float(), b.float())


def _zhat(z, mean, var):
    return (z.float() - mean) * torch.rsqrt(var + EPS)


def bn_sums(dy, z, mean, var):
    """(sum dy, sum dy * zhat) over every axis but the last: (2, C) float32,
    the gradients of BatchNorm's bias and scale."""
    axes = tuple(range(z.dim() - 1))
    dy32 = dy.float()
    return torch.stack([dy32.sum(axes), (dy32 * _zhat(z, mean, var)).sum(axes)])


def bn_dz(dy, z, mean, var, gamma, s12):
    """BatchNorm (batch statistics) backward from the finished sums:
    dz = inv gamma (dy - S1/m - zhat S2/m), in the compute dtype."""
    m = z[..., 0].numel()
    inv = torch.rsqrt(var + EPS)
    dz = (inv * gamma) * (dy.float() - s12[0] / m
                          - _zhat(z, mean, var) * (s12[1] / m))
    return dz.to(dy.dtype)


def edge_vjp(de, idx):
    """Cotangent of the edge rows (x[idx] - x, x) onto x, from de (B, k, N,
    6) float32: (dq, dscat) (B, N, 3) float32, the centre half summed over k
    and the neighbour half scattered onto its points; dx = dq + dscat."""
    dq = (de[..., 3:] - de[..., :3]).sum(dim=1)
    B, k, N, _ = de.shape
    rows = (idx.long().transpose(1, 2)
            + N * torch.arange(B, device=de.device).view(B, 1, 1))
    dscat = torch.zeros(B * N, 3, dtype=torch.float32, device=de.device)
    dscat.index_add_(0, rows.reshape(-1), de[..., :3].reshape(-1, 3))
    return dq, dscat.view(B, N, 3)


def _stage_dy(z, dtap, mean, var, gamma, beta, extra=None):
    """dy of one stage: h recomputed from z, max-VJP of the tap cotangent,
    plus the cotangent from the stage above, through the ReLU."""
    y = bn_apply(z, mean, var, gamma, beta)
    dh = max_vjp(dtap, torch.relu(y))
    if extra is not None:
        dh = dh + extra
    return relu_vjp(dh, y)


# ------------------------------------------------------------ plain versions

@torch.no_grad()
def bwd_reduce_reference(z, dtap, mean, var, gamma, beta):
    """Plain version of the reduce kernel: (2, C) float32 sums of the last
    stage."""
    return bn_sums(_stage_dy(z, dtap, mean, var, gamma, beta), z, mean, var)


@torch.no_grad()
def bwd_stage_reference(z, dtap, mean, var, gamma, beta, s12, w_i,
                        zp, meanp, varp, gammap, betap, dtapp,
                        dznext=None, wnext=None):
    """Plain version of the stage kernel: (dz_i (B, k, N, C) compute dtype,
    dW_i (C_in, C) float32, S_{i-1} (2, C_in) float32)."""
    dt = z.dtype
    extra = (None if dznext is None
             else torch.matmul(dznext, wnext.to(dt).t()))
    dy = _stage_dy(z, dtap, mean, var, gamma, beta, extra)
    dz = bn_dz(dy, z, mean, var, gamma, s12)
    yp = bn_apply(zp, meanp, varp, gammap, betap)
    hp = torch.relu(yp)
    dw = mm32(hp.flatten(0, 2).t(), dz.flatten(0, 2))
    dhp = max_vjp(dtapp, hp) + torch.matmul(dz, w_i.to(dt).t())
    return dz, dw, bn_sums(relu_vjp(dhp, yp), zp, meanp, varp)


@torch.no_grad()
def bwd_edge_reference(z1, dtap1, mean1, var1, gamma1, beta1, s12,
                       dz2, w2, e, w1, idx):
    """Plain version of the edge kernel: (dW_1 (6, C1) float32, dq (B, N, 3)
    float32, dscat (B, N, 3) float32)."""
    dt = z1.dtype
    extra = torch.matmul(dz2, w2.to(dt).t())
    dy = _stage_dy(z1, dtap1, mean1, var1, gamma1, beta1, extra)
    dz = bn_dz(dy, z1, mean1, var1, gamma1, s12)
    dw = mm32(e.flatten(0, 2).t(), dz.flatten(0, 2))
    de = mm32(dz, w1.to(dt).t())                          # (B, k, N, 6)
    return (dw, *edge_vjp(de, idx))


# ----------------------------------------------------------------- kernels

def _bn_pack(mean, var, gamma, beta, dt):
    """(6, C) float32 per-channel constants, formed by the same PyTorch
    operations as `bn_apply` and `bn_dz` so that the kernel's recomputed h
    is the plain version's bit for bit: mean, inv gamma and beta in the
    compute dtype, then mean, inv and inv gamma in float32: the float32
    stage kernel reads them. (The reduce, the bf16 stage kernel and both
    edge kernels form the same values themselves from the statistics,
    `csrc/dgcnn_bwd.cu:bn_stats`.)"""
    mean, var, gamma, beta = (a.detach().float() for a in (mean, var, gamma, beta))
    inv = torch.rsqrt(var + EPS)
    ig = inv * gamma
    return torch.stack([mean.to(dt).float(), ig.to(dt).float(),
                        beta.to(dt).float(), mean, inv, ig]).contiguous()


def kernels_take(k: int, n: int) -> bool:
    """Whether the stage and edge kernels take a graph of k neighbours over
    clouds of n points: 1 <= k <= KERNEL_MAX_K (the row classes) and
    k <= n <= KERNEL_MAX_N."""
    return 1 <= k <= KERNEL_MAX_K and k <= n <= KERNEL_MAX_N


def _check(name, z, dtap, *others, any_n=False):
    """(B, N, k, C) of a call, refused unless the kernels take it
    (`kernels_take`), or for the reduce any N >= 1 at those k."""
    if z.dim() != 4:
        raise ValueError(f"{name} kernel takes z of shape (B, k, N, C); got "
                         f"{tuple(z.shape)}")
    B, k, N, C = z.shape
    if not (1 <= k <= KERNEL_MAX_K and N >= 1 if any_n else kernels_take(k, N)):
        raise ValueError(f"{name} kernel takes z of shape (B, k, N, C) with "
                         f"1 <= k <= {KERNEL_MAX_K}"
                         + (" and N >= 1" if any_n else " and k <= N <= 1024")
                         + f"; got {tuple(z.shape)}")
    if z.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name} kernel: dtype {z.dtype} not supported")
    if tuple(dtap.shape) != (B, N, C):
        raise ValueError(f"{name} kernel: dtap must be {(B, N, C)}, got "
                         f"{tuple(dtap.shape)}")
    for t in (dtap, *others):
        if t.device != z.device:
            raise ValueError(f"{name} kernel: every input must be on {z.device}")
    return B, N, k, C


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr() if t is not None else 0)


def _fn(name, k, n_ptrs, n_ints):
    """The launcher `name` of the library of k's row class."""
    return dispatch.kernel_fn(library(k), f"{name}_launch",
                              (ctypes.c_void_p,) * n_ptrs + (ctypes.c_int,) * n_ints
                              + (ctypes.c_void_p,))


# ------------------------------------------------------------------- plans

def row_class(k: int) -> int:
    """The rows a point of the smallest compiled class that takes a graph of
    k neighbours (`ROW_CLASSES`; csrc/dgcnn_bwd.cu: KP)."""
    fits = [kp for kp in ROW_CLASSES if kp >= k]
    if k < 1 or not fits:
        raise ValueError(f"the backward kernels take 1 <= k <= {max(ROW_CLASSES)}; "
                         f"got k={k}")
    return fits[0]


def library(k: int) -> str:
    """The kernel library (`dispatch.VARIANTS`) of k's row class."""
    return f"dgcnn_bwd_k{row_class(k)}"


def tile_points(k: int) -> int:
    """Points of a tile of the bf16 stage and both edge kernels (WTN): 8, 4
    or 2 as the class's rows a point grow, so that a tile keeps at most
    MAX_TILE_ROWS rows, a multiple of 16 (wgmma's k when the rows are the
    weight gradient's depth)."""
    kp = row_class(k)
    return 8 if kp <= 8 else 4 if kp <= 20 else 2


def f32_tile_points(k: int) -> int:
    """Points of a tile of the float32 stage kernel (FTN): two, one above
    k = 20 (two points of 24 or 32 rows outgrow stage 3's buffers and a
    column's rows a lane's registers)."""
    return 2 if row_class(k) <= 20 else 1


def column_lanes(k: int, C: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """Lanes a (point, channel) column of C channels in the element work
    (each lane takes every lanes-th row of the class): bf16 stage and edge
    kernels at most 8 / tile_points (a lane's rows then lie 8 or 4 tile rows
    apart) and few enough that a thread keeps one channel over its passes;
    the float32 stage kernel one column a thread; the float32 edge kernel
    8 / tile_points."""
    if dtype == torch.float32:
        return STAGE_THREADS // (f32_tile_points(k) * C)
    return min(8 // tile_points(k), STAGE_THREADS // C)


def tile_rows(k: int, dtype: torch.dtype = torch.bfloat16, edge: bool = False) -> int:
    """Rows of a tile: the class's rows a point times its points."""
    f32_stage = dtype == torch.float32 and not edge
    return row_class(k) * (f32_tile_points(k) if f32_stage else tile_points(k))


def row_split(M: int, k: int, mpw: int = 1) -> dict:
    """How the float32 stage kernel's row products (`rows_tf32`) of M output
    channels share the STAGE_WARPS warps (`RowSplit`): each warp takes `mpw`
    m-tiles of 16 channels (two in stage 3's extra product, `F32Plan::XPW`)
    and one of `k_slices` slices of the depth; the slices' partials
    (k_slices, rows, M + 4) float32 lie in shared memory."""
    groups = M // (16 * mpw)
    k_slices = STAGE_WARPS // groups
    return {"m_tiles_a_warp": mpw, "groups": groups, "k_slices": k_slices,
            "floats": k_slices * tile_rows(k, torch.float32) * (M + 4)}


def bwd_stage_plan(B: int, N: int, k: int, C: int, cin: int, cn: int,
                   dtype: torch.dtype = torch.bfloat16) -> dict:
    """The stage kernel's launch for `dtype` as a pure function of the
    shapes, mirroring `csrc/dgcnn_bwd.cu`: its tiles (of one cloud each, the
    class's rows a point), the blocks of its persistent grid
    (`stage_shares`), its dynamic shared memory and its float32 partials,
    one per block: dW_i (G, C_in, C) and S_{i-1} (G, 2, C_in).
    bf16 (`StagePlan`): tiles of `tile_points(k)` points; two buffers of a
    tile's z_i, z_{i-1} and dz_{i+1} panels, the resident W_i and W_{i+1},
    the last stage's scratch tile, 1024 bytes of alignment.
    float32 (`F32Plan`): tiles of `f32_tile_points(k)` points; two buffers
    of a tile's z_i and z_{i-1} rows (padded by 4 floats) and its points'
    tap cotangents, one of its dz_{i+1} rows, and the larger row product's
    K-slice partials (`row_split`); also the weight
    gradient's split over the warps: `dw_tiles_a_warp` (m-tiles of 16 rows
    of C_in, 8-column tiles of C) a warp, and `dw_flush` the tiles a block's
    accumulators take before they are added to its partial."""
    f32 = dtype == torch.float32
    tn = f32_tile_points(k) if f32 else tile_points(k)
    rows = tile_rows(k, dtype)
    tiles = B * -(-N // tn)
    blocks = min(STAGE_BLOCKS, tiles)
    plan = {"tiles": tiles, "blocks": blocks, "points_a_tile": tn,
            "row_class": row_class(k), "rows_a_tile": rows,
            "part_w": (blocks, cin, C), "part_s": (blocks, 2, cin)}
    if f32:
        buf = rows * ((C + 4) + (cin + 4)) + tn * (C + cin)
        dzn = rows * (cn + 4) if cn else 0
        xpw = 2 if C == 128 else 1
        e = max(row_split(cin, k)["floats"], row_split(C, k, xpw)["floats"] if cn else 0)
        plan.update(smem=4 * (2 * buf + dzn + e), threads=32 * STAGE_WARPS,
                    extra_m_tiles_a_warp=xpw, dw_flush=DW_FLUSH_TILES,
                    dw_tiles_a_warp=(2, (C // 8) * (cin // 32) // STAGE_WARPS))
        return plan
    panel = rows * 128
    buf = (C + cin + cn) // 64 * panel
    e = 0 if cn else -(-(rows * (cin + 8) * 2) // 1024) * 1024
    plan.update(smem=2 * buf + 2 * cin * C + 2 * C * cn + e + 1024,
                threads=STAGE_THREADS, row_product_n=rows // 2)
    return plan


def stage_shares(tiles: int, blocks: int) -> list:
    """The tiles block i of the stage or edge kernel walks, in order:
    [i T / G, (i + 1) T / G)."""
    return [(i * tiles // blocks, (i + 1) * tiles // blocks)
            for i in range(blocks)]


def bwd_edge_plan(B: int, N: int, k: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The edge kernel's launch for `dtype` as a pure function of the
    shapes, mirroring `csrc/dgcnn_bwd.cu`: its tiles of `tile_points(k)`
    points and persistent grid (as the bf16 stage kernel's, `stage_shares`),
    its dynamic shared memory and its float32 dW_1 partials, one per block.
    bf16 (`EdgePlan`): two buffers of a tile's z_1 and dz_2 panels, the
    resident W_2 and W_1 as 64-row panels, the e panel, the extra
    cotangent's scratch tile of rows of 72 bf16, de of the tile in float32,
    1024 bytes of alignment.
    float32 (`EdgeF32Plan`, STAGE_WARPS warps): two buffers of a tile's z_1
    and dz_2 as 32-channel panels (TMA's 128-byte swizzle) and its points'
    tap cotangents (a buffer rounded up to 1024 bytes), the extra
    cotangent's two K halves (`extra_k_slices`: warp w holds W_2's m-tile
    w % 4 over the K half (w / 4) % 2 in registers; rows of C + 4 floats),
    the e rows and de (8 floats a row), W_1 (6 rows of C + 4), 1024 bytes of
    alignment; the weight gradient in `dw_parts` parts of a tile's rows
    (thread i: channel i % C, the rows [R p, R p + R) of part p = i // C,
    R = rows / dw_parts), added in order at the end."""
    tn = tile_points(k)
    tiles = B * -(-N // tn)
    blocks = min(STAGE_BLOCKS, tiles)
    rows = tile_rows(k, dtype, edge=True)
    C = KERNEL_EDGE[0]
    plan = {"tiles": tiles, "blocks": blocks, "points_a_tile": tn,
            "row_class": row_class(k), "rows_a_tile": rows,
            "part_w": (blocks, 6, C)}
    if dtype == torch.float32:
        ld = C + 4
        buf = -(-(4 * rows * 32 + tn * C) // 256) * 256
        plan.update(smem=4 * (2 * buf + 2 * rows * ld + 2 * rows * 8 + 6 * ld) + 1024,
                    threads=32 * STAGE_WARPS, extra_k_slices=2,
                    dw_parts=32 * STAGE_WARPS // C)
        return plan
    panel = rows * 128
    plan.update(smem=2 * 2 * panel + 2 * 64 * 64 * 2 + panel + rows * 72 * 2
                + rows * 8 * 4 + 1024, threads=STAGE_THREADS, row_product_n=rows // 2)
    return plan


def scatter_plan(B: int, N: int, k: int) -> dict:
    """The neighbour scatter's launch, mirroring `csrc/dgcnn_bwd.cu:
    launch_scatter`: block (r, b) owns the points [r P, min((r + 1) P, N))
    of cloud b (P = SCATTER_POINTS); its dynamic shared memory holds each
    warp's count of each point's rows, the points' offsets and totals, the
    warps' totals and the lists (at most k N rows): 149.6 KB at k = 32,
    N = 1024, within a block's SMEM_LIMIT."""
    per = SCATTER_POINTS
    grid = (-(-N // per), B)
    ranges = [(b, r * per, min((r + 1) * per, N))
              for b in range(B) for r in range(grid[0])]
    smem = 4 * ((SCATTER_WARPS + 2) * per + SCATTER_WARPS + k * N)
    assert smem <= SMEM_LIMIT, f"the scatter's lists at k={k}, N={N} outgrow shared memory"
    return {"grid": grid, "ranges": ranges, "smem": smem}


@functools.lru_cache(maxsize=None)
def reduce_plan(B: int, N: int, C: int, n_sm: int) -> dict:
    """The reduce kernel's launch, mirroring `csrc/dgcnn_bwd.cu:
    reduce_kernel`: a thread owns REDUCE_CHANNELS adjacent channels of one
    point, a warp 256 channels (`points_a_warp` points at once); a
    persistent grid of at most one block an SM, no more blocks than the
    B N points give each warp one round; one float32 partial of (2, C) a
    block."""
    warps = REDUCE_THREADS // 32
    ppw = 32 * REDUCE_CHANNELS // C
    blocks = max(1, min(n_sm, -(-(B * N) // (warps * ppw))))
    return {"blocks": blocks, "threads": REDUCE_THREADS, "points_a_warp": ppw,
            "part": (blocks, 2, C)}


def reduce_order(B: int, N: int, C: int, blocks: int) -> list:
    """The points p = b N + n each block of the reduce kernel takes, in the
    order its warps' rounds take them: block i owns [i P / G, (i + 1) P / G)
    of the P = B N points, and round r of warp w takes the points_a_warp
    points from p0 + (r W + w) points_a_warp."""
    P, warps = B * N, REDUCE_THREADS // 32
    ppw = 32 * REDUCE_CHANNELS // C
    order = []
    for i in range(blocks):
        p0, p1 = P * i // blocks, P * (i + 1) // blocks
        order.append([p for r in range(p0, p1, warps * ppw)
                      for w in range(warps) for q in range(ppw)
                      if (p := r + w * ppw + q) < p1])
    return order


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# one zeroed unsigned a (device, stream): the reduce's last block takes its
# ticket from it and leaves it zeroed for the next launch on that stream
_tickets: dict = {}


def _ticket(device: torch.device, stream: int) -> torch.Tensor:
    t = _tickets.get((device.index, stream))
    if t is None:
        t = _tickets[(device.index, stream)] = torch.zeros(
            1, dtype=torch.int32, device=device)
    return t


def _rows_in_place(t):
    """Whether a (B, N, C) tensor's points lie one row stride apart with
    dense, 16-byte aligned rows: a slice along C of a contiguous tensor."""
    return (t.stride(2) == 1 and t.stride(0) == t.shape[1] * t.stride(1)
            and t.stride(1) * t.element_size() % 16 == 0
            and t.data_ptr() % 16 == 0)


def _bwd_reduce_cuda(z, dtap, mean, var, gamma, beta):
    B, N, k, C = _check("bwd_reduce", z, dtap, mean, any_n=True)
    if C not in {s[0] for s in KERNEL_STAGES}:
        raise ValueError(f"bwd_reduce kernel takes C in 64/128/256; got {C}")
    if dtap.dtype != z.dtype:
        raise ValueError(f"bwd_reduce kernel: dtap must be {z.dtype}, got {dtap.dtype}")
    dt, dev = z.dtype, z.device
    plan = reduce_plan(B, N, C, _n_sm(z.get_device()))
    part = torch.empty(plan["part"], dtype=torch.float32, device=dev)
    s = torch.empty(2, C, dtype=torch.float32, device=dev)
    stream = dispatch.current_stream(z)
    # the kernel forms the BN constants from the statistics itself, and reads
    # dtap in place where it is a slice of the concatenated taps' cotangent
    stats = [a.detach().float().contiguous() for a in (mean, var, gamma, beta)]
    tstride = dtap.stride(1) if _rows_in_place(dtap) else C
    if tstride == C:
        dtap = dtap.contiguous()
    code = _fn("bwd_reduce", k, 9, 7)(
        *map(_ptr, (z.contiguous(), dtap, *stats, part, _ticket(dev, stream), s)),
        B, N, k, C, tstride, int(dt == torch.bfloat16), plan["blocks"],
        ctypes.c_void_p(stream))
    dispatch.check_launch(code, "bwd_reduce")
    dispatch.launch_counts["bwd_reduce"] += 1
    return s


def _bwd_stage_cuda(z, dtap, mean, var, gamma, beta, s12, w_i, zp, meanp,
                    varp, gammap, betap, dtapp, dznext, wnext):
    B, N, k, C = _check("bwd_stage", z, dtap, zp, dtapp, s12, w_i)
    cin = zp.shape[-1]
    cn = 0 if dznext is None else dznext.shape[-1]
    if (C, cin, cn) not in KERNEL_STAGES:
        raise ValueError(f"bwd_stage kernel takes (C, C_in, C_next) in "
                         f"{KERNEL_STAGES}; got {(C, cin, cn)}")
    if (tuple(zp.shape) != (B, k, N, cin) or zp.dtype != z.dtype
            or tuple(dtapp.shape) != (B, N, cin)
            or tuple(w_i.shape) != (cin, C)
            or (cn and (tuple(dznext.shape) != (B, k, N, cn)
                        or dznext.dtype != z.dtype
                        or tuple(wnext.shape) != (C, cn)))):
        raise ValueError("bwd_stage kernel: inputs of inconsistent shapes "
                         "or dtypes")
    dt, dev = z.dtype, z.device
    s12 = s12.detach().float().contiguous()
    dz = torch.empty_like(z, memory_format=torch.contiguous_format)
    sp = torch.empty(2, cin, dtype=torch.float32, device=dev)
    dw = torch.empty(cin, C, dtype=torch.float32, device=dev)
    stream = ctypes.c_void_p(dispatch.current_stream(z))
    # one pass: one partial of each a block
    blocks = bwd_stage_plan(B, N, k, C, cin, cn, dt)["blocks"]
    part_s = torch.empty(blocks, 2, cin, dtype=torch.float32, device=dev)
    part_w = torch.empty(blocks, cin, C, dtype=torch.float32, device=dev)
    f32 = lambda a: None if a is None else a.detach().float().contiguous()
    if dt == torch.bfloat16:
        # the kernel forms the BN constants from the statistics and rounds
        # the float32 weights itself
        stats = [f32(a) for a in (mean, var, gamma, beta, meanp, varp, gammap,
                                  betap)]
        ins = (z.contiguous(), dtap.contiguous(), *stats, s12,
               None if not cn else dznext.contiguous(), f32(wnext), f32(w_i),
               zp.contiguous(), dtapp.contiguous())
        code = _fn("bwd_stage_bf16", k, 21, 7)(
            *map(_ptr, ins + (dz, part_s, sp, part_w, dw)), B, N, k, C, cin, cn,
            blocks, stream)
    else:
        # the BN constants packed by the plain version's operations; the
        # weights as they are (the products read them row by row)
        ins = (z.contiguous(), dtap.contiguous(),
               _bn_pack(mean, var, gamma, beta, dt), s12,
               None if not cn else dznext.contiguous(), f32(wnext), f32(w_i),
               zp.contiguous(), dtapp.contiguous(),
               _bn_pack(meanp, varp, gammap, betap, dt))
        code = _fn("bwd_stage", k, 15, 7)(
            *map(_ptr, ins + (dz, part_s, sp, part_w, dw)), B, N, k, C, cin, cn,
            blocks, stream)
    dispatch.check_launch(code, "bwd_stage")
    dispatch.launch_counts["bwd_stage"] += 1
    return dz, dw, sp


def _bwd_edge_cuda(z1, dtap1, mean1, var1, gamma1, beta1, s12, dz2, w2, e,
                   w1, idx):
    B, N, k, C = _check("bwd_edge", z1, dtap1, dz2, e, idx, s12)
    if ((C, w1.shape[0], dz2.shape[-1]) != KERNEL_EDGE
            or tuple(dz2.shape) != (B, k, N, C) or dz2.dtype != z1.dtype
            or tuple(e.shape) != (B, k, N, 6) or e.dtype != z1.dtype
            or tuple(idx.shape) != (B, N, k)
            or tuple(w1.shape) != (6, C) or tuple(w2.shape) != (C, C)):
        raise ValueError(f"bwd_edge kernel takes (C1, 6, C2) = {KERNEL_EDGE} "
                         "and inputs of consistent shapes and dtypes")
    dt, dev = z1.dtype, z1.device
    dneigh = torch.empty(B, k, N, 3, dtype=torch.float32, device=dev)
    dw = torch.empty(6, C, dtype=torch.float32, device=dev)
    dq = torch.empty(B, N, 3, dtype=torch.float32, device=dev)
    dscat = torch.empty(B, N, 3, dtype=torch.float32, device=dev)
    s12 = s12.detach().float().contiguous()
    # the scatter reads the indices as (B, k, N): its rows s = j N + n in
    # memory order
    idx = idx.transpose(1, 2).to(torch.int32).contiguous()
    stream = ctypes.c_void_p(dispatch.current_stream(z1))
    # one pass for either dtype, dz_1 kept in shared memory: one dW_1 partial
    # a block; the kernel forms the BN constants from the statistics (and
    # for bf16 rounds the float32 weights) itself
    blocks = bwd_edge_plan(B, N, k, dt)["blocks"]
    part_w = torch.empty(blocks, 6, C, dtype=torch.float32, device=dev)
    f32 = lambda a: a.detach().float().contiguous()
    ins = (z1.contiguous(), dtap1.contiguous(),
           *[f32(a) for a in (mean1, var1, gamma1, beta1)], s12,
           dz2.contiguous(), f32(w2), e.contiguous(), f32(w1), idx)
    code = _fn("bwd_edge_bf16" if dt == torch.bfloat16 else "bwd_edge", k, 17, 4)(
        *map(_ptr, ins + (dneigh, part_w, dw, dq, dscat)), B, N, k, blocks, stream)
    dispatch.check_launch(code, "bwd_edge")
    dispatch.launch_counts["bwd_edge"] += 1
    return dw, dq, dscat


# ----------------------------------------------------------------- wrappers

def bwd_reduce(z, dtap, mean, var, gamma, beta):
    """(2, C) float32 BatchNorm sums of the last edge stage. Launches the
    CUDA kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if z.is_cuda:
        return _bwd_reduce_cuda(z, dtap, mean, var, gamma, beta)
    return bwd_reduce_reference(z, dtap, mean, var, gamma, beta)


def bwd_stage(z, dtap, mean, var, gamma, beta, s12, w_i, zp, meanp, varp,
              gammap, betap, dtapp, dznext=None, wnext=None):
    """Backward of edge stage i: (dz_i, dW_i, S_{i-1}); `dznext`/`wnext`
    are absent for the last stage. Launches the CUDA kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if z.is_cuda:
        return _bwd_stage_cuda(z, dtap, mean, var, gamma, beta, s12, w_i, zp,
                               meanp, varp, gammap, betap, dtapp, dznext, wnext)
    return bwd_stage_reference(z, dtap, mean, var, gamma, beta, s12, w_i, zp,
                               meanp, varp, gammap, betap, dtapp, dznext, wnext)


def bwd_edge(z1, dtap1, mean1, var1, gamma1, beta1, s12, dz2, w2, e, w1, idx):
    """Backward of edge stage 1 and the edge features: (dW_1, dq, dscat),
    dx = dq + dscat. Launches the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if z1.is_cuda:
        return _bwd_edge_cuda(z1, dtap1, mean1, var1, gamma1, beta1, s12, dz2,
                              w2, e, w1, idx)
    return bwd_edge_reference(z1, dtap1, mean1, var1, gamma1, beta1, s12, dz2,
                              w2, e, w1, idx)
