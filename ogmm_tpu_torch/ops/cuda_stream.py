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
               with D a multiple of 32 (three TF32 products each); v
               (B, M, 1)

The launch plans of the 1-NN and projection kernels are pure functions of
shapes here (`nn1_stream_plan`, `wproject_plan`, `wproject_units`,
`wproject_key_tiles`, `wproject_smem_bytes`, `wproject_f32_smem_bytes`), so
that the CPU tests can hold them.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import STREAM_MAX_K
from ogmm_tpu_torch.ops.stream import (TILE_M, TILE_N, knn_stream_plain,
                                       nn1_stream_plain,
                                       wproject_stream_lse_plain)

WPROJECT_BF16_D = (64, 128, 256, 512)   # csrc/wproject.cu: instantiated widths
WPROJECT_F32_DC = 32                     # and the float32 kernel's chunk (FC)
WPROJECT_ROWS = 128      # query rows a unit, both forms (WQ)
WPROJECT_KEYS = 64       # keys a tile of the bf16 kernel (WK)
WPROJECT_F32_KEYS = 256  # and of the float32 kernel (FK)
WPROJECT_F32_STAGES = 2  # the float32 block's split chunks (FSTAGES)
WPROJECT_F32_RAW = 3     # and raw chunks in flight (FRAW)
NN1_SPLIT_BLOCKS = 2     # blocks an SM the 1-NN split aims at


def nn1_stream_plan(B: int, N: int, M: int, n_sm: int):
    """(chunks, tiles a chunk) of the 1-NN kernel: the grid is (query tiles
    of TILE_N, chunks, B), and chunk c searches the target tiles of TILE_M
    [c * per, min((c + 1) * per, n_m)). Where the query tiles alone fill
    the n_sm SMs the target stays whole (one chunk); otherwise it splits
    into chunks of whole tiles until about NN1_SPLIT_BLOCKS blocks an SM
    have work (the clustering's (2, 16, 35000): 69 chunks of one tile)."""
    n_qt, n_m = -(-N // TILE_N), -(-M // TILE_M)
    if B * n_qt >= n_sm:
        return 1, n_m
    want = min(n_m, -(-NN1_SPLIT_BLOCKS * n_sm // (B * n_qt)))
    per = -(-n_m // want)
    return -(-n_m // per), per


def wproject_smem_bytes(D: int) -> int:
    """Dynamic shared memory of a bf16 block (csrc/wproject.cu: WPlan): a
    ring of key tiles of WPROJECT_KEYS x D, 3 stages at D = 512, 6 at 256,
    8 below, and 1024 bytes to align the ring to the swizzle."""
    stages = 3 if D >= 512 else 6 if D >= 256 else 8
    return stages * WPROJECT_KEYS * D * 2 + 1024


def wproject_f32_smem_bytes(D: int) -> int:
    """Dynamic shared memory of a float32 block (csrc/wproject.cu: FSMEM),
    the same at every D: chunks of WPROJECT_F32_KEYS keys x 32 features in
    float32, a TF32 high and low plane for each split stage and one plane
    for each raw chunk in flight, and 1024 bytes to align them to the
    swizzle."""
    plane = WPROJECT_F32_KEYS * WPROJECT_F32_DC * 4
    return (2 * WPROJECT_F32_STAGES + WPROJECT_F32_RAW) * plane + 1024


def wproject_keys(dtype: torch.dtype) -> int:
    """Keys a tile of the kernel that takes q and k of this type."""
    return WPROJECT_KEYS if dtype == torch.bfloat16 else WPROJECT_F32_KEYS


def _wproject_pairs(B, N, M, keys=WPROJECT_KEYS):
    n_qt, n_kt = -(-N // WPROJECT_ROWS), -(-M // keys)
    return n_qt, n_kt, B * n_qt * n_kt


def wproject_units(B: int, N: int, M: int, blocks: int, keys: int = WPROJECT_KEYS):
    """The work units of a projection kernel's persistent grid, in launch
    order: block i takes the flattened (query tile, key tile) pairs
    [i T / blocks, (i + 1) T / blocks), split at query-tile boundaries. Each
    unit is (block, slot, tile, k0, k1): query tile `tile` (over B * n_qt,
    batch major) against logical key tiles [k0, k1) of `keys` (64 bf16, 256
    float32), its partials in slot `slot` of the block. The kernel's
    integer arithmetic, mirrored."""
    n_qt, n_kt, T = _wproject_pairs(B, N, M, keys)
    units = []
    for i in range(blocks):
        p, p1 = i * T // blocks, (i + 1) * T // blocks
        tile0 = p // n_kt
        while p < p1:
            tile, k0 = divmod(p, n_kt)
            k1 = min(n_kt, k0 + p1 - p)
            units.append((i, tile - tile0, tile, k0, k1))
            p += k1 - k0
    return units


def wproject_key_tiles(B: int, N: int, M: int, blocks: int,
                       keys: int = WPROJECT_F32_KEYS):
    """For each unit of `wproject_units`, the key tiles the float32 kernel
    reads, in order: logical tile k of query tile `tile` is (k + rot) mod
    n_kt, where rot = -(first pair of block i) mod n_kt and block i holds
    the tile's last pair. So every block reads key tile s mod n_kt at the
    s-th pair of its share (a unit finishing a tile that the block before
    began lags by that block's share mod n_kt), and the blocks sweep k
    together: the L2 holds the few tiles in use, not all of k. The merge
    takes a row's units in block order, as for bf16. The kernel's integer
    arithmetic (csrc/wproject.cu: rotation), mirrored."""
    n_qt, n_kt, T = _wproject_pairs(B, N, M, keys)
    order = []
    for _, _, tile, k0, k1 in wproject_units(B, N, M, blocks, keys):
        last = ((tile * n_kt + n_kt) * blocks - 1) // T   # block_of(last pair)
        rot = -(last * T // blocks) % n_kt
        order.append([(k + rot) % n_kt for k in range(k0, k1)])
    return order


@functools.lru_cache(maxsize=64)
def wproject_plan(B: int, N: int, M: int, n_sm: int, keys: int = WPROJECT_KEYS):
    """(blocks, slots) of a projection kernel with tiles of `keys`: one
    block an SM (or one a pair where there are fewer pairs), and the most
    units a block holds."""
    blocks = min(n_sm, _wproject_pairs(B, N, M, keys)[2])
    slots = max(u[1] for u in wproject_units(B, N, M, blocks, keys)) + 1
    return blocks, slots


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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


def _visits(visits, n, device):
    if visits is not None and (visits.dtype != torch.int32 or visits.numel() != n
                               or visits.device != device):
        raise ValueError(f"visits is {n} int32 counter{'s' if n > 1 else ''} "
                         f"on the points' device")
    return visits


def _knn_stream_cuda(src, tgt, k, diag_order, stretch, cull_lb, visits):
    B, N, M, src, tgt = _points(src, tgt, "knn_stream")
    if not knn_stream_takes(3, M, k):
        raise ValueError(f"knn_stream kernel takes 1 <= k <= "
                         f"min({STREAM_MAX_K}, M); got k={k}, M={M}")
    lb = _cull(cull_lb, B, N, M, src.device)
    visits = _visits(visits, 3, src.device)
    idx = torch.empty(B, N, k, dtype=torch.int64, device=src.device)
    fn = dispatch.load_kernel("knn_stream").knn_stream_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    code = fn(_ptr(src), _ptr(tgt), _ptr(lb), _ptr(idx), _ptr(visits), B, N, M,
              k, int(diag_order), int(stretch),
              ctypes.c_void_p(dispatch.current_stream(src)))
    dispatch.check_launch(code, "knn_stream")
    dispatch.launch_counts["knn_stream"] += 1
    return idx


def knn_stream(src: torch.Tensor, tgt: torch.Tensor, k: int,
               diag_order: bool = False, stretch: int = 1,
               cull_lb: torch.Tensor | None = None,
               visits: torch.Tensor | None = None) -> torch.Tensor:
    """kNN with the target streamed: (B, N, 3) x (B, M, 3) -> int64 (B, N,
    k), ascending distance, ties to the lowest index. `cull_lb` is a table
    of `ops.stream.pair_tile_bounds` for the kernel's tiles; it and the
    visiting order (`diag_order`, `stretch`) only decide what the kernel may
    skip, never the result. Launches the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. Carries no gradient. `visits`, three
    int32 on the card, gets added the (query tile, target tile) pairs the
    kernel searched, the most one block searched (as a maximum) and the
    (warp of 8 queries, 64-point sub-tile) pairs its warps searched; the
    plain version takes none."""
    if src.is_cuda:
        return _knn_stream_cuda(src, tgt, k, diag_order, stretch, cull_lb,
                                visits)
    if visits is not None:
        raise ValueError("visits counts the CUDA kernel's tiles; the plain "
                         "version on the CPU has none")
    return knn_stream_plain(src, tgt, k, cull_lb=cull_lb)


def _nn1_stream_cuda(src, tgt, cull_lb, max_dist_sq, diag_order, stretch,
                     visits):
    B, N, M, src, tgt = _points(src, tgt, "nn1_stream")
    lb = _cull(cull_lb, B, N, M, src.device)
    visits = _visits(visits, 1, src.device)
    chunks, per = nn1_stream_plan(B, N, M, _sm_count(src.device.index or 0))
    d = torch.empty(B, N, dtype=torch.float32, device=src.device)
    idx = torch.empty(B, N, dtype=torch.int64, device=src.device)
    pd = pi = None
    if chunks > 1:
        pd = torch.empty(B, chunks, N, dtype=torch.float32, device=src.device)
        pi = torch.empty(B, chunks, N, dtype=torch.int32, device=src.device)
    fn = dispatch.load_kernel("knn_stream").nn1_stream_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    # the gate only clamps the cull: without a table it has nothing to do
    gate = float("inf") if max_dist_sq is None or lb is None else float(max_dist_sq)
    code = fn(_ptr(src), _ptr(tgt), _ptr(lb), _ptr(d), _ptr(idx), _ptr(pd),
              _ptr(pi), _ptr(visits), B, N, M, gate, int(diag_order),
              int(stretch), chunks, per,
              ctypes.c_void_p(dispatch.current_stream(src)))
    dispatch.check_launch(code, "nn1_stream")
    dispatch.launch_counts["nn1_stream"] += 1
    return d, idx


def nn1_stream(src: torch.Tensor, tgt: torch.Tensor,
               cull_lb: torch.Tensor | None = None,
               max_dist_sq: float | None = None, diag_order: bool = False,
               stretch: int = 1, visits: torch.Tensor | None = None):
    """1-NN with the target streamed: (B, N, 3) x (B, M, 3) -> (min squared
    distance (B, N), index (B, N) int64), first index among equal minima.
    With `cull_lb` and `max_dist_sq` (the ICP inlier gate), a row whose
    nearest point lies at or beyond the gate may return any index and a
    distance >= the gate; every other row is exact. Launches the CUDA
    kernel for a CUDA tensor (a split target adds a merge launch; one
    launch is counted), the plain version for a CPU tensor. `visits`, one
    int32 on the card, gets the number of (query tile, target tile) pairs
    the kernel searched added to it; the plain version takes none."""
    if src.is_cuda:
        return _nn1_stream_cuda(src, tgt, cull_lb, max_dist_sq, diag_order,
                                stretch, visits)
    if visits is not None:
        raise ValueError("visits counts the CUDA kernel's tiles; the plain "
                         "version on the CPU has none")
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
    bf16 = q.dtype == torch.bfloat16
    # the persistent grid's units write partials, merged after
    blocks, slots = wproject_plan(B, N, M, _sm_count(q.device.index or 0),
                                  wproject_keys(q.dtype))
    part = torch.empty(blocks * slots * 3 * WPROJECT_ROWS,
                       dtype=torch.float32, device=q.device)
    fn = dispatch.load_kernel("wproject").wproject_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    code = fn(_ptr(q), _ptr(k), _ptr(v), _ptr(out), _ptr(lse), _ptr(part),
              B, N, M, D, int(bf16), blocks, slots,
              ctypes.c_void_p(dispatch.current_stream(q)))
    dispatch.check_launch(code, "wproject")
    dispatch.launch_counts["wproject"] += 1
    return out, lse


def wproject_stream_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """softmax(q k^T) v without the (N, M) matrix, and the row logsumexp:
    q (B, N, D), k (B, M, D), v (B, M, 1) -> out (B, N, 1), lse (B, N, 1),
    float32. Launches the CUDA kernel for a CUDA tensor (no gradient; a
    merge launch follows, one launch is counted), the plain version for a
    CPU tensor."""
    if q.is_cuda:
        with torch.no_grad():
            return _wproject_cuda(q, k, v)
    return wproject_stream_lse_plain(q, k, v)
