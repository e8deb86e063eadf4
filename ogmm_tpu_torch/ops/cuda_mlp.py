"""The eval PointMLP of the attention blocks (Dense -> InstanceNorm -> ReLU
-> Dense) as one CUDA kernel call, and its plain version.

`pointmlp_eval(x, w1, b1, w2, b2, dtype)` maps (B, N, Cin) to (B, N, Cout)
with the weights in the nn.Linear layout (w1 (H, Cin), w2 (Cout, H)) cast to
the compute type `dtype`, rounding where the TPU kernel
(`ogmm_tpu/ops/pallas_mlp.py:_mlp_kernel`) and the eager chain round: the
first product is summed in float32 and rounded to `dtype` before its bias is
added in `dtype`; the InstanceNorm moments are float32, two passes, biased,
eps 1e-5, over those rounded values; the normalised value is rounded to
`dtype` before the ReLU; the second product is rounded before its bias.

On a CUDA tensor the wrapper launches `csrc/pointmlp.cu` (bf16 or float32,
N <= 1024, Cin, H and Cout multiples of 64); on a CPU tensor it runs
`pointmlp_eval_reference`. `nn.layers.PointMLP(fuse_eval=True)` reaches it
where `mlp_route` says so, on either device.

The bf16 route is three launches (`pointmlp_plan` mirrors their shapes):
z = x w1^T + b1 on wgmma over tiles of 128 rows of one cloud, writing z in
bf16 and each tile's column moments; the moments combined per cloud in tile
order; out = h w2^T + b2 on wgmma, h formed from z on the way to the tensor
cores. The float32 route is the same three on the tensor cores in 3xTF32
(each product as a_lo b_hi + a_hi b_lo + a_hi b_hi of TF32 parts), after a
fourth launch that splits each weight into TF32 high and low planes.
"""
from __future__ import annotations

import ctypes

import torch

from ogmm_tpu_torch.ops import dispatch
from ogmm_tpu_torch.ops.common import matmul32

KERNEL_MAX_N = 1024   # the JAX rule (nn/layers.py:124-129): a cloud's rows
#                       of a column tile sit in shared memory
KERNEL_WIDTH = 64     # Cin, H and Cout are multiples of the kernel's tiles
DTYPES = (torch.bfloat16, torch.float32)
SMEM_LIMIT = 232_448  # shared memory a block may use on an H100

# the products' tiles and grid (csrc/pointmlp.cu): rows of a tile, depth of
# a stage (bf16; float32), stages of the operand ring, blocks of the
# persistent grid
GEMM_ROWS, GEMM_DEPTH, GEMM_STAGES, GEMM_BLOCKS = 128, 64, 3, 132
GEMM_DEPTH_F32 = 32


def _column_tile(width: int, dtype: torch.dtype = torch.bfloat16) -> int:
    """The widest column tile that divides the width: of 256, 128, 64 for
    bf16 (`column_tile`), of 128, 64 for float32 (`column_tile_f32`)."""
    if width % 256 == 0 and dtype == torch.bfloat16:
        return 256
    return 128 if width % 128 == 0 else 64


def pointmlp_plan(B: int, N: int, cin: int, h: int, cout: int,
                  dtype: torch.dtype = torch.bfloat16) -> dict:
    """The launches of the route of `dtype` as functions of the shapes,
    mirroring `csrc/pointmlp.cu`: for each product its column tile, its
    number of tiles (`pointmlp_tile` orders them), the blocks of its
    persistent grid (block i takes tiles i, i + G, ...) and its dynamic
    shared memory (the operand ring: a stage holds the A box and the weight
    box, for float32 the weight's high and low planes; the epilogue's own
    tile, bf16 or float32; the 1024-byte alignment); the moment partials
    (B, row tiles, 2, H) float32, one a (cloud, row tile, column); for
    float32 the weights' TF32 planes (2 H Cin + 2 Cout H floats) and the
    launches (4: the planes, z, the moments, out; bf16 3)."""
    f32 = dtype == torch.float32
    rows = -(-N // GEMM_ROWS)
    plan = {"row_tiles": rows, "partials": (B, rows, 2, h),
            "launches": 4 if f32 else 3}
    if f32:
        plan["planes"] = (2 * h * cin + 2 * cout * h,)
    esize, depth = (4, GEMM_DEPTH_F32) if f32 else (2, GEMM_DEPTH)
    for name, width in (("z", h), ("out", cout)):
        bn = _column_tile(width, dtype)
        stage = (GEMM_ROWS + (2 if f32 else 1) * bn) * depth * esize
        epilogue = -(-(GEMM_ROWS * (bn + 8) * esize) // 1024) * 1024
        tiles = B * rows * (width // bn)
        plan[name] = {"column_tile": bn, "tiles": tiles,
                      "blocks": min(GEMM_BLOCKS, tiles), "stage": stage,
                      "smem": GEMM_STAGES * stage + epilogue + 1024,
                      "epilogue": epilogue}
    return plan


def pointmlp_tile(i: int, row_tiles: int, col_tiles: int) -> tuple:
    """Tile i of a product as the kernel decodes it: (cloud, row tile,
    column tile), the column tiles of a row tile adjacent."""
    return (i // (col_tiles * row_tiles), i // col_tiles % row_tiles,
            i % col_tiles)


def kernel_takes(cin: int, h: int, cout: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes these widths and compute type."""
    return dtype in DTYPES and all(w >= KERNEL_WIDTH and w % KERNEL_WIDTH == 0
                                   for w in (cin, h, cout))


def mlp_route(fuse_eval: bool, training: bool, shape, channels,
              dtype: torch.dtype, group=None) -> bool:
    """Whether a PointMLP of `channels` on input of `shape` runs the fused
    kernel: asked for with `fuse_eval`, in eval, two layers, (B, N, C) input
    with N <= 1024 and no point-sharding `group` (the kernel's InstanceNorm
    sees one process's rows), the JAX package's rule
    (`ogmm_tpu/nn/layers.py:124-129`); and widths the port's kernel takes
    (the JAX kernel takes any)."""
    return (fuse_eval and not training and len(channels) == 2
            and group is None
            and len(shape) == 3 and shape[1] <= KERNEL_MAX_N
            and kernel_takes(shape[-1], *channels, dtype))


@torch.no_grad()
def pointmlp_eval_reference(x: torch.Tensor, w1: torch.Tensor,
                            b1: torch.Tensor, w2: torch.Tensor,
                            b2: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version: (B, N, Cin) -> (B, N, Cout) in `dtype`."""
    dt = dtype
    z = matmul32(x.to(dt).float(), w1.to(dt).float().transpose(0, 1))
    z = (z.to(dt) + b1.to(dt)).float()
    mean = z.mean(dim=-2, keepdim=True)
    cz = z - mean
    var = (cz * cz).mean(dim=-2, keepdim=True)
    h = torch.relu((cz * torch.rsqrt(var + 1e-5)).to(dt))
    out = matmul32(h.float(), w2.to(dt).float().transpose(0, 1))
    return out.to(dt) + b2.to(dt)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with 16-byte aligned rows (the kernel's 16-byte loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _pointmlp_cuda(x, w1, b1, w2, b2, dtype):
    if dtype not in DTYPES:
        raise ValueError(f"pointmlp kernel takes dtype bf16 or float32; got {dtype}")
    if x.dim() != 3:
        raise ValueError(f"pointmlp kernel takes (B, N, Cin); got {tuple(x.shape)}")
    B, N, Cin = x.shape
    H, Cout = w1.shape[0], w2.shape[0]
    if (w1.shape != (H, Cin) or b1.shape != (H,) or w2.shape != (Cout, H)
            or b2.shape != (Cout,)):
        raise ValueError(f"pointmlp kernel takes w1 (H, Cin), b1 (H,), w2 "
                         f"(Cout, H), b2 (Cout,); got {tuple(w1.shape)}, "
                         f"{tuple(b1.shape)}, {tuple(w2.shape)}, {tuple(b2.shape)}")
    if not 1 <= N <= KERNEL_MAX_N or not kernel_takes(Cin, H, Cout, dtype):
        raise ValueError(f"pointmlp kernel takes 1 <= N <= {KERNEL_MAX_N} and "
                         f"Cin, H, Cout multiples of {KERNEL_WIDTH}; got N={N}, "
                         f"Cin={Cin}, H={H}, Cout={Cout}")
    x, w1, b1, w2, b2 = (_aligned(a.to(dtype)) for a in (x, w1, b1, w2, b2))
    dev = x.device
    plan = pointmlp_plan(B, N, Cin, H, Cout, dtype)
    z = torch.empty(B, N, H, dtype=dtype, device=dev)
    out = torch.empty(B, N, Cout, dtype=dtype, device=dev)
    part = torch.empty(plan["partials"], dtype=torch.float32, device=dev)
    stats = torch.empty(B, 2, H, dtype=torch.float32, device=dev)
    planes = (torch.empty(plan["planes"], dtype=torch.float32, device=dev)
              if "planes" in plan else None)
    fn = dispatch.kernel_fn("pointmlp", "pointmlp_launch",
                            (ctypes.c_void_p,) * 10 + (ctypes.c_int,) * 6
                            + (ctypes.c_void_p,))
    ptr = lambda a: ctypes.c_void_p(0 if a is None else a.data_ptr())
    code = fn(*[ptr(a) for a in (x, w1, b1, w2, b2, z, out, part, stats, planes)],
              B, N, Cin, H, Cout, int(dtype == torch.bfloat16),
              ctypes.c_void_p(dispatch.current_stream(x)))
    dispatch.check_launch(code, "pointmlp")
    dispatch.launch_counts["pointmlp"] += 1
    return out


def pointmlp_eval(x: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                  w2: torch.Tensor, b2: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    """Dense(w1, b1) -> InstanceNorm over N -> ReLU -> Dense(w2, b2):
    (B, N, Cin) -> (B, N, Cout) in `dtype`. Launches the CUDA kernel for a
    CUDA tensor, the plain version for a CPU tensor. Eval only: carries no
    gradient."""
    if x.is_cuda:
        with torch.no_grad():
            return _pointmlp_cuda(x, w1, b1, w2, b2, dtype)
    return pointmlp_eval_reference(x, w1, b1, w2, b2, dtype)
