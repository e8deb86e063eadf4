// 3xTF32 helpers shared by the kernels that take float32 products on the
// tensor cores (dgcnn_eval.cu, dgcnn_bwd.cu, pointmlp.cu, wproject.cu): an
// operand v is split into hi = tf32(v) and lo = tf32(v - hi), and a product
// a b taken as a_lo b_hi + a_hi b_lo + a_hi b_hi, about 2^-22 of it from
// float32 (tests/test_torch_tf32x3.py emulates it).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// v rounded to TF32 (10 mantissa bits, to nearest, ties away), as a .b32:
// half of the 13 dropped bits added to the magnitude's bits and the 13
// cleared, the bits of cvt.rna.tf32.f32 for every finite v (which compiles
// to a compare, an add and a logic operation, and took the DGCNN stage chain
// 1.468 ms against 1.280 on an H100, scripts/torch_port_profile.py --probe
// dgcnn_eval)
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
}

// v = hi + lo to about 2^-22 relative: hi = tf32(v), lo = tf32(v - hi)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = tf32(__fsub_rn(v, __uint_as_float(hi)));
}

// c += a b for one 16x8 (a, row-major) by 8x8 (b, column-major) TF32 tile:
// a[i] is row g + 8 (i & 1), column t + 4 (i >> 1); b0 row t, b1 row t + 4,
// both column g; c[i] row g + 8 (i >> 1), column 2 t + (i & 1) (lane 4 g + t)
__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b for split operands, the three TF32 products in the order
// a_lo b_hi, a_hi b_lo, a_hi b_hi
__device__ __forceinline__ void mma_tf32x3(float c[4], const uint32_t ah[4], const uint32_t al[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  mma_tf32(c, al, bh0, bh1);
  mma_tf32(c, ah, bl0, bl1);
  mma_tf32(c, ah, bh0, bh1);
}
