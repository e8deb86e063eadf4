// The attention blocks' eval PointMLP, Dense -> InstanceNorm -> ReLU ->
// Dense, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_mlp.py:pointmlp_eval_pallas
// (_mlp_kernel): x (B, N, Cin) in the compute type T (bf16 or float32),
// weights in the nn.Linear layout w1 (H, Cin), w2 (Cout, H), biases in T:
//   z   = T(x w1^T, summed in float32) + b1          (the add in T)
//   mu, var over the N points of a cloud, float32, biased
//   h   = relu(T((z - mu) / sqrt(var + 1e-5)))
//   out = T(h w2^T, summed in float32) + b2           (the add in T)
// the rounding points of the TPU kernel and of the eager chain
// (Dense(dtype) -> instance_norm -> relu -> Dense(dtype)), so that the
// moments are taken over the rounded z.
//
// Bound: operations. 2 B N (Cin H + H Cout) products at the tensor cores'
// rate (1.08e11 at the attention call (48, 717, 1024 -> 1024 -> 512), 0.11
// ms) against about 0.1 GB that must move.
//
// bf16: three launches, both products on wgmma fed by TMA.
//  1. mlp_gemm_kernel<BN, false>: z = T(x w1^T) + b1 over tiles of 128 rows
//     of one cloud (a tile never straddles two clouds: TMA fills the rows
//     past N with zeros) by BN columns of H. A persistent grid of one block
//     an SM walks the tiles (cloud, row tile, column tile; the column tiles
//     of a row tile fastest, so that the blocks sharing an x tile run
//     together and read it from L2), block i taking tiles i, i + G, ... One
//     producer thread keeps a ring of 3 stages in flight (x's 128 x 64 box
//     and w1's BN x 64 box a stage, 128-byte swizzle) across the block's
//     tiles; two consumer warpgroups of 64 rows take m64nBNk16 wgmma with
//     both operands from shared memory, a stage's products in flight while
//     the next stage's are issued. The epilogue rounds the tile into a
//     shared-memory tile of its own (the producer meanwhile fills the ring
//     with the next tile), writes z (B, N, H) in bf16 (70 MB at the
//     attention call) and, per column, the tile's mean and sum of squared
//     deviations over its valid rows (eight running sums in a fixed order)
//     from the rounded values: one partial a (cloud, row tile, column),
//     fixed by the shape.
//  2. mlp_moments_kernel: a thread a (cloud, column) combines its row
//     tiles' partials in tile order (Chan's pairwise formula) into mu and
//     rstd = 1 / sqrt(var + 1e-5): the same bits on every launch.
//  3. mlp_gemm_kernel<BN, true>: out = T(h w2^T) + b2, where each consumer
//     thread forms its A fragments of h from the z stage in shared memory
//     (ldmatrix, then relu(T((z - mu) rstd)) on the registers) and takes
//     m64nBNk16 wgmma with A from registers: h never reaches device memory.
// The column tile BN is 256, 128 or 64, the widest that divides the width.
// Tried and dropped (probe builds, timed on the card with torch.profiler):
// three producer warps normalising each z stage in shared memory for the
// consumers (slower than the consumers' own register fragments: one warp an
// SM sub-partition could not keep up with the tensor cores); h written to
// device memory by a fourth launch and a second product with both operands
// in shared memory (slower in all); one block a tile instead of the
// persistent grid (slower: each block paid its pipeline fill and its
// epilogue with the tensor cores idle).
//
// float32: the same frame with each product as three TF32 products on the
// tensor cores (an operand v split into hi = tf32(v) and lo = tf32(v - hi),
// a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, about 2^-22 of it from float32).
// Bound: 3 x 1.08e11 TF32 operations at 495 TFLOP/s, 0.66 ms at the
// attention call; z in float32 (141 MB) is written and read back once
// (about 0.08 ms at 3.35 TB/s). Four launches:
//  0. tf32_planes_kernel: each weight split once a call into a hi and a lo
//     plane in device memory ((2 H, Cin) and (2 Cout, H), 12 MB at the
//     attention call, held by the L2), so that TMA brings both planes of a
//     weight box as it brings the bf16 box: TF32 wgmma reads B only K-major
//     from shared memory, and splitting it there would cost the consumers'
//     issue slots a stage.
//  1. mlp_tf32_kernel<BN, false>: z = x w1^T + b1 as mlp_gemm_kernel's
//     first product (its grid, ring, producer, epilogue and moments), a
//     stage 32 features deep (x's 128 x 32 box, w1's hi and lo BN x 32
//     boxes); each consumer thread loads its A values of a stage from shared
//     memory, splits them in registers and takes m64nBNk8 TF32 wgmma with A
//     from registers. BN is 128 (or 64 where 128 does not divide the width):
//     the float32 epilogue tile of 256 columns would not fit beside the ring.
//  2. mlp_moments_kernel, as for bf16.
//  3. mlp_tf32_kernel<BN, true>: out = h w2^T + b2, h = relu((z - mu) rstd)
//     formed from the z stage in the consumers' registers before the split.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"    // mbarriers, TMA, wgmma, tensor maps
#include "mma_bf16.cuh"  // ldsm_x4
#include "tf32.cuh"      // split_tf32

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// T(acc) + b in T: the float32 sum of the two T values, rounded to T
template <typename T>
__device__ __forceinline__ T add_bias(float acc, T b) {
  return from_f<T>(__fadd_rn(to_f(from_f<T>(acc)), to_f(b)));
}

// The mean and the sum of squared deviations of column col of a tile's
// first `valid` rows (row stride ld): eight running sums over rows r = 8 i + u,
// added in a fixed order, the deviations from the rounded mean
template <typename E>
__device__ __forceinline__ void tile_moments(const E* tile, int ld, int col, int valid,
                                             float& mean_out, float& q_out) {
  auto sum8 = [&](auto value) {
    float p[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) p[u] = 0.f;
    for (int q = 0; q < valid; q += 8)
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (q + u < valid) p[u] = __fadd_rn(p[u], value(q + u));
    return __fadd_rn(__fadd_rn(__fadd_rn(p[0], p[1]), __fadd_rn(p[2], p[3])),
                     __fadd_rn(__fadd_rn(p[4], p[5]), __fadd_rn(p[6], p[7])));
  };
  const float mean = sum8([&](int r) { return to_f(tile[r * ld + col]); }) / (float)valid;
  mean_out = mean;
  q_out = sum8([&](int r) {
    const float d = __fsub_rn(to_f(tile[r * ld + col]), mean);
    return __fmul_rn(d, d);
  });
}

// ------------------------------------------------------------ bf16 products

#define GM 128          // rows of a product tile: two consumer warpgroups of 64
#define GK 64           // depth of a stage (one 128-byte swizzle row)
#define GSTAGES 3
#define GTHREADS 384    // one producer and two consumer warpgroups
#define GBLOCKS 132     // the persistent grid: one block an SM of an H100

template <int BN>
struct GPlan {
  static constexpr int A_BYTES = GM * GK * 2;
  static constexpr int STAGE = A_BYTES + BN * GK * 2;
  static constexpr int OUT_LD = BN + 8;  // the epilogue's tile: bf16, padded
  static constexpr int EPI = (GM * OUT_LD * 2 + 1023) / 1024 * 1024;
  // + 1024: the ring starts at the first 1024-byte boundary (the swizzle's)
  static constexpr int SMEM = GSTAGES * STAGE + EPI + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

template <int BN>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t da, uint64_t db, int s) {
  if constexpr (BN == 256) wgmma_ss_n256<0, 0>(d, da, db, s);
  else if constexpr (BN == 128) wgmma_ss_n128<0, 0>(d, da, db, s);
  else wgmma_ss_n64<0, 0>(d, da, db, s);
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db, int s) {
  if constexpr (BN == 256) wgmma_rs_n256(d, a, db, s);
  else if constexpr (BN == 128) wgmma_rs_n128(d, a, db, s);
  else wgmma_rs_n64(d, a, db, s);
}

// relu(T((z - mu) rstd)) of the two bf16 values of a register: the ReLU
// before the rounding gives the same bf16 (rounding keeps the sign)
__device__ __forceinline__ uint32_t norm_relu2(uint32_t zz, float2 mu, float2 rs) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&zz);
  const float a = fmaxf(__fmul_rn(__fsub_rn(__low2float(v), mu.x), rs.x), 0.f);
  const float b = fmaxf(__fmul_rn(__fsub_rn(__high2float(v), mu.y), rs.y), 0.f);
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The (128-row, BN-column) tiles of A W^T + bias, A (B, N, K) by the 3-D map
// amap (boxes of 64 x 128 x 1), W (Nout, K) by the 2-D map wmap (boxes of
// 64 x BN), over a persistent grid. One producer thread keeps the ring full;
// the two consumer warpgroups take m64nBNk16 wgmma, one stage's products in
// flight while the next stage's are issued (wait_group 1), which then hands
// that stage back.
// NORM: A is z, and each consumer thread forms its A fragments of h from
// the stage (ldmatrix, then relu(T((z - mu) rstd)) with stats (B, 2, K) =
// (mu, rstd)), two sets of fragments alternating; otherwise both operands
// come from shared memory and the tile's column moments go to part
// (B, T, 2, Nout) = (mean, sum of squared deviations).
template <int BN, bool NORM>
__global__ void __launch_bounds__(GTHREADS, 1)
mlp_gemm_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap wmap,
                const bf16* __restrict__ bias, const float* __restrict__ stats,
                bf16* __restrict__ out, float* __restrict__ part, int B, int N,
                int K, int Nout) {
  typedef GPlan<BN> P;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[GSTAGES], empty[GSTAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  bf16* tile = reinterpret_cast<bf16*>(ring_ptr + GSTAGES * P::STAGE);
  const int nk = K / GK, ncol = Nout / BN, nrow = (N + GM - 1) / GM;
  const int T = ncol * nrow * B;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tl = blockIdx.x; tl < T; tl += gridDim.x) {
        const int c0 = (tl % ncol) * BN, r0 = (tl / ncol % nrow) * GM, b = tl / (ncol * nrow);
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1u);   // the first lap passes
          mbar_expect_tx(&full[stage], P::STAGE);
          const uint32_t st = ring + stage * P::STAGE;
          tma_load_3d(st, &amap, &full[stage], kc * GK, r0, b);
          tma_load_2d(st + P::A_BYTES, &wmap, &full[stage], kc * GK, c0);
          if (++stage == GSTAGES) { stage = 0; phase ^= 1u; }
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128, wg = ct / 128, warp = (ct / 32) % 4;
  const int lane = ct % 32, g = lane / 4, t = lane % 4;
  int stage = 0;
  uint32_t phase = 0;
  float acc[BN / 2];
  uint32_t af0[4][4], af1[4][4];
  for (int tl = blockIdx.x; tl < T; tl += gridDim.x) {
    const int c0 = (tl % ncol) * BN, rt = tl / ncol % nrow, r0 = rt * GM, b = tl / (ncol * nrow);
    const float* mu = NORM ? stats + (size_t)b * 2 * K : nullptr;
    const float* rs = NORM ? mu + K : nullptr;
    int prev = -1;
    auto step = [&](int kc, uint32_t (&af)[4][4]) {
      const uint32_t st = ring + stage * P::STAGE;
      const uint32_t a_wg = st + wg * 64 * 128, w_st = st + P::A_BYTES;
      if constexpr (NORM) {
        float2 m[4][2], r[4][2];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = kc * GK + ks * 16 + 2 * t + 8 * u;
            m[ks][u] = __ldg(reinterpret_cast<const float2*>(mu + k));
            r[ks][u] = __ldg(reinterpret_cast<const float2*>(rs + k));
          }
        mbar_wait(&full[stage], phase);
        const int row = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          ldsm_x4(af[ks], ring_ptr + (st - ring) + sw128_offset(row, ks * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int i = 0; i < 4; ++i) af[ks][i] = norm_relu2(af[ks][i], m[ks][i >> 1], r[ks][i >> 1]);
        }
      } else {
        mbar_wait(&full[stage], phase);
      }
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        if constexpr (NORM)
          wgmma_rs<BN>(acc, af[ks], desc_k(w_st + ks * 32), kc > 0 || ks > 0);
        else
          wgmma_ss<BN>(acc, desc_k(a_wg + ks * 32), desc_k(w_st + ks * 32), kc > 0 || ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == GSTAGES) { stage = 0; phase ^= 1u; }
    };
    for (int kc = 0; kc < nk; kc += 2) {
      step(kc, af0);
      if (kc + 1 < nk) step(kc + 1, af1);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);   // the tile's last stage

    // epilogue, in its own tile while the producer fills the ring with the
    // next tile's stages; every consumer is past the last tile's epilogue
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int rl = wg * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const bf16 b0 = bias[c0 + col], b1 = bias[c0 + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        __nv_bfloat162 v;
        v.x = add_bias<bf16>(acc[4 * j + 2 * h], b0);
        v.y = add_bias<bf16>(acc[4 * j + 2 * h + 1], b1);
        *reinterpret_cast<__nv_bfloat162*>(tile + (rl + 8 * h) * P::OUT_LD + col) = v;
      }
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int valid = min(GM, N - r0);
    if constexpr (!NORM) {
      // the tile's moments of each column over its valid rows
      for (int col = ct; col < BN; col += 256) {
        float* pp = part + ((size_t)(b * nrow + rt) * 2) * Nout + c0 + col;
        tile_moments(tile, P::OUT_LD, col, valid, pp[0], pp[Nout]);
      }
    }
    for (int e = ct; e < valid * (BN / 8); e += 256) {
      const int r = e / (BN / 8), ch = (e % (BN / 8)) * 8;
      *reinterpret_cast<uint4*>(out + ((size_t)b * N + r0 + r) * Nout + c0 + ch) =
          *reinterpret_cast<const uint4*>(tile + r * P::OUT_LD + ch);
    }
  }
}

// mu and rstd of each (cloud, column) from the row tiles' partials, combined
// in tile order
__global__ void __launch_bounds__(256)
mlp_moments_kernel(const float* __restrict__ part, float* __restrict__ stats,
                   int B, int N, int H) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= B * H) return;
  const int b = i / H, c = i % H, T = (N + GM - 1) / GM;
  const float* p = part + (size_t)b * T * 2 * H + c;
  float n = fminf((float)GM, (float)N), mean = p[0], m2 = p[H];
  for (int rt = 1; rt < T; ++rt) {
    const float nt = (float)min(GM, N - rt * GM);
    const float mt = p[(size_t)rt * 2 * H], qt = p[(size_t)(rt * 2 + 1) * H];
    const float nn = __fadd_rn(n, nt), d = __fsub_rn(mt, mean);
    mean = __fadd_rn(mean, __fdiv_rn(__fmul_rn(d, nt), nn));
    m2 = __fadd_rn(__fadd_rn(m2, qt), __fdiv_rn(__fmul_rn(__fmul_rn(d, d), __fmul_rn(n, nt)), nn));
    n = nn;
  }
  stats[(size_t)b * 2 * H + c] = mean;
  stats[(size_t)b * 2 * H + H + c] = 1.0f / sqrtf(m2 / (float)N + 1e-5f);
}

static int column_tile(int width) {
  return width % 256 == 0 ? 256 : width % 128 == 0 ? 128 : 64;
}

template <int BN, bool NORM>
static cudaError_t launch_gemm(const void* a, const void* w, const void* bias,
                               const float* stats, void* out, float* part, int B,
                               int N, int K, int Nout, cudaStream_t stream) {
  CUtensorMap amap, wmap;
  const cuuint64_t adims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t astr[2] = {(cuuint64_t)K * 2, (cuuint64_t)N * K * 2};
  const cuuint32_t abox[3] = {GK, GM, 1};
  cudaError_t err = make_map(&amap, a, 3, adims, astr, abox);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)Nout};
  const cuuint64_t wstr[1] = {(cuuint64_t)K * 2};
  const cuuint32_t wbox[2] = {GK, BN};
  err = make_map(&wmap, w, 2, wdims, wstr, wbox);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_gemm_kernel<BN, NORM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             GPlan<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (Nout / BN) * ((N + GM - 1) / GM) * B;
  mlp_gemm_kernel<BN, NORM><<<tiles < GBLOCKS ? tiles : GBLOCKS, GTHREADS,
                              GPlan<BN>::SMEM, stream>>>(
      amap, wmap, (const bf16*)bias, stats, (bf16*)out, part, B, N, K, Nout);
  return cudaGetLastError();
}

template <bool NORM>
static cudaError_t gemm(const void* a, const void* w, const void* bias,
                        const float* stats, void* out, float* part, int B, int N,
                        int K, int Nout, cudaStream_t stream) {
  switch (column_tile(Nout)) {
    case 256: return launch_gemm<256, NORM>(a, w, bias, stats, out, part, B, N, K, Nout, stream);
    case 128: return launch_gemm<128, NORM>(a, w, bias, stats, out, part, B, N, K, Nout, stream);
    default: return launch_gemm<64, NORM>(a, w, bias, stats, out, part, B, N, K, Nout, stream);
  }
}

static cudaError_t launch_bf16(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* z,
                               void* out, float* part, float* stats, int B,
                               int N, int Cin, int H, int Cout,
                               cudaStream_t stream) {
  cudaError_t err = gemm<false>(x, w1, b1, nullptr, z, part, B, N, Cin, H, stream);
  if (err != cudaSuccess) return err;
  mlp_moments_kernel<<<(B * H + 255) / 256, 256, 0, stream>>>(part, stats, B, N, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemm<true>(z, w2, b2, stats, out, nullptr, B, N, H, Cout, stream);
}

// ------------------------------------------------- float32 products (3xTF32)

#define FK 32           // depth of a float32 stage (one 128-byte swizzle row)

template <int BN>
struct FPlan {
  static constexpr int A_BYTES = GM * FK * 4;
  static constexpr int W_BYTES = BN * FK * 4;             // one weight plane's box
  static constexpr int STAGE = A_BYTES + 2 * W_BYTES;     // x or z, w hi, w lo
  static constexpr int OUT_LD = BN + 8;                   // the epilogue's tile: float32, padded
  static constexpr int EPI = (GM * OUT_LD * 4 + 1023) / 1024 * 1024;
  static constexpr int SMEM = GSTAGES * STAGE + EPI + 1024;
  static_assert(SMEM <= 232448, "shared memory");
};

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db, int s) {
  if constexpr (BN == 128) wgmma_rs_n128_tf32(d, a, db, s);
  else wgmma_rs_n64_tf32(d, a, db, s);
}

// byte offset of (row, k) in a 128-byte-swizzled stage of 32 float32 a row
__device__ __forceinline__ uint32_t sw128_f32(int row, int k) {
  return (uint32_t)(row * 128 + ((((k >> 2) ^ row) & 7) << 4) + (k & 3) * 4);
}

// hi and lo TF32 planes of the two weights: p1 (2 n1) holds hi(w1) then
// lo(w1), p2 (2 n2) the same for w2, so that a weight of R rows becomes a
// (2 R, K) tensor whose row R + r is the low part of row r
__global__ void __launch_bounds__(256)
tf32_planes_kernel(const float* __restrict__ w1, int n1, float* __restrict__ p1,
                   const float* __restrict__ w2, int n2, float* __restrict__ p2) {
  for (int i = blockIdx.x * 256 + threadIdx.x; i < n1 + n2; i += gridDim.x * 256) {
    const bool first = i < n1;
    const int j = first ? i : i - n1, n = first ? n1 : n2;
    float* p = first ? p1 : p2;
    uint32_t hi, lo;
    split_tf32(first ? w1[j] : w2[j], hi, lo);
    p[j] = __uint_as_float(hi);
    p[n + j] = __uint_as_float(lo);
  }
}

// The (128-row, BN-column) tiles of A W^T + bias in float32, A (B, N, K)
// float32 by the 3-D map amap (boxes of 32 x 128 x 1), W's hi and lo planes
// ((2 Nout, K), tf32_planes_kernel) by the 2-D map wmap (boxes of 32 x BN),
// over mlp_gemm_kernel's persistent grid, ring and producer. Each consumer
// thread loads its A values of a stage from shared memory (NORM: A is z and
// the values become h = relu((z - mu) rstd) first), splits them into TF32
// high and low parts in registers and takes each k8 step as three m64nBNk8
// TF32 wgmma, a_lo w_hi + a_hi w_lo + a_hi w_hi; two sets of fragments
// alternate, so one stage's products run while the next stage's fragments
// are formed. The epilogue is mlp_gemm_kernel's in float32.
template <int BN, bool NORM>
__global__ void __launch_bounds__(GTHREADS, 1)
mlp_tf32_kernel(const __grid_constant__ CUtensorMap amap,
                const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ bias, const float* __restrict__ stats,
                float* __restrict__ out, float* __restrict__ part, int B, int N,
                int K, int Nout) {
  typedef FPlan<BN> P;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[GSTAGES], empty[GSTAGES];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* ring_ptr = smem_raw + (ring - smem_u32(smem_raw));
  float* tile = reinterpret_cast<float*>(ring_ptr + GSTAGES * P::STAGE);
  const int nk = K / FK, ncol = Nout / BN, nrow = (N + GM - 1) / GM;
  const int T = ncol * nrow * B;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < GSTAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tl = blockIdx.x; tl < T; tl += gridDim.x) {
        const int c0 = (tl % ncol) * BN, r0 = (tl / ncol % nrow) * GM, b = tl / (ncol * nrow);
        for (int kc = 0; kc < nk; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1u);   // the first lap passes
          mbar_expect_tx(&full[stage], P::STAGE);
          const uint32_t st = ring + stage * P::STAGE;
          tma_load_3d(st, &amap, &full[stage], kc * FK, r0, b);
          tma_load_2d(st + P::A_BYTES, &wmap, &full[stage], kc * FK, c0);
          tma_load_2d(st + P::A_BYTES + P::W_BYTES, &wmap, &full[stage], kc * FK, Nout + c0);
          if (++stage == GSTAGES) { stage = 0; phase ^= 1u; }
        }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int ct = threadIdx.x - 128, wg = ct / 128, warp = (ct / 32) % 4;
  const int lane = ct % 32, g = lane / 4, t = lane % 4;
  const int row = wg * 64 + warp * 16 + g;   // this lane's rows of a tile: +0, +8
  int stage = 0;
  uint32_t phase = 0;
  float acc[BN / 2];
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
  for (int tl = blockIdx.x; tl < T; tl += gridDim.x) {
    const int c0 = (tl % ncol) * BN, rt = tl / ncol % nrow, r0 = rt * GM, b = tl / (ncol * nrow);
    const float* mu = NORM ? stats + (size_t)b * 2 * K : nullptr;
    const float* rs = NORM ? mu + K : nullptr;
    int prev = -1;
    auto step = [&](int kc, uint32_t (&ah)[4][4], uint32_t (&al)[4][4]) {
      const uint32_t st = ring + stage * P::STAGE;
      const unsigned char* a_st = ring_ptr + stage * P::STAGE;
      const uint32_t w_hi = st + P::A_BYTES, w_lo = w_hi + P::W_BYTES;
      // a[i] of k8 step ks: row `row` + 8 (i & 1), column 8 ks + t + 4 (i >> 1)
      float m[4][2], r[4][2];
      if constexpr (NORM) {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int k = kc * FK + 8 * ks + t + 4 * u;
            m[ks][u] = __ldg(mu + k);
            r[ks][u] = __ldg(rs + k);
          }
      }
      mbar_wait(&full[stage], phase);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v = *reinterpret_cast<const float*>(
              a_st + sw128_f32(row + 8 * (i & 1), 8 * ks + t + 4 * (i >> 1)));
          if constexpr (NORM)
            v = fmaxf(__fmul_rn(__fsub_rn(v, m[ks][i >> 1]), r[ks][i >> 1]), 0.f);
          split_tf32(v, ah[ks][i], al[ks][i]);
        }
      wgmma_fence();
      fence_acc(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        wgmma_tf32<BN>(acc, al[ks], desc_k(w_hi + ks * 32), kc > 0 || ks > 0);
        wgmma_tf32<BN>(acc, ah[ks], desc_k(w_lo + ks * 32), 1);
        wgmma_tf32<BN>(acc, ah[ks], desc_k(w_hi + ks * 32), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_acc(acc);
      if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == GSTAGES) { stage = 0; phase ^= 1u; }
    };
    for (int kc = 0; kc < nk; kc += 2) {
      step(kc, ah0, al0);
      if (kc + 1 < nk) step(kc + 1, ah1, al1);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[prev]);   // the tile's last stage

    // epilogue, in its own tile while the producer fills the ring with the
    // next tile's stages; every consumer is past the last tile's epilogue
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * t;
      const float b0 = bias[c0 + col], b1 = bias[c0 + col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(tile + (row + 8 * h) * P::OUT_LD + col) =
            make_float2(add_bias<float>(acc[4 * j + 2 * h], b0),
                        add_bias<float>(acc[4 * j + 2 * h + 1], b1));
    }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int valid = min(GM, N - r0);
    if constexpr (!NORM) {
      for (int col = ct; col < BN; col += 256) {
        float* pp = part + ((size_t)(b * nrow + rt) * 2) * Nout + c0 + col;
        tile_moments(tile, P::OUT_LD, col, valid, pp[0], pp[Nout]);
      }
    }
    for (int e = ct; e < valid * (BN / 4); e += 256) {
      const int r = e / (BN / 4), ch = (e % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(out + ((size_t)b * N + r0 + r) * Nout + c0 + ch) =
          *reinterpret_cast<const float4*>(tile + r * P::OUT_LD + ch);
    }
  }
}

static int column_tile_f32(int width) { return width % 128 == 0 ? 128 : 64; }

template <int BN, bool NORM>
static cudaError_t launch_tf32(const void* a, const float* planes, const void* bias,
                               const float* stats, void* out, float* part, int B,
                               int N, int K, int Nout, cudaStream_t stream) {
  CUtensorMap amap, wmap;
  const cuuint64_t adims[3] = {(cuuint64_t)K, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t astr[2] = {(cuuint64_t)K * 4, (cuuint64_t)N * K * 4};
  const cuuint32_t abox[3] = {FK, GM, 1};
  cudaError_t err = make_map(&amap, a, 3, adims, astr, abox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return err;
  const cuuint64_t wdims[2] = {(cuuint64_t)K, (cuuint64_t)2 * Nout};
  const cuuint64_t wstr[1] = {(cuuint64_t)K * 4};
  const cuuint32_t wbox[2] = {FK, BN};
  err = make_map(&wmap, planes, 2, wdims, wstr, wbox, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_tf32_kernel<BN, NORM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, FPlan<BN>::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (Nout / BN) * ((N + GM - 1) / GM) * B;
  mlp_tf32_kernel<BN, NORM><<<tiles < GBLOCKS ? tiles : GBLOCKS, GTHREADS,
                              FPlan<BN>::SMEM, stream>>>(
      amap, wmap, (const float*)bias, stats, (float*)out, part, B, N, K, Nout);
  return cudaGetLastError();
}

template <bool NORM>
static cudaError_t gemm_tf32(const void* a, const float* planes, const void* bias,
                             const float* stats, void* out, float* part, int B, int N,
                             int K, int Nout, cudaStream_t stream) {
  if (column_tile_f32(Nout) == 128)
    return launch_tf32<128, NORM>(a, planes, bias, stats, out, part, B, N, K, Nout, stream);
  return launch_tf32<64, NORM>(a, planes, bias, stats, out, part, B, N, K, Nout, stream);
}

// four launches: the weights' TF32 planes, z with its tile moments, the
// moments per cloud, out
static cudaError_t launch_f32(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* z, void* out,
                              float* part, float* stats, float* planes, int B, int N,
                              int Cin, int H, int Cout, cudaStream_t stream) {
  float* p1 = planes;
  float* p2 = planes + (size_t)2 * H * Cin;
  const int n = H * Cin + Cout * H, blocks = (n + 255) / 256;
  tf32_planes_kernel<<<blocks < 1056 ? blocks : 1056, 256, 0, stream>>>(
      (const float*)w1, H * Cin, p1, (const float*)w2, Cout * H, p2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = gemm_tf32<false>(x, p1, b1, nullptr, z, part, B, N, Cin, H, stream);
  if (err != cudaSuccess) return err;
  mlp_moments_kernel<<<(B * H + 255) / 256, 256, 0, stream>>>(part, stats, B, N, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return gemm_tf32<true>(z, p2, b2, stats, out, nullptr, B, N, H, Cout, stream);
}

// x (B, N, Cin), w1 (H, Cin), b1 (H), w2 (Cout, H), b2 (Cout), all in the
// compute type; z (B, N, H) scratch in the compute type, out (B, N, Cout);
// part (B, ceil(N / 128), 2, H) and stats (B, 2, H) float32 scratch; float32
// also planes (2 H Cin + 2 Cout H) float32 scratch (ops/cuda_mlp.py:
// pointmlp_plan mirrors the launches). Takes Cin, H, Cout multiples of 64;
// 16-byte aligned rows.
extern "C" int pointmlp_launch(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* z,
                               void* out, float* part, float* stats, float* planes,
                               int B, int N, int Cin, int H, int Cout, int is_bf16,
                               void* stream_ptr) {
  if (B < 1 || N < 1 || Cin % 64 || H % 64 || Cout % 64 || Cin < 64 || H < 64 ||
      Cout < 64 || part == nullptr || stats == nullptr || (!is_bf16 && planes == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (is_bf16)
    return (int)launch_bf16(x, w1, b1, w2, b2, z, out, part, stats, B, N, Cin, H,
                            Cout, stream);
  return (int)launch_f32(x, w1, b1, w2, b2, z, out, part, stats, planes, B, N, Cin, H,
                         Cout, stream);
}
