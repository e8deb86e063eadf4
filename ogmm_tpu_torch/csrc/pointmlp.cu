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
// float32: two launches on the CUDA cores (each thread 4 rows by 4 columns).
//  1. mlp_norm_kernel: a block owns one cloud and 32 columns of H, walks
//     the cloud's rows in tiles of 128 and keeps all N <= 1024 rows of its
//     columns in shared memory, takes the moments in a fixed order (two
//     passes) and writes h (B, N, H).
//  2. mlp_out_kernel: h w2^T + b2 over tiles of 128 rows of the B N rows.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"    // mbarriers, TMA, wgmma, tensor maps
#include "mma_bf16.cuh"  // ldsm_x4

#define NT 256     // threads a float32 block, 8 warps
#define BR 128     // rows of a product tile
#define MAXN 1024  // float32: the rows of one cloud held in shared memory

typedef __nv_bfloat16 bf16;

// float32 tiles: column tile, depth of a staged chunk, padded row strides (a
// staged row of 36 words, 4 mod 32, keeps the loads free of bank conflicts)
struct TileF {
  static constexpr int TC = 32, KC = 32, LD = 36, ZLD = 36;
  static constexpr int STAGE_BYTES = (BR + TC) * LD * 4;
};

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
        // eight running sums over rows r = 8 i + u, added in a fixed order
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
        const float mean = sum8([&](int r) {
          return __bfloat162float(tile[r * P::OUT_LD + col]);
        }) / (float)valid;
        const float q = sum8([&](int r) {
          const float d = __fsub_rn(__bfloat162float(tile[r * P::OUT_LD + col]), mean);
          return __fmul_rn(d, d);
        });
        float* pp = part + ((size_t)(b * nrow + rt) * 2) * Nout + c0 + col;
        pp[0] = mean;
        pp[Nout] = q;
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

// ------------------------------------------------------- float32 products

// The same tile of A W^T in float32 on the CUDA cores: thread (i, j) of the
// (32, 8) grid owns rows 4 i .. 4 i + 3 and columns j, j + 8, j + 16, j + 24.
template <class Emit>
__device__ __forceinline__ void product(const float* __restrict__ A, int rows,
                                        const float* __restrict__ W, int K,
                                        int r0, int c0, unsigned char* smem,
                                        Emit emit) {
  typedef TileF TL;
  float* sa = reinterpret_cast<float*>(smem);
  float* sw = sa + BR * TL::LD;
  const int tid = threadIdx.x, rg = (tid / 8) * 4, cg = tid % 8;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += TL::KC) {
    __syncthreads();
    for (int e = tid; e < BR * TL::KC / 4; e += NT) {
      const int r = e / (TL::KC / 4), c = (e % (TL::KC / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r0 + r < rows)
        v = *reinterpret_cast<const float4*>(A + (size_t)(r0 + r) * K + k0 + c);
      *reinterpret_cast<float4*>(sa + r * TL::LD + c) = v;
    }
    for (int e = tid; e < TL::TC * TL::KC / 4; e += NT) {
      const int r = e / (TL::KC / 4), c = (e % (TL::KC / 4)) * 4;
      *reinterpret_cast<float4*>(sw + r * TL::LD + c) =
          *reinterpret_cast<const float4*>(W + (size_t)(c0 + r) * K + k0 + c);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TL::KC; kk += 4) {
      float4 a[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(sa + (rg + i) * TL::LD + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) w[j] = *reinterpret_cast<const float4*>(sw + (cg + 8 * j) * TL::LD + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i].x, w[j].x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, w[j].y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, w[j].z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, w[j].w, acc[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) emit(r0 + rg + i, c0 + cg + 8 * j, acc[i][j]);
}

// ---------------------------------------------------------- the kernels

__host__ __device__ constexpr int align16(int bytes) { return (bytes + 15) / 16 * 16; }

template <typename T>
__global__ void __launch_bounds__(NT, 1)
mlp_norm_kernel(const T* __restrict__ x, const T* __restrict__ w1,
                const T* __restrict__ b1, T* __restrict__ h, int N, int Cin,
                int H) {
  typedef TileF TL;
  constexpr int P = NT / TL::TC;        // row groups of the moments
  extern __shared__ __align__(16) unsigned char smem[];
  T* zs = reinterpret_cast<T*>(smem);   // (N, ZLD): z of this column tile
  unsigned char* stage = smem + align16(N * TL::ZLD * (int)sizeof(T));
  __shared__ float red[P][TL::TC];
  __shared__ float mean[TL::TC], inv[TL::TC];
  const int b = blockIdx.y, c0 = blockIdx.x * TL::TC, tid = threadIdx.x;
  const T* xb = x + (size_t)b * N * Cin;

  for (int r0 = 0; r0 < N; r0 += BR)
    product(xb, N, w1, Cin, r0, c0, stage, [&](int r, int c, float acc) {
      if (r < N) zs[r * TL::ZLD + c - c0] = add_bias<T>(acc, b1[c]);
    });
  __syncthreads();

  // moments over the N rows, each column in P row groups, summed in order
  const int col = tid % TL::TC, part = tid / TL::TC;
  float s = 0.f;
  for (int r = part; r < N; r += P) s += to_f(zs[r * TL::ZLD + col]);
  red[part][col] = s;
  __syncthreads();
  if (tid < TL::TC) {
    float tot = 0.f;
    for (int p = 0; p < P; ++p) tot += red[p][tid];
    mean[tid] = tot / (float)N;
  }
  __syncthreads();
  const float mu = mean[col];
  s = 0.f;
  for (int r = part; r < N; r += P) {
    const float d = __fsub_rn(to_f(zs[r * TL::ZLD + col]), mu);
    s = __fadd_rn(s, __fmul_rn(d, d));
  }
  red[part][col] = s;
  __syncthreads();
  if (tid < TL::TC) {
    float tot = 0.f;
    for (int p = 0; p < P; ++p) tot += red[p][tid];
    inv[tid] = 1.0f / sqrtf(tot / (float)N + 1e-5f);
  }
  __syncthreads();

  // h = relu(T((z - mu) * inv)), a row's TC columns by consecutive threads
  T* hb = h + (size_t)b * N * H + c0;
  for (int e = tid; e < N * TL::TC; e += NT) {
    const int r = e / TL::TC, c = e % TL::TC;
    const float v = to_f(from_f<T>(__fmul_rn(
        __fsub_rn(to_f(zs[r * TL::ZLD + c]), mean[c]), inv[c])));
    hb[(size_t)r * H + c] = from_f<T>(v > 0.f ? v : 0.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
mlp_out_kernel(const T* __restrict__ h, const T* __restrict__ w2,
               const T* __restrict__ b2, T* __restrict__ out, int rows, int H,
               int Cout) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r0 = blockIdx.y * BR, c0 = blockIdx.x * TileF::TC;
  product(h, rows, w2, H, r0, c0, smem, [&](int r, int c, float acc) {
    if (r < rows) out[(size_t)r * Cout + c] = add_bias<T>(acc, b2[c]);
  });
}

static cudaError_t launch_f32(const void* x, const void* w1, const void* b1,
                              const void* w2, const void* b2, void* h, void* out,
                              int B, int N, int Cin, int H, int Cout,
                              cudaStream_t stream) {
  typedef TileF TL;
  const int smem1 = align16(N * TL::ZLD * 4) + TL::STAGE_BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_norm_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(mlp_out_kernel<float>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TL::STAGE_BYTES);
  if (err != cudaSuccess) return err;
  mlp_norm_kernel<float><<<dim3(H / TL::TC, B), NT, smem1, stream>>>(
      (const float*)x, (const float*)w1, (const float*)b1, (float*)h, N, Cin, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rows = B * N;
  mlp_out_kernel<float><<<dim3(Cout / TL::TC, (rows + BR - 1) / BR), NT,
                          TL::STAGE_BYTES, stream>>>(
      (const float*)h, (const float*)w2, (const float*)b2, (float*)out, rows, H, Cout);
  return cudaGetLastError();
}

// x (B, N, Cin), w1 (H, Cin), b1 (H), w2 (Cout, H), b2 (Cout), all in the
// compute type; h (B, N, H) scratch in the compute type (z for bf16, h for
// float32), out (B, N, Cout); bf16 also part (B, ceil(N / 128), 2, H) and
// stats (B, 2, H) float32 scratch (ops/cuda_mlp.py:pointmlp_plan mirrors the
// launches). Takes Cin,
// H, Cout multiples of 64, and float32 N <= 1024; 16-byte aligned rows.
extern "C" int pointmlp_launch(const void* x, const void* w1, const void* b1,
                               const void* w2, const void* b2, void* h,
                               void* out, float* part, float* stats, int B,
                               int N, int Cin, int H, int Cout, int is_bf16,
                               void* stream_ptr) {
  if (B < 1 || N < 1 || Cin % 64 || H % 64 || Cout % 64 || Cin < 64 || H < 64 ||
      Cout < 64 || (!is_bf16 && N > MAXN) || (is_bf16 && (part == nullptr || stats == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (is_bf16)
    return (int)launch_bf16(x, w1, b1, w2, b2, h, out, part, stats, B, N, Cin, H,
                            Cout, stream);
  return (int)launch_f32(x, w1, b1, w2, b2, h, out, B, N, Cin, H, Cout, stream);
}
