// The overlap head's streamed projection softmax(q k^T) v for a one-column v,
// with the row logsumexp, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_stream.py:wproject_stream_lse
// (_wproject_kernel): q (B, N, D), k (B, M, D) in the body's type, v (B, M)
// float32 -> out (B, N) = sum_m softmax_m(q_n . k_m) v_m and lse (B, N) =
// log sum_m exp(q_n . k_m), both float32. The (N, M) similarity never exists
// in device memory (at the indoor request it would be 4.9 GB a pair).
//
// Every route runs a flash-style online softmax: each row keeps its running
// max m, sum l and accumulator acc in float32, rescaled by exp(m_old - m_new)
// when the max grows; out = acc / l and lse = m + log l. Keys past M never
// reach a sum: their logits are replaced by -inf (a select, not a product),
// so no padding value can.
//
//  - bf16 (wproject_wgmma_kernel + wproject_merge_kernel, D in {64, 128,
//    256, 512}). Bound: operations, 2 D flops a (query, key) pair at the
//    tensor cores' rate; at the indoor call (N = M = 35,000, D = 512) 1.25
//    TFLOP, 1.27 ms at 989 TFLOP/s, against 72 MB to read. A block has one
//    producer warpgroup and two consumer warpgroups of 64 query rows each
//    (a work unit is 128 rows). One producer thread keeps a ring of key
//    tiles (64 keys x D) in flight with TMA (cp.async.bulk.tensor, 128-byte
//    swizzle, one box of 64 features at a time, mbarrier-guarded stages;
//    rows past M arrive as zeros and are masked by column index). The
//    consumers hold their q rows as wgmma A fragments in registers (D / 4
//    of them, 128 at D = 512: setmaxnreg moves registers from the producer
//    to the consumers) and take S = q k^T for a tile with D / 16
//    wgmma.mma_async m64n64k16 (bf16 products, exact, summed in float32,
//    B from shared memory, K-major). The online softmax runs on the
//    accumulator fragments (a lane holds rows g and g + 8, columns 2t,
//    2t + 1 of every 8), in base 2; p . v stays on the CUDA cores (v has
//    one column). The two warpgroups take turns to issue their products
//    (named barriers, as FlashAttention-3 does), so that one runs its
//    softmax (8,192 exponentials a tile for the block, at 16 a clock on an
//    SM's special function units) while the tensor cores take the other's
//    products.
//    Wave tail: a persistent grid of one block an SM walks the flattened
//    (query tile, key tile) pairs, each block an equal contiguous share, so
//    every SM has work to the end; a block's share splits at query-tile
//    boundaries into units (a tile and a key range), each writing its rows'
//    partial (m, l, acc). A second small launch merges the partials of a
//    row in ascending key order (no float atomics: the same bits every
//    launch). ops/cuda_stream.py:wproject_units mirrors the split.
//    Every block reads all of k: (N / 128) M D 2 bytes from L2, 9.8 GB at
//    the indoor call. Clusters of two blocks sharing each tile by TMA
//    multicast halve that, but measured slower: the L2 does not bound the
//    kernel, and two blocks' rings in lockstep stall each other. Without
//    its softmax the kernel measured most of its time: the m64n64k16
//    products from register fragments, which the 128 registers of q keep
//    from a wider N, stand between it and the bound.
//  - float32 (wproject_f32_kernel, D a multiple of 32): 64 query rows and
//    keys in tiles of 64, the logit tile on the CUDA cores (each thread 4
//    rows by 8 keys over 32-feature chunks staged in shared memory), then
//    through shared memory to the softmax step, two threads a row.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): the indoor
// call (1, 35000, 35000, D = 512) bf16 takes 2.05-2.10 ms (about 600
// TFLOP/s, 64% of the bound's rate; k at 4.7 TB/s from L2); 2.15 ms
// without the turns (another call).
#include <cuda.h>  // CUtensorMap and its enums (types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// ---------------------------------------------------------------- bf16

#define WQ 128         // query rows a work unit: two consumer warpgroups of 64
#define WK 64          // keys a tile: the wgmma's N
#define WTHREADS 384   // one producer and two consumer warpgroups
#define SPIN_LIMIT (1u << 28)  // an mbarrier wait that never ends traps

template <int D>
struct WPlan {
  static constexpr int STAGES = D >= 512 ? 3 : D >= 256 ? 6 : 8;
  static constexpr int STAGE_BYTES = WK * D * 2;
  // + 1024: the ring starts at the first 1024-byte boundary (the swizzle's)
  static constexpr int SMEM = STAGES * STAGE_BYTES + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (spin == SPIN_LIMIT) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// one box of the 3-D tensor map (D, M, B) -> shared memory, completion on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzle: rows of 128
// bytes, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (64 x 64, f32) = a (64 x 16, bf16 registers) b (16 x 64, bf16 in shared
// memory) + (scale_d ? d : 0), asynchronous
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// keep the compiler from moving register reads or writes across a wgmma
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// named barriers 1 and 2 over the 256 consumer threads: a warpgroup waits
// for its turn to issue products, then hands the turn to the other
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - cw) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// the integer split of a persistent grid of G blocks over T (query tile, key
// tile) pairs: block i takes pairs [i T / G, (i + 1) T / G); block_of(p) is
// the block holding pair p
__device__ __forceinline__ long long share_start(long long i, long long T, long long G) {
  return i * T / G;
}
__device__ __forceinline__ long long block_of(long long p, long long T, long long G) {
  return ((p + 1) * G - 1) / T;
}

template <int D>
__global__ void __launch_bounds__(WTHREADS, 1)
wproject_wgmma_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __nv_bfloat16* __restrict__ q,
                      const float* __restrict__ v, float* __restrict__ part,
                      int B, int N, int M, int slots) {
  constexpr int KS = D / 16, ST = WPlan<D>::STAGES, SB = WPlan<D>::STAGE_BYTES;
  constexpr float L2E = 1.4426950408889634f;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[ST], empty[ST];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int n_qt = (N + WQ - 1) / WQ, n_kt = (M + WK - 1) / WK;
  const long long T = (long long)B * n_qt * n_kt, G = gridDim.x;
  const long long p0 = share_start(blockIdx.x, T, G);
  const long long p1 = share_start(blockIdx.x + 1, T, G);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);   // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (long long p = p0; p < p1; ++p) {
        const int tile = (int)(p / n_kt), kt = (int)(p % n_kt);
        mbar_wait(&empty[stage], phase ^ 1u);   // the first lap passes
        mbar_expect_tx(&full[stage], SB);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(ring + stage * SB + c * (WK * 128), &kmap, &full[stage],
                      c * 64, kt * WK, tile / n_qt);
        if (++stage == ST) { stage = 0; phase ^= 1u; }
      }
    }
    return;
  }

  // --------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = threadIdx.x / 128 - 1, warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int tile0 = (int)(p0 / n_kt);
  int stage = 0;
  uint32_t phase = 0;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  if (cw == 1) turn_pass(cw);   // warpgroup 0 issues first
  for (long long p = p0; p < p1;) {
    // a unit: query tile `tile`, key tiles [k0, k1)
    const int tile = (int)(p / n_kt), k0 = (int)(p % n_kt);
    const int k1 = (int)(k0 + p1 - p < n_kt ? k0 + p1 - p : n_kt);
    const int b = tile / n_qt, rr = (tile % n_qt) * WQ + cw * 64 + warp * 16 + g;
    const __nv_bfloat16* qb = q + (size_t)b * N * D;
    const float* vb = v + (size_t)b * M;
    // rows rr and rr + 8 of q as A fragments: (g, 2t), (g + 8, 2t),
    // (g, 2t + 8), (g + 8, 2t + 8) of each 16-feature step
    uint32_t qa[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rr + 8 * (i & 1), c = ks * 16 + 2 * t + 8 * (i >> 1);
        qa[ks][i] = r < N ? __ldg(reinterpret_cast<const unsigned int*>(qb + (size_t)r * D + c)) : 0u;
      }
    float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};   // base-2 logits
    float l_run[2] = {0.f, 0.f}, a_run[2] = {0.f, 0.f};
    for (int kt = k0; kt < k1; ++kt) {
      const int m0 = kt * WK;
      const bool whole = m0 + WK <= M;
      float vv[8][2];   // v of this lane's columns 8 j + 2 t + e
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = m0 + 8 * j + 2 * t + e;
          vv[j][e] = whole || col < M ? __ldg(vb + col) : 0.f;
        }
      mbar_wait(&full[stage], phase);
      // the two warpgroups issue their products in turn, so that one's
      // softmax runs while the tensor cores take the other's products
      turn_wait(cw);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const uint32_t kbase = ring + stage * SB;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        wgmma_m64n64k16(acc, qa[ks],
                        sw128_desc(kbase + (ks / 4) * (WK * 128) + (ks % 4) * 32),
                        ks > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      turn_pass(cw);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc(acc);
      if (lane == 0) mbar_arrive(&empty[stage]);   // this warp is done with it
      if (++stage == ST) { stage = 0; phase ^= 1u; }
      // online softmax over the tile's 64 keys: acc[4 j + e] is row g,
      // acc[4 j + 2 + e] row g + 8, column 8 j + 2 t + e
      if (!whole) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (m0 + 8 * j + 2 * t + e >= M) acc[4 * j + e] = acc[4 * j + 2 + e] = -CUDART_INF_F;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          mx = fmaxf(mx, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_run[h], mx * L2E);  // finite: a tile has a key
        const float alpha = ex2(m_run[h] - m_new);      // 0 on a unit's first tile
        float ps = 0.f, pv = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float pe = ex2(fmaf(acc[4 * j + 2 * h + e], L2E, -m_new));  // -inf -> 0
            ps += pe;
            pv = fmaf(pe, vv[j][e], pv);
          }
        l_run[h] = fmaf(l_run[h], alpha, ps);
        a_run[h] = fmaf(a_run[h], alpha, pv);
        m_run[h] = m_new;
      }
    }
    // the unit's partial (m, l, acc) of each row, lanes of a row summed
    float* dst = part + (size_t)((long long)blockIdx.x * slots + (tile - tile0)) * 3 * WQ;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = l_run[h], a = a_run[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      if (t == 0) {
        const int row = cw * 64 + warp * 16 + g + 8 * h;
        dst[row] = m_run[h];
        dst[WQ + row] = l;
        dst[2 * WQ + row] = a;
      }
    }
    p += k1 - k0;
  }
}

// one thread a row: the partials of its query tile's units, in ascending key
// order -> out, lse
__global__ void __launch_bounds__(256)
wproject_merge_kernel(const float* __restrict__ part, float* __restrict__ out,
                      float* __restrict__ lse, int B, int N, int M, int slots,
                      int G) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * N) return;
  const int b = idx / N, n = idx % N;
  const int n_qt = (N + WQ - 1) / WQ, n_kt = (M + WK - 1) / WK;
  const long long T = (long long)B * n_qt * n_kt;
  const int tile = b * n_qt + n / WQ, row = n % WQ;
  const long long pa = (long long)tile * n_kt;
  const int g0 = (int)block_of(pa, T, G), g1 = (int)block_of(pa + n_kt - 1, T, G);
  float mx = -CUDART_INF_F;
  for (int i = g0; i <= g1; ++i) {
    const int s = tile - (int)(share_start(i, T, G) / n_kt);
    mx = fmaxf(mx, part[((size_t)i * slots + s) * 3 * WQ + row]);
  }
  float l = 0.f, a = 0.f;
  for (int i = g0; i <= g1; ++i) {
    const int s = tile - (int)(share_start(i, T, G) / n_kt);
    const float* src = part + ((size_t)i * slots + s) * 3 * WQ;
    const float w = exp2f(src[row] - mx);
    l = fmaf(src[WQ + row], w, l);
    a = fmaf(src[2 * WQ + row], w, a);
  }
  out[idx] = a / l;
  lse[idx] = (mx + log2f(l)) * 0.6931471805599453f;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime
static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) != cudaSuccess)
      return nullptr;
#endif
    if (found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int D>
static cudaError_t launch_bf16(const void* q, const void* k, const float* v,
                               float* out, float* lse, float* part, int B, int N,
                               int M, int blocks, int slots, cudaStream_t stream) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  if (reinterpret_cast<uintptr_t>(k) % 16 != 0) return cudaErrorMisalignedAddress;
  CUtensorMap kmap;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)M, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)M * D * 2};
  const cuuint32_t box[3] = {64, WK, 1}, elem[3] = {1, 1, 1};
  if (encode(&kmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(k),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      wproject_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      WPlan<D>::SMEM);
  if (err != cudaSuccess) return err;
  wproject_wgmma_kernel<D><<<blocks, WTHREADS, WPlan<D>::SMEM, stream>>>(
      kmap, (const __nv_bfloat16*)q, v, part, B, N, M, slots);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wproject_merge_kernel<<<(B * N + 255) / 256, 256, 0, stream>>>(
      part, out, lse, B, N, M, slots, blocks);
  return cudaGetLastError();
}

// ------------------------------------------------------------- float32

#define FQ 64     // query rows a block
#define FK 64     // keys a tile
#define FDC 32    // features of a staged chunk
#define FNT 128   // threads a block
#define FLD (FDC + 4)   // 36 words a staged row

// rows [r0, r0 + 64) x features [d0, d0 + FDC) of a (rows, D) matrix into
// shared memory; rows past `rows` are zeros
__device__ __forceinline__ void stage_f32(float* dst, const float* __restrict__ src,
                                          int r0, int rows, int D, int d0) {
  for (int e = threadIdx.x; e < 64 * FDC / 4; e += FNT) {
    const int r = e / (FDC / 4), c = (e % (FDC / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < rows)
      val = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + d0 + c);
    *reinterpret_cast<float4*>(dst + r * FLD + c) = val;
  }
}

__global__ void __launch_bounds__(FNT)
wproject_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ out,
                    float* __restrict__ lse, int N, int M, int D) {
  __shared__ __align__(16) float qs[FQ * FLD];
  __shared__ __align__(16) float ks[FK * FLD];
  __shared__ float S[FQ][FK + 1];
  __shared__ float vs[FK];
  const int b = blockIdx.y, n0 = blockIdx.x * FQ, tid = threadIdx.x;
  const float* qb = q + (size_t)b * N * D;
  const float* kb = k + (size_t)b * M * D;
  const float* vb = v + (size_t)b * M;
  // logits: rows 4 (tid / 8) + i, keys (tid % 8) + 8 j; the eight threads of
  // a 16-byte load phase read one q row (a broadcast) and eight k rows
  const int rg = (tid / 8) * 4, kg = tid % 8;
  // softmax: two threads a row, 32 keys each
  const int row = tid >> 1, c0 = (tid & 1) * (FK / 2);
  float m = -CUDART_INF_F, l = 0.f, acc = 0.f;
  for (int m0 = 0; m0 < M; m0 += FK) {
    float sacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sacc[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += FDC) {
      __syncthreads();
      stage_f32(qs, qb, n0, N, D, d0);
      stage_f32(ks, kb, m0, M, D, d0);
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < FDC; kk += 4) {
        float4 a[4], c[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qs + (rg + i) * FLD + kk);
#pragma unroll
        for (int j = 0; j < 8; ++j) c[j] = *reinterpret_cast<const float4*>(ks + (kg + 8 * j) * FLD + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sacc[i][j] = fmaf(a[i].x, c[j].x, sacc[i][j]);
            sacc[i][j] = fmaf(a[i].y, c[j].y, sacc[i][j]);
            sacc[i][j] = fmaf(a[i].z, c[j].z, sacc[i][j]);
            sacc[i][j] = fmaf(a[i].w, c[j].w, sacc[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) S[rg + i][kg + 8 * j] = sacc[i][j];
    if (tid < FK) vs[tid] = m0 + tid < M ? vb[m0 + tid] : 0.f;
    __syncthreads();
    const int len = min(FK, M - m0);
    float mx = -CUDART_INF_F;
    for (int c = c0; c < c0 + FK / 2 && c < len; ++c) mx = fmaxf(mx, S[row][c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);    // finite: every tile has a key
    const float alpha = expf(m - m_new); // 0 on the first tile
    float ps = 0.f, pv = 0.f;
    for (int c = c0; c < c0 + FK / 2 && c < len; ++c) {
      const float p = expf(S[row][c] - m_new);
      ps += p;
      pv = fmaf(p, vs[c], pv);
    }
    l = fmaf(l, alpha, ps);
    acc = fmaf(acc, alpha, pv);
    m = m_new;
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if ((tid & 1) == 0 && n0 + row < N) {
    out[(size_t)b * N + n0 + row] = acc / l;
    lse[(size_t)b * N + n0 + row] = m + logf(l);
  }
}

extern "C" int wproject_launch(const void* q, const void* k, const float* v,
                               float* out, float* lse, float* part, int B, int N,
                               int M, int D, int is_bf16, int blocks, int slots,
                               void* stream_ptr) {
  if (B < 1 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (is_bf16) {
    // blocks and slots: ops/cuda_stream.py:wproject_plan
    const long long T = (long long)B * ((N + WQ - 1) / WQ) * ((M + WK - 1) / WK);
    if (blocks < 1 || blocks > T || slots < 1 || part == nullptr)
      return (int)cudaErrorInvalidValue;
    switch (D) {
      case 64: return (int)launch_bf16<64>(q, k, v, out, lse, part, B, N, M, blocks, slots, stream);
      case 128: return (int)launch_bf16<128>(q, k, v, out, lse, part, B, N, M, blocks, slots, stream);
      case 256: return (int)launch_bf16<256>(q, k, v, out, lse, part, B, N, M, blocks, slots, stream);
      case 512: return (int)launch_bf16<512>(q, k, v, out, lse, part, B, N, M, blocks, slots, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (D < FDC || D % FDC != 0) return (int)cudaErrorInvalidValue;
  wproject_f32_kernel<<<dim3((N + FQ - 1) / FQ, B), FNT, 0, stream>>>(
      (const float*)q, (const float*)k, v, out, lse, N, M, D);
  return (int)cudaGetLastError();
}
