// The overlap head's streamed projection softmax(q k^T) v for a one-column v,
// with the row logsumexp, for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_stream.py:wproject_stream_lse
// (_wproject_kernel): q (B, N, D), k (B, M, D) in the body's type, v (B, M)
// float32 -> out (B, N) = sum_m softmax_m(q_n . k_m) v_m and lse (B, N) =
// log sum_m exp(q_n . k_m), both float32. The (N, M) similarity never exists
// in device memory (at the indoor request it would be 4.9 GB a pair).
//
// A block owns a tile of query rows and walks the keys in tiles, in order,
// with a flash-style online softmax: each row keeps its running max m, sum l
// and accumulator acc in float32, rescaled by exp(m_old - m_new) when the max
// grows; at the end out = acc / l and lse = m + log l. Keys past M are never
// read: their logits are replaced by -inf and their p by 0 (a select, not a
// product), so no padding value can reach a sum.
//
//  - bf16 (wproject_bf16_kernel, D in {64, 128, 256, 512}): 8 warps, 128
//    query rows, 16 a warp. A warp keeps its rows of q as mma.sync A
//    fragments in registers for the whole call (D / 16 fragments: 128
//    registers at D = 512), staged once through shared memory. Key tiles of
//    32 rows stream through a double buffer in shared memory with cp.async,
//    the next tile in flight while this one is multiplied. The (16, 32)
//    logits of a warp come from mma.sync m16n8k16 (bf16 products, exact,
//    summed in float32) with B fragments from ldmatrix, and the online
//    softmax runs on the accumulator fragments in registers; the four lanes
//    of a row combine their maxima with shuffles and their sums at the end.
//  - float32 (wproject_f32_kernel, D a multiple of 32): 64 query rows and
//    keys in tiles of 64, the logit tile on the CUDA cores (each thread 4
//    rows by 8 keys over 32-feature chunks staged in shared memory), then
//    through shared memory to the softmax step, two threads a row.
//
// Bound: operations. 2 D flops a (query, key) pair at the tensor cores' rate,
// against (N + M) D elements read and 8 bytes written a row. The bf16 kernel
// reads each fragment of k from shared memory with ldmatrix once per warp:
// shared-memory bandwidth, not the tensor cores, limits it; wgmma with k
// tiles fed by TMA is the way to the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

// ---------------------------------------------------------------- bf16

#define BQ 128    // query rows a block (8 warps x 16)
#define BK 32     // keys a tile
#define BNT 256   // threads a block

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices from shared memory: lanes 8i..8i+7 give the rows of
// matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16 bytes global -> shared without registers; zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(valid ? 16 : 0));
}

// key rows [m0, m0 + BK) of k (B's rows: (M, D)) into a (BK, D + 8) buffer
template <int D>
__device__ __forceinline__ void load_keys(__nv_bfloat16* buf,
                                          const __nv_bfloat16* __restrict__ kb,
                                          int m0, int M) {
  constexpr int PER_ROW = D / 8;                 // 16-byte pieces a row
  for (int e = threadIdx.x; e < BK * PER_ROW; e += BNT) {
    const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
    const bool valid = m0 + r < M;
    cp_async16(buf + r * (D + 8) + c,
               kb + (valid ? (size_t)(m0 + r) * D + c : 0), valid);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int D>
__global__ void __launch_bounds__(BNT, 1)
wproject_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ lse, int N, int M) {
  constexpr int KS = D / 16;                 // k-steps of one logit
  constexpr int QC = D < 128 ? D : 128;      // q columns a staging round
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const int b = blockIdx.y, n0 = blockIdx.x * BQ, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const __nv_bfloat16* qb = q + (size_t)b * N * D;
  const __nv_bfloat16* kb = k + (size_t)b * M * D;
  const float* vb = v + (size_t)b * M;

  // this warp's 16 rows of q as A fragments, staged through shared memory
  uint32_t qa[KS][4];
#pragma unroll
  for (int d0 = 0; d0 < D; d0 += QC) {
    for (int e = tid; e < BQ * QC / 8; e += BNT) {
      const int r = e / (QC / 8), c = (e % (QC / 8)) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + r < N)
        val = *reinterpret_cast<const uint4*>(qb + (size_t)(n0 + r) * D + d0 + c);
      *reinterpret_cast<uint4*>(sm + r * (QC + 8) + c) = val;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < QC / 16; ++s)
      ldsm_x4(qa[d0 / 16 + s], sm + (warp * 16 + (lane % 8) + ((lane >> 3) & 1) * 8) * (QC + 8)
                                   + s * 16 + (lane >> 4) * 8);
    __syncthreads();
  }

  __nv_bfloat16* kbuf[2] = {sm, sm + BK * (D + 8)};
  const int n_tiles = (M + BK - 1) / BK;
  load_keys<D>(kbuf[0], kb, 0, M);
  float m_run[2] = {-CUDART_INF_F, -CUDART_INF_F};  // rows g and g + 8
  float l_run[2] = {0.f, 0.f}, a_run[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    const int m0 = j * BK;
    if (j + 1 < n_tiles) {
      load_keys<D>(kbuf[(j + 1) & 1], kb, m0 + BK, M);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    const __nv_bfloat16* kt = kbuf[j & 1];
    float s[BK / 8][4];
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        uint32_t bf[4];  // n-tiles 2 np and 2 np + 1, feature halves 0 and 1
        ldsm_x4(bf, kt + (np * 16 + (lane % 8) + (lane >> 4) * 8) * (D + 8)
                        + ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[ks], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qa[ks], bf[2], bf[3]);
      }
    }
    // online softmax over this tile's 32 keys; lane holds keys 2t, 2t + 1
    // of each 8-key n-tile, for rows g (s[.][0..1]) and g + 8 (s[.][2..3])
    float vv[BK / 8][2], mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = m0 + nt * 8 + 2 * t + e;
        const bool valid = col < M;
        vv[nt][e] = valid ? vb[col] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!valid) s[nt][2 * h + e] = -CUDART_INF_F;
          mx[h] = fmaxf(mx[h], s[nt][2 * h + e]);
        }
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);  // finite: a tile has a key
      const float alpha = expf(m_run[h] - m_new);  // 0 on the first tile
      float ps = 0.f, pv = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float sv = s[nt][2 * h + e];
          const float p = sv == -CUDART_INF_F ? 0.f : expf(sv - m_new);
          ps += p;
          pv = fmaf(p, vv[nt][e], pv);
        }
      l_run[h] = fmaf(l_run[h], alpha, ps);
      a_run[h] = fmaf(a_run[h], alpha, pv);
      m_run[h] = m_new;
    }
    __syncthreads();   // the buffer of this tile is refilled next trip
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    a_run[h] += __shfl_xor_sync(0xffffffffu, a_run[h], 1);
    a_run[h] += __shfl_xor_sync(0xffffffffu, a_run[h], 2);
    const int n = n0 + warp * 16 + g + 8 * h;
    if (t == 0 && n < N) {
      out[(size_t)b * N + n] = a_run[h] / l_run[h];
      lse[(size_t)b * N + n] = m_run[h] + logf(l_run[h]);
    }
  }
}

template <int D>
static cudaError_t launch_bf16(const void* q, const void* k, const float* v,
                               float* out, float* lse, int B, int N, int M,
                               cudaStream_t stream) {
  constexpr int QC = D < 128 ? D : 128;
  const int kbytes = 2 * BK * (D + 8) * 2, qbytes = BQ * (QC + 8) * 2;
  const int smem = kbytes > qbytes ? kbytes : qbytes;
  cudaError_t err = cudaFuncSetAttribute(
      wproject_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  wproject_bf16_kernel<D><<<dim3((N + BQ - 1) / BQ, B), BNT, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, v, out, lse, N, M);
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
                               float* out, float* lse, int B, int N, int M,
                               int D, int is_bf16, void* stream_ptr) {
  if (B < 1 || N < 1 || M < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (is_bf16) {
    switch (D) {
      case 64: return (int)launch_bf16<64>(q, k, v, out, lse, B, N, M, stream);
      case 128: return (int)launch_bf16<128>(q, k, v, out, lse, B, N, M, stream);
      case 256: return (int)launch_bf16<256>(q, k, v, out, lse, B, N, M, stream);
      case 512: return (int)launch_bf16<512>(q, k, v, out, lse, B, N, M, stream);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (D < FDC || D % FDC != 0) return (int)cudaErrorInvalidValue;
  wproject_f32_kernel<<<dim3((N + FQ - 1) / FQ, B), FNT, 0, stream>>>(
      (const float*)q, (const float*)k, v, out, lse, N, M, D);
  return (int)cudaGetLastError();
}
