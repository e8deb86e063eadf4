// Position-encoding angle features for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_knn.py:posenc_angles_pallas
// (_angle_kernel): for every point p of a (B, N, 3) cloud, N <= 1024, and
// its k <= 32 nearest neighbours in ascending distance (ties to the lowest
// index), cos(angle(p -> neighbour, p -> centroid)) from float32
// coordinates, a coincident neighbour giving 0.
//
// It is the alpha-only instantiation of the selection the DGCNN kernels
// share (knn_select.cuh:knn_alpha_kernel with KNN = pk = k and no index
// output): one warp per query, the cloud in shared memory, the query's
// distance row in the warp's registers, k rounds of warp argmin-and-mask.
// The centroid is passed in, as the TPU kernel's is (the wrapper takes the
// cloud's mean as the plain version does, so that both use the same one).
// Distances are the fixed-order float32 form of knn_select.cuh, so the plain
// version (ops/cuda_posenc.py:posenc_angles_reference) picks the same
// neighbours.
//
// Bound: operations. Per query N distances (8 flops each) and k passes of
// N compares, against 12 bytes read and 4 k bytes written per point.
#include <cuda_runtime.h>

#include "knn_select.cuh"  // knn_alpha_kernel, MAXN, QPB

#define POSENC_KS(X)                                                        \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)      \
  X(14) X(15) X(16) X(17) X(18) X(19) X(20) X(21) X(22) X(23) X(24) X(25) \
  X(26) X(27) X(28) X(29) X(30) X(31) X(32)

extern "C" int posenc_angles_launch(const float* x, const float* centroid,
                                    float* alpha, int B, int N, int k,
                                    void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N > MAXN || k < 1 || k > N) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + QPB - 1) / QPB, B);
  switch (k) {
#define CASE(K)                                                              \
  case K:                                                                    \
    knn_alpha_kernel<K><<<grid, 256, 0, stream>>>(x, centroid, nullptr,      \
                                                  alpha, N, K);              \
    return (int)cudaGetLastError();
    POSENC_KS(CASE)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
