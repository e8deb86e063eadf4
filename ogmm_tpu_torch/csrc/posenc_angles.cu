// Position-encoding angle features for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ogmm_tpu/ops/pallas_knn.py:posenc_angles_pallas
// (_angle_kernel): for every point p of a (B, N, 3) cloud, N <= 1024, and
// its k <= 32 nearest neighbours in ascending distance (ties to the lowest
// index), cos(angle(p -> neighbour, p -> centroid)) from float32
// coordinates, a coincident neighbour giving 0.
//
// It is the angles instantiation of the dense selection the kNN and DGCNN
// kernels share (knn_lanes.cuh:knn_kernel<K, GraphOut> with pk = k; no
// index output on the main path): the cloud in shared memory, 64 queries a
// block, four lanes a query with register lists, merged by rank; the lane
// that holds a neighbour of rank below k writes its angle. K is the compiled list length
// the wrapper chose (ops/cuda_knn.py:knn_compiled_k, the kNN kernel's
// KNN_KS); the first k of its K pairs are the k nearest. The centroid is
// passed in, as the TPU kernel's is (the wrapper takes the cloud's mean as
// the plain version does, so that both use the same one). Distances are the
// fixed-order float32 form of knn_select.cuh, so the plain version
// (ops/cuda_posenc.py:posenc_angles_reference) picks the same neighbours.
//
// Bound: operations. Per query N distances (8 flops each) and about one
// compare a candidate, against 12 bytes read and 4 k bytes written per point.
#include <cuda_runtime.h>

#include "knn_lanes.cuh"   // knn_launch_k, GraphOut
#include "knn_select.cuh"  // MAXN

#define POSENC_KS(X) X(1) X(5) X(20) X(32)

// idx: null (the main path), or (B, N, k) int32 the neighbours are written to
extern "C" int posenc_angles_launch(const float* x, const float* centroid,
                                    float* alpha, int* idx, int B, int N, int k,
                                    int K, void* stream_ptr) {
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  if (N > MAXN || k < 1 || k > N || K < k || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const GraphOut out{idx, alpha, centroid, k};
#define CASE(KK) \
  if (K == KK) return (int)knn_launch_k<KK>(x, x, out, B, N, N, k, stream);
  POSENC_KS(CASE)
#undef CASE
  return (int)cudaErrorInvalidValue;
}
