// Brute-force exact kNN (k <= 8) of each query over a ref cloud.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/knn.py::_knn_kernel
// (pallas_call at knn.py:134). On the slice's path it is the three-NN search
// of every feature-propagation level, the largest being 8192 queries over
// 1024 refs (FP level 4).
//
// Design: one thread per query; ref tiles of 1024 points staged through
// shared memory (read once per block, then broadcast to every lane); a
// sorted top-K kept in registers (K a template parameter, fully unrolled so
// nothing spills); refs scanned in index order with strict '<' insertion, so
// ties go to the lower index, as jax.lax.top_k and the Pallas merge do.
//
// Bound on the H100: operations, 9 f32 operations per query-ref pair (3 sub,
// 3 mul, 2 add, 1 compare) on the CUDA cores; the bytes (inputs read once,
// outputs written once) weigh less. chip_smoke.py computes the bound from
// the run's shapes. At the slice's shapes the grid is small (M/64 blocks),
// so the kernel runs far from either roof, bound by latency.
#include "common.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kBlock = 64;

template <int K>
__global__ void knn_brute_kernel(const float* __restrict__ q,
                                 const float* __restrict__ r, int M, int N,
                                 float* __restrict__ out_d,
                                 int* __restrict__ out_i) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  const bool active = m < M;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qp = q + 3 * ((size_t)b * M + m);
    qx = qp[0];
    qy = qp[1];
    qz = qp[2];
  }
  float bd[K];
  int bi[K];
#pragma unroll
  for (int s = 0; s < K; ++s) {
    bd[s] = __int_as_float(0x7f800000);  // +inf
    bi[s] = 0;
  }
  mvp_scan_refs<K, kTile>(r + 3 * (size_t)b * N, 0, N, active, qx, qy, qz, bd,
                          bi, tile);
  if (active) {
    const size_t o = ((size_t)b * M + m) * K;
#pragma unroll
    for (int s = 0; s < K; ++s) {
      out_d[o + s] = bd[s];
      out_i[o + s] = bi[s];
    }
  }
}

template <int K>
void launch(const float* q, const float* r, int B, int M, int N, float* d,
            int* i, cudaStream_t st) {
  dim3 grid((M + kBlock - 1) / kBlock, B);
  knn_brute_kernel<K><<<grid, kBlock, 0, st>>>(q, r, M, N, d, i);
}

}  // namespace

// q (B, M, 3) f32, r (B, N, 3) f32 contiguous -> out_d (B, M, k) f32
// ascending squared distances, out_i (B, M, k) int32. Returns cudaError_t.
extern "C" int knn_brute(const float* q, const float* r, int B, int M, int N,
                         int k, float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  switch (k) {
    case 1: launch<1>(q, r, B, M, N, out_d, out_i, st); break;
    case 2: launch<2>(q, r, B, M, N, out_d, out_i, st); break;
    case 3: launch<3>(q, r, B, M, N, out_d, out_i, st); break;
    case 4: launch<4>(q, r, B, M, N, out_d, out_i, st); break;
    case 5: launch<5>(q, r, B, M, N, out_d, out_i, st); break;
    case 6: launch<6>(q, r, B, M, N, out_d, out_i, st); break;
    case 7: launch<7>(q, r, B, M, N, out_d, out_i, st); break;
    case 8: launch<8>(q, r, B, M, N, out_d, out_i, st); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
