// Fixed-K ball query: the first K points within the radius, in index order.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/ballquery.py::_bq_kernel
// (pallas_call at ballquery.py:145). On the slice's path it groups SA1:
// 1024 centers over 8192 points, r = 0.1, K = 32 (and SA2-SA4 below the TPU's
// size threshold).
//
// Contract (mvpnet_tpu/ops/reference.py:130): slots [0, count) hold the first
// in-radius points in index order, the rest repeat the first hit; an empty
// ball falls back to the nearest point (lower index on ties); count =
// min(hits, K). Masked points arrive at the 1e9 sentinel from the wrapper.
// r2 is float32(radius**2), as ballquery.py:140 rounds it.
//
// Design: one warp per center walks the points 32 at a time in index order.
// __ballot_sync gives the warp's hit mask; a hit's slot is the running count
// plus __popc(mask & lanemask_lt), the rank the TPU kernel builds with a
// prefix sum. The walk stops once the count reaches K: later hits could only
// take slots >= K, so the result is exact. Each lane tracks its nearest
// point on the way; only an empty ball, which walks every point, reads it.
//
// Bound on the H100: operations, 9 f32 operations per center-point pair
// actually visited (the walk ends early), over the bytes of the inputs read
// once and the outputs written once. chip_smoke.py counts the pairs this
// run's data needs and computes the bound from them.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void ball_query_kernel(const float* __restrict__ centers,
                                  const float* __restrict__ pts, int M, int N,
                                  float r2, int K, int* __restrict__ out_idx,
                                  int* __restrict__ out_cnt) {
  const int b = blockIdx.y;
  const int m = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (m >= M) return;  // warp-uniform: the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const unsigned lanes_below = (1u << lane) - 1u;
  const float* c = centers + 3 * ((size_t)b * M + m);
  const float cx = c[0], cy = c[1], cz = c[2];
  const float* p = pts + 3 * (size_t)b * N;
  int* o = out_idx + ((size_t)b * M + m) * K;

  int count = 0;
  int first = -1;
  float near_d = __int_as_float(0x7f800000);
  int near_i = INT_MAX;
  for (int base = 0; base < N && count < K; base += 32) {
    const int j = base + lane;
    bool hit = false;
    if (j < N) {
      const float d = mvp_sqdist(cx, cy, cz, p[3 * j], p[3 * j + 1], p[3 * j + 2]);
      hit = d < r2;
      if (d < near_d || near_i == INT_MAX) {  // a lane's j only ascends
        near_d = d;
        near_i = j;
      }
    }
    const unsigned mask = __ballot_sync(MVP_FULL_MASK, hit);
    if (hit) {
      const int slot = count + __popc(mask & lanes_below);
      if (slot < K) o[slot] = j;
    }
    if (first < 0 && mask != 0u) first = base + __ffs(mask) - 1;
    count += __popc(mask);
  }
  if (count == 0) {  // empty ball: the walk saw every point
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_down_sync(MVP_FULL_MASK, near_d, off);
      const int oi = __shfl_down_sync(MVP_FULL_MASK, near_i, off);
      if (od < near_d || (od == near_d && oi < near_i)) {
        near_d = od;
        near_i = oi;
      }
    }
    first = __shfl_sync(MVP_FULL_MASK, near_i, 0);
  }
  const int cnt = count < K ? count : K;
  for (int s = cnt + lane; s < K; s += 32) o[s] = first;
  if (lane == 0) out_cnt[(size_t)b * M + m] = cnt;
}

}  // namespace

// centers (B, M, 3), pts (B, N, 3) f32 contiguous -> out_idx (B, M, K) int32,
// out_cnt (B, M) int32. Returns cudaError_t.
extern "C" int ball_query(const float* centers, const float* pts, int B, int M,
                          int N, float r2, int K, int* out_idx, int* out_cnt,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (N <= 0 || K <= 0) return cudaErrorInvalidValue;
  dim3 grid((M + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  ball_query_kernel<<<grid, kWarpsPerBlock * 32, 0, st>>>(centers, pts, M, N,
                                                          r2, K, out_idx,
                                                          out_cnt);
  return cudaGetLastError();
}
