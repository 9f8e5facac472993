// Fixed-K ball query: the first K points within the radius, in index order.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/ballquery.py::_bq_kernel
// (pallas_call at ballquery.py:145). On the chunk and train paths it groups
// SA1-SA4 (SA1: 1024 centers over 8192 points, r = 0.1, K = 32); on the
// whole-scene path at the high-resolution config, SA1-SA4 (SA1: 8192
// centers over 102,400 points).
//
// Contract (mvpnet_tpu/ops/reference.py:130): slots [0, count) hold the first
// in-radius points in index order, the rest repeat the first hit; an empty
// ball falls back to the nearest point (lower index on ties); count =
// min(hits, K). Masked points arrive at the 1e9 sentinel from the wrapper.
// r2 is float32(radius**2), as ballquery.py:140 rounds it.
//
// Design: one block of kWarps warps serves C consecutive centers of a row
// (C <= 32, from the wrapper: ops/ballquery.py::centers_per_block lowers C
// until the grid has about two blocks an SM). It walks the row's points in
// tiles of kTile, in index order; each lane holds kLanePoints points of the
// tile in registers, loaded once per block (the next tile's loads are in
// flight while the current one is scanned), so every point is read from
// device memory once per block of centers, not once per center. A tile is
// 32 chunks of 32 points; chunk ch = warp * kLanePoints + q, point
// base + 32 * ch + lane. For each tile:
//   1. every warp loops over the block's centers (broadcast from shared
//      memory) that are not yet full, and ballots its chunks: the mask of
//      (center, chunk) goes to shared memory;
//   2. one __syncthreads();
//   3. the warp of center c (c mod kWarps) takes the 32 chunk masks, one a
//      lane: a hit's slot is the center's count, plus the hits of the chunks
//      before it (a warp prefix sum of __popc), plus its rank in its chunk;
//      slots below K are written (the rank of the TPU kernel, ballquery.py
//      :83-104). The first hit of a ball is kept for the padding.
//   4. one __syncthreads(); the block stops once every one of its centers
//      has K hits. That is exact: later hits could only take slots >= K. A
//      full center is skipped inside the tile.
// An empty ball has seen every point; its warp then walks the row once more
// for the nearest point (lower index on ties), as the plain version does.
//
// Bound on the H100: operations, 9 f32 operations per (center, point) pair
// the data needs (each center up to its K-th hit, else every point), against
// the bytes of the inputs read once and the outputs written once;
// chip_smoke.py computes it from the run. The kernel executes about 12
// instructions a pair it scans, and scans whole tiles for every center not
// yet full: on an H100 80GB HBM3 at 700 W it takes 1.55-1.57 ms of device
// time at config #4's SA1 (4 x 8192 centers over 102,400 points) against a
// 0.30 ms bound and 4.63-4.66 ms for the former kernel (one warp a center,
// 12-byte loads from L2 for every center). The same design with each tile
// staged in shared memory by coalesced loads took 1.72-1.77 ms with CUDA
// events (this one 1.61-1.70), and one whose whole warp wrote a chunk's
// hits in step 3 took 1.64-1.65 ms of device time. Only at the smallest
// launch (16 centers over 64 points) is it slower than the former kernel,
// 2.1-2.5 against 1.6-1.7 us: its chain of barriers and passes is longer
// than the former kernel's single 32-point step (PERF.md).
#include "common.cuh"

namespace {

// mirrored by mvpnet_torch/ops/ballquery.py (TILE, CHUNK, MAX_CENTERS)
constexpr int kWarps = 8;
constexpr int kLanePoints = 4;
constexpr int kChunks = kWarps * kLanePoints;  // 32: one a lane in step 3
constexpr int kTile = 32 * kChunks;
constexpr int kMaxCenters = 32;  // one a lane in the fullness ballot

__global__ void __launch_bounds__(32 * kWarps)
ball_query_kernel(const float* __restrict__ centers, const float* __restrict__ pts, int M, int N,
                  float r2, int K, int C, int* __restrict__ out_idx, int* __restrict__ out_cnt) {
  __shared__ float4 s_center[kMaxCenters];
  __shared__ unsigned s_mask[kMaxCenters][kChunks + 1];  // +1: no bank conflicts either way
  __shared__ int s_count[kMaxCenters];
  __shared__ int s_first[kMaxCenters];

  const int b = blockIdx.y;
  const int m0 = blockIdx.x * C;
  const int nc = min(C, M - m0);  // this block's centers
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = pts + 3 * (size_t)b * N;
  int* o = out_idx + ((size_t)b * M + m0) * K;  // center c's slots at o + c * K
  const float inf = __int_as_float(0x7f800000);

  if (tid < kMaxCenters) {
    if (tid < nc) {
      const float* c = centers + 3 * ((size_t)b * M + m0 + tid);
      s_center[tid] = make_float4(c[0], c[1], c[2], 0.f);
    }
    s_count[tid] = tid < nc ? 0 : K;  // a missing center counts as full
    s_first[tid] = 0;
  }

  // this lane's points of a tile; past N at +inf, which is in no ball
  float px[kLanePoints], py[kLanePoints], pz[kLanePoints];
  float nx[kLanePoints], ny[kLanePoints], nz[kLanePoints];
  auto load = [&](int base) {
#pragma unroll
    for (int q = 0; q < kLanePoints; ++q) {
      const int j = base + 32 * (warp * kLanePoints + q) + lane;
      nx[q] = ny[q] = nz[q] = inf;
      if (j < N) {
        nx[q] = p[3 * j];
        ny[q] = p[3 * j + 1];
        nz[q] = p[3 * j + 2];
      }
    }
  };
  load(0);
  __syncthreads();

  for (int base = 0; base < N; base += kTile) {
    // the same counts in every warp (read after the last barrier): the
    // block leaves together once all its centers are full
    const unsigned full = __ballot_sync(MVP_FULL_MASK, s_count[lane] >= K);
    if (full == MVP_FULL_MASK) break;
#pragma unroll
    for (int q = 0; q < kLanePoints; ++q) {
      px[q] = nx[q];
      py[q] = ny[q];
      pz[q] = nz[q];
    }
    load(base + kTile);  // in flight while this tile is scanned

    // 1. the hit masks of this warp's chunks, center by center; lane c keeps
    // center c's
    unsigned mine[kLanePoints];
#pragma unroll
    for (int q = 0; q < kLanePoints; ++q) mine[q] = 0u;
    for (int c = 0; c < nc; ++c) {
      if ((full >> c) & 1u) continue;
      const float4 cc = s_center[c];
#pragma unroll
      for (int q = 0; q < kLanePoints; ++q) {
        const unsigned m = __ballot_sync(MVP_FULL_MASK, mvp_sqdist(cc.x, cc.y, cc.z, px[q], py[q], pz[q]) < r2);
        if (lane == c) mine[q] = m;
      }
    }
    if (lane < nc) {
#pragma unroll
      for (int q = 0; q < kLanePoints; ++q) s_mask[lane][warp * kLanePoints + q] = mine[q];
    }
    __syncthreads();

    // 3. slots: the warp of center c, one chunk a lane
    for (int c = warp; c < nc; c += kWarps) {
      const int cnt = s_count[c];
      if (cnt >= K) continue;
      const unsigned m = s_mask[c][lane];
      const int pc = __popc(m);
      int incl = pc;  // hits in chunks <= lane
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(MVP_FULL_MASK, incl, off);
        if (lane >= off) incl += t;
      }
      const int total = __shfl_sync(MVP_FULL_MASK, incl, 31);
      int slot = cnt + incl - pc;
      for (unsigned left = m; left != 0u && slot < K; left &= left - 1u, ++slot)
        o[c * K + slot] = base + 32 * lane + __ffs(left) - 1;
      const unsigned chunks_hit = __ballot_sync(MVP_FULL_MASK, m != 0u);
      if (cnt == 0 && chunks_hit != 0u) {
        const int ch = __ffs(chunks_hit) - 1;
        const unsigned first_mask = __shfl_sync(MVP_FULL_MASK, m, ch);
        if (lane == 0) s_first[c] = base + 32 * ch + __ffs(first_mask) - 1;
      }
      if (lane == 0) s_count[c] = cnt + total;
    }
    __syncthreads();
  }

  // counts, padding, and the nearest point of an empty ball
  for (int c = warp; c < nc; c += kWarps) {
    const int cnt = min(s_count[c], K);
    int first = s_first[c];
    if (cnt == 0) {
      const float4 cc = s_center[c];
      float near_d = inf;
      int near_i = INT_MAX;
      for (int j = lane; j < N; j += 32) {  // a lane's j only ascends
        const float d = mvp_sqdist(cc.x, cc.y, cc.z, p[3 * j], p[3 * j + 1], p[3 * j + 2]);
        if (d < near_d || near_i == INT_MAX) {
          near_d = d;
          near_i = j;
        }
      }
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
    for (int s = cnt + lane; s < K; s += 32) o[c * K + s] = first;
    if (lane == 0) out_cnt[(size_t)b * M + m0 + c] = cnt;
  }
}

}  // namespace

// centers (B, M, 3), pts (B, N, 3) f32 contiguous -> out_idx (B, M, K) int32,
// out_cnt (B, M) int32; centers_per_block in [1, 32]
// (ops/ballquery.py::centers_per_block). Returns cudaError_t.
extern "C" int ball_query(const float* centers, const float* pts, int B, int M, int N, float r2,
                          int K, int centers_per_block, int* out_idx, int* out_cnt, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (N <= 0 || K <= 0 || centers_per_block < 1 || centers_per_block > kMaxCenters || B > 65535)
    return cudaErrorInvalidValue;
  const dim3 grid((M + centers_per_block - 1) / centers_per_block, B);
  ball_query_kernel<<<grid, 32 * kWarps, 0, st>>>(centers, pts, M, N, r2, K, centers_per_block,
                                                  out_idx, out_cnt);
  return cudaGetLastError();
}
