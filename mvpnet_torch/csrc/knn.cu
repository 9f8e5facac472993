// Brute-force exact kNN (k <= 8) of each query over a ref cloud.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/knn.py::_knn_kernel
// (pallas_call at knn.py:134). On the port's paths it is the three-NN search
// of every feature-propagation level. FP1 (a forward's input points over
// SA1's centers) is the largest: 8192 queries over 1024 refs a row on the
// chunk (B = 1) and train (B = 8) paths, 102,400 over 8192 on the scene path
// at the high-resolution config (B = 4); FP2-FP4 are 8 to 8000 times smaller.
//
// Contract (reference.knn): the k smallest squared distances (mvp_sqdist's
// order and rounding), ascending, ties to the lower index; equal bit for bit
// to the plain version.
//
// Bound on the H100: instructions. A (query, ref) pair costs 9 (3 sub, 3 mul,
// 2 add, 1 compare), each its own instruction on the CUDA cores since the
// build keeps products and sums apart (-fmad=false, for the plain version's
// rounding): 9 * pairs / 33.5e12 lane-instructions a second (132 SMs x 128
// lanes x 1.98 GHz). The bytes weigh far less: each ref tile is read once a
// block, mostly from L2.
//
// Design (ops/knn.py::layout picks lanes, queries a thread and the tile from
// the shape and the SM count):
//   * lanes a query: a group of `lanes` threads (a power of two, 1 to 32)
//     shares each query, and lane j scans quads j, j + lanes, ... of every
//     tile (a quad is 4 consecutive refs, 3 float4 in shared memory) into its
//     own register top-K with strict '<': its candidates arrive in ascending
//     index, so a tie stays with the lower index. merge_lanes (a shuffle
//     butterfly in (distance, index) order) then gives every lane the top-K
//     of the union, the stable-sort top-K exactly. The small searches (FP2-
//     FP4, the chunk's FP1) fill the card this way;
//   * queries a thread: each thread holds Q queries (1 or 2; 4 ran 11%
//     slower than 2 at the scene's FP1, PERF.md). One quad read from shared
//     memory feeds 4Q distances, and one combined compare with the K-th
//     distances guards the insertion path (mvp_topk_insert_select), so loads
//     and loop cost about 1.5 instructions a pair beside its 9 (cuobjdump
//     -sass at K = 3, Q = 2). The insertion path is the rest: a warp
//     takes it when any of its lanes has a candidate, which at the scene's
//     FP1 (32 queries of a warp anywhere in a 6 m window, 8192 refs in FPS
//     order) is a large share of the quads early in the scan;
//   * ref tiles come into a double buffer in shared memory by cp.async.bulk
//     (TMA) on an mbarrier, the next tile in flight while the current one is
//     scanned, where the row and the tile are 16-byte aligned (N a multiple
//     of 4); otherwise by plain cooperative loads, the last quad padded with
//     +inf refs, which are never inserted.
// K is a template parameter (1, 2, 3, 4 or 8; k = 5..7 keeps 8 and writes the
// first k) and every loop over K or Q is unrolled, so the lists stay in
// registers.
//
// Measured (profile_levels.py, device ms a launch, NVIDIA H100 80GB HBM3,
// 700.00 W; the former kernel, one thread a query in blocks of 64, in the
// same call in brackets): FP1-FP4 of the scene 1.466-1.475, 0.057, 0.0083-
// 0.0085, 0.0029 [1.951-1.961, 0.096-0.097, 0.028, 0.0092]; of the chunk
// request 0.0138-0.0139, 0.0034, 0.0024, 0.0020-0.0021 [0.0463-0.0466,
// 0.016, 0.0052, 0.0023]; of the train step 0.0564, 0.0054-0.0055, 0.0025,
// 0.0021 [0.061, 0.016, 0.0051-0.0052, 0.0023]. The scene's FP1 runs at 61%
// of its 0.90 ms instruction floor; the rest is the insertion path.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;   // ops/knn.py THREADS
constexpr int kMaxTile = 1024;  // refs a tile at most (ops/knn.py MAX_TILE): 24 KB double-buffered

struct Args {
  const float* q;
  const float* r;
  int B, M, N, k, lanes, tile, bulk;
  float* out_d;
  int* out_i;
};

template <int K, int Q>
__global__ void __launch_bounds__(kThreads) knn_brute_kernel(Args a) {
  extern __shared__ __align__(128) float4 buf[];  // two tiles of `tile` refs, packed xyz
  __shared__ __align__(8) uint64_t bar[2];
  const float inf = __int_as_float(0x7f800000);
  const int M = a.M, N = a.N, lanes = a.lanes, tile = a.tile;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & (lanes - 1);
  const int m0 = (blockIdx.x * (kThreads / lanes) + tid / lanes) * Q;  // this thread's first query
  float qx[Q], qy[Q], qz[Q];
  float bd[Q][K];
  int bi[Q][K];
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    // a query past M is a copy of the last one: it keeps the warp whole and is never written
    const float* qp = a.q + 3 * ((size_t)b * M + min(m0 + j, M - 1));
    qx[j] = qp[0];
    qy[j] = qp[1];
    qz[j] = qp[2];
#pragma unroll
    for (int s = 0; s < K; ++s) {
      bd[j][s] = inf;  // an unfilled slot: after every real entry
      bi[j][s] = INT_MAX;
    }
  }
  const float* rb = a.r + 3 * (size_t)b * N;
  const int tiles = (N + tile - 1) / tile;
  float* sbuf = reinterpret_cast<float*>(buf);
  if (a.bulk) {
    if (tid == 0) {
      bar_init(&bar[0]);
      bar_init(&bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) bulk_load(sbuf, rb, 12u * min(tile, N), &bar[0]);
  }
  // tile t lands in buffer t & 1 (on barrier t & 1, whose (t >> 1)-th phase it completes)
  for (int t = 0; t < tiles; ++t) {
    const int base = t * tile;
    const int cnt = min(tile, N - base);
    float* cur = sbuf + (t & 1) * 3 * tile;
    if (a.bulk) {
      if (tid == 0 && t + 1 < tiles)
        bulk_load(sbuf + ((t + 1) & 1) * 3 * tile, rb + 3 * (size_t)(base + tile),
                  12u * min(tile, N - base - tile), &bar[(t + 1) & 1]);
      bar_wait(&bar[t & 1], (t >> 1) & 1);
    } else {
      const int padded = 3 * ((cnt + 3) & ~3);
      for (int i = tid; i < padded; i += kThreads) cur[i] = i < 3 * cnt ? rb[3 * (size_t)base + i] : inf;
      __syncthreads();
    }
    const float4* quads = reinterpret_cast<const float4*>(cur);
    const int nq = (cnt + 3) >> 2;
    for (int u = lane; u < nq; u += lanes) {
      // refs 4u .. 4u + 3 of the tile: x0 y0 z0 x1 | y1 z1 x2 y2 | z2 x3 y3 z3
      const float4 p0 = quads[3 * u], p1 = quads[3 * u + 1], p2 = quads[3 * u + 2];
      const float rx[4] = {p0.x, p0.w, p1.z, p2.y};
      const float ry[4] = {p0.y, p1.x, p1.w, p2.z};
      const float rz[4] = {p0.z, p1.y, p2.x, p2.w};
      float d[Q][4];
      bool hit = false;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          d[j][i] = mvp_sqdist(qx[j], qy[j], qz[j], rx[i], ry[i], rz[i]);
          hit |= d[j][i] < bd[j][K - 1];
        }
      }
      if (hit) {  // rare once the lists fill: insert in index order
        const int j0 = base + 4 * u;
#pragma unroll
        for (int j = 0; j < Q; ++j) {
#pragma unroll
          for (int i = 0; i < 4; ++i) mvp_topk_insert_select<K>(bd[j], bi[j], d[j][i], j0 + i);
        }
      }
    }
    __syncthreads();  // buffer t & 1 is consumed before tile t + 2 comes into it
  }

#pragma unroll
  for (int j = 0; j < Q; ++j) {
    float md[K];
    int mi[K];
    merge_lanes<K>(bd[j], bi[j], md, mi, lanes);
    const int m = m0 + j;
    if (m < M && lane == (j & (lanes - 1))) {
      const size_t o = ((size_t)b * M + m) * a.k;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        if (s < a.k) {
          a.out_d[o + s] = md[s];
          a.out_i[o + s] = mi[s];
        }
      }
    }
  }
}

template <int K, int Q>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int per_block = (kThreads / a.lanes) * Q;
  const size_t shared = 2 * 12 * (size_t)a.tile;
  knn_brute_kernel<K, Q><<<dim3((a.M + per_block - 1) / per_block, a.B), kThreads, shared, st>>>(a);
  return cudaGetLastError();
}

template <int K>
cudaError_t launch_k(const Args& a, int per_thread, cudaStream_t st) {
  switch (per_thread) {
    case 1: return launch<K, 1>(a, st);
    case 2: return launch<K, 2>(a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, M, 3) f32, r (B, N, 3) f32 contiguous -> out_d (B, M, k) f32
// ascending squared distances, out_i (B, M, k) int32. Layout: `lanes` threads
// a query (a power of two, 1 to 32), `per_thread` queries a thread (1 or 2),
// `tile` refs a tile (a multiple of 4, at most 1024); `bulk` copies tiles
// with cp.async.bulk and needs N a multiple of 4 and r 16-byte aligned.
// Returns cudaError_t.
extern "C" int knn_brute(const float* q, const float* r, int B, int M, int N, int k, int lanes,
                         int per_thread, int tile, int bulk, float* out_d, int* out_i,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (k < 1 || k > 8 || k > N || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      tile < 4 || tile > kMaxTile || tile % 4 ||
      (bulk && (N % 4 || reinterpret_cast<uintptr_t>(r) % 16)))
    return cudaErrorInvalidValue;
  const Args a{q, r, B, M, N, k, lanes, tile, bulk, out_d, out_i};
  switch (k) {
    case 1: return launch_k<1>(a, per_thread, st);
    case 2: return launch_k<2>(a, per_thread, st);
    case 3: return launch_k<3>(a, per_thread, st);
    case 4: return launch_k<4>(a, per_thread, st);
    default: return launch_k<8>(a, per_thread, st);
  }
}
