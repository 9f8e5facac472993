// The Morton prep of the gated fusion kNN (rows 6 and 7) on the card.
//
// Replaces the jnp preparation mvpnet_tpu/ops/pallas/knn_bucketed.py::
// _prepare (:693-741, outside any Pallas kernel) and the un-mapping _unmap
// (:610): its plain version is mvpnet_torch/ops/morton.py::prepare, which the
// tests hold against _prepare, and ops/morton.py::prepare_device calls these
// two entry points, eight launches in all:
//   morton_sort   the per-row query box (morton_box_kernel, which also
//                 clears the sort's histograms), then the 30-bit Morton code
//                 of every query and ref over it (morton_codes_kernel), in
//                 morton_code's f32 arithmetic to the bit: subtract, divide
//                 by max(hi - lo, 1e-12) correctly rounded, clamp to [0,
//                 f32(1 - 1e-7)], times 1024, truncate. A ref's key has bit
//                 30 set, so that one stable sort of a row's keys puts the
//                 queries in their Morton order first and the refs in theirs
//                 after them. The sort is an LSD radix sort, 8 bits a pass,
//                 four passes (morton_sort_pass_kernel): each block takes a
//                 tile of 4096 keys in index order, finds its digits' places
//                 from the per-tile digit counts (written by the codes kernel
//                 for the first pass, by the pass before for the others),
//                 ranks equal digits in index order (a warp match, then the
//                 warps and rounds in order), so each pass is stable, and
//                 counts the next digit of each key at the tile it lands in;
//   morton_tiles  one block a tile gathers the sorted points as float4 with
//                 the original index's bits in .w, pads with 3e9 and writes
//                 the tile's box over its real points (|c| < 1e5)
//                 (morton_gather_kernel); then one block a query tile writes
//                 its bound to every ref tile and ranks them by (bound, tile)
//                 in shared memory: a stable sort, the visit order
//                 (morton_order_kernel).
// The search kernels read q4.w and r4.w to write the original order, so the
// plain chain's inverse permutation and three gathers have no counterpart.
//
// Bound on the H100: bytes (each input read once, each output written once);
// the sort moves each key and index 4 times, and the rank of a query tile's
// Nt bounds takes Nt^2 compares, 22,500 at the scene's 150 ref tiles.
#include "common.cuh"

namespace {

constexpr float kSentinelMin = 1e5f;
constexpr float kPadCoord = 3e9f;
constexpr float kCellMax = 0.99999988079071044921875f;  // f32(1 - 1e-7)
constexpr int kThreads = 256;
constexpr int kBoxThreads = 1024;
// the radix sort: keys a tile (a block), bits a pass, passes
constexpr int kSortTile = 4096;
constexpr int kDigits = 256;
constexpr int kPasses = 4;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ int spread10(int v) {  // 10 bits -> every third bit
  v = (v | (v << 16)) & 0x030000FF;
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ __forceinline__ bool real_point(float x, float y, float z) {
  return fabsf(x) < kSentinelMin && fabsf(y) < kSentinelMin && fabsf(z) < kSentinelMin;
}

// lo / hi (3 each) to their min / max over the block, in thread 0. `red`
// holds 6 floats a warp.
__device__ __forceinline__ void block_box(float (&lo)[3], float (&hi)[3], float* red) {
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    lo[d] = mvp_group_min<32>(lo[d]);
    hi[d] = mvp_group_max<32>(hi[d]);
  }
  if ((threadIdx.x & 31) == 0) {
    float* w = red + 6 * (threadIdx.x >> 5);
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      w[d] = lo[d];
      w[3 + d] = hi[d];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        lo[d] = fminf(lo[d], red[6 * w + d]);
        hi[d] = fmaxf(hi[d], red[6 * w + 3 + d]);
      }
    }
  }
}

// box (B, 6): each row's query box (lo, hi) over all its queries, as
// q.amin / q.amax
__global__ void __launch_bounds__(kBoxThreads) morton_box_kernel(const float* __restrict__ q, int M, int T,
                                                                 float* __restrict__ box, int* __restrict__ hist) {
  __shared__ float red[6 * 32];
  // the digit counts of passes 1-3 of this row, which the passes add to
  for (int p = 1; p < kPasses; ++p) {
    int* h = hist + ((size_t)p * gridDim.x + blockIdx.x) * T * kDigits;
    for (int i = threadIdx.x; i < T * kDigits; i += blockDim.x) h[i] = 0;
  }
  const float inf = __int_as_float(0x7f800000);
  const float* qb = q + (size_t)blockIdx.x * M * 3;
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int i = threadIdx.x; i < M; i += blockDim.x) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float v = qb[3 * i + d];
      lo[d] = fminf(lo[d], v);
      hi[d] = fmaxf(hi[d], v);
    }
  }
  block_box(lo, hi, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      box[6 * blockIdx.x + d] = lo[d];
      box[6 * blockIdx.x + 3 + d] = hi[d];
    }
  }
}

// keys (B, S) and idx (B, S): the Morton code of query i < M, and of ref
// i - M with bit 30 set (S = M + N; S = M when the refs keep their order),
// beside i; hist (kPasses, B, T, 256): each tile's count of the keys'
// lowest digit. One block a tile of kSortTile keys.
__global__ void __launch_bounds__(kThreads) morton_codes_kernel(const float* __restrict__ q,
                                                               const float* __restrict__ r,
                                                               const float* __restrict__ box, int M, int N,
                                                               int S, int* __restrict__ keys,
                                                               int* __restrict__ idx, int* __restrict__ hist) {
  __shared__ int count[kDigits];
  const int b = blockIdx.y;
  const int T = gridDim.x;
  count[threadIdx.x] = 0;
  __syncthreads();
  const float* bx = box + 6 * b;
  const int end = min(S, (int)(blockIdx.x + 1) * kSortTile);
  for (int i = blockIdx.x * kSortTile + threadIdx.x; i < end; i += kThreads) {
    const float* p = i < M ? q + 3 * ((size_t)b * M + i) : r + 3 * ((size_t)b * N + (i - M));
    int code = 0;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float scale = fmaxf(__fsub_rn(bx[3 + d], bx[d]), 1e-12f);
      const float t = fminf(fmaxf(__fdiv_rn(__fsub_rn(p[d], bx[d]), scale), 0.f), kCellMax);
      code |= spread10(__float2int_rz(__fmul_rn(t, 1024.f))) << d;
    }
    const int key = i < M ? code : code | (1 << 30);
    keys[(size_t)b * S + i] = key;
    idx[(size_t)b * S + i] = i;
    atomicAdd(&count[key & (kDigits - 1)], 1);
  }
  __syncthreads();
  hist[((size_t)b * T + blockIdx.x) * kDigits + threadIdx.x] = count[threadIdx.x];
}

// One stable pass of the radix sort on digit `pass` (bits 8 pass .. 8 pass +
// 7) of (keys, idx) (B, S) into (keys_out, idx_out); one block a tile of
// kSortTile keys in index order. hist (kPasses, B, T, 256) holds each tile's
// digit counts for this pass (read) and the next (added to).
__global__ void __launch_bounds__(kThreads) morton_sort_pass_kernel(const int* __restrict__ keys,
                                                                   const int* __restrict__ idx, int S, int pass,
                                                                   int* __restrict__ keys_out,
                                                                   int* __restrict__ idx_out,
                                                                   int* __restrict__ hist) {
  __shared__ int base[kDigits];             // where the tile's next key of each digit goes
  __shared__ int wcount[kWarps][kDigits];   // a round's keys of each digit, by warp
  __shared__ int scan[kDigits];
  const int b = blockIdx.y;
  const int T = gridDim.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int shift = 8 * pass;
  const int B = gridDim.y;
  // this digit's keys before this tile, and in the whole row
  const int* h = hist + ((size_t)pass * B + b) * T * kDigits;
  int before = 0, total = 0;
  for (int t = 0; t < T; ++t) {
    const int c = h[(size_t)t * kDigits + tid];
    before += t < (int)blockIdx.x ? c : 0;
    total += c;
  }
  // exclusive scan of the totals over the digits (Hillis-Steele in shared memory)
  scan[tid] = total;
  __syncthreads();
  for (int o = 1; o < kDigits; o <<= 1) {
    const int v = tid >= o ? scan[tid - o] : 0;
    __syncthreads();
    scan[tid] += v;
    __syncthreads();
  }
  base[tid] = scan[tid] - total + before;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) wcount[w][tid] = 0;
  __syncthreads();
  int* next = pass + 1 < kPasses ? hist + ((size_t)(pass + 1) * B + b) * T * kDigits : nullptr;
  const unsigned lower = (1u << lane) - 1;
  const size_t row = (size_t)b * S;
  const int start = blockIdx.x * kSortTile;
  for (int r0 = start; r0 < min(S, start + kSortTile); r0 += kThreads) {
    const int e = r0 + tid;
    const bool valid = e < S;
    const int key = valid ? keys[row + e] : 0;
    const int d = valid ? (key >> shift) & (kDigits - 1) : -1;
    const unsigned peers = __match_any_sync(MVP_FULL_MASK, d);
    const int rank = __popc(peers & lower);
    if (valid && rank == 0) wcount[warp][d] = __popc(peers);
    __syncthreads();
    int dest = -1;
    if (valid) {
      dest = base[d] + rank;
      for (int w = 0; w < warp; ++w) dest += wcount[w][d];
      keys_out[row + dest] = key;
      idx_out[row + dest] = idx[row + e];
    }
    if (next != nullptr) {  // the next digit's count at the tile the key lands in
      const int v = valid ? (dest / kSortTile) * kDigits + ((key >> (shift + 8)) & (kDigits - 1)) : -1;
      const unsigned same = __match_any_sync(MVP_FULL_MASK, v);
      if (valid && __popc(same & lower) == 0) atomicAdd(&next[v], __popc(same));
    }
    __syncthreads();
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      sum += wcount[w][tid];
      wcount[w][tid] = 0;
    }
    base[tid] += sum;
    __syncthreads();
  }
}

// One block a tile: blockIdx.x < Mt a query tile, else a ref tile. perm (B,
// S) int32, the stable sort's permutation of the keys.
__global__ void morton_gather_kernel(const float* __restrict__ q, const float* __restrict__ r,
                                    const int* __restrict__ perm, int M, int N, int S, int M_pad,
                                    int N_pad, int tile_m, int tile_n, int sort_refs, float4* __restrict__ q4,
                                    float4* __restrict__ r4, float* __restrict__ qbox, float* __restrict__ rbox) {
  __shared__ float red[6 * (kThreads / 32)];
  const float inf = __int_as_float(0x7f800000);
  const int b = blockIdx.y;
  const int Mt = M_pad / tile_m;
  const bool is_q = (int)blockIdx.x < Mt;
  const int t = is_q ? blockIdx.x : blockIdx.x - Mt;
  const int tile = is_q ? tile_m : tile_n;
  const int n = is_q ? M : N;
  const int* pb = perm + (size_t)b * S;
  const float* src = is_q ? q + (size_t)b * M * 3 : r + (size_t)b * N * 3;
  float4* dst = is_q ? q4 + (size_t)b * M_pad : r4 + (size_t)b * N_pad;
  // a pad ref names the last sorted ref, as unmap clamps a sorted index to
  // N - 1; a pad query row is written nowhere
  const int pad_index = is_q ? -1 : (sort_refs ? pb[M + N - 1] - M : N - 1);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  for (int i = threadIdx.x; i < tile; i += blockDim.x) {
    const int s = t * tile + i;
    float4 v = make_float4(kPadCoord, kPadCoord, kPadCoord, __int_as_float(pad_index));
    if (s < n) {
      const int orig = is_q ? pb[s] : (sort_refs ? pb[M + s] - M : s);
      const float* p = src + 3 * (size_t)orig;
      v = make_float4(p[0], p[1], p[2], __int_as_float(orig));
      if (real_point(v.x, v.y, v.z)) {
        lo[0] = fminf(lo[0], v.x);
        lo[1] = fminf(lo[1], v.y);
        lo[2] = fminf(lo[2], v.z);
        hi[0] = fmaxf(hi[0], v.x);
        hi[1] = fmaxf(hi[1], v.y);
        hi[2] = fmaxf(hi[2], v.z);
      }
    }
    dst[s] = v;
  }
  block_box(lo, hi, red);
  if (threadIdx.x == 0) {
    float* out = is_q ? qbox + ((size_t)b * Mt + t) * 6 : rbox + ((size_t)b * (N_pad / tile_n) + t) * 6;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      out[d] = lo[d];
      out[3 + d] = hi[d];
    }
  }
}

// One block a query tile: its bound to each ref tile (mvp_box_sqdist, as
// morton.box_sqdist rounds it), then each bound's rank among them by
// (bound, tile), where it is written: order and lb_sorted (B, Mt, Nt).
__global__ void morton_order_kernel(const float* __restrict__ qbox, const float* __restrict__ rbox, int Mt,
                                  int Nt, int* __restrict__ order, float* __restrict__ lb_sorted) {
  extern __shared__ float lb[];
  const int b = blockIdx.y;
  const int mt = blockIdx.x;
  const float* qb = qbox + ((size_t)b * Mt + mt) * 6;
  const float alo[3] = {qb[0], qb[1], qb[2]};
  const float ahi[3] = {qb[3], qb[4], qb[5]};
  const float* rb = rbox + (size_t)b * Nt * 6;
  for (int j = threadIdx.x; j < Nt; j += blockDim.x) lb[j] = mvp_box_sqdist(alo, ahi, rb + 6 * j, rb + 6 * j + 3);
  __syncthreads();
  const size_t out = ((size_t)b * Mt + mt) * Nt;
  for (int i = threadIdx.x; i < Nt; i += blockDim.x) {
    const float v = lb[i];
    int rank = 0;
    for (int j = 0; j < Nt; ++j) {
      const float w = lb[j];
      rank += (w < v) | ((w == v) & (j < i));
    }
    order[out + rank] = i;
    lb_sorted[out + rank] = v;
  }
}

}  // namespace

// q (B, M, 3), r (B, N, 3) f32 contiguous. Writes box (B, 6) f32, each row's
// query box, and sorts each row's keys: S = M + N (sort_refs) or M keys, T =
// ceil(S / 4096) tiles. keys, idx (2, B, S) int32 and hist (4, B, T, 256)
// int32 are scratch; after the call idx[0] (B, S) is the stable sort's
// permutation, the queries' Morton order, then the refs' (as M + their
// index). Returns cudaError_t.
extern "C" int morton_sort(const float* q, const float* r, int B, int M, int N, int sort_refs, float* box,
                           int* keys, int* idx, int* hist, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (N <= 0 || B > 65535) return cudaErrorInvalidValue;
  const int S = sort_refs ? M + N : M;
  const int T = (S + kSortTile - 1) / kSortTile;
  const size_t plane = (size_t)B * S;
  morton_box_kernel<<<B, kBoxThreads, 0, st>>>(q, M, T, box, hist);
  morton_codes_kernel<<<dim3(T, B), kThreads, 0, st>>>(q, r, box, M, N, S, keys, idx, hist);
  for (int p = 0; p < kPasses; ++p) {  // plane p % 2 to plane (p + 1) % 2: the last writes plane 0
    const size_t in = (p % 2) * plane, out = ((p + 1) % 2) * plane;
    morton_sort_pass_kernel<<<dim3(T, B), kThreads, 0, st>>>(keys + in, idx + in, S, p, keys + out, idx + out,
                                                             hist);
  }
  return cudaGetLastError();
}

// q, r as morton_sort's; perm (B, S) int32 its permutation (idx[0]). Writes q4 (B, M_pad, 4) and r4 (B, N_pad, 4) f32 (the sorted
// points, or the refs in their order without sort_refs, padded with 3e9;
// the original index's int32 bits in .w, -1 for a pad query row, the last
// sorted ref's for a pad ref), qbox (B, Mt, 6) and rbox (B, Nt, 6) f32 each
// tile's box over its real points ((+inf, -inf) when it has none), order
// (B, Mt, Nt) int32 and lb_sorted (B, Mt, Nt) f32 each query tile's ref
// tiles by ascending bound, ties to the lower tile. Returns cudaError_t.
extern "C" int morton_tiles(const float* q, const float* r, const int* perm, int B, int M, int N,
                            int M_pad, int N_pad, int tile_m, int tile_n, int sort_refs, float* q4, float* r4,
                            float* qbox, float* rbox, int* order, float* lb_sorted, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return cudaSuccess;
  if (N <= 0 || B > 65535 || tile_m <= 0 || tile_n <= 0 || M_pad % tile_m || N_pad % tile_n || M > M_pad ||
      N > N_pad || M_pad - M >= tile_m || N_pad - N >= tile_n)
    return cudaErrorInvalidValue;
  const int Mt = M_pad / tile_m;
  const int Nt = N_pad / tile_n;
  const size_t shared = (size_t)Nt * sizeof(float);
  if (shared > 232448) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(morton_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return err;
  morton_gather_kernel<<<dim3(Mt + Nt, B), kThreads, 0, st>>>(
      q, r, perm, M, N, sort_refs ? M + N : M, M_pad, N_pad, tile_m, tile_n, sort_refs,
      reinterpret_cast<float4*>(q4), reinterpret_cast<float4*>(r4), qbox, rbox);
  morton_order_kernel<<<dim3(Mt, B), kThreads, shared, st>>>(qbox, rbox, Mt, Nt, order, lb_sorted);
  return cudaGetLastError();
}
