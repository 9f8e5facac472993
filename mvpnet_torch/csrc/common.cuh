// Device helpers shared by the point-cloud kernels.
//
// Distances are (dx*dx + dy*dy) + dz*dz with every product and sum rounded
// on its own (__fmul_rn/__fadd_rn are never contracted into an FMA), which
// is the order and rounding of the plain PyTorch versions in
// mvpnet_torch/ops/reference.py, so kernel and plain version agree bit for
// bit and their index choices are identical.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#define MVP_FULL_MASK 0xffffffffu

__device__ __forceinline__ float mvp_sqdist(float ax, float ay, float az,
                                            float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Insert (d, j) into a list sorted by (distance, index). Candidates arrive in
// ascending index order, so the strict '<' keeps an earlier (lower-index)
// entry ahead of an equal later one: ties go to the lower index.
template <int K>
__device__ __forceinline__ void mvp_topk_insert(float (&bd)[K], int (&bi)[K],
                                                float d, int j) {
  if (d < bd[K - 1]) {
    bd[K - 1] = d;
    bi[K - 1] = j;
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      if (bd[s] < bd[s - 1]) {
        const float td = bd[s];
        bd[s] = bd[s - 1];
        bd[s - 1] = td;
        const int ti = bi[s];
        bi[s] = bi[s - 1];
        bi[s - 1] = ti;
      }
    }
  }
}

// mvp_topk_insert's function (the same list for every input), written as
// selects from where d goes (c[s]: entry s stays, bd[s] <= d) instead of a
// chain of swaps. Which form is faster depends on the caller (H100, PERF.md
// row 4): knn.cu inserts a group of 4Q candidates back to back behind one
// guard, and ran fastest with this form; rows 1 (brute), 6 and 7 insert one
// candidate a guard and ran 2-14% slower with it, so they keep the swaps.
template <int K>
__device__ __forceinline__ void mvp_topk_insert_select(float (&bd)[K], int (&bi)[K],
                                                       float d, int j) {
  if (d < bd[K - 1]) {
    bool c[K];  // never the K-th entry, which d replaces
#pragma unroll
    for (int s = 0; s < K; ++s) c[s] = s < K - 1 && bd[s] <= d;
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      bd[s] = c[s] ? bd[s] : (c[s - 1] ? d : bd[s - 1]);
      bi[s] = c[s] ? bi[s] : (c[s - 1] ? j : bi[s - 1]);
    }
    bd[0] = c[0] ? bd[0] : d;
    bi[0] = c[0] ? bi[0] : j;
  }
}

// Min (max) of v over the W consecutive lanes of this thread's group (W a
// power of two <= 32): the query subgroups of the gated kernels.
template <int W>
__device__ __forceinline__ float mvp_group_min(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(MVP_FULL_MASK, v, o, W));
  return v;
}
template <int W>
__device__ __forceinline__ float mvp_group_max(float v) {
#pragma unroll
  for (int o = W / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(MVP_FULL_MASK, v, o, W));
  return v;
}

// Least squared distance between the boxes [alo, ahi] and [blo, bhi], in the
// order and rounding of mvp_sqdist (and of ops/morton.py::box_sqdist): every
// gap is at most the matching |difference| of any two points in the boxes,
// and the rounding is monotone, so the bound is <= every such distance in
// f32 too. An empty box (lo = +inf, hi = -inf) gives +inf.
__device__ __forceinline__ float mvp_box_sqdist(const float (&alo)[3], const float (&ahi)[3],
                                                const float* blo, const float* bhi) {
  float g2[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float gap = fmaxf(0.f, fmaxf(__fsub_rn(alo[d], bhi[d]), __fsub_rn(blo[d], ahi[d])));
    g2[d] = __fmul_rn(gap, gap);
  }
  return __fadd_rn(__fadd_rn(g2[0], g2[1]), g2[2]);
}

// Max of v over the block, returned to every thread. `red` holds one float a
// warp; blockDim.x is a multiple of 32, and every thread must call it.
__device__ __forceinline__ float mvp_block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(MVP_FULL_MASK, v, o));
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) v = fmaxf(v, red[w]);
  return v;
}

// Scan refs [n0, n1) of one batch row, staged through shared memory in tiles
// of TILE points, into each thread's running top-K. Every thread of the
// block must call it (it synchronizes); `active` marks threads that own a
// query. Refs are read once per block from device memory; inside the tile
// all lanes of a warp read the same point, a shared-memory broadcast.
template <int K, int TILE>
__device__ __forceinline__ void mvp_scan_refs(const float* __restrict__ r,
                                              int n0, int n1, bool active,
                                              float qx, float qy, float qz,
                                              float (&bd)[K], int (&bi)[K],
                                              float4* tile) {
  for (int base = n0; base < n1; base += TILE) {
    const int cnt = min(TILE, n1 - base);
    __syncthreads();  // previous tile fully consumed
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const float* p = r + 3 * (size_t)(base + t);
      tile[t] = make_float4(p[0], p[1], p[2], 0.f);
    }
    __syncthreads();
    if (active) {
      for (int t = 0; t < cnt; ++t) {
        const float4 p = tile[t];
        mvp_topk_insert<K>(bd, bi, mvp_sqdist(qx, qy, qz, p.x, p.y, p.z),
                           base + t);
      }
    }
  }
}

// (d, i) comes before (d2, i2) in the (distance, index) order
__device__ __forceinline__ bool precedes(float d, int i, float d2, int i2) {
  return d < d2 || (d == d2 && i < i2);
}

// Insert (d, j) into a list sorted by (distance, index), in any arrival order.
template <int K>
__device__ __forceinline__ void insert_ordered(float (&bd)[K], int (&bi)[K], float d, int j) {
  if (d <= bd[K - 1] && (d < bd[K - 1] || j < bi[K - 1])) {  // precedes(d, j, k-th)
    bd[K - 1] = d;
    bi[K - 1] = j;
#pragma unroll
    for (int s = K - 1; s > 0; --s) {
      if (precedes(bd[s], bi[s], bd[s - 1], bi[s - 1])) {
        const float td = bd[s];
        bd[s] = bd[s - 1];
        bd[s - 1] = td;
        const int ti = bi[s];
        bi[s] = bi[s - 1];
        bi[s - 1] = ti;
      }
    }
  }
}

// The top-K, in (distance, index) order, of the union of the disjoint lists
// of the `lanes` consecutive lanes of this thread's aligned group (a power
// of two up to 32), to each of them: a butterfly of shuffles. Every lane of
// the warp must call it. Unfilled slots are (+inf, INT_MAX), after every
// real entry. A caller with a constant lane count gets the rounds unrolled.
template <int K>
__device__ __forceinline__ void merge_lanes(const float (&bd)[K], const int (&bi)[K],
                                            float (&md)[K], int (&mi)[K], int lanes) {
#pragma unroll
  for (int t = 0; t < K; ++t) {
    md[t] = bd[t];
    mi[t] = bi[t];
  }
#pragma unroll
  for (int off = 1; off < lanes; off <<= 1) {
    float od[K];
    int oi[K];
#pragma unroll
    for (int t = 0; t < K; ++t) {
      od[t] = __shfl_xor_sync(MVP_FULL_MASK, md[t], off);
      oi[t] = __shfl_xor_sync(MVP_FULL_MASK, mi[t], off);
    }
#pragma unroll
    for (int t = 0; t < K; ++t) insert_ordered<K>(md, mi, od[t], oi[t]);
  }
}

// Asynchronous 1-D bulk copies (TMA) into shared memory, completing on an
// mbarrier (sm_90).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
}

// Arm the barrier for one copy of `bytes`, then start the 1-D bulk copy
// (TMA) of `bytes` from global `src` to shared `dst`, completing on it.
// src, dst and bytes must be multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  // earlier generic-proxy reads of dst are ordered before the async write
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// The gated search of rows 6 and 7 (csrc/knn_gated.cu, csrc/knn_resident.cu)
// ---------------------------------------------------------------------------

// refs a bulk copy of the gated search: two buffers of this many float4 refs
// (64 KB of shared memory); a larger ref tile streams in chunks of it
constexpr int kGatedChunk = 2048;

// Exact kNN (K <= 8) of one block's query rows over Morton-sorted ref tiles,
// visited in the query tile's ascending lower-bound order; the body of the
// kernels of rows 6 and 7. Operands from ops/morton.py::prepare_device:
// q4 (B, M_pad, 4) sorted queries with each original row index's bits in .w;
// r4 (B, N_pad, 4) sorted refs with each original ref index's bits in .w;
// rbox (B, Nt, 6) each ref tile's box over its real refs; order and lb (B,
// Mt, Nt) each query tile's ref tiles in visit order and their bounds.
//
// A block holds `rows` rows of one query tile (gridDim.x = Mt * parts), a
// row `lanes` threads (a power of two): lane j scans columns j, j + lanes,
// ... of each tile into its own register list, so a warp holds 32 / lanes
// rows. Ref tiles come into shared memory by cp.async.bulk on an mbarrier,
// in chunks of up to kGatedChunk refs, double-buffered: the next chunk is
// in flight while this one is scanned, and a tile's first chunk is issued
// only if the tile can still matter. Three gates, each exact:
//   * the block's: tile t is open iff lb[t] < worst (or t == 0 with
//     first_always), worst the block max over its real rows of the row's
//     k-th distance; lb ascends and worst only shrinks, so the first closed
//     tile ends the loop;
//   * the warp's: an open tile is scanned by a warp iff t == 0 or the bound
//     between the warp's box (its real rows) and the tile's box is below the
//     warp's worst;
//   * the row's: a lane inserts a candidate only if it is below both its own
//     k-th distance and the row's (its lanes merged at the end of the last
//     tile in which one of the warp's lanes took a candidate).
// Lists are ordered by (distance, visit position), the position of column c
// of slot t being t * tile_n + c: each lane sees its candidates in rising
// position and inserts with strict '<', and the lanes merge in that order
// (merge_lanes), so a row's list is the first K of every candidate in
// _merge_candidate's order (mvpnet_tpu/ops/pallas/knn.py:55). A skipped
// tile holds nothing that precedes the k-th entry: each of its distances is
// >= its bound >= the k-th distance, and on equal distance its later
// position loses. So the result equals morton.gated_plain, ties included.
// The epilogue writes each real row at its original index (q4.w), with the
// original ref index (r4.w) of each entry's column. `scanned` gets the
// (real row, ref) pairs the gates let through.
template <int K>
__device__ __forceinline__ void gated_search(const float4* __restrict__ q4, const float4* __restrict__ r4,
                                             const int* __restrict__ order, const float* __restrict__ lb,
                                             const float* __restrict__ rbox, int M, int M_pad, int N_pad,
                                             int tile_m, int tile_n, int lanes, int rows, bool first_always,
                                             float* __restrict__ out_d, int* __restrict__ out_i,
                                             unsigned long long* __restrict__ scanned, float4* buf,
                                             uint64_t* bar, float* red) {
  const float inf = __int_as_float(0x7f800000);
  const int Mt = M_pad / tile_m;
  const int Nt = N_pad / tile_n;
  const int parts = gridDim.x / Mt;
  const int mt = blockIdx.x / parts;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & (lanes - 1);
  const int row = tid / lanes;                               // in the block
  const int trow = (blockIdx.x % parts) * rows + row;        // in the query tile
  const int s = mt * tile_m + trow;                          // sorted query row
  const bool real = row < rows && trow < tile_m && s < M;    // pad rows vote in no gate
  const float4 qv = real ? q4[(size_t)b * M_pad + s] : make_float4(0.f, 0.f, 0.f, 0.f);
  float glo[3], ghi[3];  // the warp's box over its real rows
  {
    const float c[3] = {qv.x, qv.y, qv.z};
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      glo[d] = mvp_group_min<32>(real ? c[d] : inf);
      ghi[d] = mvp_group_max<32>(real ? c[d] : -inf);
    }
  }
  const unsigned real_rows = __ballot_sync(MVP_FULL_MASK, real && lane == 0);
  float bd[K];
  int bi[K];
#pragma unroll
  for (int t = 0; t < K; ++t) {
    bd[t] = inf;  // an unfilled slot: after every candidate
    bi[t] = INT_MAX;
  }
  float kth = inf;  // the row's k-th distance, its lanes merged
  const int chunk = tile_n < kGatedChunk ? tile_n : kGatedChunk;
  const int cpt = tile_n / chunk;  // chunks a tile
  const int total = Nt * cpt;
  const size_t list = ((size_t)b * Mt + mt) * Nt;
  const float4* rb = r4 + (size_t)b * N_pad;
  const float* bx = rbox + (size_t)b * Nt * 6;
  const uint32_t bytes = (uint32_t)chunk * sizeof(float4);
  if (tid == 0) {
    bar_init(&bar[0]);
    bar_init(&bar[1]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // chunk u lands in buffer u & 1 on barrier u & 1, completing its (u >> 1)-th
  // phase; a chunk is waited for iff it was issued
  if (tid == 0) bulk_load(buf, rb + (size_t)order[list] * tile_n, bytes, &bar[0]);
  int issued = 1;
  float worst = inf;
  bool scan = false;  // this warp scans the current tile
  bool inserted = false;  // this lane took a candidate in the current tile
  unsigned long long pairs = 0;
  for (int u = 0; u < issued; ++u) {
    const int t = u / cpt;
    const int c0 = (u - t * cpt) * chunk;
    // block-uniform: lb and worst are the same in every thread
    const bool open = (t == 0 && first_always) || lb[list + t] < worst;
    if (u + 1 < total) {
      const int t1 = (u + 1) / cpt;
      if (t1 == t ? open : lb[list + t1] < worst) {
        if (tid == 0)
          bulk_load(buf + ((u + 1) & 1) * chunk,
                    rb + (size_t)order[list + t1] * tile_n + (u + 1 - t1 * cpt) * chunk, bytes,
                    &bar[(u + 1) & 1]);
        issued = u + 2;
      }
    }
    bar_wait(&bar[u & 1], (u >> 1) & 1);
    if (c0 == 0) {  // the warp gate, once a tile (warp-uniform)
      scan = false;
      if (open && real_rows != 0) {
        const float* tb = bx + (size_t)order[list + t] * 6;
        const float kth_warp = mvp_group_max<32>(real ? kth : -inf);
        scan = t == 0 || mvp_box_sqdist(glo, ghi, tb, tb + 3) < kth_warp;
      }
    }
    if (scan) {
      const float4* tile = buf + (u & 1) * chunk;
      const int base = t * tile_n + c0;  // visit position of the chunk's column 0
      float thr = fminf(bd[K - 1], kth);
#pragma unroll 4
      for (int c = lane; c < chunk; c += lanes) {
        const float4 p = tile[c];
        const float d = mvp_sqdist(qv.x, qv.y, qv.z, p.x, p.y, p.z);
        if (d < thr) {
          mvp_topk_insert<K>(bd, bi, d, base + c);
          thr = fminf(bd[K - 1], kth);
          inserted = true;
        }
      }
      if ((tid & 31) == 0) pairs += (unsigned long long)__popc(real_rows) * chunk;
    }
    if (c0 + chunk == tile_n) {  // the tile's last chunk
      // the lanes merge only if one of the warp's took a candidate: else
      // every row's k-th distance stands (warp-uniform)
      if (scan && __any_sync(MVP_FULL_MASK, inserted)) {
        float md[K];
        int mi[K];
        merge_lanes<K>(bd, bi, md, mi, lanes);
        kth = md[K - 1];
      }
      inserted = false;
      // every thread is past buffer u & 1 before chunk u + 2 is issued into it
      worst = mvp_block_max(real ? kth : -inf, red);
    } else {
      __syncthreads();
    }
  }
  float md[K];
  int mi[K];
  merge_lanes<K>(bd, bi, md, mi, lanes);
  if (real && lane == 0) {
    const size_t o = ((size_t)b * M + __float_as_int(qv.w)) * K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
      // an unfilled slot (fewer than K refs scanned) names sorted column 0
      const int pos = mi[t];
      const int col = pos == INT_MAX ? 0 : order[list + pos / tile_n] * tile_n + pos % tile_n;
      out_d[o + t] = md[t];
      out_i[o + t] = __float_as_int(rb[col].w);
    }
  }
  if (scanned != nullptr && pairs > 0) atomicAdd(scanned, pairs);
}

// Whether a launch of the gated search has arguments it takes.
inline bool gated_args_ok(int B, int M, int M_pad, int N_pad, int tile_m, int tile_n, int lanes, int rows,
                         int max_threads) {
  return B > 0 && M > 0 && M <= M_pad && tile_m > 0 && tile_n > 0 && M_pad % tile_m == 0 &&
         N_pad % tile_n == 0 && N_pad > 0 && (tile_n <= kGatedChunk || tile_n % kGatedChunk == 0) &&
         lanes >= 1 && lanes <= 32 && (lanes & (lanes - 1)) == 0 && rows >= 1 && rows <= tile_m &&
         rows * lanes <= max_threads;
}

extern "C" const char* mvp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
