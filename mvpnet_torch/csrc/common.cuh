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

extern "C" const char* mvp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
