// Farthest point sampling.
//
// Replaces the Pallas kernel mvpnet_tpu/ops/pallas/fps.py::
// _fps_batched_kernel (pallas_call at fps.py:133); the same kernel covers the
// per-row variant _fps_kernel (fps.py:174) once that is ported for its
// shapes. On the slice's path it samples 8192 -> 1024 at SA1 and 1024 -> 256
// at SA2 (and 256 -> 64, 64 -> 16 below the TPU's size threshold).
//
// Contract (mvpnet_tpu/ops/reference.py:67): the seed is the first valid
// index (0 when unmasked or when no point is valid); each step takes
// dist = min(dist, |p - last|^2) and the argmax with the first occurrence on
// ties; invalid points start at -inf and so are never selected while a valid
// point remains.
//
// Design: one block per batch row, up to 1024 threads. The row's points and
// running distances live in dynamic shared memory as float4 (x, y, z, dist):
// 16 B a point, 128 KB at N = 8192, which needs the opt-in above 48 KB. Each
// step is a strided update, then a warp-shuffle argmax with the tie rule
// (d > bd) || (d == bd && i < bi) and a second pass over the warps' winners.
// A row too long for shared memory keeps the same loop over device memory.
//
// Bound on the H100: the npoint - 1 steps are sequential and each is a
// block-wide reduction, so at B = 1 the kernel runs on one SM and is bound
// by the latency of the step loop, not by bytes or operations (10 f32
// operations per point and step). chip_smoke.py computes both roofs from
// the run's shapes.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

struct ArgMax {
  float d;
  int i;
};

__device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.d > a.d || (b.d == a.d && b.i < a.i)) ? b : a;
}

__device__ __forceinline__ ArgMax warp_argmax(ArgMax v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ArgMax o;
    o.d = __shfl_down_sync(MVP_FULL_MASK, v.d, off);
    o.i = __shfl_down_sync(MVP_FULL_MASK, v.i, off);
    v = better(v, o);
  }
  return v;
}

template <bool kShared>
__global__ void fps_kernel(const float* __restrict__ pts,
                           const uint8_t* __restrict__ mask, int N,
                           int npoint, float* __restrict__ scratch,
                           int* __restrict__ out) {
  extern __shared__ float4 sp[];  // (x, y, z, dist) when kShared
  __shared__ ArgMax red[kMaxThreads / 32];
  __shared__ int s_last;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const float* p = pts + 3 * (size_t)b * N;
  const uint8_t* mk = mask ? mask + (size_t)b * N : nullptr;
  float* dist = scratch + (size_t)b * N;
  int* o = out + (size_t)b * npoint;
  const float inf = __int_as_float(0x7f800000);

  // init: dist +inf for valid points, -inf for invalid; seed = first valid
  int first = INT_MAX;
  for (int i = tid; i < N; i += blockDim.x) {
    const bool valid = mk == nullptr || mk[i] != 0;
    const float d = valid ? inf : -inf;
    if (kShared) {
      sp[i] = make_float4(p[3 * i], p[3 * i + 1], p[3 * i + 2], d);
    } else {
      dist[i] = d;
    }
    if (valid && i < first) first = i;
  }
  // block min of `first` through the same argmax machinery (-index)
  ArgMax f = warp_argmax(ArgMax{first == INT_MAX ? -inf : 0.f, first});
  if (lane == 0) red[warp] = f;
  __syncthreads();
  if (warp == 0) {
    ArgMax v = lane < nwarps ? red[lane] : ArgMax{-inf, INT_MAX};
    v = warp_argmax(v);
    if (lane == 0) {
      s_last = v.i == INT_MAX ? 0 : v.i;
      o[0] = s_last;
    }
  }
  __syncthreads();
  int last = s_last;

  for (int step = 1; step < npoint; ++step) {
    float lx, ly, lz;
    if (kShared) {
      const float4 l = sp[last];
      lx = l.x;
      ly = l.y;
      lz = l.z;
    } else {
      lx = p[3 * last];
      ly = p[3 * last + 1];
      lz = p[3 * last + 2];
    }
    ArgMax best{-inf, INT_MAX};
    for (int i = tid; i < N; i += blockDim.x) {
      float px, py, pz, di;
      if (kShared) {
        const float4 v = sp[i];
        px = v.x;
        py = v.y;
        pz = v.z;
        di = v.w;
      } else {
        px = p[3 * i];
        py = p[3 * i + 1];
        pz = p[3 * i + 2];
        di = dist[i];
      }
      const float nd = fminf(di, mvp_sqdist(px, py, pz, lx, ly, lz));
      if (kShared) {
        sp[i].w = nd;
      } else {
        dist[i] = nd;
      }
      best = better(best, ArgMax{nd, i});
    }
    best = warp_argmax(best);
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      ArgMax v = lane < nwarps ? red[lane] : ArgMax{-inf, INT_MAX};
      v = warp_argmax(v);
      if (lane == 0) {
        s_last = v.i;
        o[step] = v.i;
      }
    }
    __syncthreads();
    last = s_last;
  }
}

}  // namespace

// pts (B, N, 3) f32 contiguous; mask (B, N) uint8 or null; scratch (B, N)
// f32 (used only when a row does not fit in shared memory); out (B, npoint)
// int32. Returns cudaError_t.
extern "C" int fps(const float* pts, const uint8_t* mask, int B, int N,
                   int npoint, float* scratch, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || npoint <= 0) return cudaSuccess;
  if (N <= 0) return cudaErrorInvalidValue;
  int threads = ((N + 31) / 32) * 32;
  threads = threads > kMaxThreads ? kMaxThreads : threads;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fps_kernel<true>);
  if (e != cudaSuccess) return e;
  const size_t bytes = sizeof(float4) * (size_t)N;
  if (bytes + attr.sharedSizeBytes <= (size_t)optin) {
    e = cudaFuncSetAttribute(fps_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e != cudaSuccess) return e;
    fps_kernel<true><<<B, threads, bytes, st>>>(pts, mask, N, npoint, scratch,
                                                out);
  } else {
    fps_kernel<false><<<B, threads, 0, st>>>(pts, mask, N, npoint, scratch,
                                             out);
  }
  return cudaGetLastError();
}
