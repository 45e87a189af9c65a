// RG-LRU linear recurrence for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py (rglru_scan,
// Pallas body _kernel).  It computes what repro_torch/kernels/ref.py::rglru
// computes: for each row b and channel w,
//
//   h_t = a_t * h_{t-1} + b_t,   h_{-1} = h0 (or 0),
//
// with the carry in fp32, h (B, S, W) rounded to a's dtype and the last
// carry h_final (B, W) in fp32, as the reference's oracle returns it.  Any
// S and W: the Pallas kernel asserts S and W are multiples of its blocks.
//
// What bounds it on this card: bytes.  It does 2 flops per element and
// must read a and b and write h once (201 MB in bf16 at recurrentgemma-9b's
// prefill shape B=4, S=2048, W=4096: 0.06 ms at 3.35 TB/s).  The TPU kernel
// walks the sequence in order, one step after the other, with the carry in
// VMEM.  One thread per channel doing the same here would give B*W = 16,384
// threads at that shape, each waiting on one load per step: far too few
// bytes in flight to fill the memory system.  So the sequence is cut too.
// A block owns a tile of kLanes * V channels of one row and walks the
// sequence in super-chunks of kSub * kT steps; its kSub warps-worth of
// threads each take kT consecutive steps of the super-chunk:
//
//   1. load its kT steps of a and b (V channels each, 16 bytes of fp32 or
//      8 of bf16 per load, all issued before the first is used) into
//      registers, and scan them from 0: the product A of the a's and the
//      local end state E;
//   2. publish (A, E) in shared memory; every thread then composes the
//      carry entering its own sub-chunk (carry := A_j carry + E_j over the
//      sub-chunks j before it) and past the whole super-chunk;
//   3. rescan its kT steps from its carry and store h.
//
// a and b are read once, from registers, and h written once; the only
// extra work is the kSub-long composition of the carries per super-chunk.
// No product of a's is ever divided out: a product that underflows to 0
// just ends the carry's memory, as it does in the sequential recurrence.
// Steps past S load as (a, b) = (1, 0), which carry h unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 16;               // channel vectors per block
constexpr int kSub = 16;                 // sub-chunks per super-chunk
constexpr int kT = 8;                    // steps per sub-chunk
constexpr int kThreads = kLanes * kSub;  // 256

// V consecutive elements of T, as floats
template <int V>
__device__ __forceinline__ void loadv(const float* p, float* x) {
  if constexpr (V == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else {
    x[0] = *p;
  }
}
template <int V>
__device__ __forceinline__ void loadv(const __nv_bfloat16* p, float* x) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
  } else {
    x[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void storev(float* p, const float* x) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else {
    *p = x[0];
  }
}
template <int V>
__device__ __forceinline__ void storev(__nv_bfloat16* p, const float* x) {
  if constexpr (V == 4) {
    uint2 u;
    *reinterpret_cast<__nv_bfloat162*>(&u.x) = __floats2bfloat162_rn(x[0], x[1]);
    *reinterpret_cast<__nv_bfloat162*>(&u.y) = __floats2bfloat162_rn(x[2], x[3]);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
    *p = __float2bfloat16(x[0]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  const float* __restrict__ h0, T* __restrict__ h,
                  float* __restrict__ h_final, int S, int W) {
  const int lane = threadIdx.x % kLanes;
  const int sub = threadIdx.x / kLanes;
  const int row = blockIdx.y;
  const int w0 = (blockIdx.x * kLanes + lane) * V;
  // W % V == 0 when V > 1, so a vector is wholly in or wholly out
  const bool on = w0 < W;

  __shared__ float sA[kSub][kLanes * V];
  __shared__ float sE[kSub][kLanes * V];

  float carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v)
    carry[v] = (h0 != nullptr && on) ? h0[(size_t)row * W + w0 + v] : 0.f;

  const size_t base = (size_t)row * S * W + w0;
  for (int s0 = 0; s0 < S; s0 += kSub * kT) {
    const int t0 = s0 + sub * kT;
    float av[kT][V], bv[kT][V];
#pragma unroll
    for (int t = 0; t < kT; ++t) {
      if (on && t0 + t < S) {
        loadv<V>(a + base + (size_t)(t0 + t) * W, av[t]);
        loadv<V>(b + base + (size_t)(t0 + t) * W, bv[t]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) {
          av[t][v] = 1.f;
          bv[t][v] = 0.f;
        }
      }
    }

    // 1. the sub-chunk alone, from a zero carry
    float A[V], E[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      A[v] = 1.f;
      E[v] = 0.f;
    }
#pragma unroll
    for (int t = 0; t < kT; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v) {
        E[v] = fmaf(av[t][v], E[v], bv[t][v]);
        A[v] *= av[t][v];
      }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sA[sub][lane * V + v] = A[v];
      sE[sub][lane * V + v] = E[v];
    }
    __syncthreads();

    // 2. the carry into this sub-chunk, and past the super-chunk
    float hc[V];
    for (int j = 0; j < kSub; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        if (j == sub) hc[v] = carry[v];
        carry[v] = fmaf(sA[j][lane * V + v], carry[v], sE[j][lane * V + v]);
      }
    }

    // 3. the sub-chunk again, from its carry
#pragma unroll
    for (int t = 0; t < kT; ++t) {
#pragma unroll
      for (int v = 0; v < V; ++v) hc[v] = fmaf(av[t][v], hc[v], bv[t][v]);
      if (on && t0 + t < S) storev<V>(h + base + (size_t)(t0 + t) * W, hc);
    }
    __syncthreads();  // sA and sE are written again in the next round
  }
  if (on && sub == 0)
#pragma unroll
    for (int v = 0; v < V; ++v) h_final[(size_t)row * W + w0 + v] = carry[v];
}

template <typename T, int V>
cudaError_t launch(const void* a, const void* b, const float* h0, void* h,
                   float* h_final, int B, int S, int W, cudaStream_t stream) {
  const int per_block = kLanes * V;
  const dim3 grid((W + per_block - 1) / per_block, B);
  rglru_scan_kernel<T, V><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h0,
      static_cast<T*>(h), h_final, S, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_v(const void* a, const void* b, const float* h0, void* h,
                     float* h_final, int B, int S, int W, int vec,
                     cudaStream_t stream) {
  if (vec == 4) return launch<T, 4>(a, b, h0, h, h_final, B, S, W, stream);
  if (vec == 1) return launch<T, 1>(a, b, h0, h, h_final, B, S, W, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (a, b and h share it).  All contiguous:
// a, b, h (B,S,W); h0 (B,W) fp32 or null; h_final (B,W) fp32, written.
// vec: channels per thread, 4 (W % 4 == 0, pointers on 16-byte
// boundaries) or 1.  S >= 1, B <= 65535.  Returns a cudaError_t.
int repro_rglru_scan(const void* a, const void* b, const float* h0, void* h,
                     float* h_final, int dtype, int B, int S, int W, int vec,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_v<float>(a, b, h0, h, h_final, B, S, W, vec, s);
  if (dtype == 1)
    return launch_v<__nv_bfloat16>(a, b, h0, h, h_final, B, S, W, vec, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
