// Single-token GQA decode attention against a slotted KV cache, for Hopper
// (sm_90a), bound to Python through a plain C interface (ctypes).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py
// (decode_attention, Pallas body _kernel).  It computes what
// repro_torch/kernels/ref.py::decode_attention computes: for each row b and
// query head h, softmax over the cache positions p with
// max(0, len-window) <= p < min(len, Smax) of (scale * q.k_p, tanh-softcapped
// when softcap > 0), applied to v.  The g = H/K query heads of one kv head
// share the K/V they read.  A row with no valid position averages every
// cache entry, as the reference's softmax over fully masked logits does.
//
// What bounds it on this card: the bytes of K and V it reads.  A decode
// step does 2*D flops per cached element for g heads, far below the ~295
// flops per byte at which an H100 stops being bound by its memory.  The
// design reads each K/V row once per (row, kv head) and reuses it for all
// g heads from shared memory, and stops at min(len, Smax), so nothing past
// the valid tail is read.  It is a first, simple kernel: one block per
// (row, kv head) walks the cache in tiles of 32 positions with an fp32
// online softmax.  At serving shapes (8 rows x 8 kv heads) that is 64 blocks
// on 132 SMs; splitting Smax across blocks is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // cache positions per tile: one per lane
constexpr int kThreads = 128;  // four warps
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory, in floats: q (g*D), a K tile (kTile*(D+1), padded against
// bank conflicts), a V tile (kTile*Dv), scores (g*kTile), the accumulator
// (g*Dv) and the running max, sum and rescale factor of each head (3*g).
__host__ __device__ inline size_t smem_floats(int g, int D, int Dv) {
  return (size_t)g * D + (size_t)kTile * (D + 1) + (size_t)kTile * Dv +
         (size_t)g * kTile + (size_t)g * Dv + 3 * (size_t)g;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int K, int Smax, int D, int Dv, float scale,
                        float softcap, int window) {
  const int b = blockIdx.x / K;
  const int kh = blockIdx.x % K;
  const int g = H / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int kWarps = kThreads / 32;

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + g * D;
  float* vs = ks + kTile * (D + 1);
  float* sc = vs + kTile * Dv;
  float* acc = sc + g * kTile;
  float* m_s = acc + g * Dv;
  float* l_s = m_s + g;
  float* alpha_s = l_s + g;

  const int length = lengths[b];
  int hi = min(length, Smax);
  int lo = window > 0 ? max(length - window, 0) : 0;
  const bool empty = lo >= hi;
  if (empty) {
    lo = 0;
    hi = Smax;
  }

  const T* qb = q + ((size_t)b * H + (size_t)kh * g) * D;
  for (int i = tid; i < g * D; i += kThreads) qs[i] = to_float(qb[i]) * scale;
  for (int i = tid; i < g * Dv; i += kThreads) acc[i] = 0.f;
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }

  const size_t k_row = (size_t)K * D;   // stride between cache positions
  const size_t v_row = (size_t)K * Dv;
  const T* kb = k + (size_t)b * Smax * k_row + (size_t)kh * D;
  const T* vb = v + (size_t)b * Smax * v_row + (size_t)kh * Dv;

  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int n = min(kTile, hi - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int t = i / D, d = i - t * D;
      ks[t * (D + 1) + d] = t < n ? to_float(kb[(t0 + t) * k_row + d]) : 0.f;
    }
    for (int i = tid; i < kTile * Dv; i += kThreads) {
      const int t = i / Dv, d = i - t * Dv;
      vs[i] = t < n ? to_float(vb[(t0 + t) * v_row + d]) : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < g * kTile; i += kThreads) {
      const int h = i / kTile, t = i - h * kTile;
      float s = kNegInf;
      if (t < n) {
        if (empty) {
          s = 0.f;  // every logit equally masked: a uniform softmax
        } else {
          const float* qh = qs + h * D;
          const float* kt = ks + t * (D + 1);
          float dot = 0.f;
          for (int d = 0; d < D; ++d) dot += qh[d] * kt[d];
          if (softcap > 0.f) dot = tanhf(dot / softcap) * softcap;
          s = dot;
        }
      }
      sc[i] = s;
    }
    __syncthreads();

    // online softmax: one warp per head, one lane per position of the tile
    for (int h = warp; h < g; h += kWarps) {
      const float s = sc[h * kTile + lane];
      float mx = s;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[h];
      const float m_cur = fmaxf(m_prev, mx);
      const float p = lane < n ? expf(s - m_cur) : 0.f;
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sc[h * kTile + lane] = p;
      if (lane == 0) {
        const float a = expf(m_prev - m_cur);
        alpha_s[h] = a;
        l_s[h] = a * l_s[h] + sum;
        m_s[h] = m_cur;
      }
    }
    __syncthreads();

    for (int i = tid; i < g * Dv; i += kThreads) {
      const int h = i / Dv, d = i - h * Dv;
      const float* ph = sc + h * kTile;
      float a = acc[i] * alpha_s[h];
      for (int t = 0; t < n; ++t) a += ph[t] * vs[t * Dv + d];
      acc[i] = a;
    }
  }
  __syncthreads();

  T* ob = out + ((size_t)b * H + (size_t)kh * g) * Dv;
  for (int i = tid; i < g * Dv; i += kThreads) {
    const int h = i / Dv;
    ob[i] = from_float<T>(acc[i] / fmaxf(l_s[h], 1e-30f));
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int H, int K,
                   int Smax, int D, int Dv, float scale, float softcap,
                   int window, cudaStream_t stream) {
  const size_t smem = smem_floats(H / K, D, Dv) * sizeof(float);
  auto kernel = decode_attention_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B * K, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), H, K, Smax, D,
      Dv, scale, softcap, window);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the wrapper checks it fits).
size_t repro_decode_attention_smem_bytes(int g, int D, int Dv) {
  return smem_floats(g, D, Dv) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (q, caches and out share it).  All
// tensors are contiguous: q (B,H,D), k (B,Smax,K,D), v (B,Smax,K,Dv),
// lengths (B,) int32, out (B,H,Dv).  Returns a cudaError_t.
int repro_decode_attention(const void* q, const void* k, const void* v,
                           const void* lengths, void* out, int dtype, int B,
                           int H, int K, int Smax, int D, int Dv, float scale,
                           float softcap, int window, void* stream) {
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, len, out, B, H, K, Smax, D, Dv, scale,
                         softcap, window, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, len, out, B, H, K, Smax, D, Dv,
                                 scale, softcap, window, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
