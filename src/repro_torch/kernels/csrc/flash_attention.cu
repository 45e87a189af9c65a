// Tiled online-softmax attention (train / prefill) for Hopper (sm_90a),
// bound to Python through a plain C interface (ctypes).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention, Pallas body _kernel).  It computes what
// repro_torch/kernels/ref.py::mha computes: for each row b, query position
// i and query head h (kv head h / g, H = g*K), softmax over the keys t < T
// that the mask keeps of (scale * q.k_t, tanh-softcapped when softcap > 0),
// applied to v.  The mask keeps t <= q_offset + i when causal, and
// t > q_offset + i - window when window > 0 (causal or not).  A query row
// that keeps no key averages every value, as the reference's softmax over
// fully masked logits does (the Pallas body returns zeros there).
//
// What bounds it on this card: operations.  A causal pass does 2*(D+Dv)
// flops for each of the ~S*T/2 (query, key) pairs of every head, and reads
// q, k, v and writes out once: at the prefill shapes (S = T = 2048, D = 64)
// that is ~800 flops per byte, well above the ~295 at which an H100 stops
// being bound by its memory.  This first kernel does that work in fp32 on
// the CUDA cores (67 TFLOP/s), not on the tensor cores (989 TFLOP/s bf16):
// `wgmma` and TMA, and one K/V tile shared by the g heads of a group, are
// the next steps.  What it does about the bound now: one block per
// (query tile, head, row) keeps its running max, running sum and
// accumulator on chip through a loop over tiles of 64 keys, so scores and
// probabilities never reach device memory; each thread computes a 4 x 8
// register tile of scores (and of the output) per step from 16-byte
// shared-memory reads; K/V come in with 16-byte loads; and a kv tile that
// the causal frontier or the window masks for every row of the block is
// never visited, so a windowed pass does O(S*W) work.  Query tiles are
// issued longest first, so the causal pass's long rows do not trail.
//
// The query tile is 64 rows where its shared memory fits the 227 KB a block
// may use, and 32 rows (2 x 8 register tiles) above that: at D = Dv = 256
// (recurrentgemma-9b) a 64-row tile would need 282,624 bytes, a 32-row one
// needs 208,896.  The accumulator stays in shared memory either way.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBk = 64;        // keys per kv tile
constexpr int kThreads = 128;  // 16 x 8: each thread BQ/16 query rows x 8 keys
constexpr size_t kMaxSmem = 232448;  // bytes a block may use on Hopper
constexpr int kKs = kBk + 4;   // row stride of the transposed K tile
constexpr float kNegInf = -1e30f;

// 16 bytes of T from global memory, as floats
__device__ __forceinline__ void load16(const float* p, float* x) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* x) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// R consecutive floats of shared memory (one thread's rows of a column)
template <int R>
__device__ __forceinline__ void ld_rows(const float* p, float* x) {
  if constexpr (R == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
  } else {
    const float2 u = *reinterpret_cast<const float2*>(p);
    x[0] = u.x; x[1] = u.y;
  }
}
template <int R>
__device__ __forceinline__ void st_rows(float* p, const float* x) {
  if constexpr (R == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}

// Shared memory, in floats: the scaled query tile transposed (D x bq), the
// K tile transposed (D x kKs), the V tile (kBk x Dv), the probabilities
// transposed (kBk x bq) and the accumulator (bq x Dv).
__host__ __device__ inline size_t smem_floats(int D, int Dv, int bq) {
  return (size_t)D * bq + (size_t)D * kKs + (size_t)kBk * Dv +
         (size_t)kBk * bq + (size_t)bq * Dv;
}

// Queries per block: 64 where that fits, else 32.
inline int query_tile(int D, int Dv) {
  return smem_floats(D, Dv, 64) * sizeof(float) <= kMaxSmem ? 64 : 32;
}

// The keys [lo, hi) that query position qp keeps; a row that keeps none
// is `empty` and attends to every key with equal weight.
__device__ __forceinline__ void row_range(int64_t qp, int T, bool causal,
                                          int window, int& lo, int& hi,
                                          bool& empty) {
  const int64_t h = causal ? (qp + 1 < T ? qp + 1 : T) : T;
  const int64_t l = window > 0 ? (qp - window + 1 > 0 ? qp - window + 1 : 0)
                               : 0;
  empty = l >= h;
  lo = empty ? 0 : (int)l;
  hi = empty ? T : (int)h;
}

template <typename T, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int Tk, int H, int K, int D, int Dv, int64_t q_sb,
                       int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_st,
                       int64_t k_sh, int64_t v_sb, int64_t v_st, int64_t v_sh,
                       float scale, float softcap, int causal, int window,
                       int64_t q_offset) {
  constexpr int kVec = 16 / sizeof(T);  // elements in a 16-byte load
  constexpr int RQ = BQ / 16;           // query rows per thread
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int kh = h / (H / K);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // rows ty*RQ .. ty*RQ+RQ-1
  const int tx = tid & 7;   // keys / value columns, see col() below

  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);
  float* kT = qT + (size_t)D * BQ;
  float* vs = kT + (size_t)D * kKs;
  float* pT = vs + (size_t)kBk * Dv;
  float* acc = pT + kBk * BQ;
  __shared__ int s_lo, s_hi;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;

  // the kv range of the block: the union of its rows' ranges
  if (tid == 0) {
    s_lo = Tk;
    s_hi = 0;
  }
  __syncthreads();
  if (tid < BQ && q0 + tid < S) {
    int lo, hi;
    bool empty;
    row_range(q_offset + q0 + tid, Tk, causal, window, lo, hi, empty);
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
  }

  // the query tile, scaled, transposed; lanes walk rows so that the
  // transposed stores fall in distinct banks
  for (int i = tid; i < BQ * (D / kVec); i += kThreads) {
    const int r = i % BQ, c = i / BQ;
    float x[kVec];
    if (q0 + r < S) {
      load16(qb + (q0 + r) * q_ss + c * kVec, x);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) qT[(c * kVec + j) * BQ + r] = x[j] * scale;
  }
  for (int i = tid; i < BQ * Dv; i += kThreads) acc[i] = 0.f;

  int lo[RQ], hi[RQ];
  bool empty[RQ];
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    row_range(q_offset + q0 + ty * RQ + i, Tk, causal, window, lo[i], hi[i],
              empty[i]);
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  __syncthreads();
  const int kv_lo = s_lo / kBk * kBk;
  const int kv_hi = s_hi;

  // a thread's 8 keys (and value columns) are two runs of 4, 32 apart, so
  // that 8 neighbouring lanes read 128 contiguous bytes of shared memory
  auto col = [tx](int j) { return (j >> 2) * 32 + tx * 4 + (j & 3); };

  for (int t0 = kv_lo; t0 < kv_hi; t0 += kBk) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < kBk * (D / kVec); i += kThreads) {
      const int t = i % kBk, c = i / kBk;
      float x[kVec];
      if (t0 + t < Tk) {
        load16(kb + (t0 + t) * k_st + c * kVec, x);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) kT[(c * kVec + j) * kKs + t] = x[j];
    }
    for (int i = tid; i < kBk * (Dv / kVec); i += kThreads) {
      const int cv = Dv / kVec;
      const int t = i / cv, c = i % cv;
      float x[kVec];
      if (t0 + t < Tk) {
        load16(vb + (t0 + t) * v_st + c * kVec, x);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) x[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) vs[t * Dv + c * kVec + j] = x[j];
    }
    __syncthreads();

    float s[RQ][8];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[RQ];
      ld_rows<RQ>(qT + d * BQ + ty * RQ, qv);
      const float4 k0 = ld4(kT + d * kKs + tx * 4);
      const float4 k1 = ld4(kT + d * kKs + 32 + tx * 4);
      const float kv[8] = {k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w};
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; the 8 lanes of a row are neighbours in the warp
    float alpha[RQ];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      unsigned keep = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int t = t0 + col(j);
        float x = s[i][j];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        if (empty[i]) x = 0.f;  // every logit equally masked: uniform
        s[i][j] = x;
        if (t < Tk && t >= lo[i] && t < hi[i]) {
          keep |= 1u << j;
          mx = fmaxf(mx, x);
        }
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (keep >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pc[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pc[i] = s[i][j];
      st_rows<RQ>(pT + col(j) * BQ + ty * RQ, pc);
    }
    __syncthreads();

    // acc = alpha * acc + P V, on the thread's own RQ rows x 8 columns of
    // each 64-column chunk (no other thread touches them)
    for (int c0 = 0; c0 < Dv; c0 += 64) {
      float a[RQ][8];
      bool in[2];
#pragma unroll
      for (int g = 0; g < 2; ++g) in[g] = c0 + col(4 * g) < Dv;
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int g = 0; g < 2; ++g) {
          float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
          if (in[g]) x = ld4(acc + (ty * RQ + i) * Dv + c0 + col(4 * g));
          a[i][4 * g] = x.x * alpha[i];
          a[i][4 * g + 1] = x.y * alpha[i];
          a[i][4 * g + 2] = x.z * alpha[i];
          a[i][4 * g + 3] = x.w * alpha[i];
        }
      const int n = min(kBk, Tk - t0);
      for (int t = 0; t < n; ++t) {
        float pv[RQ];
        ld_rows<RQ>(pT + t * BQ + ty * RQ, pv);
        const float4 v0 =
            in[0] ? ld4(vs + t * Dv + c0 + col(0)) : make_float4(0, 0, 0, 0);
        const float4 v1 =
            in[1] ? ld4(vs + t * Dv + c0 + col(4)) : make_float4(0, 0, 0, 0);
        const float vv[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) a[i][j] = fmaf(pv[i], vv[j], a[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int g = 0; g < 2; ++g)
          if (in[g])
            *reinterpret_cast<float4*>(acc + (ty * RQ + i) * Dv + c0 +
                                       col(4 * g)) =
                make_float4(a[i][4 * g], a[i][4 * g + 1], a[i][4 * g + 2],
                            a[i][4 * g + 3]);
    }
  }

  // out (B, S, H, Dv), contiguous; each thread writes what it accumulated
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    if (q0 + r >= S) continue;
    T* orow = out + (((size_t)b * S + q0 + r) * H + h) * Dv;
    for (int c0 = 0; c0 < Dv; c0 += 64)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = c0 + col(j);
        if (c < Dv) orow[c] = from_float<T>(acc[r * Dv + c] / l[i]);
      }
  }
}

template <typename T, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int S, int Tk, int H, int K, int D, int Dv,
                   const int64_t* strides, float scale, float softcap,
                   int causal, int window, int64_t q_offset,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(D, Dv, BQ) * sizeof(float);
  auto kernel = flash_attention_kernel<T, BQ>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, Tk, H, K, D, Dv,
      strides[0], strides[1], strides[2], strides[3], strides[4], strides[5],
      strides[6], strides[7], strides[8], scale, softcap, causal, window,
      q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int Tk, int H, int K, int D,
                        int Dv, const int64_t* strides, float scale,
                        float softcap, int causal, int window,
                        int64_t q_offset, cudaStream_t stream) {
  if (query_tile(D, Dv) == 64)
    return launch<T, 64>(q, k, v, out, B, S, Tk, H, K, D, Dv, strides, scale,
                         softcap, causal, window, q_offset, stream);
  return launch<T, 32>(q, k, v, out, B, S, Tk, H, K, D, Dv, strides, scale,
                       softcap, causal, window, q_offset, stream);
}

}  // namespace

extern "C" {

// Shared memory one block of a launch at (D, Dv) uses, in bytes, with the
// query tile the launch picks (the wrapper checks it fits).
size_t repro_flash_attention_smem_bytes(int D, int Dv) {
  return smem_floats(D, Dv, query_tile(D, Dv)) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out share it).
// q (B,S,H,D), k (B,T,K,D), v (B,T,K,Dv), each with a unit last stride;
// strides (in elements) are q's (b, s, h), k's (b, t, k) and v's (b, t, k),
// each a multiple of 16 bytes, as are the pointers and D and Dv.  out
// (B,S,H,Dv) is contiguous.  Returns a cudaError_t.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int dtype, int B, int S, int T, int H,
                          int K, int D, int Dv, const int64_t* strides,
                          float scale, float softcap, int causal, int window,
                          int64_t q_offset, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_tile<float>(q, k, v, out, B, S, T, H, K, D, Dv, strides,
                              scale, softcap, causal, window, q_offset, s);
  if (dtype == 1)
    return launch_tile<__nv_bfloat16>(q, k, v, out, B, S, T, H, K, D, Dv,
                                      strides, scale, softcap, causal, window,
                                      q_offset, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
