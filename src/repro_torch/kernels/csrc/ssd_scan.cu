// Mamba-2 SSD chunked scan for Hopper (sm_90a), bound to Python through a
// plain C interface (ctypes).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py (ssd_scan, Pallas
// body _kernel).  It computes what repro_torch/kernels/ref.py::ssd
// computes.  For each row b and head h (group g = h / (H/G)), over chunks of
// L = min(chunk, S) steps with cum the inclusive cumsum of dt*A inside the
// chunk and h the (P, N) state carried from the chunk before:
//
//   y_i = sum_{j<=i} (C_i.B_j) exp(cum_i - cum_j) dt_j x_j     (intra)
//       + exp(cum_i) C_i.h^T                                  (inter)
//       + D x_i                                               (skip)
//   h  <- h exp(cum_last) + sum_j exp(cum_last - cum_j) dt_j x_j^T B_j
//
// and the final h is the state (B, H, P, N) in fp32.  A ragged last chunk
// of Lc < L steps is computed over its Lc steps alone: that is exactly what
// the reference's dt=0 padding gives (a pad step decays by exp(0) = 1 and
// adds nothing), without copying padded inputs.
//
// What bounds it on this card: bytes.  It reads x, B, C and dt and writes
// y and the state once; at mamba2-780m's prefill shape (B=4, S=2048,
// H=48, P=64, G=1, N=128, bf16) that is ~113 MB against ~20 GFLOP when
// C.B^T is formed once per group, ~175 flops per byte, under the ~295 at
// which an H100 stops being bound by its memory.  This first kernel is far
// from that bound: it forms C.B^T once per head (48 times per group at
// G=1) and does all products in fp32 on the CUDA cores.  What its design
// does: one block per (b, h) owns the whole carry, walking the chunks in
// order with the state in shared memory (the Pallas grid carries it across
// a sequential axis; blocks on Hopper run in no order); inside a chunk the
// L x L weights, the C.h^T term and the state update are 64 x 64 tiles
// held in registers (a 4 x 4 tile per thread, fed by 16-byte shared-memory
// reads), so neither the weights nor the decays reach device memory; two
// blocks share an SM (89 KB of shared memory each at P=64, N=128).
// Tensor cores (wgmma), C.B^T shared across the heads of a group, and a
// chunk-parallel two-pass design are the next steps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;          // rows and columns of a tile of the chunk
constexpr int kKc = 32;         // depth of one step of C.B^T over N
constexpr int kThreads = 256;   // 16 x 16, each a 4 x 4 register tile
constexpr int kTs = kT + 4;     // row stride of a 64-wide tile
constexpr int kMaxTiles = 2;    // 64 x 64 register tiles per thread

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// padded row stride of a tile `cols` wide: 16-byte rows, zero tail
__host__ __device__ inline int padded(int cols) {
  return round_up(cols, kT) + 4;
}

// Shared memory, in floats: the state transposed (N x P, rows rounded up to
// kKc), dt and cum of one chunk, and a scratch region that the two phases of
// a chunk use in turn: C and B tiles (kKc x kT each, n-major), the weights
// (kT x kT, j-major) and an x tile (kT x P) while y is formed; an x tile and
// a scaled B tile (kT x N) while the state is updated.
__host__ __device__ inline size_t smem_floats(int L, int P, int N) {
  const size_t Pp = padded(P), Np = padded(N);
  const size_t state = (size_t)round_up(N, kKc) * Pp;
  const size_t scan = 2 * (size_t)round_up(L, 4);
  const size_t form_y = 2 * (size_t)kKc * kTs + (size_t)kT * kTs + kT * Pp;
  const size_t update = kT * Pp + kT * Np;
  return state + scan + (form_y > update ? form_y : update);
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
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

// acc[r][c] += a[r] * b[c]
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a,
                                       float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

// dst[kk * kTs + i] = src[(t0 + i) * row + n0 + kk]: a kT x kKc tile of C
// or B, n-major; rows past `rows` and columns past N are zero.
template <typename T>
__device__ void load_nmajor(float* dst, const T* src, int t0, int rows,
                            int n0, int N, size_t row) {
  for (int e = threadIdx.x; e < kT * kKc; e += kThreads) {
    const int i = e / kKc, kk = e % kKc;
    float v = 0.f;
    if (i < rows && n0 + kk < N)
      v = to_float(src[(size_t)(t0 + i) * row + n0 + kk]);
    dst[kk * kTs + i] = v;
  }
}

// dst[j * stride + c] = src[(t0 + j) * row + c] * scale[j] (scale null: 1)
// for j < kT, c < stride - 4; rows past `rows` and columns past `cols` are
// zero.
template <typename T>
__device__ void load_rows(float* dst, int stride, const T* src, int t0,
                          int rows, int cols, size_t row,
                          const float* scale) {
  const int w = stride - 4;
  for (int e = threadIdx.x; e < kT * w; e += kThreads) {
    const int j = e / w, c = e % w;
    float v = 0.f;
    if (j < rows && c < cols) {
      v = to_float(src[(size_t)(t0 + j) * row + c]);
      if (scale) v *= scale[j];
    }
    dst[j * stride + c] = v;
  }
}

// at most 128 registers a thread, so that two blocks share an SM: B*H
// blocks (192 at the prefill shape) then run in one wave on 132 SMs
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dskip,
                T* __restrict__ y, float* __restrict__ state, int S, int H,
                int P, int G, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int Pp = padded(P), Np = padded(N), Nr = round_up(N, kKc);
  const int tilesP = (P + kT - 1) / kT, tilesN = (N + kT - 1) / kT;

  float* hT = smem;                       // Nr x Pp: hT[n][p] = h[p][n]
  float* dts = hT + (size_t)Nr * Pp;      // L: dt, then the update's scale
  float* cum = dts + round_up(L, 4);      // L: inclusive cumsum of dt*A
  float* scr = cum + round_up(L, 4);
  float* Ct = scr;                        // forming y: kKc x kTs
  float* Bt = Ct + kKc * kTs;             //            kKc x kTs
  float* Wt = Bt + kKc * kTs;             //            kT x kTs, j-major
  float* Xs = Wt + kT * kTs;              //            kT x Pp
  float* Xu = scr;                        // updating h: kT x Pp
  float* Bu = scr + kT * Pp;              //             kT x Np

  for (int e = tid; e < Nr * Pp; e += kThreads) hT[e] = 0.f;
  const float a_h = A[h];
  const size_t rowX = (size_t)H * P, rowBC = (size_t)G * N;
  const T* xb = x + (size_t)b * S * rowX + (size_t)h * P;
  T* yb = y + (size_t)b * S * rowX + (size_t)h * P;
  const float* dtb = dt + (size_t)b * S * H + h;
  const T* Bb = Bm + (size_t)b * S * rowBC + (size_t)g * N;
  const T* Cb = Cm + (size_t)b * S * rowBC + (size_t)g * N;

  for (int t0 = 0; t0 < S; t0 += L) {
    const int Lc = min(L, S - t0);
    __syncthreads();   // the last chunk's readers of dts, cum, scr are done
    for (int i = tid; i < Lc; i += kThreads)
      dts[i] = dtb[(size_t)(t0 + i) * H];
    __syncthreads();
    if (tid < 32) {    // warp 0: a run of steps per lane, then a shuffle scan
      const int per = (Lc + 31) / 32;
      const int lo = min(tid * per, Lc), hi = min(lo + per, Lc);
      float run = 0.f;
      for (int i = lo; i < hi; ++i) run += dts[i] * a_h;
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += v;
      }
      float acc = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) acc = 0.f;
      for (int i = lo; i < hi; ++i) {
        acc += dts[i] * a_h;
        cum[i] = acc;
      }
    }
    __syncthreads();

    // ---- y, one tile of kT rows at a time ----
    for (int i0 = 0; i0 < Lc; i0 += kT) {
      float acc[kMaxTiles][4][4] = {};   // rows i0+4ty+r, cols kT*s+4tx+c
      // inter-chunk term C_i.h^T, with h from before this chunk
      for (int n0 = 0; n0 < N; n0 += kKc) {
        load_nmajor(Ct, Cb, t0 + i0, Lc - i0, n0, N, rowBC);
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < kKc; ++kk) {
          const float4 a = ld4(Ct + kk * kTs + 4 * ty);
#pragma unroll
          for (int s = 0; s < kMaxTiles; ++s)
            if (s < tilesP)
              outer4(acc[s], a, ld4(hT + (size_t)(n0 + kk) * Pp + kT * s +
                                    4 * tx));
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * ty + r;
        const float e = i < Lc ? expf(cum[i]) : 0.f;
#pragma unroll
        for (int s = 0; s < kMaxTiles; ++s)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[s][r][c] *= e;
      }
      // intra-chunk term over the column tiles j0 <= i0
      for (int j0 = 0; j0 <= i0; j0 += kT) {
        float w[4][4] = {};
        for (int n0 = 0; n0 < N; n0 += kKc) {
          load_nmajor(Ct, Cb, t0 + i0, Lc - i0, n0, N, rowBC);
          load_nmajor(Bt, Bb, t0 + j0, Lc - j0, n0, N, rowBC);
          __syncthreads();
#pragma unroll 8
          for (int kk = 0; kk < kKc; ++kk)
            outer4(w, ld4(Ct + kk * kTs + 4 * ty), ld4(Bt + kk * kTs + 4 * tx));
          __syncthreads();
        }
        // w_ij = C_i.B_j exp(cum_i - cum_j) dt_j for j <= i, else 0
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int il = 4 * ty + r, i = i0 + il;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jl = 4 * tx + c, j = j0 + jl;
            float v = 0.f;
            if (j <= i && i < Lc) v = w[r][c] * expf(cum[i] - cum[j]) * dts[j];
            Wt[jl * kTs + il] = v;
          }
        }
        load_rows(Xs, Pp, xb, t0 + j0, Lc - j0, P, rowX, nullptr);
        __syncthreads();
        const int jn = min(kT, Lc - j0);
        for (int jj = 0; jj < jn; ++jj) {
          const float4 a = ld4(Wt + jj * kTs + 4 * ty);
#pragma unroll
          for (int s = 0; s < kMaxTiles; ++s)
            if (s < tilesP)
              outer4(acc[s], a, ld4(Xs + jj * Pp + kT * s + 4 * tx));
        }
        __syncthreads();
      }
      // the D skip, and y in x's dtype
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + 4 * ty + r;
        if (i >= Lc) continue;
        const size_t at = (size_t)(t0 + i) * rowX;
#pragma unroll
        for (int s = 0; s < kMaxTiles; ++s)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int p = kT * s + 4 * tx + c;
            if (s >= tilesP || p >= P) continue;
            float v = acc[s][r][c];
            if (Dskip) v += Dskip[h] * to_float(xb[at + p]);
            yb[at + p] = from_float<T>(v);
          }
      }
    }

    // ---- the state: h <- h exp(last) + sum_j x_j^T (B_j exp(last - cum_j) dt_j)
    const float last = cum[Lc - 1];
    for (int j = tid; j < Lc; j += kThreads)
      dts[j] = expf(last - cum[j]) * dts[j];
    float u[kMaxTiles][4][4] = {};   // s -> (p tile s / tilesN, n tile s % tilesN)
    for (int j0 = 0; j0 < Lc; j0 += kT) {
      __syncthreads();   // dts is written; the last tile's readers are done
      load_rows(Xu, Pp, xb, t0 + j0, Lc - j0, P, rowX, nullptr);
      load_rows(Bu, Np, Bb, t0 + j0, Lc - j0, N, rowBC, dts + j0);
      __syncthreads();
      const int jn = min(kT, Lc - j0);
      for (int jj = 0; jj < jn; ++jj) {
#pragma unroll
        for (int s = 0; s < kMaxTiles; ++s)
          if (s < tilesP * tilesN)
            outer4(u[s], ld4(Xu + jj * Pp + kT * (s / tilesN) + 4 * ty),
                   ld4(Bu + jj * Np + kT * (s % tilesN) + 4 * tx));
      }
    }
    const float decay = expf(last);
#pragma unroll
    for (int s = 0; s < kMaxTiles; ++s) {
      if (s >= tilesP * tilesN) continue;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int p = kT * (s / tilesN) + 4 * ty + r;
          const int n = kT * (s % tilesN) + 4 * tx + c;
          // each (p, n) belongs to one thread: no other reads it here
          if (p < P && n < N)
            hT[(size_t)n * Pp + p] = hT[(size_t)n * Pp + p] * decay + u[s][r][c];
        }
    }
  }
  __syncthreads();
  float* st = state + ((size_t)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += kThreads)
    st[e] = hT[(size_t)(e % N) * Pp + e / N];
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, void* y,
                   float* state, int B, int S, int H, int P, int G, int N,
                   int L, cudaStream_t stream) {
  const size_t smem = smem_floats(L, P, N) * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), D, static_cast<T*>(y), state, S, H, P, G, N,
      L);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes (the wrapper checks it fits).
size_t repro_ssd_scan_smem_bytes(int L, int P, int N) {
  return smem_floats(L, P, N) * sizeof(float);
}

// dtype: 0 = float32, 1 = bfloat16 (x, Bm, Cm and y share it).  All
// contiguous: x, y (B,S,H,P); dt (B,S,H), A (H,), D (H,) or null, fp32;
// Bm, Cm (B,S,G,N); state (B,H,P,N) fp32, written.  H % G == 0,
// 1 <= L <= S, ceil(P/64) * ceil(N/64) <= kMaxTiles.  Returns a
// cudaError_t.
int repro_ssd_scan(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, const float* D, void* y,
                   float* state, int dtype, int B, int S, int H, int P, int G,
                   int N, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, D, y, state, B, S, H, P, G, N, L,
                         s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, D, y, state, B, S, H, P,
                                 G, N, L, s);
  return cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
