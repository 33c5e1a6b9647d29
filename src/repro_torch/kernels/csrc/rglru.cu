// RG-LRU scan (Griffin / RecurrentGemma) for Hopper (sm_90a), with the gate
// math fused in; bound to Python with ctypes through a plain C interface (see
// ../build.py and ../ops.py::rglru_scan).
//
// Replaces the Pallas kernel of the JAX reference:
//   rglru_scan_kernel <- src/repro/kernels/rglru.py:40
//                        (rglru_scan_kernel, body _kernel), together with
//                        the gate math of its wrapper ops.rglru_scan
//                        (src/repro/kernels/ops.py:41-48)
//
// What it computes: x, r and i of (B,S,L) in one dtype T (f32, bf16 or f16),
// row-major and contiguous, and lam of (L,) in its own dtype:
//   coef = -8 softplus(lam), taken in lam's dtype (as the reference's oracle
//          does), then in f32
//   a_t  = exp(coef r_t),  g_t = sqrt(max(1 - exp(2 coef r_t), 1e-12)) i_t x_t
//   h_t  = a_t h_{t-1} + g_t, h in f32 from zero, written in T.
// This is kernels/ref.py::rglru_ref, so the two agree to f32 rounding.  The
// reference's wrapper computes a and g in the inputs' dtype (bf16 on the
// serving path) before its kernel; computing them in f32 here moves the
// result by less than tests/test_kernels.py's bf16 tolerance of 2e-2.
// Unlike the Pallas kernel (S a multiple of 128 when S > 128, L of 512) it
// takes any S and L.
//
// What bounds it on this card: at the serving path's largest shape (B=1,
// S=2048, L=4096, bf16) it reads 3 and writes 1 tensor of 16.8 MB, 67.1 MB
// in all, so 0.020 ms at 3.35 TB/s; the gate math is about 40 operations per
// element, far below the f32 peak.  But the recurrence is sequential in time
// and independent across (batch, channel): B*L = 4096 chains at that shape,
// a small fraction of what 132 SMs can hold in flight, so each chain's loop
// is bound by the latency of its loads, not by bandwidth.
//
// Design: one thread per (batch, channel), marching over time with its state
// in registers.  Time is cut into chunks of U steps; the loads of chunk k+1
// are issued before chunk k is computed (two register buffers), so the
// loads' latency overlaps the gate math and the one dependent FMA per step.
// Blocks are one warp, so the few chains spread over as many SMs as
// possible.  A variant in which each thread took a 16-byte pack of 8
// channels (16-byte vector loads) was slower at every shape measured on the
// H100 (B = 1 and 8, bf16 and f32): it has an eighth of the threads, each
// with eight channels' gate math in series, for the same latency-bound
// chains.  The Pallas kernel's tc=128 time chunks and lb=512 lane blocks are
// VMEM tiling and are not carried over.  Later work: a chunked two-pass scan
// that splits time across blocks, to put more loads in flight at B=1.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;
constexpr int kThreads = 32;   // threads per block: one warp
constexpr float kC = 8.0f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// -8 softplus(lam[l]) as the reference takes it: softplus rounded to lam's
// dtype (times -8 is exact), then f32.
__device__ __forceinline__ float lru_coef(const void* lam, int code, int l) {
  float v, sp;
  switch (code) {
    case kBF16:
      v = __bfloat162float(static_cast<const __nv_bfloat16*>(lam)[l]);
      break;
    case kF16:
      v = __half2float(static_cast<const __half*>(lam)[l]);
      break;
    default:
      v = static_cast<const float*>(lam)[l];
  }
  sp = v > 20.f ? v : log1pf(expf(v));
  if (code == kBF16) sp = __bfloat162float(__float2bfloat16_rn(sp));
  if (code == kF16) sp = __half2float(__float2half_rn(sp));
  return -kC * sp;
}

template <typename T, int U>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ x, const T* __restrict__ r,
                  const T* __restrict__ ig, const void* __restrict__ lam,
                  int lam_code, T* __restrict__ h_out, int B, int S, int L) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (long long)B * L) return;
  const int b = (int)(tid / L);
  const int l = (int)(tid % L);
  const float coef = lru_coef(lam, lam_code, l);
  float h = 0.f;
  const long long base = (long long)b * S * L + l;

  T bx[U], br[U], bi[U];   // the chunk being computed
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (u < S) {
      const long long off = base + (long long)u * L;
      bx[u] = x[off];
      br[u] = r[off];
      bi[u] = ig[off];
    }
  }
  for (int t0 = 0; t0 < S; t0 += U) {
    // issue the next chunk's loads before this chunk's arithmetic
    T nx[U], nr[U], ni[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + U + u;
      if (t < S) {
        const long long off = base + (long long)t * L;
        nx[u] = x[off];
        nr[u] = r[off];
        ni[u] = ig[off];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u;
      if (t < S) {
        const float la = coef * to_f32(br[u]);
        const float a = expf(la);
        const float g = sqrtf(fmaxf(1.f - expf(2.f * la), 1e-12f)) *
                        (to_f32(bi[u]) * to_f32(bx[u]));
        h = fmaf(a, h, g);
        h_out[base + (long long)t * L] = from_f32<T>(h);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      bx[u] = nx[u];
      br[u] = nr[u];
      bi[u] = ni[u];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* r, const void* i,
                   const void* lam, int lam_code, void* h, int B, int S,
                   int L, cudaStream_t stream) {
  constexpr int kU = 16;   // time steps per chunk
  const long long blocks = ((long long)B * L + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  rglru_scan_kernel<T, kU><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(r),
      static_cast<const T*>(i), lam, lam_code, static_cast<T*>(h), B, S, L);
  return cudaGetLastError();
}

}  // namespace

// h = rglru(x, r, i, lam) on `stream`.  dtype: 0 f32, 1 bf16, 2 f16 (x, r,
// i and h alike); lam_dtype likewise for lam.  B, S, L > 0.  Returns the
// launch's cudaError_t.
extern "C" int repro_rglru_scan(const void* x, const void* r, const void* i,
                                const void* lam, void* h, int dtype,
                                int lam_dtype, int B, int S, int L,
                                void* stream) {
  if (B <= 0 || S <= 0 || L <= 0 || lam_dtype < kF32 || lam_dtype > kF16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)launch<float>(x, r, i, lam, lam_dtype, h, B, S, L, st);
    case kBF16:
      return (int)launch<__nv_bfloat16>(x, r, i, lam, lam_dtype, h, B, S, L,
                                        st);
    case kF16:
      return (int)launch<__half>(x, r, i, lam, lam_dtype, h, B, S, L, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
