// WKV-6 recurrence (RWKV-6 "Finch") for Hopper (sm_90a), returning the final
// state as well; bound to Python with ctypes through a plain C interface (see
// ../build.py and ../ops.py::rwkv6_wkv).
//
// Replaces the Pallas kernel of the JAX reference:
//   rwkv6_wkv_kernel <- src/repro/kernels/rwkv6.py:44
//                       (rwkv6_wkv_kernel, body _kernel)
//
// What it computes: r, k, v of (B,S,H,hd) in one dtype T (f32, bf16 or f16),
// w of (B,S,H,hd) in f32 or T, u of (H,hd) in f32, all row-major and
// contiguous.  Per (batch b, head h) a state S of (hd, hd) f32 from zero,
// indexed [key i, value j]:
//   out_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- w_t[i] S[i][j] + k_t[i] v_t[j]
// out is written in T and the final S in f32 as (B,H,hd,hd).  This is
// kernels/ref.py::rwkv6_ref; the sums over i run in another order, so the two
// agree to f32 rounding.  An f32 w is read as f32: a decay near 1 rounded to
// bf16 would lose its low bits, and the error would compound over the steps.
// Unlike the Pallas kernel (S a multiple of tc = min(128, S)) it takes any
// S >= 1, and it returns the final state, which the Pallas kernel keeps in
// VMEM scratch and drops, so a prefill through it can seed a decode.
//
// What bounds it on this card: at the serving path's largest shape (B=1,
// S=2048, H=40, hd=64; bf16 r, k, v and out, f32 w) it moves 63.6 MB, 0.019 ms
// at 3.35 TB/s, and needs 5 f32 operations per (step, key, value) -- a
// multiply-add to read S out, a multiply and a multiply-add to update it --
// 1.68 GFLOP, 0.025 ms at 67 TFLOP/s.  But each (batch, head) is one chain of
// S dependent steps, and there are only B*H = 40 of them, so a simple kernel
// is bound by the issue rate and latency of the few SMs that hold them.
//
// Design: a block per (batch, head, slice of 16 value columns): hd/16 blocks
// per head, 160 at the path's shape.  Its 64 threads each own one column j
// and one quarter of the keys i, and keep those hd/4 entries of S in
// registers.  Time is cut into chunks of C = 1024/hd steps: the block stages
// a chunk's r, k, w (every key) and v (its columns) in shared memory as f32,
// issues the next chunk's loads into registers before computing the current
// chunk, and sums each step's four partial read-outs of a column with two
// warp shuffles (the four key quarters of a column lie in one warp).  The
// Pallas kernel's (hd, hd) VMEM state per program and its tc=128 time blocks
// are TPU tiling and are not carried over.  Later work: a chunked form of the
// recurrence that splits time across blocks, to put more of the card to work
// at B=1.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;
constexpr int kThreads = 64;       // two warps
constexpr int kCols = 16;          // value columns per block
constexpr int kGroups = 4;         // key quarters per column
constexpr int kChunkElems = 1024;  // steps per chunk x hd

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

// One (step, key) of a column: adds r (S + u k v) to the read-out and
// updates S in place.
__device__ __forceinline__ float wkv_step(float r, float k, float w, float u,
                                          float v, float& s, float acc) {
  const float kv = k * v;
  acc = fmaf(r, fmaf(u, kv, s), acc);
  s = fmaf(w, s, kv);
  return acc;
}

template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const TW* __restrict__ w,
            const float* __restrict__ u, T* __restrict__ out,
            float* __restrict__ final_state, int S, int H) {
  constexpr int C = kChunkElems / HD;           // steps per chunk
  constexpr int NI = HD / kGroups;              // keys per thread
  constexpr int PER = kChunkElems / kThreads;   // r, k, w loads per thread
  constexpr int VPER = C * kCols / kThreads;    // v loads per thread
  constexpr int kSlices = HD / kCols;
  __shared__ __align__(16) float sr[kChunkElems];
  __shared__ __align__(16) float sk[kChunkElems];
  __shared__ __align__(16) float sw[kChunkElems];
  __shared__ float sv[C * kCols];

  const int slice = blockIdx.x % kSlices;
  const int bh = blockIdx.x / kSlices;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int grp = lane >> 3;                    // key quarter
  const int col = (tid >> 5) * 8 + (lane & 7);  // column within the slice
  const int j = slice * kCols + col;
  const long long row = (long long)H * HD;      // elements between steps
  const long long base = ((long long)b * S * H + h) * HD;  // (b, 0, h, 0)

  float uu[NI], st[NI];
#pragma unroll
  for (int q = 0; q < NI; ++q) {
    uu[q] = u[h * HD + grp * NI + q];
    st[q] = 0.f;
  }

  // A chunk in flight: element e of r, k, w is (step e / HD, key e % HD);
  // of v, (step e / kCols, column e % kCols).  Zero past S.
  T pr[PER], pk[PER], pv[VPER];
  TW pw[PER];
  auto load = [&](int t0) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + kThreads * m;
      const int t = t0 + e / HD;
      const long long off = base + (long long)t * row + e % HD;
      const bool in = t < S;
      pr[m] = in ? r[off] : from_f32<T>(0.f);
      pk[m] = in ? k[off] : from_f32<T>(0.f);
      pw[m] = in ? w[off] : from_f32<TW>(0.f);
    }
#pragma unroll
    for (int m = 0; m < VPER; ++m) {
      const int e = tid + kThreads * m;
      const int t = t0 + e / kCols;
      pv[m] = t < S ? v[base + (long long)t * row + slice * kCols + e % kCols]
                    : from_f32<T>(0.f);
    }
  };
  auto stage = [&]() {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + kThreads * m;
      sr[e] = to_f32(pr[m]);
      sk[e] = to_f32(pk[m]);
      sw[e] = to_f32(pw[m]);
    }
#pragma unroll
    for (int m = 0; m < VPER; ++m) sv[tid + kThreads * m] = to_f32(pv[m]);
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += C) {
    __syncthreads();  // every thread is done with the previous chunk
    stage();
    __syncthreads();
    if (t0 + C < S) load(t0 + C);  // in flight while this chunk computes
    const int steps = S - t0 < C ? S - t0 : C;
    for (int s = 0; s < steps; ++s) {
      const float vj = sv[s * kCols + col];
      const float4* r4 = reinterpret_cast<const float4*>(sr + s * HD + grp * NI);
      const float4* k4 = reinterpret_cast<const float4*>(sk + s * HD + grp * NI);
      const float4* w4 = reinterpret_cast<const float4*>(sw + s * HD + grp * NI);
      float acc = 0.f;
#pragma unroll
      for (int q4 = 0; q4 < NI / 4; ++q4) {
        const float4 rq = r4[q4], kq = k4[q4], wq = w4[q4];
        acc = wkv_step(rq.x, kq.x, wq.x, uu[4 * q4], vj, st[4 * q4], acc);
        acc = wkv_step(rq.y, kq.y, wq.y, uu[4 * q4 + 1], vj, st[4 * q4 + 1],
                       acc);
        acc = wkv_step(rq.z, kq.z, wq.z, uu[4 * q4 + 2], vj, st[4 * q4 + 2],
                       acc);
        acc = wkv_step(rq.w, kq.w, wq.w, uu[4 * q4 + 3], vj, st[4 * q4 + 3],
                       acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 8);
      acc += __shfl_xor_sync(0xffffffffu, acc, 16);
      if (grp == 0)
        out[base + (long long)(t0 + s) * row + j] = from_f32<T>(acc);
    }
  }
  float* fs = final_state + (long long)bh * HD * HD;
#pragma unroll
  for (int q = 0; q < NI; ++q) fs[(grp * NI + q) * HD + j] = st[q];
}

template <typename T, typename TW, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* out, void* final_state, int B, int S,
                   int H, cudaStream_t stream) {
  const long long blocks = (long long)B * H * (HD / kCols);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  wkv6_kernel<T, TW, HD><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w),
      static_cast<const float*>(u), static_cast<T*>(out),
      static_cast<float*>(final_state), S, H);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t launch_hd(const void* r, const void* k, const void* v,
                      const void* w, const void* u, void* out,
                      void* final_state, int B, int S, int H, int hd,
                      cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, TW, 32>(r, k, v, w, u, out, final_state, B, S, H, st);
    case 64:
      return launch<T, TW, 64>(r, k, v, w, u, out, final_state, B, S, H, st);
    case 128:
      return launch<T, TW, 128>(r, k, v, w, u, out, final_state, B, S, H, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_w(bool w_f32, const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* out,
                     void* final_state, int B, int S, int H, int hd,
                     cudaStream_t st) {
  if (w_f32)
    return launch_hd<T, float>(r, k, v, w, u, out, final_state, B, S, H, hd,
                               st);
  return launch_hd<T, T>(r, k, v, w, u, out, final_state, B, S, H, hd, st);
}

}  // namespace

// out, final = wkv6(r, k, v, w, u) on `stream`.  dtype: 0 f32, 1 bf16, 2 f16
// (r, k, v and out alike); w_dtype is 0 or dtype; u and final are f32.
// B, S, H > 0 and hd in {32, 64, 128}.  Returns the launch's cudaError_t.
extern "C" int repro_rwkv6_wkv(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* out,
                               void* final_state, int dtype, int w_dtype,
                               int B, int S, int H, int hd, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || (w_dtype != kF32 && w_dtype != dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w_f32 = w_dtype == kF32;
  switch (dtype) {
    case kF32:
      return (int)launch_hd<float, float>(r, k, v, w, u, out, final_state, B,
                                          S, H, hd, st);
    case kBF16:
      return (int)launch_w<__nv_bfloat16>(w_f32, r, k, v, w, u, out,
                                          final_state, B, S, H, hd, st);
    case kF16:
      return (int)launch_w<__half>(w_f32, r, k, v, w, u, out, final_state, B,
                                   S, H, hd, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
