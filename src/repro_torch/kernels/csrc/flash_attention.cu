// Forward flash attention (GQA, causal, sliding window) for Hopper (sm_90a),
// bound to Python with ctypes through a plain C interface (see ../build.py
// and ../ops.py::flash_attention).
//
// Replaces the Pallas kernel of the JAX reference:
//   flash_attention_kernel <- src/repro/kernels/flash_attention.py:82
//                             (flash_attention_kernel, body _kernel)
//
// What it computes, as the Pallas kernel does: q (B,S,H,hd), k and v
// (B,T,KV,hd), all row-major and contiguous; G = H / KV query heads share a
// KV head (head h uses KV head h / G).  Scores q.k in f32, times 1/sqrt(hd);
// masked scores are finfo(f32).min (causal: kpos <= qpos; window w:
// kpos > qpos - w; both positions counted from 0); an online softmax keeps
// m, l and acc in f32; the output is acc / max(l, 1e-30) in q's dtype.
// Unlike the Pallas kernel (which asserts S % 128 == 0 and T % 128 == 0) it
// takes any S and T: keys past T score -inf and so weigh exactly 0, and
// rows past S are computed but not stored.
//
// What bounds it on this card: at tinyllama's largest prefill shape
// (tinyllama-1.1b prefill, B=1, S=T=2048, H=32, KV=4, hd=64, bf16, causal)
// the work is 4*H*hd*S(S+1)/2 = 17.2 GFLOP against 2.1 MB of q, k, v and o:
// about 8,000 operations per byte, far above the card's ~295, so it is
// bound by operations.  At the bf16 tensor-core peak (989 TFLOP/s) that is
// 0.017 ms.  This kernel runs its FMAs on the CUDA cores in f32 (67 TFLOP/s
// peak), so its own floor is ~0.26 ms; tensor cores (wgmma fed by TMA) are
// the later step that closes the gap.  At recurrentgemma-9b's local
// attention (S=T=2048, H=16, KV=1, hd=256, causal) the work is 34.4 GFLOP:
// 0.035 ms at the tensor-core peak, ~0.51 ms on the CUDA cores.  There it
// took 2.98 ms (11.5 TFLOP/s; chip_smoke.py phase (e), NVIDIA H100 80GB
// HBM3, 700 W), slower than its plain version's two cuBLAS products
// (1.51 ms): every FMA reads its k or v operand from shared memory, one
// 16-byte load per four FMAs, so the kernel is bound by shared-memory
// bandwidth near a quarter of the f32 peak.
//
// Design.  One block covers one (batch, KV head, block of BQ query rows) and
// all G query heads of that KV head, as each Pallas program does, so each
// K/V tile is read from memory once per group of heads.  BQ is as many rows
// as fit kMaxThreads threads: at G=16 and hd=256 (16 x 16 threads per row)
// that is one row per block, which still stages each K/V tile once for 16
// heads, so staging stays a small share of the block's work.  NSUB = hd/16
// threads share one (query row, head) pair: each owns 16 of its head dims,
// holding that slice of q and of the f32 accumulator in registers.  K and V
// tiles of BK keys (64, or 32 at hd 256, so the two f32 tiles take 64 KiB
// at most and three blocks still fit an SM) are staged in shared memory as
// f32; a thread reads its
// dims of a key with 16-byte loads that all pairs of a warp share
// (broadcast, no bank conflicts).  A dot product is summed across the NSUB
// threads with warp shuffles.  Keys are scored kChunk at a time, so the
// running max and the rescale of acc are applied once per chunk, not once
// per key.  Key tiles that the causal or window mask hides from every row of
// the block are never loaded (the Pallas kernel's pl.when(live) skip), and
// blocks are issued heaviest (last query rows) first, so the causal
// triangle does not leave a tail of long blocks.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;
constexpr int kMaxThreads = 256;   // threads per block, at most
constexpr int kDims = 16;          // head dims owned by one thread
// keys per shared-memory tile: two f32 tiles of kBK x HD stay <= 64 KiB
template <int HD> constexpr int kBK = HD >= 256 ? 32 : 64;
constexpr int kChunk = 16;         // keys per online-softmax update
constexpr float kF32Min = -3.40282346638528859812e+38f;  // finfo(f32).min

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

// Stage rows [t0, t0 + BK) of one KV head of k (or v) into `dst` as f32,
// BK x HD; rows at or past T are zero.  With `vec`, the rows are 16-byte
// aligned and move as 16-byte loads.
template <typename T, int HD>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src,
                                           float* __restrict__ dst,
                                           long long row0_off, int t0, int T_,
                                           int row_stride, bool vec) {
  constexpr int kPer = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int BK = kBK<HD>;
  if (vec) {
    constexpr int kVecPerRow = HD / kPer;
    for (int e = threadIdx.x; e < BK * kVecPerRow; e += blockDim.x) {
      const int j = e / kVecPerRow, c = e % kVecPerRow;
      float f[kPer];
      if (t0 + j < T_) {
        const uint4 u = *reinterpret_cast<const uint4*>(
            src + row0_off + (long long)(t0 + j) * row_stride + c * kPer);
        const T* el = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int i = 0; i < kPer; ++i) f[i] = to_f32(el[i]);
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) f[i] = 0.f;
      }
      float4* out = reinterpret_cast<float4*>(dst + j * HD + c * kPer);
#pragma unroll
      for (int i = 0; i < kPer / 4; ++i)
        out[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2],
                             f[4 * i + 3]);
    }
  } else {
    for (int e = threadIdx.x; e < BK * HD; e += blockDim.x) {
      const int j = e / HD, d = e % HD;
      const long long at = row0_off + (long long)(t0 + j) * row_stride + d;
      dst[e] = t0 + j < T_ ? to_f32(src[at]) : 0.f;
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int S, int T_,
                 int H, int KV, int G, int BQ, int causal, int window,
                 float scale, int vec) {
  constexpr int NSUB = HD / kDims;     // threads per (row, head) pair
  constexpr int kV4 = kDims / 4;       // float4 slices per thread
  constexpr int BK = kBK<HD>;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + BK * HD;

  const int tid = threadIdx.x;
  const int sub = tid % NSUB;
  const int pair = tid / NSUB;
  const int r = pair / G, g = pair % G;
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int qblk = gridDim.x - 1 - blockIdx.x;   // heaviest blocks first
  const int q0 = qblk * BQ;
  const int qpos = q0 + r;
  const bool live_row = pair < BQ * G && qpos < S;
  const int h = kvh * G + g;

  // this thread's dims: slice i covers dims [i*NSUB*4 + sub*4, +4)
  float qf[kDims], acc[kDims];
  const long long qoff = ((long long)(b * S + qpos) * H + h) * HD;
#pragma unroll
  for (int i = 0; i < kV4; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int d = i * NSUB * 4 + sub * 4 + c;
      qf[i * 4 + c] = live_row ? to_f32(q[qoff + d]) : 0.f;
      acc[i * 4 + c] = 0.f;
    }
  }
  float m = kF32Min, l = 0.f;

  // keys any row of this block can see
  const int q_last = min(q0 + BQ, S) - 1;
  int k_lo = 0, k_hi = T_;
  if (causal) k_hi = min(T_, q_last + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int row_stride = KV * HD;
  const long long kv0 = (long long)b * T_ * row_stride + (long long)kvh * HD;

  for (int t0 = (k_lo / BK) * BK; t0 < k_hi; t0 += BK) {
    __syncthreads();   // the previous tile is no longer read
    stage_tile<T, HD>(k, ks, kv0, t0, T_, row_stride, vec);
    stage_tile<T, HD>(v, vs, kv0, t0, T_, row_stride, vec);
    __syncthreads();
    for (int c0 = 0; c0 < BK && t0 + c0 < k_hi; c0 += kChunk) {
      float s[kChunk];
      float mx = m;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* kr = ks + (c0 + j) * HD + sub * 4;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kV4; ++i) {
          const float4 kk =
              *reinterpret_cast<const float4*>(kr + i * NSUB * 4);
          part = fmaf(qf[i * 4 + 0], kk.x, part);
          part = fmaf(qf[i * 4 + 1], kk.y, part);
          part = fmaf(qf[i * 4 + 2], kk.z, part);
          part = fmaf(qf[i * 4 + 3], kk.w, part);
        }
#pragma unroll
        for (int off = NSUB / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        const int kpos = t0 + c0 + j;
        bool ok = !causal || kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        float sc = ok ? part * scale : kF32Min;
        if (kpos >= T_) sc = -INFINITY;          // no such key: weight 0
        s[j] = sc;
        mx = fmaxf(mx, sc);
      }
      const float corr = expf(m - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        s[j] = expf(s[j] - mx);
        psum += s[j];
      }
      l = l * corr + psum;
#pragma unroll
      for (int d = 0; d < kDims; ++d) acc[d] *= corr;
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const float* vr = vs + (c0 + j) * HD + sub * 4;
#pragma unroll
        for (int i = 0; i < kV4; ++i) {
          const float4 vv =
              *reinterpret_cast<const float4*>(vr + i * NSUB * 4);
          acc[i * 4 + 0] = fmaf(s[j], vv.x, acc[i * 4 + 0]);
          acc[i * 4 + 1] = fmaf(s[j], vv.y, acc[i * 4 + 1]);
          acc[i * 4 + 2] = fmaf(s[j], vv.z, acc[i * 4 + 2]);
          acc[i * 4 + 3] = fmaf(s[j], vv.w, acc[i * 4 + 3]);
        }
      }
      m = mx;
    }
  }

  if (live_row) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < kV4; ++i) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = i * NSUB * 4 + sub * 4 + c;
        o[qoff + d] = from_f32<T>(acc[i * 4 + c] * inv);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int T_, int H, int KV, int causal,
                   int window, int vec, cudaStream_t stream) {
  constexpr int NSUB = HD / kDims;
  const int G = H / KV;
  // BQ query rows x G heads x NSUB threads, rounded up to whole warps
  if (G * NSUB > kMaxThreads) return cudaErrorInvalidConfiguration;
  const int BQ = kMaxThreads / (NSUB * G);
  const int threads = (BQ * G * NSUB + 31) / 32 * 32;
  const size_t smem = 2 * kBK<HD> * HD * sizeof(float);
  auto kernel = flash_fwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + BQ - 1) / BQ, KV, B);
  const float scale = 1.0f / sqrtf((float)HD);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, T_, H, KV, G, BQ,
      causal, window, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int T_, int H, int KV, int hd,
                        int causal, int window, int vec,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, S, T_, H, KV, causal, window, vec,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, S, T_, H, KV, causal, window, vec,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, S, T_, H, KV, causal, window, vec,
                            stream);
    case 256:
      return launch<T, 256>(q, k, v, o, B, S, T_, H, KV, causal, window, vec,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// o = attention(q, k, v) on `stream`.  dtype: 0 f32, 1 bf16, 2 f16 (q, k, v
// and o alike); hd in {32, 64, 128, 256}; H % KV == 0; window <= 0 means none;
// (hd / 16) * (H / KV) <= 256; vec: k and v start 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype, int B,
                                     int S, int T, int H, int KV, int hd,
                                     int causal, int window, int vec,
                                     void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)dispatch_hd<float>(q, k, v, o, B, S, T, H, KV, hd, causal,
                                     window, vec, st);
    case kBF16:
      return (int)dispatch_hd<__nv_bfloat16>(q, k, v, o, B, S, T, H, KV, hd,
                                             causal, window, vec, st);
    case kF16:
      return (int)dispatch_hd<__half>(q, k, v, o, B, S, T, H, KV, hd, causal,
                                      window, vec, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
