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
// in all, so 0.020 ms at 3.35 TB/s; the gate math is 11 operations per
// element, far below the f32 peak.  The recurrence is sequential in time and
// independent across (batch, channel): at B=1 a thread per channel gives
// 4096 chains of 2048 dependent steps, too few loads in flight to draw on
// the card's bandwidth.
//
// Design: time is cut into chunks of C = 32 steps, and the chain is split
// across blocks in three launches, each a thread per (batch, two adjacent
// channels, ...) -- one channel where L is odd or an input is not aligned
// to two elements -- with the threads of a block on consecutive channels,
// so every load and store is coalesced along L:
//   1. chunk aggregates, per (batch, channel, chunk) but the last: the
//      chunk's decay A_c = prod a_t and the state it leaves from a zero
//      start, H_c;
//   2. carry, per (batch, channel), sequential over the chunks:
//      h_{c+1} = A_c h_c + H_c from h_0 = 0, written over H_c;
//   3. outputs, per (batch, channel, chunk): the chunk rerun from its true
//      start state h_c, writing h.
// With one chunk (S <= C) only launch 3 runs, from zero.  At the path's shape
// launches 1 and 3 have 2048 x 64 threads, where a thread per chain would have
// 4096.  The price is the inputs read twice, 7 tensor passes where the bound
// counts 4, plus 2 f32 per (batch, channel, chunk) of scratch that the wrapper
// allocates.  A_c is a product of a in [0, 1], with no log and no division: an
// a that underflows to 0 resets the state, as it does in the sequential
// scan.  Each thread loads 4 steps ahead of those it computes (two register
// buffers), so the loads' latency overlaps the gate math and the one dependent
// FMA per step.  Launches 2 and 3 are programmatic dependent launches: each
// starts while the one before it drains, issues the loads that do not depend
// on it, and waits (griddepcontrol.wait) before it reads the
// aggregates.  Launches 1 and 3 are bound by memory (PERF.md).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;
constexpr int kChunk = 32;        // steps per chunk
constexpr int kU = 4;             // steps loaded at once
constexpr int kThreads = 128;     // launches 1 and 3
constexpr int kCarryThreads = 32; // launch 2: few chains, spread over SMs
constexpr int kCarryBatch = 32;   // chunk aggregates loaded at once
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

// V values of T loaded or stored at once, for an address aligned to
// V sizeof(T).
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Programmatic dependent launch: a kernel launched by launch_dependent may
// start while the kernel before it on the stream finishes, once every
// block of that kernel has called allow_dependents(); it must call
// wait_for_previous() before it reads what that kernel wrote.
__device__ __forceinline__ void allow_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename... P, typename... A>
cudaError_t launch_dependent(void (*kernel)(P...), dim3 grid, dim3 block,
                             cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Launches 1 (kOut false) and 3 (kOut true): one chunk of V adjacent
// channels.  Grid: (channel blocks, chunks, batch).  Launch 1 covers the
// chunks but the last, each a full C steps, and writes (A_c, H_c) to slot c
// of agg_a / agg_h, (B, n-1, L) f32; launch 3 covers every chunk, starts
// chunk c > 0 from agg_h's slot c-1 and writes h.
template <typename T, int V, bool kOut>
__global__ void __launch_bounds__(kThreads)
rglru_chunk(const T* __restrict__ x, const T* __restrict__ r,
            const T* __restrict__ ig, const void* __restrict__ lam,
            int lam_code, float* __restrict__ agg_a,
            float* __restrict__ agg_h, T* __restrict__ h_out, int S, int L,
            int n) {
  using P = Pack<T, V>;
  if (!kOut) allow_dependents();   // the carry may launch and wait
  const int l0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (l0 >= L) return;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t_begin = c * kChunk;
  const int t_end = S - t_begin < kChunk ? S : t_begin + kChunk;
  const long long slots = (long long)b * (n - 1);
  float coef[V], h[V], decay[V];
#pragma unroll
  for (int q = 0; q < V; ++q) {
    coef[q] = lru_coef(lam, lam_code, l0 + q);
    h[q] = 0.f;
    decay[q] = 1.f;
  }
  // in units of V channels
  const long long base = ((long long)b * S * L + l0) / V;
  const long long row = L / V;
  const P* xv = reinterpret_cast<const P*>(x);
  const P* rv = reinterpret_cast<const P*>(r);
  const P* iv = reinterpret_cast<const P*>(ig);

  P bx[kU], br[kU], bi[kU];   // the steps being computed
#pragma unroll
  for (int u = 0; u < kU; ++u) {
    const int t = t_begin + u;
    if (t < t_end) {
      const long long off = base + (long long)t * row;
      bx[u] = xv[off];
      br[u] = rv[off];
      bi[u] = iv[off];
    }
  }
  if (kOut) {
    wait_for_previous();   // the carry's start states (a no-op otherwise)
    if (c > 0) {
#pragma unroll
      for (int q = 0; q < V; ++q) h[q] = agg_h[(slots + c - 1) * L + l0 + q];
    }
  }
  for (int t0 = t_begin; t0 < t_end; t0 += kU) {
    // issue the next steps' loads before these steps' arithmetic
    P nx[kU], nr[kU], ni[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + kU + u;
      if (t < t_end) {
        const long long off = base + (long long)t * row;
        nx[u] = xv[off];
        nr[u] = rv[off];
        ni[u] = iv[off];
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int t = t0 + u;
      if (t < t_end) {
        P o;
#pragma unroll
        for (int q = 0; q < V; ++q) {
          const float la = coef[q] * to_f32(br[u].v[q]);
          const float a = expf(la);
          const float g = sqrtf(fmaxf(1.f - expf(2.f * la), 1e-12f)) *
                          (to_f32(bi[u].v[q]) * to_f32(bx[u].v[q]));
          h[q] = fmaf(a, h[q], g);
          decay[q] *= a;
          o.v[q] = from_f32<T>(h[q]);
        }
        if (kOut)
          reinterpret_cast<P*>(h_out)[base + (long long)t * row] = o;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      bx[u] = nx[u];
      br[u] = nr[u];
      bi[u] = ni[u];
    }
  }
  if (!kOut) {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      agg_a[(slots + c) * L + l0 + q] = decay[q];
      agg_h[(slots + c) * L + l0 + q] = h[q];
    }
  }
}

// Launch 2: h_{c+1} = A_c h_c + H_c over the chunks, written over H_c.  A
// thread per (batch, channel); each loads 32 chunks' aggregates at once.
__global__ void __launch_bounds__(kCarryThreads)
rglru_carry(const float* __restrict__ agg_a, float* __restrict__ agg_h,
            int B, int L, int n1) {
  allow_dependents();   // launch 3 may launch and load its first steps
  wait_for_previous();  // launch 1's aggregates
  const long long q = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (q >= (long long)B * L) return;
  const long long b = q / L;
  const int l = (int)(q % L);
  const long long base = b * n1 * L + l;
  float h = 0.f;
  for (int c0 = 0; c0 < n1; c0 += kCarryBatch) {
    float a[kCarryBatch], g[kCarryBatch];
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      if (c0 + u < n1) {
        a[u] = agg_a[base + (long long)(c0 + u) * L];
        g[u] = agg_h[base + (long long)(c0 + u) * L];
      }
    }
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      if (c0 + u < n1) {
        h = fmaf(a[u], h, g[u]);
        agg_h[base + (long long)(c0 + u) * L] = h;
      }
    }
  }
}

int chunks(int S) { return (S + kChunk - 1) / kChunk; }

long long scratch_bytes(int B, int S, int L) {
  return 2LL * B * (chunks(S) - 1) * L * (long long)sizeof(float);
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* r, const void* i,
                   const void* lam, int lam_code, void* h, int B, int S,
                   int L, float* scratch, cudaStream_t stream) {
  const int n = chunks(S);
  if (n > 65535 || B > 65535) return cudaErrorInvalidConfiguration;
  const int per_block = kThreads * V;
  const unsigned cblocks = (unsigned)((L + per_block - 1) / per_block);
  float* agg_a = scratch;
  float* agg_h = scratch + (long long)B * (n - 1) * L;
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(r);
  const T* it = static_cast<const T*>(i);
  if (n > 1) {
    rglru_chunk<T, V, false>
        <<<dim3(cblocks, n - 1, B), kThreads, 0, stream>>>(
            xt, rt, it, lam, lam_code, agg_a, agg_h, nullptr, S, L, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long chains = (long long)B * L;
    err = launch_dependent(
        rglru_carry,
        dim3((unsigned)((chains + kCarryThreads - 1) / kCarryThreads)),
        dim3(kCarryThreads), stream, (const float*)agg_a, agg_h, B, L,
        n - 1);
    if (err != cudaSuccess) return err;
    return launch_dependent(rglru_chunk<T, V, true>, dim3(cblocks, n, B),
                            dim3(kThreads), stream, xt, rt, it, lam,
                            lam_code, agg_a, agg_h, static_cast<T*>(h), S, L,
                            n);
  }
  rglru_chunk<T, V, true><<<dim3(cblocks, n, B), kThreads, 0, stream>>>(
      xt, rt, it, lam, lam_code, agg_a, agg_h, static_cast<T*>(h), S, L, n);
  return cudaGetLastError();
}

// Two channels a thread where L is even and x, r, i and h are aligned to
// two elements, else one.
template <typename T>
cudaError_t launch_v(const void* x, const void* r, const void* i,
                     const void* lam, int lam_code, void* h, int B, int S,
                     int L, float* scratch, cudaStream_t stream) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(x) |
                               reinterpret_cast<unsigned long long>(r) |
                               reinterpret_cast<unsigned long long>(i) |
                               reinterpret_cast<unsigned long long>(h);
  if (L % 2 == 0 && a % (2 * sizeof(T)) == 0)
    return launch<T, 2>(x, r, i, lam, lam_code, h, B, S, L, scratch, stream);
  return launch<T, 1>(x, r, i, lam, lam_code, h, B, S, L, scratch, stream);
}

bool valid(int B, int S, int L) { return B > 0 && S > 0 && L > 0; }

}  // namespace

// Bytes of scratch a call of repro_rglru_scan at this shape needs (0 when S
// fits one chunk), or -1 for a shape it does not take.
extern "C" long long repro_rglru_scan_scratch(int B, int S, int L) {
  return valid(B, S, L) ? scratch_bytes(B, S, L) : -1;
}

// h = rglru(x, r, i, lam) on `stream`.  dtype: 0 f32, 1 bf16, 2 f16 (x, r,
// i and h alike); lam_dtype likewise for lam.  B, S, L > 0.  scratch:
// device memory of at least repro_rglru_scan_scratch(B, S, L) bytes,
// 4-byte aligned, its contents not read.  Returns the first failed
// launch's cudaError_t, or 0.
extern "C" int repro_rglru_scan(const void* x, const void* r, const void* i,
                                const void* lam, void* h, int dtype,
                                int lam_dtype, int B, int S, int L,
                                void* scratch, long long scratch_size,
                                void* stream) {
  if (!valid(B, S, L) || lam_dtype < kF32 || lam_dtype > kF16 ||
      scratch_size < scratch_bytes(B, S, L) ||
      reinterpret_cast<unsigned long long>(scratch) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case kF32:
      return (int)launch_v<float>(x, r, i, lam, lam_dtype, h, B, S, L, sc,
                                  st);
    case kBF16:
      return (int)launch_v<__nv_bfloat16>(x, r, i, lam, lam_dtype, h, B, S,
                                          L, sc, st);
    case kF16:
      return (int)launch_v<__half>(x, r, i, lam, lam_dtype, h, B, S, L, sc,
                                   st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
