// Flash attention (GQA, causal, sliding window) for Hopper (sm_90a), bound
// to Python with ctypes through a plain C interface (see ../build.py and
// ../ops.py::flash_attention).  The forward has two routes, chosen by dtype:
//   bf16, f16: flash_tc_kernel, on the tensor cores (wgmma fed by TMA);
//   f32:       flash_fwd_kernel, on the CUDA cores.
// The tensor-core route also has a backward (flash_bwd_kernel, below), so
// training runs through it.
//
// The forward replaces the Pallas kernel of the JAX reference:
//   flash_attention_kernel <- src/repro/kernels/flash_attention.py:82
//                             (flash_attention_kernel, body _kernel)
// The backward replaces no Pallas kernel: the reference trains through
// XLA's query-chunked path (src/repro/models/layers.py, _flash_xla), whose
// port (../../models/layers.py::_flash_xla) the CPU keeps.
//
// What it computes, as the Pallas kernel does: q (B,S,H,hd), k and v
// (B,T,KV,hd), all row-major and contiguous; G = H / KV query heads share a
// KV head (head h uses KV head h / G).  Scores q.k in f32, times 1/sqrt(hd);
// masked scores are finfo(f32).min (causal: kpos <= qpos; window w:
// kpos > qpos - w; both positions counted from 0); an online softmax keeps
// m, l and acc in f32; the output is acc / max(l, 1e-30) in q's dtype.
// Unlike the Pallas kernel (which asserts S % 128 == 0 and T % 128 == 0) it
// takes any S and T: keys past T score -inf and so weigh exactly 0, and
// rows past S are computed but not stored.  A masked score is finfo.min and
// not -inf so that a row whose first visited tile hides every key from it
// gets weight exp(0) there, which the next live key's correction
// exp(m_prev - m_new) = 0 wipes out, as in the Pallas kernel; -inf would
// give NaN.
//
// What bounds it on this card.  At tinyllama-1.1b's largest prefill (B=1,
// S=T=2048, H=32, KV=4, hd=64, bf16, causal) the work is
// 4*H*hd*S(S+1)/2 = 17.2 GFLOP against 2.1 MB of q, k, v and o, about
// 8,000 operations per byte, far above the card's ~295: bound by
// operations, 0.0174 ms at the bf16 tensor-core peak (989 TFLOP/s).  At
// recurrentgemma-9b's local attention (S=T=2048, H=16, KV=1, hd=256,
// window 2048, causal) it is 34.4 GFLOP, 0.0348 ms.  The tensor-core route
// does 1.5x that as tensor-core work (P.V twice, below): 25.8 and 51.6
// GFLOP, plus the masked half of each diagonal tile.
//
// The tensor-core route (flash_tc_kernel).  One block per (batch, query
// head, tile of BM = 128 query rows), two consumer warpgroups of 64 rows
// each; blocks are issued heaviest (last query rows) first, and the G heads
// of one KV head run side by side, so their K/V tiles come from L2 (0.5 MB
// and 2 MB per KV head at S=2048 against a 50 MB L2).  One thread loads
// with TMA: Q once, then K and V tiles of BN keys (128, or 64 at hd 256)
// into a two-stage ring, one mbarrier per tile, so tile j+1 lands while
// tile j computes; the last warpgroup done with a stage refills it, so the
// two warpgroups keep their own pace (one's softmax runs while the other's
// wgmma do).  128-byte swizzle (64-byte at hd 32), rows split into
// 64-element chunks; TMA's zero fill covers the ragged edges.  Two blocks
// share an SM at hd <= 64 (128 registers a thread), one at hd 128 and 256
// (165 and 198 KB of shared memory).  S = Q.K^T is wgmma m64nBNk16 with
// both operands K-major in shared memory and f32 accumulation.  The scale (times log2 e) and the masks are applied in
// registers, the masks only on tiles that cross the causal diagonal, the
// window's edge or T; tiles the masks hide from every row of the block are
// never loaded, and a warpgroup skips the tiles they hide from all its
// rows (the Pallas kernel's pl.when(live)).  m and l stay in f32 and l sums
// the f32 P.  O += P.V is wgmma with P from registers (the S accumulator's
// layout is the A fragment's) and V from shared memory, MN-major (the
// transpose bit).  P is split into two terms in the input dtype,
// hi = rn(P) and lo = rn(P - hi), and O += hi.V + lo.V: one rounding of P
// to bf16 (relative 2^-9) adds an error of the order of the check against
// f32 copies of the inputs (rtol 8e-3, atol 2e-3); the split keeps P's
// error below 2^-16.  The epilogue divides by max(l, 1e-30) in f32 and
// stores the rows below S.  The instance the backward's forward takes (LSE
// true, hd 128) also stores each row's log-sum-exp (m + log2 l, times
// ln 2); serving's instance is compiled without that store, so its code
// and time are the forward's alone.
// Next steps, not here: a warp-specialised producer with setmaxnreg,
// ping-pong between the consumer warpgroups with the softmax overlapping
// the next wgmma, persistent blocks, fp8.
//
// The CUDA-core route (flash_fwd_kernel, f32 only: TF32 keeps about three
// decimal digits, short of the f32 tolerance 2e-5).  One block covers one
// (batch, KV head, block of BQ query rows) and all G query heads of that KV
// head, so each K/V tile is read once per group of heads; BQ is as many
// rows as fit kMaxThreads threads.  NSUB = hd/16 threads share one (query
// row, head) pair: each owns 16 of its head dims, holding that slice of q
// and of the f32 accumulator in registers.  K and V tiles of BK keys (64,
// or 32 at hd 256) are staged in shared memory; a thread reads its dims of
// a key with 16-byte loads that all pairs of a warp share (broadcast).  A
// dot product is summed across the NSUB threads with warp shuffles; keys
// are scored kChunk at a time, so the running max and the rescale of acc
// are applied once per chunk.  Every FMA reads its k or v operand from
// shared memory, one 16-byte load per four FMAs, so it is bound by
// shared-memory bandwidth near a quarter of the f32 peak (67 TFLOP/s).
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, per launch at S=2048, causal (median of 20):
//   tinyllama (1,2048,32,64) over 4 KV heads, bf16: 0.0877 ms, 196
//     TFLOP/s (SDPA 0.0620, plain version 2.849; the CUDA-core kernel took
//     1.368 here);
//   recurrentgemma (1,2048,16,256) over 1 KV head, window 2048, bf16:
//     0.1125 ms, 306 TFLOP/s (SDPA 0.0936, plain 1.501; CUDA cores 2.975).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;
constexpr float kF32Min = -3.40282346638528859812e+38f;  // finfo(f32).min

// ------------------------------------------------ CUDA-core route (f32)
constexpr int kMaxThreads = 256;   // threads per block, at most
constexpr int kDims = 16;          // head dims owned by one thread
// keys per shared-memory tile: two f32 tiles of kBK x HD stay <= 64 KiB
template <int HD> constexpr int kBK = HD >= 256 ? 32 : 64;
constexpr int kChunk = 16;         // keys per online-softmax update

__device__ __forceinline__ float to_f32(float v) { return v; }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
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


// --------------------------------------- tensor-core route (bf16, f16)
namespace tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tile shapes at head dim HD, for a 16-bit input type.
template <int HD> struct Tile {
  static constexpr int BN = HD >= 256 ? 64 : 128;  // keys per K/V tile
  static constexpr int NWG = 2;                    // consumer warpgroups
  static constexpr int BM = 64 * NWG;              // query rows per block
  static constexpr int THREADS = 128 * NWG;
  // two blocks per SM at hd <= 64: 128 registers a thread, a few spilled
  static constexpr int MIN_BLOCKS = HD <= 64 ? 2 : 1;
  static constexpr int SW = HD >= 64 ? 128 : 64;   // swizzle span, bytes
  static constexpr int EPR = SW / 2;               // elements per smem row
  static constexpr int NCH = HD / EPR;             // row chunks across hd
  static constexpr int STAGES = 2;                 // K/V ring depth
  static constexpr int Q_BYTES = BM * HD * 2;
  static constexpr int KV_BYTES = BN * HD * 2;     // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + STAGES * 2 * KV_BYTES;
  // tiles, then the barriers (Q, K per stage, V per stage), plus the slack
  // that aligns the tiles to 1024 bytes (the swizzle's period)
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase after `parity` to complete.  A wait that outlasts
// some seconds traps: a lost TMA completion fails the launch, not the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (n == (1u << 28)) __trap();
  }
}

// One box of a 4-D tensor map (dims hd, heads, rows, batch) into shared
// memory at `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(d0), "r"(head), "r"(row),
      "r"(batch), "r"(bar)
      : "memory");
}

// ---- wgmma
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N> __device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a swizzled tile (SW-byte rows, 8-row
// groups SW*8 bytes apart).  K-major operands (Q, K) read 16 elements of a
// row, inside one swizzle span, so the leading offset is unused; the
// MN-major operand (V) spans one SW-byte atom in N, so both offsets are the
// 8-row group stride.
template <int SW>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  constexpr uint64_t kLayout = SW == 128 ? 1 : 2;  // 128B or 64B swizzle
  constexpr uint64_t kSbo = (8 * SW) >> 4;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)lbo << 16) |
         (kSbo << 32) | (kLayout << 62);
}

#define REPRO_F8(d, i)                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_F16(d, i) REPRO_F8(d, i), REPRO_F8(d, i + 8)
#define REPRO_F32(d, i) REPRO_F16(d, i), REPRO_F16(d, i + 16)
#define REPRO_F64(d) REPRO_F32(d, 0), REPRO_F32(d, 32)
#define REPRO_S16                                                       \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define REPRO_S32                                                       \
  REPRO_S16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "  \
            "%27, %28, %29, %30, %31"
#define REPRO_S64                                                       \
  REPRO_S32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "  \
            "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
            "%55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N, f32) = [d +] A (64 x 16) . B (16 x N); A and B K-major in
// shared memory.  acc = 0 overwrites d.
template <typename T, int N>
__device__ void mma_ss(float* d, uint64_t a, uint64_t b, int acc);
// d (64 x N, f32) += A (64 x 16, registers) . B (16 x N); B MN-major in
// shared memory.
template <typename T, int N>
__device__ void mma_rs(float* d, const uint32_t* a, uint64_t b);

#define REPRO_MMA(TY, CT)                                                    \
  template <>                                                                \
  __device__ __forceinline__ void mma_ss<CT, 64>(float* d, uint64_t a,       \
                                                 uint64_t b, int acc) {      \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
                 " {" REPRO_S32 "}, %32, %33, p, 1, 1, 0, 0;\n}\n"           \
                 : REPRO_F32(d, 0)                                           \
                 : "l"(a), "l"(b), "r"(acc));                                \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void mma_ss<CT, 128>(float* d, uint64_t a,      \
                                                  uint64_t b, int acc) {     \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY    \
                 " {" REPRO_S64 "}, %64, %65, p, 1, 1, 0, 0;\n}\n"           \
                 : REPRO_F64(d)                                              \
                 : "l"(a), "l"(b), "r"(acc));                                \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void mma_rs<CT, 32>(float* d, const uint32_t* a, \
                                                 uint64_t b) {               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY     \
                 " {" REPRO_S16 "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n" \
                 "}\n"                                                       \
                 : REPRO_F16(d, 0)                                           \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                   "r"(1));                                                  \
  }                                                                          \
  template <>                                                                \
  __device__ __forceinline__ void mma_rs<CT, 64>(float* d, const uint32_t* a, \
                                                 uint64_t b) {               \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
                 " {" REPRO_S32 "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n" \
                 "}\n"                                                       \
                 : REPRO_F32(d, 0)                                           \
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),       \
                   "r"(1));                                                  \
  }

REPRO_MMA("bf16", __nv_bfloat16)
REPRO_MMA("f16", __half)

// Two floats rounded to the 16-bit type and packed (a in the low half);
// ra and rb get the rounded values back as floats.
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float a, float b, float& ra,
                                                  float& rb) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    ra = __low2float(v);
    rb = __high2float(v);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};
template <> struct Pair<__half> {
  static __device__ __forceinline__ uint32_t pack(float a, float b, float& ra,
                                                  float& rb) {
    const __half2 v = __floats2half2_rn(a, b);
    ra = __low2float(v);
    rb = __high2float(v);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

// 2^x on the special-function unit (relative error about 2^-22); 2^-inf
// is 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(Tile<HD>::THREADS, Tile<HD>::MIN_BLOCKS)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, T* __restrict__ o,
                int S, int T_, int H, int G, int causal, int window,
                float scale_log2, float* __restrict__ lse, int lse_rows) {
  using C = Tile<HD>;
  constexpr int BN = C::BN, SW = C::SW, EPR = C::EPR;
  constexpr int NS = BN / 2;   // S accumulator floats per thread
  constexpr int NO = HD / 2;   // O accumulator floats per thread
  constexpr int KPR = EPR / 16;  // k-steps of Q.K^T inside one row chunk

  extern __shared__ uint8_t smem_raw[];
  __shared__ int done_with[Tile<HD>::STAGES];   // warpgroups done, per stage
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bar_q = base + C::BAR_OFF;
  // stage s: K at kv(s), V at kv(s) + KV_BYTES; barriers after Q's
  auto kv_tile = [&](int s) { return base + C::Q_BYTES + s * 2 * C::KV_BYTES; };
  auto k_bar = [&](int s) { return bar_q + 8 * (1 + s); };
  auto v_bar = [&](int s) { return bar_q + 8 * (1 + C::STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.z;
  const int qblk = gridDim.y - 1 - blockIdx.y;   // heaviest blocks first
  const int kvh = h / G;
  const int q0 = qblk * C::BM;

  // key tiles any row of this block can see
  const int q_last = min(q0 + C::BM, S) - 1;
  int k_lo = 0, k_hi = T_;
  if (causal) k_hi = min(T_, q_last + 1);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int j0 = k_lo / BN;
  const int nt = max(0, (k_hi + BN - 1) / BN - j0);

  auto load_kv = [&](int j) {
    const int s = j % C::STAGES, t0 = (j0 + j) * BN;
    mbar_expect_tx(k_bar(s), C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
      tma_load(kv_tile(s) + c * BN * SW, &kmap, k_bar(s), c * EPR, kvh, t0,
               b);
    mbar_expect_tx(v_bar(s), C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
      tma_load(kv_tile(s) + C::KV_BYTES + c * BN * SW, &vmap, v_bar(s),
               c * EPR, kvh, t0, b);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      done_with[s] = 0;
      mbar_init(k_bar(s), 1);
      mbar_init(v_bar(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
      tma_load(q_s + c * C::BM * SW, &qmap, bar_q, c * EPR, h, q0, b);
    for (int j = 0; j < min(nt, C::STAGES); ++j) load_kv(j);
  }

  // This thread's accumulator rows are row0 and row0 + 8, its columns
  // col, col + 1 of every 8 (the wgmma accumulator layout).
  const int r_lo = q0 + 64 * wg;                 // the warpgroup's rows
  const int row0 = r_lo + 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  const bool wg_live = r_lo < S;
  float oacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
  float m[2] = {kF32Min, kF32Min}, l[2] = {0.f, 0.f};
  mbar_wait(bar_q, 0);

  for (int j = 0; j < nt; ++j) {
    const int s = j % C::STAGES;
    const uint32_t ph = (j / C::STAGES) & 1;
    const int t0 = (j0 + j) * BN;
    const bool skip = !wg_live || (causal && t0 > r_lo + 63) ||
                      (window > 0 && t0 + BN - 1 <= r_lo - window);
    mbar_wait(k_bar(s), ph);
    if (!skip) {
      // S = Q . K^T
      float sacc[NS];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / KPR, w = kk % KPR;
        mma_ss<T, BN>(
            sacc,
            smem_desc<SW>(q_s + c * C::BM * SW + wg * 64 * SW + w * 32, 1),
            smem_desc<SW>(kv_tile(s) + c * BN * SW + w * 32, 1), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs<NS>(sacc);

      // scale (log2 domain), mask, online softmax
      const bool masked = (causal && t0 + BN - 1 > r_lo) ||
                          (window > 0 && t0 <= r_lo + 63 - window) ||
                          t0 + BN > T_;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        float x = sacc[i] * scale_log2;
        if (masked) {
          const int kpos = t0 + 8 * (i / 4) + col + (i & 1);
          const int qpos = row0 + 8 * ((i / 2) & 1);
          bool ok = !causal || kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          x = ok ? x : kF32Min;
          if (kpos >= T_) x = -INFINITY;       // no such key: weight 0
        }
        sacc[i] = x;
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = m[r];
#pragma unroll
        for (int i = 2 * r; i < NS; i += 4)
          mx = fmaxf(mx, fmaxf(sacc[i], sacc[i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        corr[r] = fast_exp2(m[r] - mx);
        m[r] = mx;
      }
      // P in f32, summed into l, then split into hi + lo in T, packed as
      // the A fragments of P . V (k-step kk takes pairs 4kk .. 4kk+3)
      uint32_t phi[NS / 2], plo[NS / 2];
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NS; i += 2) {
        const int r = (i / 2) & 1;
        const float p0 = fast_exp2(sacc[i] - m[r]);
        const float p1 = fast_exp2(sacc[i + 1] - m[r]);
        psum[r] += p0 + p1;
        float h0, h1, unused0, unused1;
        phi[i / 2] = Pair<T>::pack(p0, p1, h0, h1);
        plo[i / 2] = Pair<T>::pack(p0 - h0, p1 - h1, unused0, unused1);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
      for (int i = 0; i < NO; ++i) oacc[i] *= corr[(i / 2) & 1];

      // O += hi . V + lo . V
      mbar_wait(v_bar(s), ph);
      fence_regs<NO>(oacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          const uint64_t dv = smem_desc<SW>(
              kv_tile(s) + C::KV_BYTES + c * BN * SW + kk * 16 * SW,
              (8 * SW) >> 4);
          mma_rs<T, EPR>(oacc + c * (EPR / 2), phi + 4 * kk, dv);
          mma_rs<T, EPR>(oacc + c * (EPR / 2), plo + 4 * kk, dv);
        }
      }
      wg_commit();
      wg_wait_all();
      fence_regs<NO>(oacc);
    } else {
      mbar_wait(v_bar(s), ph);
    }
    // The last warpgroup done with stage s refills it: its own wgmma have
    // completed (wait_group 0) and the others' had before they counted in,
    // so no block-wide barrier ties the warpgroups to one pace.
    if (j + C::STAGES < nt && tid % 128 == 0) {
      __threadfence_block();
      if (atomicAdd(&done_with[s], 1) == C::NWG - 1) {
        done_with[s] = 0;
        load_kv(j + C::STAGES);
      }
    }
  }

  if (wg_live) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qpos = row0 + 8 * r;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      // the row's log-sum-exp of the scaled scores, natural log, for the
      // backward; serving's instance (LSE false) has no such store
      if (LSE && qpos < S && (lane & 3) == 0)
        lse[((long long)b * H + h) * lse_rows + qpos] =
            (m[r] + log2f(l[r])) * kLn2;
      if (qpos < S) {
        T* out = o + ((long long)b * S + qpos) * H * HD + (long long)h * HD +
                 col;
#pragma unroll
        for (int n8 = 0; n8 < HD / 8; ++n8) {
          float u0, u1;
          *reinterpret_cast<uint32_t*>(out + 8 * n8) =
              Pair<T>::pack(oacc[4 * n8 + 2 * r] * inv,
                            oacc[4 * n8 + 2 * r + 1] * inv, u0, u1);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, without linking libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a (B, L, NH, HD) tensor of 16-bit T, read in boxes of
// EPR head dims x 1 head x `rows` rows.
template <typename T, int HD>
bool encode_map(CUtensorMap* map, const void* ptr, int B, int L, int NH,
                int rows) {
  using C = Tile<HD>;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)NH, (cuuint64_t)L,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)NH * HD * 2,
                                 (cuuint64_t)L * NH * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)C::EPR, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map,
            std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            4, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                         : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int lse_rows, int B, int S, int T_, int H,
                   int KV, int causal, int window, cudaStream_t stream) {
  using C = Tile<HD>;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_map<T, HD>(&qmap, q, B, S, H, C::BM) ||
      !encode_map<T, HD>(&kmap, k, B, T_, KV, C::BN) ||
      !encode_map<T, HD>(&vmap, v, B, T_, KV, C::BN))
    return cudaErrorInvalidValue;
  // the log-sum-exp only where the backward takes the head dim, so every
  // other instance, and serving's at every head dim, is the forward alone
  auto kernel = flash_tc_kernel<T, HD, false>;
  if (lse != nullptr) {
    if constexpr (HD == 128)
      kernel = flash_tc_kernel<T, HD, true>;
    else
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(H, (S + C::BM - 1) / C::BM, B);
  const float scale_log2 = kLog2e / sqrtf((float)HD);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      qmap, kmap, vmap, static_cast<T*>(o), S, T_, H, H / KV, causal, window,
      scale_log2, lse, lse_rows);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        float* lse, int lse_rows, int B, int S, int T_, int H,
                        int KV, int hd, int causal, int window,
                        cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, lse, lse_rows, B, S, T_, H, KV,
                           causal, window, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, lse_rows, B, S, T_, H, KV,
                           causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, lse_rows, B, S, T_, H, KV,
                            causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, o, lse, lse_rows, B, S, T_, H, KV,
                            causal, window, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------ backward (bf16, f16)
//
// Gradients of the tensor-core forward, given its output O, the upstream
// gradient dO and the forward's per-row log-sum-exp L (natural log):
//   P = exp(scale * Q.K^T - L) under the forward's masks (0 where masked),
//   dV = P^T.dO,  dP = dO.V^T,  D = rowsum(dO * O),  dS = P * (dP - D),
//   dQ = scale * dS.K,  dK = scale * dS^T.Q,
// with P and dS rounded to the input type before their products, as the
// plain path's bf16 einsums round them, and every sum in f32.
//
// Three launches.  flash_bwd_dot_kernel: D in f32, one warp a row.
// flash_bwd_kernel: one block per (KV head, batch, tile of BN = 128 keys),
// two consumer warpgroups of 64 keys each, heaviest tiles (the first keys,
// seen by the most causal rows) issued first.  K and V of the tile are
// loaded once with TMA; the block then walks the G query heads of its KV
// head and, for each, the tiles of BM = 64 query rows the masks leave
// live, Q, dO, L and D of a tile arriving by TMA into a two-stage ring on
// one mbarrier each.  Each warpgroup computes S^T = K.Q^T and dP^T = V.dO^T
// (wgmma, both operands K-major in shared memory), P and dS in registers
// (the accumulator layout is the A fragment's), then dV += P^T.dO and
// dK += dS^T.Q with the A operand from registers and dO, Q MN-major.  dK
// and dV stay in registers across all G heads (64 + 64 floats a thread),
// so no pass reduces over heads.  dS^T goes to shared memory (128-byte
// swizzle, double-buffered); after a barrier of both warpgroups each
// computes half of dQ's head dims, dQ = dS.K over the tile's live keys
// (both operands MN-major), stages it in shared memory and adds it to an
// f32 scratch in global memory with one bulk reduce-add (TMA's
// cp.reduce.async.bulk) a tile.  flash_bwd_dq_kernel scales that scratch
// and converts it to the input type.  A warpgroup whose 64 keys the masks
// hide from a whole query tile skips it; tiles no key of the block sees are
// never visited.
//
// What bounds it: at deepseek-coder-33b's training shape (B=2, S=T=4096,
// 56 query heads over 8 KV heads, hd 128, causal) five products of the
// forward's size over the causal half: 2.5 x 4.81e11 = 1.20e12 FLOP, 1.22 ms
// at the bf16 peak, against 0.47 GB of q, k, v, o, dO and the gradients
// (0.14 ms) and the dQ scratch's f32 traffic.
template <int HD> struct BwdTile {
  static constexpr int BN = 128;                // keys per block
  static constexpr int BM = 64;                 // query rows per step
  static constexpr int NWG = 2;                 // consumer warpgroups
  static constexpr int THREADS = 128 * NWG;
  static constexpr int SW = 128, EPR = 64, NCH = HD / EPR;
  static constexpr int STAGES = 2;
  static constexpr int KV_BYTES = BN * HD * 2;  // K or V of the block
  static constexpr int QT_BYTES = BM * HD * 2;  // one Q or dO tile
  static constexpr int DS_BYTES = BN * BM * 2;  // one dS^T buffer
  static constexpr int DQ_COLS = HD / NWG;      // dQ head dims a warpgroup
  static constexpr int DQ_BYTES = BM * DQ_COLS * 4;
  static constexpr int STAGE_OFF = 2 * KV_BYTES;          // Q, dO per stage
  static constexpr int DS_OFF = STAGE_OFF + STAGES * 2 * QT_BYTES;
  static constexpr int DQ_OFF = DS_OFF + 2 * DS_BYTES;
  static constexpr int ROW_OFF = DQ_OFF + NWG * DQ_BYTES;  // L, D per stage
  static constexpr int BAR_OFF = ROW_OFF + STAGES * 2 * BM * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + STAGES) + 1024;
  static_assert(HD == 128, "the backward is built for hd 128");
};

// Rows of the log-sum-exp and D buffers: S rounded up to whole query tiles,
// so a tile's 64 values are one aligned bulk copy.
constexpr int kBwdRows = 64;

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;" ::"l"(reinterpret_cast<uint64_t>(dst)),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// the shared memory of every bulk reduce-add this thread issued is read
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// writes to shared memory by this thread are seen by wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// d (64 x 64, f32) = [d +] A (64 x 16) . B (16 x 64), both MN-major in
// shared memory (the transpose bits).
template <typename T>
__device__ void mma_ss_tt(float* d, uint64_t a, uint64_t b, int acc);
#define REPRO_MMA_TT(TY, CT)                                                 \
  template <>                                                                \
  __device__ __forceinline__ void mma_ss_tt<CT>(float* d, uint64_t a,        \
                                                uint64_t b, int acc) {       \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                \
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY     \
                 " {" REPRO_S32 "}, %32, %33, p, 1, 1, 1, 1;\n}\n"           \
                 : REPRO_F32(d, 0)                                           \
                 : "l"(a), "l"(b), "r"(acc));                                \
  }
REPRO_MMA_TT("bf16", __nv_bfloat16)
REPRO_MMA_TT("f16", __half)

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// D[b, h, row] = sum over hd of dO * O in f32, for rows below S; 0 for the
// rows up to `rows`.  One warp a row, four elements a lane.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dot_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                     float* __restrict__ dvec, int B, int S, int H,
                     int rows) {
  const long long w = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (w >= (long long)B * H * rows) return;
  const int s = (int)(w % rows);
  const long long bh = w / rows;
  const int h = (int)(bh % H), b = (int)(bh / H);
  float acc = 0.f;
  if (s < S) {
    const long long off = (((long long)b * S + s) * H + h) * HD;
#pragma unroll
    for (int d = lane * 4; d < HD; d += 128) {
      const uint2 ou = *reinterpret_cast<const uint2*>(o + off + d);
      const uint2 gu = *reinterpret_cast<const uint2*>(dout + off + d);
      const T* oe = reinterpret_cast<const T*>(&ou);
      const T* ge = reinterpret_cast<const T*>(&gu);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc = fmaf(to_float(oe[i]), to_float(ge[i]),
                                             acc);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dvec[w] = acc;
}

// The f32 dQ scratch: per (batch, head, query tile, warpgroup's half of the
// head dims) a 64 x DQ_COLS block, rows of DQ_COLS floats whose 8-float
// units are swizzled by the row (unit u of row r at u ^ (r % 8)), the
// layout the backward stages it in.
template <int HD>
__device__ __forceinline__ long long dq_index(int b, int h, int H, int nqt,
                                              int s, int d) {
  using C = BwdTile<HD>;
  const int qt = s / C::BM, r = s % C::BM, w = d / C::DQ_COLS,
            c = d % C::DQ_COLS;
  return ((((long long)b * H + h) * nqt + qt) * C::NWG + w) * C::BM *
             C::DQ_COLS +
         r * C::DQ_COLS + (((c / 8) ^ (r % 8)) * 8) + c % 8;
}

// dq[b, s, h, :] = scale * the scratch, in T; one thread per 8 head dims.
template <typename T, int HD>
__global__ void __launch_bounds__(256)
flash_bwd_dq_kernel(const float* __restrict__ acc, T* __restrict__ dq,
                    int B, int S, int H, int nqt, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * S * H * (HD / 8)) return;
  const int u = (int)(i % (HD / 8));
  const long long row = i / (HD / 8);            // (b * S + s) * H + h
  const int h = (int)(row % H);
  const long long bs = row / H;
  const int s = (int)(bs % S), b = (int)(bs / S);
  const float* src = acc + dq_index<HD>(b, h, H, nqt, s, 8 * u);
  const float4 x = *reinterpret_cast<const float4*>(src);
  const float4 y = *reinterpret_cast<const float4*>(src + 4);
  uint4 out;
  float r0, r1;
  out.x = Pair<T>::pack(x.x * scale, x.y * scale, r0, r1);
  out.y = Pair<T>::pack(x.z * scale, x.w * scale, r0, r1);
  out.z = Pair<T>::pack(y.x * scale, y.y * scale, r0, r1);
  out.w = Pair<T>::pack(y.z * scale, y.w * scale, r0, r1);
  *reinterpret_cast<uint4*>(dq + row * HD + 8 * u) = out;
}

template <typename T, int HD>
__global__ void __launch_bounds__(BwdTile<HD>::THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap,
                 const float* __restrict__ lse,
                 const float* __restrict__ dvec, float* __restrict__ dq_acc,
                 T* __restrict__ dk, T* __restrict__ dv, int S, int T_,
                 int H, int G, int rows, int causal, int window,
                 float scale_log2, float scale) {
  using C = BwdTile<HD>;
  constexpr int BM = C::BM, BN = C::BN, SW = C::SW, EPR = C::EPR;
  constexpr int KPR = EPR / 16;  // k-steps of a K-major product per chunk
  constexpr int NA = BM / 2;     // S^T and dP^T accumulator floats a thread
  constexpr int NO = HD / 2;     // dK, dV accumulator floats a thread
  constexpr int NQ = C::DQ_COLS / 2;   // dQ accumulator floats a thread

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);   // generic view of base
  const uint32_t k_s = base, v_s = base + C::KV_BYTES;
  auto q_tile = [&](int s) { return base + C::STAGE_OFF + s * 2 * C::QT_BYTES; };
  auto do_tile = [&](int s) { return q_tile(s) + C::QT_BYTES; };
  auto ds_buf = [&](int j) { return base + C::DS_OFF + (j & 1) * C::DS_BYTES; };
  auto rows_of = [&](int s) {   // L then D of stage s, BM floats each
    return reinterpret_cast<const float*>(gbase + C::ROW_OFF + s * 2 * BM * 4);
  };
  const uint32_t bar_kv = base + C::BAR_OFF;
  auto stage_bar = [&](int s) { return bar_kv + 8 * (1 + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid / 32) % 4, lane = tid % 32;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int n0 = blockIdx.z * BN;   // blockIdx.z = 0 first: the most rows
  const int nqt = rows / BM;

  // query rows that see some key of the block, as whole tiles
  const int k_last = min(n0 + BN, T_) - 1;
  const int m_lo = causal ? n0 : 0;
  const int m_hi = window > 0 ? min(S, k_last + window) : S;
  const int qt0 = m_lo / BM;
  const int nq = max(0, (m_hi + BM - 1) / BM - qt0);
  const int iters = G * nq;

  auto load_tile = [&](int j) {
    const int s = j % C::STAGES, h = kvh * G + j / nq;
    const int q0 = (qt0 + j % nq) * BM;
    mbar_expect_tx(stage_bar(s), 2 * C::QT_BYTES + 2 * BM * 4);
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      tma_load(q_tile(s) + c * BM * SW, &qmap, stage_bar(s), c * EPR, h, q0,
               b);
      tma_load(do_tile(s) + c * BM * SW, &domap, stage_bar(s), c * EPR, h,
               q0, b);
    }
    const long long at = ((long long)b * H + h) * rows + q0;
    const uint32_t rs = base + C::ROW_OFF + s * 2 * BM * 4;
    bulk_load(rs, lse + at, BM * 4, stage_bar(s));
    bulk_load(rs + BM * 4, dvec + at, BM * 4, stage_bar(s));
  };

  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) mbar_init(stage_bar(s), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
#pragma unroll
    for (int c = 0; c < C::NCH; ++c) {
      tma_load(k_s + c * BN * SW, &kmap, bar_kv, c * EPR, kvh, n0, b);
      tma_load(v_s + c * BN * SW, &vmap, bar_kv, c * EPR, kvh, n0, b);
    }
    for (int j = 0; j < min(iters, C::STAGES); ++j) load_tile(j);
  }

  // This thread's accumulator rows (keys, for S^T, dP^T, dK, dV; query
  // rows, for dQ) are r0 and r0 + 8 of its warpgroup's 64, its columns col,
  // col + 1 of every 8.
  const int r0 = 16 * warp + lane / 4;
  const int col = 2 * (lane % 4);
  const int kb = n0 + 64 * wg;                   // the warpgroup's keys
  float dkacc[NO], dvacc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) dkacc[i] = dvacc[i] = 0.f;
  mbar_wait(bar_kv, 0);

  for (int j = 0; j < iters; ++j) {
    const int s = j % C::STAGES;
    const uint32_t ph = (j / C::STAGES) & 1;
    const int h = kvh * G + j / nq;
    const int qt = qt0 + j % nq, q0 = qt * BM;
    const int q_max = min(q0 + BM, S) - 1;
    // does any (key, row) pair of keys [k0, k0 + 64) and this tile count?
    auto live = [&](int k0) {
      return k0 < T_ && !(causal && k0 > q_max) &&
             !(window > 0 && k0 + 63 <= q0 - window);
    };
    const bool live0 = live(n0), live1 = live(n0 + 64);
    mbar_wait(stage_bar(s), ph);
    if (wg == 0 ? live0 : live1) {
      const float* lrow = rows_of(s);
      const float* drow = lrow + BM;
      // S^T = K . Q^T  (keys x query rows)
      float pacc[NA];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / KPR, w = kk % KPR;
        mma_ss<T, BM>(pacc,
                      smem_desc<SW>(k_s + c * BN * SW + wg * 64 * SW + w * 32, 1),
                      smem_desc<SW>(q_tile(s) + c * BM * SW + w * 32, 1), kk > 0);
      }
      wg_commit();
      // dP^T = V . dO^T, issued behind S^T
      float dpacc[NA];
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int c = kk / KPR, w = kk % KPR;
        mma_ss<T, BM>(dpacc,
                      smem_desc<SW>(v_s + c * BN * SW + wg * 64 * SW + w * 32, 1),
                      smem_desc<SW>(do_tile(s) + c * BM * SW + w * 32, 1), kk > 0);
      }
      wg_commit();
      asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
      fence_regs<NA>(pacc);

      // P = exp2(S * scale * log2 e - L * log2 e), 0 where masked
      const bool masked = (causal && kb + 63 > q0) ||
                          (window > 0 && kb <= q_max - window) ||
                          kb + 64 > T_ || q0 + BM > S;
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        const int qc = 8 * (i / 4) + col + (i & 1);
        float p = fast_exp2(pacc[i] * scale_log2 - lrow[qc] * kLog2e);
        if (masked) {
          const int key = kb + r0 + 8 * ((i / 2) & 1), qpos = q0 + qc;
          bool ok = key < T_ && qpos < S && (!causal || key <= qpos);
          if (window > 0) ok = ok && key > qpos - window;
          p = ok ? p : 0.f;
        }
        pacc[i] = p;
      }
      wg_wait_all();
      fence_regs<NA>(dpacc);

      // dS = P * (dP - D); P and dS rounded to T as the products' A
      // fragments, dS^T also to shared memory for dQ
      uint32_t pp[NA / 2], dsp[NA / 2];
      const uint32_t dsb = ds_buf(j);
#pragma unroll
      for (int i = 0; i < NA; i += 2) {
        const int qc = 8 * (i / 4) + col;
        float u0, u1;
        pp[i / 2] = Pair<T>::pack(pacc[i], pacc[i + 1], u0, u1);
        dsp[i / 2] = Pair<T>::pack(pacc[i] * (dpacc[i] - drow[qc]),
                                   pacc[i + 1] * (dpacc[i + 1] - drow[qc + 1]),
                                   u0, u1);
        const int r = 64 * wg + r0 + 8 * ((i / 2) & 1);   // key in the block
        const uint32_t at = dsb + r * SW + ((((i / 4) ^ (r % 8))) << 4) + col * 2;
        asm volatile("st.shared.u32 [%0], %1;" ::"r"(at), "r"(dsp[i / 2])
                     : "memory");
      }
      fence_async_smem();

      // dV += P^T . dO,  dK += dS^T . Q
      fence_regs<NO>(dvacc);
      fence_regs<NO>(dkacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
#pragma unroll
        for (int c = 0; c < C::NCH; ++c) {
          mma_rs<T, EPR>(dvacc + c * (EPR / 2), pp + 4 * kk,
                         smem_desc<SW>(do_tile(s) + c * BM * SW + kk * 16 * SW,
                                       (8 * SW) >> 4));
          mma_rs<T, EPR>(dkacc + c * (EPR / 2), dsp + 4 * kk,
                         smem_desc<SW>(q_tile(s) + c * BM * SW + kk * 16 * SW,
                                       (8 * SW) >> 4));
        }
      }
      wg_commit();
      wg_wait_all();
      fence_regs<NO>(dvacc);
      fence_regs<NO>(dkacc);
    }
    // both warpgroups' dS^T are in shared memory, stage s is read, and the
    // dQ staging's last bulk add has read it
    if (tid % 128 == 0) bulk_wait_read();
    named_sync(1, C::THREADS);
    if (tid == 0 && j + C::STAGES < iters) load_tile(j + C::STAGES);

    // dQ[:, this warpgroup's head dims] = dS . K over the live keys
    if (live0 || live1) {
      const int kk0 = live0 ? 0 : 4, kk1 = live1 ? 8 : 4;
      const uint32_t dsb = ds_buf(j);
      float dqacc[NQ];
      wg_fence();
      for (int kk = kk0; kk < kk1; ++kk)
        mma_ss_tt<T>(dqacc, smem_desc<SW>(dsb + kk * 16 * SW, (8 * SW) >> 4),
                     smem_desc<SW>(k_s + wg * BN * SW + kk * 16 * SW,
                                   (8 * SW) >> 4),
                     kk > kk0);
      wg_commit();
      wg_wait_all();
      fence_regs<NQ>(dqacc);
      uint8_t* stage = gbase + C::DQ_OFF + wg * C::DQ_BYTES;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = r0 + 8 * rr;
#pragma unroll
        for (int n8 = 0; n8 < C::DQ_COLS / 8; ++n8)
          *reinterpret_cast<float2*>(stage + r * C::DQ_COLS * 4 +
                                     ((n8 ^ (r % 8)) * 32) + col * 4) =
              make_float2(dqacc[4 * n8 + 2 * rr], dqacc[4 * n8 + 2 * rr + 1]);
      }
      fence_async_smem();
      named_sync(2 + wg, 128);
      if (tid % 128 == 0)
        bulk_reduce_add(dq_acc + dq_index<HD>(b, h, H, nqt, q0,
                                               wg * C::DQ_COLS),
                        base + C::DQ_OFF + wg * C::DQ_BYTES, C::DQ_BYTES);
    }
  }
  if (tid % 128 == 0) bulk_wait_all();

  // dK (times the softmax scale) and dV of the warpgroup's keys below T
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = kb + r0 + 8 * rr;
    if (key < T_) {
      const long long off = (((long long)b * T_ + key) * (H / G) + kvh) * HD +
                            col;
#pragma unroll
      for (int n8 = 0; n8 < HD / 8; ++n8) {
        float u0, u1;
        *reinterpret_cast<uint32_t*>(dk + off + 8 * n8) =
            Pair<T>::pack(dkacc[4 * n8 + 2 * rr] * scale,
                          dkacc[4 * n8 + 2 * rr + 1] * scale, u0, u1);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * n8) =
            Pair<T>::pack(dvacc[4 * n8 + 2 * rr], dvacc[4 * n8 + 2 * rr + 1],
                          u0, u1);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* dout, const float* lse,
                       float* dvec, float* dq_acc, void* dq, void* dk,
                       void* dv, int B, int S, int T_, int H, int KV,
                       int rows, int causal, int window,
                       cudaStream_t stream) {
  using C = BwdTile<HD>;
  {
    const long long warps = (long long)B * H * rows;
    flash_bwd_dot_kernel<T, HD><<<(unsigned)((warps * 32 + 255) / 256), 256, 0,
                                  stream>>>(static_cast<const T*>(o),
                                            static_cast<const T*>(dout), dvec,
                                            B, S, H, rows);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  CUtensorMap qmap, kmap, vmap, domap;
  if (!encode_map<T, HD>(&qmap, q, B, S, H, C::BM) ||
      !encode_map<T, HD>(&domap, dout, B, S, H, C::BM) ||
      !encode_map<T, HD>(&kmap, k, B, T_, KV, C::BN) ||
      !encode_map<T, HD>(&vmap, v, B, T_, KV, C::BN))
    return cudaErrorInvalidValue;
  auto kernel = flash_bwd_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf((float)HD);
  dim3 grid(KV, B, (T_ + C::BN - 1) / C::BN);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(
      qmap, kmap, vmap, domap, lse, dvec, dq_acc, static_cast<T*>(dk),
      static_cast<T*>(dv), S, T_, H, H / KV, rows, causal, window,
      kLog2e * scale, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = (long long)B * S * H * (HD / 8);
  flash_bwd_dq_kernel<T, HD><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      dq_acc, static_cast<T*>(dq), B, S, H, rows / C::BM, scale);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace

// o = attention(q, k, v) on `stream` on the CUDA cores: dtype 0 (f32) only;
// hd in {32, 64, 128, 256}; H % KV == 0; window <= 0 means none;
// (hd / 16) * (H / KV) <= 256; vec: k and v start 16-byte aligned.
// Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype, int B,
                                     int S, int T, int H, int KV, int hd,
                                     int causal, int window, int vec,
                                     void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || dtype != kF32)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_hd<float>(q, k, v, o, B, S, T, H, KV, hd, causal,
                                 window, vec,
                                 static_cast<cudaStream_t>(stream));
}

// o = attention(q, k, v) on `stream` on the tensor cores: dtype 1 (bf16) or
// 2 (f16), q, k and v alike and starting 16-byte aligned (TMA reads them);
// hd in {32, 64, 128, 256}; H % KV == 0; window <= 0 means none.  With
// `lse` (f32, B x H x lse_rows, lse_rows >= S; hd 128 only) it also writes
// each row's natural-log log-sum-exp of the scaled scores at [b, h, row]
// for rows below S; null writes nothing.  Returns the launch's
// cudaError_t.
extern "C" int repro_flash_attention_tc(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int lse_rows, int dtype, int B, int S,
                                        int T, int H, int KV, int hd,
                                        int causal, int window,
                                        void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 ||
      (lse != nullptr && lse_rows < S))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) & 15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (dtype) {
    case kBF16:
      return (int)tc::dispatch_hd<__nv_bfloat16>(q, k, v, o, l, lse_rows, B,
                                                 S, T, H, KV, hd, causal,
                                                 window, st);
    case kF16:
      return (int)tc::dispatch_hd<__half>(q, k, v, o, l, lse_rows, B, S, T,
                                          H, KV, hd, causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Gradients of attention(q, k, v) on `stream` on the tensor cores: dtype 1
// (bf16) or 2 (f16); q, o and dout (B, S, H, hd), k and v (B, T, KV, hd),
// all contiguous and 16-byte aligned; hd 128; H % KV == 0; window <= 0 means
// none.  lse (B x H x rows, f32) is the forward's; rows is S rounded up to
// a multiple of 64, and lse and dvec start 16-byte aligned.  dvec (B x H x
// rows f32) is scratch; dq_acc (f32, B x H x rows x hd) must hold zeros.
// Writes dq (like q), dk and dv (like k).  Returns the first launch's
// error.
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dvec, void* dq_acc, void* dq,
    void* dk, void* dv, int dtype, int B, int S, int T, int H, int KV, int hd,
    int rows, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || T <= 0 || KV <= 0 || H % KV != 0 || hd != 128 ||
      rows < S || rows % tc::kBwdRows != 0)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o |
       (uintptr_t)dout | (uintptr_t)lse | (uintptr_t)dvec |
       (uintptr_t)dq_acc | (uintptr_t)dq | (uintptr_t)dk | (uintptr_t)dv) &
      15)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(dvec);
  float* a = static_cast<float*>(dq_acc);
  switch (dtype) {
    case kBF16:
      return (int)tc::launch_bwd<__nv_bfloat16, 128>(
          q, k, v, o, dout, l, d, a, dq, dk, dv, B, S, T, H, KV, rows, causal,
          window, st);
    case kF16:
      return (int)tc::launch_bwd<__half, 128>(q, k, v, o, dout, l, d, a, dq,
                                              dk, dv, B, S, T, H, KV, rows,
                                              causal, window, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one block of the tensor-core kernel at head dim
// hd, in bytes; 0 for a head dim it does not take.
extern "C" int repro_flash_attention_tc_smem(int hd) {
  switch (hd) {
    case 32: return tc::Tile<32>::SMEM;
    case 64: return tc::Tile<64>::SMEM;
    case 128: return tc::Tile<128>::SMEM;
    case 256: return tc::Tile<256>::SMEM;
    default: return 0;
  }
}
