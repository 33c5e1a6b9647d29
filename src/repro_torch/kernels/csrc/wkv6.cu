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
// kernels/ref.py::rwkv6_ref; the sums run in another order, so the two
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
// 1.68 GFLOP, 0.025 ms at 67 TFLOP/s.  The recurrence is one chain of S
// steps per (batch, head), and there are only B*H = 40 of them at B=1, so a
// kernel that walks each chain in one block leaves most of the card idle.
//
// Design: time is cut into chunks of C = 4096/hd steps (64 at hd 64), and
// the chain is split across blocks in three launches:
//   1. chunk states, a block per (batch, head, chunk) but the last: the
//      state the chunk leaves from a zero start, L_c = sum_t K_t^T v_t with
//      K_t[i] = k_t[i] prod_{t < tau in chunk} w_tau[i], as a (hd x C).(C x
//      hd) product register-tiled on the CUDA cores, and the chunk's decay
//      D_c[i] = prod_{tau in chunk} w_tau[i];
//   2. carry, a thread per four state entries, sequential over the chunks:
//      S_{c+1} = D_c (rows) S_c + L_c, written over L_c;
//   3. outputs, a block per (batch, head, chunk): the recurrence rerun over
//      the chunk's C steps from its true start state S_c, writing out; the
//      last chunk's block writes the final state from its registers.
// With one chunk (S <= C) only launch 3 runs, from zero.  At the path's
// shape launch 3 has 40 x 32 = 1280 blocks, where a block per chain would
// have 40.  Every decay is a product of w in [0, 1], with no log and
// no division: w = 0 resets the state, a denormal w flushes it, and a
// product that underflows to 0 is the right limit, where a log-domain form
// turns w = 0 into -inf - (-inf) = NaN.  The chunked form does 7 operations
// per (step, key, value), a multiply-add in launch 1 and the recurrence's 5
// in launch 3, where the bound counts 5; and the chunk states, hd (hd + 1)
// f32 per chunk (20.6 MB at the path's shape, in scratch the wrapper
// allocates), go through memory three times.  Launches 2 and 3 are
// programmatic dependent launches: each starts while the one before it
// drains, issues the loads that do not depend on it, and waits
// (griddepcontrol.wait) before it reads the chunk states.
//
// In launch 3 a thread per (4 value columns, quarter of the keys) holds 64
// state entries at hd 64 in registers; the block stages 512/hd steps of r,
// k, w and v at a time in shared memory as f32 while the next ones load
// into registers; each step's four partial read-outs of a column are
// summed with two warp shuffles.
// The keys of a quarter are interleaved by fours, so a warp's four quarters
// read adjacent 16-byte words of shared memory.  The bonus term sum_i r_i
// u_i k_i is one dot product per step, taken once per block and added to
// every column.  Launch 3 is bound by its instruction issue (PERF.md);
// launches 1 and 2 by memory.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;
constexpr int kChunkElems = 4096;  // steps per chunk x hd
constexpr int kSubElems = 512;     // steps staged at once x hd (launch 3)
constexpr int kCols = 4;           // value columns per thread (launch 3)
constexpr int kGroups = 4;         // key groups a column is split into
constexpr int kStateThreads = 256; // launch 1
constexpr int kCarryThreads = 256; // launch 2
constexpr int kCarryBatch = 32;    // chunk states loaded at once (launch 2)

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

// N consecutive floats at p (N = 2 or a multiple of 4), aligned to 4 N
// bytes (16 at most), into a; and back.
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&a)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int x = 0; x < N; x += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + x);
      a[x] = q.x; a[x + 1] = q.y; a[x + 2] = q.z; a[x + 3] = q.w;
    }
  } else {
    static_assert(N == 2, "load_vec of 2 or 4k floats");
    const float2 q = *reinterpret_cast<const float2*>(p);
    a[0] = q.x; a[1] = q.y;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&a)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int x = 0; x < N; x += 4)
      *reinterpret_cast<float4*>(p + x) =
          make_float4(a[x], a[x + 1], a[x + 2], a[x + 3]);
  } else {
    static_assert(N == 2, "store_vec of 2 or 4k floats");
    *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
  }
}

// N values of T stored at once, for an address aligned to N sizeof(T).
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
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

// Launch 1: the state chunk c (never the last) leaves from a zero start,
// and its decay.  256 threads: first each takes one key over 16 of the
// chunk's steps and decays k to the chunk's end; then each takes a
// (hd/16 x hd/16) tile of L_c.
template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(kStateThreads)
wkv6_chunk_state(const T* __restrict__ k, const T* __restrict__ v,
                 const TW* __restrict__ w, float* __restrict__ states,
                 float* __restrict__ decay, int S, int H, int n) {
  constexpr int C = kChunkElems / HD;
  constexpr int NSEG = kStateThreads / HD;   // time segments per key
  constexpr int SEG = C / NSEG;              // steps per segment
  constexpr int TI = HD / 16;                // tile edge of L_c per thread
  __shared__ __align__(16) float sk[kChunkElems];   // decayed k, [t][i]
  __shared__ __align__(16) float sv[kChunkElems];   // v, [t][j]
  __shared__ float sp[NSEG * HD];                   // segment decays

  allow_dependents();   // the carry may launch; it waits for this grid
  const int c = blockIdx.x % (n - 1);
  const int bh = blockIdx.x / (n - 1);
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const long long row = (long long)H * HD;      // elements between steps
  const long long base = ((long long)b * S * H + h) * HD +
                         (long long)c * C * row;  // (b, chunk start, h, 0)

  // v as it is; every step of the chunk lies before S
#pragma unroll 4
  for (int e = tid; e < kChunkElems; e += kStateThreads)
    sv[e] = to_f32(v[base + (long long)(e / HD) * row + e % HD]);

  // k of key i over segment seg, decayed by the segment's later steps
  const int i = tid % HD, seg = tid / HD;
  float kk[SEG], ww[SEG];
#pragma unroll
  for (int s = 0; s < SEG; ++s) {
    const long long off = base + (long long)(seg * SEG + s) * row + i;
    kk[s] = to_f32(k[off]);
    ww[s] = to_f32(w[off]);
  }
  float p = 1.f;
#pragma unroll
  for (int s = SEG - 1; s >= 0; --s) {
    kk[s] *= p;
    p *= ww[s];
  }
  sp[seg * HD + i] = p;
  __syncthreads();
  float later = 1.f;  // the decay of the segments after this one
  for (int g = seg + 1; g < NSEG; ++g) later *= sp[g * HD + i];
#pragma unroll
  for (int s = 0; s < SEG; ++s) sk[(seg * SEG + s) * HD + i] = kk[s] * later;
  const long long slot = (long long)bh * (n - 1) + c;
  if (seg == 0) decay[slot * HD + i] = later * p;
  __syncthreads();

  // L_c[i][j] = sum_t sk[t][i] sv[t][j], a TI x TI tile per thread; a
  // warp takes 4 x 8 tiles, so it reads 4 and 8 adjacent vectors per step
  const int warp = tid >> 5, lane = tid & 31;
  const int ti = (warp >> 1) * 4 + (lane >> 3);
  const int tj = (warp & 1) * 8 + (lane & 7);
  float acc[TI][TI];
#pragma unroll
  for (int x = 0; x < TI; ++x)
#pragma unroll
    for (int y = 0; y < TI; ++y) acc[x][y] = 0.f;
#pragma unroll 4
  for (int t = 0; t < C; ++t) {
    float a[TI], bv[TI];
    load_vec<TI>(sk + t * HD + ti * TI, a);
    load_vec<TI>(sv + t * HD + tj * TI, bv);
#pragma unroll
    for (int x = 0; x < TI; ++x)
#pragma unroll
      for (int y = 0; y < TI; ++y) acc[x][y] = fmaf(a[x], bv[y], acc[x][y]);
  }
  float* L = states + slot * HD * HD;
#pragma unroll
  for (int x = 0; x < TI; ++x)
    store_vec<TI>(L + (ti * TI + x) * HD + tj * TI, acc[x]);
}

// Launch 2: S_{c+1} = D_c S_c + L_c over the chunks, from S_0 = 0, written
// over L_c.  A thread per four consecutive entries of one row of a state.
template <int HD>
__global__ void __launch_bounds__(kCarryThreads)
wkv6_carry(float* __restrict__ states, const float* __restrict__ decay,
           long long entries4, int n1) {
  allow_dependents();   // launch 3 may launch and stage its first steps
  wait_for_previous();  // launch 1's chunk states
  const long long q = (long long)blockIdx.x * kCarryThreads + threadIdx.x;
  if (q >= entries4) return;
  constexpr int kQuads = HD * HD / 4;           // float4s per state
  const long long bh = q / kQuads;
  const int e4 = (int)(q % kQuads);
  const int i = e4 * 4 / HD;
  float4* L = reinterpret_cast<float4*>(states) + bh * n1 * kQuads + e4;
  const float* D = decay + bh * n1 * HD + i;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < n1; c0 += kCarryBatch) {
    float4 l[kCarryBatch];
    float d[kCarryBatch];
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      if (c0 + u < n1) {
        l[u] = L[(long long)(c0 + u) * kQuads];
        d[u] = D[(long long)(c0 + u) * HD];
      }
    }
#pragma unroll
    for (int u = 0; u < kCarryBatch; ++u) {
      if (c0 + u < n1) {
        s.x = fmaf(d[u], s.x, l[u].x);
        s.y = fmaf(d[u], s.y, l[u].y);
        s.z = fmaf(d[u], s.z, l[u].z);
        s.w = fmaf(d[u], s.w, l[u].w);
        L[(long long)(c0 + u) * kQuads] = s;
      }
    }
  }
}

// Launch 3: the recurrence over chunk c from its start state, writing out;
// the last chunk also writes the final state.  kGroups hd / kCols threads:
// thread (columns j0..j0+kCols-1, key group g) holds S[i][j] for its
// columns and the keys i = 4 kGroups m + 4 g + x, so a warp's groups read
// adjacent 16-byte words of shared memory.
template <typename T, typename TW, int HD>
__global__ void __launch_bounds__(kGroups * HD / kCols)
wkv6_chunk_out(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const TW* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ states,
               T* __restrict__ out, float* __restrict__ final_state, int S,
               int H, int n) {
  constexpr int kThreads = kGroups * HD / kCols;
  constexpr int kSlots = 32 / kGroups;         // column slots per warp
  constexpr int C = kChunkElems / HD;
  constexpr int SUB = kSubElems / HD;          // steps staged at once
  constexpr int NI = HD / kGroups;             // keys per thread
  constexpr int PER = kSubElems / kThreads;    // elements staged per thread
  static_assert(kThreads >= 32 && PER >= 1 && kSubElems % kThreads == 0 &&
                C % SUB == 0 && NI % 4 == 0, "launch 3's tiling");
  __shared__ __align__(16) float sr[kSubElems];
  __shared__ __align__(16) float sk[kSubElems];
  __shared__ __align__(16) float sw[kSubElems];
  __shared__ __align__(16) float sv[kSubElems];
  __shared__ float su[HD];
  __shared__ float sb[SUB];   // the bonus dot product of each step

  const int c = blockIdx.x % n;
  const int bh = blockIdx.x / n;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int grp = lane / kSlots;                              // key group
  const int j0 = (warp * kSlots + lane % kSlots) * kCols;     // first column
  const long long row = (long long)H * HD;
  const long long base = ((long long)b * S * H + h) * HD;  // (b, 0, h, 0)
  const int t_begin = c * C;
  const int t_end = S - t_begin < C ? S : t_begin + C;
  auto key = [&](int q) { return 4 * kGroups * (q / 4) + 4 * grp + q % 4; };

  // A sub-chunk in flight: element e is (step e / HD, key or column
  // e % HD); zero past the chunk's end.
  T pr[PER], pk[PER], pv[PER];
  TW pw[PER];
  auto load = [&](int t0) {
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + kThreads * m;
      const int t = t0 + e / HD;
      const long long off = base + (long long)t * row + e % HD;
      const bool in = t < t_end;
      pr[m] = in ? r[off] : from_f32<T>(0.f);
      pk[m] = in ? k[off] : from_f32<T>(0.f);
      pv[m] = in ? v[off] : from_f32<T>(0.f);
      pw[m] = in ? w[off] : from_f32<TW>(0.f);
    }
  };

  load(t_begin);
  if (tid < HD) su[tid] = u[h * HD + tid];
  wait_for_previous();  // the carry's start states (a no-op after launch 1)
  float st[NI][kCols];
  if (c == 0) {
#pragma unroll
    for (int q = 0; q < NI; ++q)
#pragma unroll
      for (int x = 0; x < kCols; ++x) st[q][x] = 0.f;
  } else {
    const float* s0 = states + ((long long)bh * (n - 1) + c - 1) * HD * HD;
#pragma unroll
    for (int q = 0; q < NI; ++q) load_vec<kCols>(s0 + key(q) * HD + j0, st[q]);
  }

  for (int t0 = t_begin; t0 < t_end; t0 += SUB) {
    __syncthreads();  // every thread is done with the previous sub-chunk
#pragma unroll
    for (int m = 0; m < PER; ++m) {
      const int e = tid + kThreads * m;
      sr[e] = to_f32(pr[m]);
      sk[e] = to_f32(pk[m]);
      sw[e] = to_f32(pw[m]);
      sv[e] = to_f32(pv[m]);
    }
    __syncthreads();
    if (t0 + SUB < t_end) load(t0 + SUB);  // in flight while this computes
    const int steps = t_end - t0 < SUB ? t_end - t0 : SUB;
    for (int s = warp; s < steps; s += kThreads / 32) {
      float x = 0.f;
#pragma unroll
      for (int i = lane; i < HD; i += 32)
        x = fmaf(sr[s * HD + i] * su[i], sk[s * HD + i], x);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) sb[s] = x;
    }
    __syncthreads();
    for (int s = 0; s < steps; ++s) {
      float vj[kCols];
      load_vec<kCols>(sv + s * HD + j0, vj);
      const float4* r4 = reinterpret_cast<const float4*>(sr + s * HD) + grp;
      const float4* k4 = reinterpret_cast<const float4*>(sk + s * HD) + grp;
      const float4* w4 = reinterpret_cast<const float4*>(sw + s * HD) + grp;
      float acc0[kCols], acc1[kCols];
#pragma unroll
      for (int x = 0; x < kCols; ++x) acc0[x] = acc1[x] = 0.f;
#pragma unroll
      for (int m = 0; m < NI / 4; ++m) {
        const float4 rq = r4[kGroups * m], kq = k4[kGroups * m],
                     wq = w4[kGroups * m];
#pragma unroll
        for (int x = 0; x < kCols; ++x) {
          acc0[x] = fmaf(rq.x, st[4 * m][x], acc0[x]);
          acc1[x] = fmaf(rq.y, st[4 * m + 1][x], acc1[x]);
          acc0[x] = fmaf(rq.z, st[4 * m + 2][x], acc0[x]);
          acc1[x] = fmaf(rq.w, st[4 * m + 3][x], acc1[x]);
          st[4 * m][x] = fmaf(wq.x, st[4 * m][x], kq.x * vj[x]);
          st[4 * m + 1][x] = fmaf(wq.y, st[4 * m + 1][x], kq.y * vj[x]);
          st[4 * m + 2][x] = fmaf(wq.z, st[4 * m + 2][x], kq.z * vj[x]);
          st[4 * m + 3][x] = fmaf(wq.w, st[4 * m + 3][x], kq.w * vj[x]);
        }
      }
      Pack<T, kCols> o;
      const float bonus = sb[s];
#pragma unroll
      for (int x = 0; x < kCols; ++x) {
        float acc = acc0[x] + acc1[x];
#pragma unroll
        for (int o = kSlots; o < 32; o <<= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        o.v[x] = from_f32<T>(fmaf(bonus, vj[x], acc));
      }
      if (grp == 0)
        *reinterpret_cast<Pack<T, kCols>*>(
            out + base + (long long)(t0 + s) * row + j0) = o;
    }
  }
  if (c == n - 1) {
    float* fs = final_state + (long long)bh * HD * HD;
#pragma unroll
    for (int q = 0; q < NI; ++q)
      store_vec<kCols>(fs + key(q) * HD + j0, st[q]);
  }
}

int chunks(int S, int hd) {
  const int C = kChunkElems / hd;
  return (S + C - 1) / C;
}

long long scratch_bytes(int B, int S, int H, int hd) {
  const long long slots = (long long)B * H * (chunks(S, hd) - 1);
  return slots * hd * (hd + 1) * (long long)sizeof(float);
}

template <typename T, typename TW, int HD>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, void* out, void* final_state, int B, int S,
                   int H, float* scratch, cudaStream_t stream) {
  const int n = chunks(S, HD);
  const long long bhs = (long long)B * H;
  if (bhs * n > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  float* states = scratch;
  float* decay = scratch + bhs * (n - 1) * HD * HD;
  if (n > 1) {
    wkv6_chunk_state<T, TW, HD>
        <<<(unsigned)(bhs * (n - 1)), kStateThreads, 0, stream>>>(
            static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const TW*>(w), states, decay, S, H, n);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const long long entries4 = bhs * HD * HD / 4;
    err = launch_dependent(
        wkv6_carry<HD>,
        dim3((unsigned)((entries4 + kCarryThreads - 1) / kCarryThreads)),
        dim3(kCarryThreads), stream, states, (const float*)decay, entries4,
        n - 1);
    if (err != cudaSuccess) return err;
    return launch_dependent(
        wkv6_chunk_out<T, TW, HD>, dim3((unsigned)(bhs * n)),
        dim3(kGroups * HD / kCols), stream, static_cast<const T*>(r),
        static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const TW*>(w), static_cast<const float*>(u),
        (const float*)states, static_cast<T*>(out),
        static_cast<float*>(final_state), S, H, n);
  }
  wkv6_chunk_out<T, TW, HD><<<(unsigned)(bhs * n), kGroups * HD / kCols, 0,
                              stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const TW*>(w),
      static_cast<const float*>(u), states, static_cast<T*>(out),
      static_cast<float*>(final_state), S, H, n);
  return cudaGetLastError();
}

template <typename T, typename TW>
cudaError_t launch_hd(const void* r, const void* k, const void* v,
                      const void* w, const void* u, void* out,
                      void* final_state, int B, int S, int H, int hd,
                      float* scratch, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, TW, 32>(r, k, v, w, u, out, final_state, B, S, H,
                               scratch, st);
    case 64:
      return launch<T, TW, 64>(r, k, v, w, u, out, final_state, B, S, H,
                               scratch, st);
    case 128:
      return launch<T, TW, 128>(r, k, v, w, u, out, final_state, B, S, H,
                                scratch, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t launch_w(bool w_f32, const void* r, const void* k, const void* v,
                     const void* w, const void* u, void* out,
                     void* final_state, int B, int S, int H, int hd,
                     float* scratch, cudaStream_t st) {
  if (w_f32)
    return launch_hd<T, float>(r, k, v, w, u, out, final_state, B, S, H, hd,
                               scratch, st);
  return launch_hd<T, T>(r, k, v, w, u, out, final_state, B, S, H, hd,
                         scratch, st);
}

bool valid(int B, int S, int H, int hd) {
  return B > 0 && S > 0 && H > 0 && (hd == 32 || hd == 64 || hd == 128);
}

}  // namespace

// Bytes of scratch a call of repro_rwkv6_wkv at this shape needs (0 when
// S fits one chunk), or -1 for a shape it does not take.
extern "C" long long repro_rwkv6_wkv_scratch(int B, int S, int H, int hd) {
  return valid(B, S, H, hd) ? scratch_bytes(B, S, H, hd) : -1;
}

// out, final = wkv6(r, k, v, w, u) on `stream`.  dtype: 0 f32, 1 bf16, 2 f16
// (r, k, v and out alike); w_dtype is 0 or dtype; u and final are f32.
// B, S, H > 0 and hd in {32, 64, 128}.  scratch: device memory of at least
// repro_rwkv6_wkv_scratch(B, S, H, hd) bytes, 16-byte aligned, its contents
// not read.  Returns the first failed launch's cudaError_t, or 0.
extern "C" int repro_rwkv6_wkv(const void* r, const void* k, const void* v,
                               const void* w, const void* u, void* out,
                               void* final_state, int dtype, int w_dtype,
                               int B, int S, int H, int hd, void* scratch,
                               long long scratch_size, void* stream) {
  if (!valid(B, S, H, hd) || (w_dtype != kF32 && w_dtype != dtype) ||
      scratch_size < scratch_bytes(B, S, H, hd) ||
      reinterpret_cast<unsigned long long>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scratch);
  const bool w_f32 = w_dtype == kF32;
  switch (dtype) {
    case kF32:
      return (int)launch_hd<float, float>(r, k, v, w, u, out, final_state, B,
                                          S, H, hd, sc, st);
    case kBF16:
      return (int)launch_w<__nv_bfloat16>(w_f32, r, k, v, w, u, out,
                                          final_state, B, S, H, hd, sc, st);
    case kF16:
      return (int)launch_w<__half>(w_f32, r, k, v, w, u, out, final_state, B,
                                   S, H, hd, sc, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
