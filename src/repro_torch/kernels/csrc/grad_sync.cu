// Gradient-sync staging kernels for Hopper (sm_90a), bound to Python with
// ctypes through a plain C interface (see ../build.py and ../ops.py).
//
// They replace the Pallas kernels of the JAX reference:
//   convert_copy_kernel <- src/repro/kernels/bucket_pack.py:20
//                          (convert_copy_kernel, body _kernel)
//   bucket_pack_kernel  <- src/repro/kernels/bucket_pack.py:44
//                          (bucket_pack_kernel)
//   fused_pack_kernel   <- src/repro/kernels/fused_grad_sync.py:40
//                          (fused_pack_kernel)
//   fused_unpack_kernel <- src/repro/kernels/fused_grad_sync.py:66
//                          (fused_unpack_kernel)
//
// What bounds them: all four are pure HBM streams with one conversion per
// element, so the bound is bytes / 3.35 TB/s.  For the largest tinyllama-1.1b
// bucket (one 22 x 2048 x 5632 bf16 MLP leaf, 253.8M elements) the pack reads
// 508 MB of bf16 and writes 1015 MB of f32: 0.45 ms at 3.35 TB/s; the unpack
// moves the same bytes the other way.
//
// Design: the Pallas versions tile one leaf at a time through VMEM, one
// pallas_call per leaf.  Here one launch covers a whole bucket (the bucket
// pack is the fused pack's table at dp=1 and one chunk, written in the
// bucket's out dtype).  The host
// (ops.py) cuts the bucket into segments -- a run of elements of one leaf
// that lands in one chunk of the staged buffer, or a run of zeros (the pad
// to `total` and each chunk's pad to a multiple of dp) -- and passes a table
// of them in device memory.  Each segment is split into tiles of
// `tile_elems` elements; blocks walk the tiles with a grid-stride loop and
// find their segment by binary search over the tiles' prefix.  A segment
// whose source and destination are 16-byte aligned moves 8 elements per
// thread per step with 16-byte vector loads and stores; others (only odd
// offsets from chunk cuts or dp padding) take a scalar loop.
// f32 -> bf16/f16 conversion rounds to nearest even (__float2bfloat16_rn,
// __float2half_rn), so results equal PyTorch's .to() bit for bit.
// Later work: start each chunk's reduce-scatter on a side stream as soon as
// its staging lands, and move tiles with TMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2, kZero = -1;
constexpr int kThreads = 256;
constexpr int kVec = 8;        // elements per thread per vector step
constexpr int kRowWords = 8;   // int64 words per segment-table row

template <int DT> struct Elem;
template <> struct Elem<kF32> { using T = float; };
template <> struct Elem<kBF16> { using T = __nv_bfloat16; };
template <> struct Elem<kF16> { using T = __half; };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <int DT>
__device__ __forceinline__ typename Elem<DT>::T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<kF32>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<kBF16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<kF16>(float v) {
  return __float2half_rn(v);
}

// 8 consecutive elements from element i of a 16-byte aligned run: one
// 16-byte load for 16-bit types, two for f32.
template <int S>
__device__ __forceinline__ void load8(const void* src, long long i,
                                      float (&v)[kVec]) {
  using T = typename Elem<S>::T;
  constexpr int kPer = 16 / sizeof(T);
  const uint4* p = reinterpret_cast<const uint4*>(
      static_cast<const T*>(src) + i);
#pragma unroll
  for (int w = 0; w < kVec / kPer; ++w) {
    uint4 u = p[w];
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < kPer; ++j) v[w * kPer + j] = to_f32(e[j]);
  }
}

template <int D>
__device__ __forceinline__ void store8(void* dst, long long i,
                                       const float (&v)[kVec]) {
  using T = typename Elem<D>::T;
  constexpr int kPer = 16 / sizeof(T);
  uint4* p = reinterpret_cast<uint4*>(static_cast<T*>(dst) + i);
#pragma unroll
  for (int w = 0; w < kVec / kPer; ++w) {
    uint4 u;
    T* e = reinterpret_cast<T*>(&u);
#pragma unroll
    for (int j = 0; j < kPer; ++j) e[j] = from_f32<D>(v[w * kPer + j]);
    p[w] = u;
  }
}

// Elements [begin, end) of one segment, by this block's threads.  With
// vec, begin is a multiple of kVec and both bases are 16-byte aligned.
template <int S, int D>
__device__ __forceinline__ void copy_range(const void* src, void* dst,
                                           long long begin, long long end,
                                           bool vec) {
  using TS = typename Elem<S>::T;
  using TD = typename Elem<D>::T;
  long long rest = begin;
  if (vec) {
    const long long vend = begin + (end - begin) / kVec * kVec;
    for (long long j = begin + (long long)threadIdx.x * kVec; j < vend;
         j += (long long)blockDim.x * kVec) {
      float v[kVec];
      load8<S>(src, j, v);
      store8<D>(dst, j, v);
    }
    rest = vend;
  }
  for (long long j = rest + threadIdx.x; j < end; j += blockDim.x)
    static_cast<TD*>(dst)[j] =
        from_f32<D>(to_f32(static_cast<const TS*>(src)[j]));
}

template <int D>
__device__ __forceinline__ void zero_range(void* dst, long long begin,
                                           long long end, bool vec) {
  using TD = typename Elem<D>::T;
  long long rest = begin;
  if (vec) {
    const long long vend = begin + (end - begin) / kVec * kVec;
    float v[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) v[j] = 0.0f;
    for (long long j = begin + (long long)threadIdx.x * kVec; j < vend;
         j += (long long)blockDim.x * kVec)
      store8<D>(dst, j, v);
    rest = vend;
  }
  for (long long j = rest + threadIdx.x; j < end; j += blockDim.x)
    static_cast<TD*>(dst)[j] = from_f32<D>(0.0f);
}

template <int S>
__device__ __forceinline__ void copy_to(int d, const void* src, void* dst,
                                        long long begin, long long end,
                                        bool vec) {
  switch (d) {
    case kF32: copy_range<S, kF32>(src, dst, begin, end, vec); break;
    case kBF16: copy_range<S, kBF16>(src, dst, begin, end, vec); break;
    case kF16: copy_range<S, kF16>(src, dst, begin, end, vec); break;
  }
}

__device__ __forceinline__ void copy_any(int s, int d, const void* src,
                                         void* dst, long long begin,
                                         long long end, bool vec) {
  switch (s) {
    case kZero:
      switch (d) {
        case kF32: zero_range<kF32>(dst, begin, end, vec); break;
        case kBF16: zero_range<kBF16>(dst, begin, end, vec); break;
        case kF16: zero_range<kF16>(dst, begin, end, vec); break;
      }
      break;
    case kF32: copy_to<kF32>(d, src, dst, begin, end, vec); break;
    case kBF16: copy_to<kBF16>(d, src, dst, begin, end, vec); break;
    case kF16: copy_to<kF16>(d, src, dst, begin, end, vec); break;
  }
}

// Segment table row (int64 words): src pointer, dst pointer, element count,
// first tile index, src dtype (kZero for a run of zeros), dst dtype,
// vector flag, unused.
__device__ __forceinline__ void segmented_copy(
    const long long* __restrict__ table, int nseg, long long ntiles,
    long long tile_elems) {
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    int lo = 0, hi = nseg - 1;
    while (lo < hi) {   // last segment whose first tile is <= t
      const int mid = (lo + hi + 1) >> 1;
      if (table[mid * kRowWords + 3] <= t) lo = mid; else hi = mid - 1;
    }
    const long long* r = table + lo * kRowWords;
    const long long begin = (t - r[3]) * tile_elems;
    const long long end =
        begin + tile_elems < r[2] ? begin + tile_elems : r[2];
    copy_any((int)r[4], (int)r[5], reinterpret_cast<const void*>(r[0]),
             reinterpret_cast<void*>(r[1]), begin, end, r[6] != 0);
  }
}

template <int S, int D>
__global__ void __launch_bounds__(kThreads)
convert_copy_kernel(const void* __restrict__ x, void* __restrict__ out,
                    long long n, bool vec) {
  using TS = typename Elem<S>::T;
  using TD = typename Elem<D>::T;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vec ? n / kVec : 0;
  for (long long j = tid; j < nvec; j += stride) {
    float v[kVec];
    load8<S>(x, j * kVec, v);
    store8<D>(out, j * kVec, v);
  }
  for (long long j = nvec * kVec + tid; j < n; j += stride)
    static_cast<TD*>(out)[j] =
        from_f32<D>(to_f32(static_cast<const TS*>(x)[j]));
}

// Stages an unfused bucket's leaves into one flat buffer in the out dtype,
// zero-padded to the bucket's total.
__global__ void __launch_bounds__(kThreads)
bucket_pack_kernel(const long long* __restrict__ table, int nseg,
                   long long ntiles, long long tile_elems) {
  segmented_copy(table, nseg, ntiles, tile_elems);
}

// Packs a bucket's leaves into the chunk-major, dp-padded f32 staging
// buffer that the per-chunk reduce-scatters read.
__global__ void __launch_bounds__(kThreads)
fused_pack_kernel(const long long* __restrict__ table, int nseg,
                  long long ntiles, long long tile_elems) {
  segmented_copy(table, nseg, ntiles, tile_elems);
}

// Unstages the gathered f32 chunks into the bucket's gradient leaves, cast
// back to each leaf's dtype.
__global__ void __launch_bounds__(kThreads)
fused_unpack_kernel(const long long* __restrict__ table, int nseg,
                    long long ntiles, long long tile_elems) {
  segmented_copy(table, nseg, ntiles, tile_elems);
}

int resident_blocks() {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms * (2048 / kThreads);
}

template <int S>
void launch_convert(int d, dim3 grid, cudaStream_t st, const void* x,
                    void* out, long long n, bool vec) {
  switch (d) {
    case kF32:
      convert_copy_kernel<S, kF32><<<grid, kThreads, 0, st>>>(x, out, n, vec);
      break;
    case kBF16:
      convert_copy_kernel<S, kBF16><<<grid, kThreads, 0, st>>>(x, out, n, vec);
      break;
    case kF16:
      convert_copy_kernel<S, kF16><<<grid, kThreads, 0, st>>>(x, out, n, vec);
      break;
  }
}

}  // namespace

extern "C" {

// Each entry point launches on the given stream, does not synchronise and
// returns cudaGetLastError() (0 = launched).  Callers pass n > 0, ntiles > 0
// and dtype codes 0 (f32), 1 (bf16), 2 (f16).
int repro_convert_copy(const void* x, int x_dtype, void* out, int out_dtype,
                       long long n, int vec, void* stream) {
  const long long steps = (n + kVec - 1) / kVec;
  const long long want = (steps + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)(want < resident_blocks() ? want
                                                      : resident_blocks()));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case kF32: launch_convert<kF32>(out_dtype, grid, st, x, out, n, vec); break;
    case kBF16: launch_convert<kBF16>(out_dtype, grid, st, x, out, n, vec); break;
    case kF16: launch_convert<kF16>(out_dtype, grid, st, x, out, n, vec); break;
  }
  return (int)cudaGetLastError();
}

int repro_bucket_pack(const long long* table, int nseg, long long ntiles,
                      long long tile_elems, void* stream) {
  const dim3 grid((unsigned)(ntiles < resident_blocks() ? ntiles
                                                        : resident_blocks()));
  bucket_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, nseg, ntiles, tile_elems);
  return (int)cudaGetLastError();
}

int repro_fused_pack(const long long* table, int nseg, long long ntiles,
                     long long tile_elems, void* stream) {
  const dim3 grid((unsigned)(ntiles < resident_blocks() ? ntiles
                                                        : resident_blocks()));
  fused_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, nseg, ntiles, tile_elems);
  return (int)cudaGetLastError();
}

int repro_fused_unpack(const long long* table, int nseg, long long ntiles,
                       long long tile_elems, void* stream) {
  const dim3 grid((unsigned)(ntiles < resident_blocks() ? ntiles
                                                        : resident_blocks()));
  fused_unpack_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      table, nseg, ntiles, tile_elems);
  return (int)cudaGetLastError();
}

const char* repro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
