// MLLess significance filter: the two Hopper kernels behind
// repro_torch/kernels/block_significance.py, compiled for sm_90a and
// bound through a plain C interface (ctypes).
//
// rt_block_norms replaces the Pallas kernel
//   src/repro/kernels/block_significance.py:block_norms
// It computes the fp32 sum of squares of each row of an (n, b) gradient
// view.  Bound: bytes read.  At MobileNet full width one MLLess step
// reads 12,582 x 256 x 4 B = 12.9 MB, about 3.8 us at 3.35 TB/s.
// Design: one warp per row, 8 rows per 256-thread block, the ragged last
// block masked by row.  Each lane loads 16 bytes at a time (two loads
// per 256-wide fp32 row, one per bf16 row), neighbouring lanes on
// neighbouring addresses, accumulates in fp32 with fma, and the warp
// reduces with a __shfl_xor_sync tree.  The TPU kernel's (256, b) VMEM
// tiles and its sequential grid have no counterpart: rows are
// independent, so every warp writes its own result and nothing is
// carried between blocks.
//
// rt_masked_filter replaces the Pallas kernel
//   src/repro/kernels/block_significance.py:masked_filter
// It computes kept = x * mask[row] and resid = x - kept in fp32 and
// writes both in the input dtype.  Bound: bytes moved.  At MobileNet
// full width one step reads 12.9 MB and the mask, and writes 2 x 12.9 MB,
// about 38.7 MB or 11.6 us at 3.35 TB/s.
// Design: a grid-stride elementwise pass over 16-byte packs (4 fp32 or
// 8 bf16 values); the row of a pack follows from its element index, and
// the mask is read as one byte per row.  A pack never straddles two rows
// because the wrapper takes the packed path only when b is a multiple of
// the pack width; otherwise it runs the same loop one element at a time.
// The products use __fmul_rn / __fsub_rn so that no fma contraction can
// change the bits: with a 0/1 mask the result equals the plain version's
// exactly.
//
// Each entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRowsPerBlock = 8;
constexpr int kFilterThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kRowsPerBlock * kWarp)
block_norms_kernel(const T* __restrict__ x, float* __restrict__ out,
                   long long n, int b) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      (long long)blockIdx.x * kRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n) return;  // the whole warp leaves together
  const T* xr = x + row * (long long)b;
  float acc = 0.f;
  for (int i = lane * V; i < b; i += kWarp * V) {
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xr + i);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float f = to_f32(p.v[j]);
      acc = fmaf(f, f, acc);
    }
  }
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[row] = acc;
}

template <typename T, int V>
__global__ void __launch_bounds__(kFilterThreads)
masked_filter_kernel(const T* __restrict__ x,
                     const uint8_t* __restrict__ mask,
                     T* __restrict__ kept, T* __restrict__ resid,
                     long long n_packs, long long b) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_packs; p += stride) {
    const float m = mask[(p * V) / b] ? 1.f : 0.f;
    const Pack<T, V> in = reinterpret_cast<const Pack<T, V>*>(x)[p];
    Pack<T, V> k, r;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xf = to_f32(in.v[j]);
      const float kf = __fmul_rn(xf, m);
      k.v[j] = from_f32<T>(kf);
      r.v[j] = from_f32<T>(__fsub_rn(xf, kf));
    }
    reinterpret_cast<Pack<T, V>*>(kept)[p] = k;
    reinterpret_cast<Pack<T, V>*>(resid)[p] = r;
  }
}

template <typename T>
int launch_block_norms(const void* x, long long n, int b, bool packed,
                       float* out, cudaStream_t s) {
  const dim3 grid((unsigned)((n + kRowsPerBlock - 1) / kRowsPerBlock));
  const dim3 block(kRowsPerBlock * kWarp);
  constexpr int V = 16 / sizeof(T);
  if (packed)
    block_norms_kernel<T, V><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), out, n, b);
  else
    block_norms_kernel<T, 1><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), out, n, b);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_masked_filter_v(const void* x, const uint8_t* mask, void* kept,
                           void* resid, long long total, long long b,
                           cudaStream_t s) {
  const long long n_packs = total / V;
  long long blocks = (n_packs + kFilterThreads - 1) / kFilterThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  masked_filter_kernel<T, V><<<(unsigned)blocks, kFilterThreads, 0, s>>>(
      static_cast<const T*>(x), mask, static_cast<T*>(kept),
      static_cast<T*>(resid), n_packs, b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_masked_filter(const void* x, const uint8_t* mask, void* kept,
                         void* resid, long long n, long long b, bool packed,
                         cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  if (packed)
    return launch_masked_filter_v<T, V>(x, mask, kept, resid, n * b, b, s);
  return launch_masked_filter_v<T, 1>(x, mask, kept, resid, n * b, b, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  packed: the caller checked that b is
// a multiple of the 16-byte pack width and that every pointer is 16-byte
// aligned.
extern "C" int rt_block_norms(const void* x, int dtype, long long n, int b,
                              int packed, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0) return launch_block_norms<float>(x, n, b, packed, o, s);
  if (dtype == 1)
    return launch_block_norms<__nv_bfloat16>(x, n, b, packed, o, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int rt_masked_filter(const void* x, const void* mask, int dtype,
                                long long n, long long b, int packed,
                                void* kept, void* resid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  if (dtype == 0)
    return launch_masked_filter<float>(x, m, kept, resid, n, b, packed, s);
  if (dtype == 1)
    return launch_masked_filter<__nv_bfloat16>(x, m, kept, resid, n, b,
                                               packed, s);
  return (int)cudaErrorInvalidValue;
}
