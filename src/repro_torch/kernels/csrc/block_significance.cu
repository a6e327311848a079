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
// rt_segment_norms and rt_segment_filter are the same two functions over
// every leaf of a gradient list at once, the form MLLess's sync runs
// (repro_torch/core/strategies.py): a fixed three launches a step, where
// the per-leaf kernels take two launches and about ten small PyTorch ops
// a leaf (83 leaves at MobileNet, 62 at ResNet-18).  A segment table, built
// once per gradient layout by the wrapper, gives each leaf's numel, first
// block row, offset in the flat output and dtype (int64, 4 a leaf); a
// second int64 array holds each leaf's data pointer (refreshed when the
// gradients move); an int32 map gives each block row's leaf.  The
// residual is one flat fp32 buffer in which each leaf fills whole block
// rows (zero past its numel), so every residual row starts 16-byte
// aligned.  All offsets are 64-bit (rwkv6-7b's 7.0 B parameters are 27 M
// rows).
//
// rt_segment_norms (kernel 1's counterpart) runs two kernels.
// segment_norms_kernel: one warp a block row, as block_norms_kernel; the
// lane loads 4 values of g (16 bytes of fp32, 8 of bf16, when the leaf's
// pointer is aligned so) and 4 of r (16 bytes), forms acc = float(g) + r
// with one fp32 add (__fadd_rn, as g.float() + r), zero past the leaf's
// numel, and sums acc * acc with fma; the warp reduces with shuffles.
// segment_significance_kernel: one 256-thread block a leaf sums its rows'
// squares in a fixed order (a strided pass, then a shared-memory tree),
// takes rms = sqrt(mean + 1e-20) and threshold * rms with correctly
// rounded fp32 operations, and writes each row's mask sqrt(sq) > that and
// the leaf's count of significant rows (int64), so the significant
// fraction needs no host loop.
// Bound: bytes.  At MobileNet width (fp32 g, 3,217,226 values in 12,582
// rows) the function reads g (12.87 MB) and r (12.88 MB) and writes one
// square, one mask byte a row and a count a leaf: 25.8 MB, 7.7 us.
//
// rt_segment_filter (kernel 2's counterpart): one warp a block row again.
// It recomputes acc from g and r rather than reading an acc written by
// rt_segment_norms: at MobileNet width writing acc would add 12.9 MB of
// writes and 12.9 MB of reads, recomputing adds 25.8 MB of reads of the
// same size, so the bytes are equal for fp32 gradients and recomputing
// moves 6.4 MB less for bf16 ones, and needs no scratch buffer.  Then
// kept = acc * mask (__fmul_rn) goes straight into the unpadded flat fp32
// buffer that the all-reduce takes, at the leaf's offset (16-byte stores
// where that offset is aligned, else one value a store), and
// resid = acc - kept (__fsub_rn) into a new padded residual buffer; with
// a 0/1 mask both equal the plain version's bit for bit.  Bound: bytes:
// g, r and the mask read, kept and resid written, 51.5 MB at MobileNet
// width, 15.4 us.
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

// ---------------------------------------------------------------------------
// the segmented pair: every leaf of a gradient list in one pass
// ---------------------------------------------------------------------------
namespace {

constexpr int kSegRowsPerBlock = 8;   // one warp a block row
constexpr int kSigThreads = 256;      // one block a leaf

struct Leaf {
  long long n, b0, off;
  int dtype;
  const void* g;
};

__device__ __forceinline__ Leaf leaf_at(const long long* __restrict__ table,
                                        const long long* __restrict__ ptrs,
                                        int i) {
  Leaf s;
  s.n = table[4 * i];
  s.b0 = table[4 * i + 1];
  s.off = table[4 * i + 2];
  s.dtype = (int)table[4 * i + 3];
  s.g = reinterpret_cast<const void*>(ptrs[i]);
  return s;
}

// acc = float(g[e + j]) + r[j] for j < 4, zero at and past the numel n;
// r points at 4 values of a residual row (16-byte aligned)
template <typename T>
__device__ __forceinline__ void load_acc(const T* __restrict__ g,
                                         const float* __restrict__ r,
                                         long long e, long long n,
                                         bool g_packed, float (&a)[4]) {
  const float4 rv = *reinterpret_cast<const float4*>(r);
  const float rr[4] = {rv.x, rv.y, rv.z, rv.w};
  if (g_packed && e + 4 <= n) {
    const Pack<T, 4> p = *reinterpret_cast<const Pack<T, 4>*>(g + e);
#pragma unroll
    for (int j = 0; j < 4; ++j) a[j] = __fadd_rn(to_f32(p.v[j]), rr[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[j] = e + j < n ? __fadd_rn(to_f32(g[e + j]), rr[j]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ bool packed_ptr(const void* g) {
  return reinterpret_cast<uintptr_t>(g) % (4 * sizeof(T)) == 0;
}

template <typename T>
__device__ __forceinline__ float row_sq(const Leaf& s, const float* r_row,
                                        long long e0, int B, int lane) {
  const T* g = static_cast<const T*>(s.g);
  const bool g_packed = packed_ptr<T>(g);
  float sq = 0.f;
  for (int i = lane * 4; i < B; i += kWarp * 4) {
    float a[4];
    load_acc(g, r_row + i, e0 + i, s.n, g_packed, a);
#pragma unroll
    for (int j = 0; j < 4; ++j) sq = fmaf(a[j], a[j], sq);
  }
  return sq;
}

__global__ void __launch_bounds__(kSegRowsPerBlock * kWarp)
segment_norms_kernel(const long long* __restrict__ table,
                     const long long* __restrict__ ptrs,
                     const int* __restrict__ leaf_of, long long n_rows,
                     int B, const float* __restrict__ resid,
                     float* __restrict__ sq_out) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      (long long)blockIdx.x * kSegRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;  // the whole warp leaves together
  const Leaf s = leaf_at(table, ptrs, leaf_of[row]);
  const long long e0 = (row - s.b0) * B;
  const float* r_row = resid + row * B;
  float sq = s.dtype == 0 ? row_sq<float>(s, r_row, e0, B, lane)
                          : row_sq<__nv_bfloat16>(s, r_row, e0, B, lane);
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1)
    sq += __shfl_xor_sync(0xffffffffu, sq, off);
  if (lane == 0) sq_out[row] = sq;
}

__global__ void __launch_bounds__(kSigThreads)
segment_significance_kernel(const long long* __restrict__ table, int B,
                            const float* __restrict__ sq, float threshold,
                            uint8_t* __restrict__ mask,
                            long long* __restrict__ counts) {
  __shared__ float part[kSigThreads];
  __shared__ long long cnt[kSigThreads];
  const int tid = threadIdx.x;
  const long long n = table[4 * blockIdx.x], b0 = table[4 * blockIdx.x + 1];
  const long long nb = (n + B - 1) / B;
  float acc = 0.f;
  for (long long i = tid; i < nb; i += kSigThreads)
    acc = __fadd_rn(acc, sq[b0 + i]);
  part[tid] = acc;
  __syncthreads();
  for (int w = kSigThreads / 2; w > 0; w >>= 1) {
    if (tid < w) part[tid] = __fadd_rn(part[tid], part[tid + w]);
    __syncthreads();
  }
  // ops.block_significance: sqrt(sq) > threshold * sqrt(mean(sq) + 1e-20)
  const float mean = __fdiv_rn(part[0], (float)nb);
  const float cut =
      __fmul_rn(threshold, __fsqrt_rn(__fadd_rn(mean, 1e-20f)));
  long long c = 0;
  for (long long i = tid; i < nb; i += kSigThreads) {
    const bool m = __fsqrt_rn(sq[b0 + i]) > cut;
    mask[b0 + i] = m;
    c += m;
  }
  cnt[tid] = c;
  __syncthreads();
  for (int w = kSigThreads / 2; w > 0; w >>= 1) {
    if (tid < w) cnt[tid] += cnt[tid + w];
    __syncthreads();
  }
  if (tid == 0) counts[blockIdx.x] = cnt[0];
}

template <typename T>
__device__ __forceinline__ void row_filter(const Leaf& s, const float* r_row,
                                           long long e0, int B, float m,
                                           float* __restrict__ kept,
                                           float* __restrict__ res_row,
                                           int lane) {
  const T* g = static_cast<const T*>(s.g);
  const bool g_packed = packed_ptr<T>(g);
  const bool k_packed = reinterpret_cast<uintptr_t>(kept) % 16 == 0;
  for (int i = lane * 4; i < B; i += kWarp * 4) {
    float a[4], k[4], r[4];
    load_acc(g, r_row + i, e0 + i, s.n, g_packed, a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      k[j] = __fmul_rn(a[j], m);
      r[j] = __fsub_rn(a[j], k[j]);
    }
    *reinterpret_cast<float4*>(res_row + i) = make_float4(r[0], r[1], r[2],
                                                          r[3]);
    const long long e = e0 + i;
    if (k_packed && e + 4 <= s.n) {
      *reinterpret_cast<float4*>(kept + e) = make_float4(k[0], k[1], k[2],
                                                         k[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (e + j < s.n) kept[e + j] = k[j];
    }
  }
}

__global__ void __launch_bounds__(kSegRowsPerBlock * kWarp)
segment_filter_kernel(const long long* __restrict__ table,
                      const long long* __restrict__ ptrs,
                      const int* __restrict__ leaf_of, long long n_rows,
                      int B, const float* __restrict__ resid,
                      const uint8_t* __restrict__ mask,
                      float* __restrict__ out,
                      float* __restrict__ new_resid) {
  const int lane = threadIdx.x % kWarp;
  const long long row =
      (long long)blockIdx.x * kSegRowsPerBlock + threadIdx.x / kWarp;
  if (row >= n_rows) return;
  const Leaf s = leaf_at(table, ptrs, leaf_of[row]);
  const long long e0 = (row - s.b0) * B;
  const float m = mask[row] ? 1.f : 0.f;
  const float* r_row = resid + row * B;
  float* res_row = new_resid + row * B;
  if (s.dtype == 0)
    row_filter<float>(s, r_row, e0, B, m, out + s.off, res_row, lane);
  else
    row_filter<__nv_bfloat16>(s, r_row, e0, B, m, out + s.off, res_row,
                              lane);
}

unsigned row_blocks(long long n_rows) {
  return (unsigned)((n_rows + kSegRowsPerBlock - 1) / kSegRowsPerBlock);
}

}  // namespace

// table: int64 (n_leaves, 4) = (numel, first row, flat offset, dtype 0 fp32
// / 1 bf16); ptrs: int64 (n_leaves,) data pointers of g; leaf_of: int32
// (n_rows,); resid: fp32 (n_rows * B,), 16-byte aligned, B a multiple of 4.
// Writes sq (n_rows,) fp32, mask (n_rows,) bytes, counts (n_leaves,) int64.
extern "C" int rt_segment_norms(const void* table, const void* ptrs,
                                const void* leaf_of, int n_leaves,
                                long long n_rows, int B, const void* resid,
                                float threshold, void* sq, void* mask,
                                void* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* t = static_cast<const long long*>(table);
  if (n_rows > 0) {
    segment_norms_kernel<<<row_blocks(n_rows), kSegRowsPerBlock * kWarp, 0,
                           s>>>(
        t, static_cast<const long long*>(ptrs),
        static_cast<const int*>(leaf_of), n_rows, B,
        static_cast<const float*>(resid), static_cast<float*>(sq));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (n_leaves > 0)
    segment_significance_kernel<<<n_leaves, kSigThreads, 0, s>>>(
        t, B, static_cast<const float*>(sq), threshold,
        static_cast<uint8_t*>(mask), static_cast<long long*>(counts));
  return (int)cudaGetLastError();
}

// As rt_segment_norms, with mask (n_rows,) bytes in; writes out (the sum
// of the numels,) fp32 unpadded and new_resid (n_rows * B,) fp32.
extern "C" int rt_segment_filter(const void* table, const void* ptrs,
                                 const void* leaf_of, long long n_rows, int B,
                                 const void* resid, const void* mask,
                                 void* out, void* new_resid, void* stream) {
  if (n_rows == 0) return (int)cudaSuccess;
  segment_filter_kernel<<<row_blocks(n_rows), kSegRowsPerBlock * kWarp, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table),
      static_cast<const long long*>(ptrs), static_cast<const int*>(leaf_of),
      n_rows, B, static_cast<const float*>(resid),
      static_cast<const uint8_t*>(mask), static_cast<float*>(out),
      static_cast<float*>(new_resid));
  return (int)cudaGetLastError();
}
