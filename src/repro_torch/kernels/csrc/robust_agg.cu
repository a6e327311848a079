// Byzantine-robust aggregation: the four Hopper kernels behind
// repro_torch/kernels/robust_agg.py, compiled for sm_90a and bound through
// a plain C interface (ctypes).  Every kernel takes the fleet's gradient
// stack as a contiguous fp32 (W, D) array, W workers by D coordinates,
// row-major, with 1 <= W <= 32 (kMaxW).
//
// rt_rowstat replaces the Pallas kernels
//   src/repro/kernels/robust_agg.py:trimmed_mean       (tile maths :131-146)
//   src/repro/kernels/robust_agg.py:coordinate_median  (tile maths :149-155)
// trim == 1: per column, the FIRST argmin and the FIRST argmax are masked
// and the other W - 2 values summed in row order (x * keep, then +), then
// divided by W - 2; a constant column (argmin == argmax) returns x[0].
// Never (sum - min - max) / (W - 2), whose cancellation a scaled
// byzantine row would exploit.  trim >= 2 and the median sort the column
// with a Batcher compare-exchange network over W padded to a power of two
// with +inf, then sum the interior in sorted-row order (trimmed mean) or
// take the middle row, or 0.5 * (a + b) of the two middle rows for even W.
// Bound: bytes.  W * D * 4 bytes read and D * 4 written; at W = 4 and the
// full-width MobileNet gradient (D = 3,217,226) that is 64.3 MB, 19.2 us
// at 3.35 TB/s.  Design: one thread per column; the W values sit in
// registers (the network is fully unrolled for P = 4, 8, 16, 32, so every
// register index is static); neighbouring threads read neighbouring
// addresses of each row, so every row's load is coalesced.  The TPU
// kernel's (W, 4096) VMEM tiles have no counterpart: columns are
// independent.  Adds, multiplies and the division are __fadd_rn /
// __fmul_rn / __fdiv_rn, so nvcc cannot contract them into an fma: the
// plain version in ref.py, which performs the same operations in the same
// order, gives the same bits.
//
// rt_krum_pairwise replaces the Pallas kernel
//   src/repro/kernels/robust_agg.py:krum_pairwise      (tile maths :158-165)
// It computes the W x W squared distances ||xi||^2 + ||xj||^2 - 2 <xi, xj>
// clamped at 0.  Bound: bytes (W * D * 4 read; 51.5 MB, 15.4 us at W = 4
// and MobileNet's D); the W(W+1)/2 products per column are few next to
// the card's fp32 rate, so the kernel is a stream and what limits it is
// how many bytes are in flight.  Design at W <= 8 (krum_stream_kernel,
// instantiated for P = 4 and 8 rows): each thread owns columns, loads a
// vector of V columns of every row straight into registers (V = 4, 2 or
// 1 floats, the widest that the base address and D keep aligned in every
// row: at D = 2 (mod 4), MobileNet's and ResNet-18's, rows 1 and 3 start
// 8 bytes off a 16-byte boundary, so V = 2) and accumulates the P(P+1)/2
// products of the Gram's upper triangle in fp32 registers.  U vectors a
// row are loaded before any product (32 floats a thread in flight at
// P = 4, 128 at P = 8), with no shared memory and no barrier in the loop,
// over a grid of the SMs times the blocks that fit on one (two at most:
// fewer block partials to sum at the end).  The block then sums each
// product over its warps by shuffles and over the warps in order, into
// one partial Gram per block.  The last block to finish (an integer
// atomic ticket; no float atomics) sums the partials block by block in a
// fixed order and forms the clamped distances, so the result is
// bit-identical from run to run.  The diagonal is exactly 0 (the norms
// are the Gram diagonal).  Above W = 8 the earlier tile form runs
// (krum_pairwise_kernel, also reachable as rt_krum_pairwise_tile): each
// block stages 128-column tiles of all rows through shared memory and
// each (pair, slice) item of the upper triangle belongs to one thread.
//
// rt_weiszfeld_sqdist and rt_weiszfeld_wsum replace the two Pallas
// kernels of
//   src/repro/kernels/robust_agg.py:weiszfeld_step     (:265-283, :311-333)
// Pass 1 gives every row's sum of (x_i - z)^2: the direct form, not the
// cached-Gram one.  Each block accumulates a grid-strided set of columns
// into W register sums, reduces them over the block by warp shuffles and
// then warp by warp, and the last block sums the block partials in a fixed
// order, as in the Krum kernel.  The caller turns the W sums into the
// weights w_i = 1 / max(sqrt(sq_i), floor) and their total.  Pass 2 is
// one thread per column: sum over rows of w_i * x_i[col] in row order,
// divided by the total.  Bound: bytes, W * D * 4 read by each pass plus
// D * 4 for z and D * 4 written; 128.7 MB, 38.4 us an iteration at W = 4
// and MobileNet's D.
//
// Each entry point launches on the caller's stream, allocates nothing
// (the wrapper passes the scratch: block partials and a zeroed ticket
// counter), does not synchronise, and returns cudaGetLastError() of the
// launch.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxW = 32;
constexpr int kMaxBlocks = 512;  // blocks of the partial-sum kernels
constexpr int kKrumTile = 128;   // columns staged per tile
constexpr int kKrumLd = kKrumTile + 1;  // padded row: no bank conflicts
constexpr int kMaxItems = 3;     // ceil(32 * 33 / 2 / 256) pairs a thread

// ---------------------------------------------------------------------------
// order statistics
// ---------------------------------------------------------------------------
template <int P>
__device__ __forceinline__ void load_column(const float* __restrict__ x,
                                            long long D, int W,
                                            long long col, float (&v)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i)
    v[i] = i < W ? __ldg(x + (long long)i * D + col) : CUDART_INF_F;
}

// Batcher's bitonic network for P a power of two, as _batcher_pairs
// enumerates it: (lo, hi) receive (min, max).  Loops over log2 so that
// every trip count is a compile-time constant and the array stays in
// registers.
template <int P, int LOG_P>
__device__ __forceinline__ void sort_network(float (&v)[P]) {
#pragma unroll
  for (int lk = 1; lk <= LOG_P; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int lj = lk - 1; lj >= 0; --lj) {
      const int j = 1 << lj;
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int partner = i ^ j;
        if (partner > i) {
          const int lo = (i & k) == 0 ? i : partner;
          const int hi = (i & k) == 0 ? partner : i;
          const float a = v[lo], b = v[hi];
          v[lo] = fminf(a, b);
          v[hi] = fmaxf(a, b);
        }
      }
    }
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
trimmed_mean1_kernel(const float* __restrict__ x, float* __restrict__ out,
                     long long D, int W) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= D) return;
  float v[P];
  load_column<P>(x, D, W, col, v);
  int imin = 0, imax = 0;
  float lo = v[0], hi = v[0];
#pragma unroll
  for (int i = 1; i < P; ++i) {
    if (i < W) {
      if (v[i] < lo) { lo = v[i]; imin = i; }  // strict: the first argmin
      if (v[i] > hi) { hi = v[i]; imax = i; }
    }
  }
  if (imin == imax) {  // only a constant column
    out[col] = v[0];
    return;
  }
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    if (i < W) {
      const float keep = (i != imin && i != imax) ? 1.f : 0.f;
      acc = __fadd_rn(acc, __fmul_rn(v[i], keep));
    }
  }
  out[col] = __fdiv_rn(acc, (float)(W - 2));
}

// trim >= 2: interior mean of the sorted column; trim < 0: the median.
template <int P, int LOG_P>
__global__ void __launch_bounds__(kThreads)
sorted_stat_kernel(const float* __restrict__ x, float* __restrict__ out,
                   long long D, int W, int trim) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= D) return;
  float v[P];
  load_column<P>(x, D, W, col, v);
  sort_network<P, LOG_P>(v);
  float r;
  if (trim < 0) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i == (W - 1) / 2) a = v[i];
      if (i == W / 2) b = v[i];
    }
    r = (W & 1) ? b : __fmul_rn(0.5f, __fadd_rn(a, b));
  } else {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i == trim) acc = v[i];
      else if (i > trim && i < W - trim) acc = __fadd_rn(acc, v[i]);
    }
    r = __fdiv_rn(acc, (float)(W - 2 * trim));
  }
  out[col] = r;
}

template <int P, int LOG_P>
int launch_rowstat(const float* x, long long D, int W, int trim,
                   float* out, cudaStream_t s) {
  const unsigned grid = (unsigned)((D + kThreads - 1) / kThreads);
  if (trim == 1)
    trimmed_mean1_kernel<P><<<grid, kThreads, 0, s>>>(x, out, D, W);
  else
    sorted_stat_kernel<P, LOG_P><<<grid, kThreads, 0, s>>>(x, out, D, W,
                                                           trim);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// cross-block sums in a fixed order
// ---------------------------------------------------------------------------
// Called by every thread of the last block.  Sums partial[c * K + k] over
// c < nb into dst[k] (shared memory) for every k < K.  L lanes (a power of
// two) share an item: lane l takes c = l, l + L, ...; the lanes are then
// added by a tree in shared memory.  The order depends only on (nb, K),
// so the bits do not change from run to run.  __ldcg reads through L2:
// the partials were written by other blocks.
__device__ void reduce_partials(const float* partial, int nb, int K,
                                float* dst, float* scratch) {
  int L = 1;
  while (2 * L * K <= kThreads) L *= 2;
  const int per_round = kThreads / L;
  const int lane = threadIdx.x % L;
  for (int base = 0; base < K; base += per_round) {
    const int k = base + threadIdx.x / L;
    float s = 0.f;
    if (k < K)
      for (int c = lane; c < nb; c += L)
        s += __ldcg(partial + (long long)c * K + k);
    scratch[threadIdx.x] = s;
    __syncthreads();
    for (int off = L / 2; off > 0; off >>= 1) {
      if (lane < off) scratch[threadIdx.x] += scratch[threadIdx.x + off];
      __syncthreads();
    }
    if (lane == 0 && k < K) dst[k] = scratch[threadIdx.x];
    __syncthreads();
  }
}

// True in the block that finishes last.  Every block calls it after
// writing its partials; the ticket is an integer atomic.
__device__ bool last_block(unsigned* counter) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  __syncthreads();
  return last;
}

// ---------------------------------------------------------------------------
// Krum pairwise distances
// ---------------------------------------------------------------------------
__device__ __forceinline__ int pair_index(int a, int b, int W) {
  // (a, b) with a <= b in the row-major upper triangle
  return a * W - a * (a - 1) / 2 + (b - a);
}

// The clamped distances from the summed upper triangle `gram` (n_pairs
// floats in pair_index order), by every thread of the last block.
__device__ void krum_distances(const float* gram, int W, float* out) {
  for (int e = threadIdx.x; e < W * W; e += kThreads) {
    const int i = e / W, j = e % W;
    const float g = gram[i <= j ? pair_index(i, j, W) : pair_index(j, i, W)];
    const float ni = gram[pair_index(i, i, W)];
    const float nj = gram[pair_index(j, j, W)];
    const float d = __fsub_rn(__fadd_rn(ni, nj), __fmul_rn(2.f, g));
    out[e] = fmaxf(d, 0.f);
  }
}

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    r[0] = t.x; r[1] = t.y;
  } else {
    r[0] = __ldg(p);
  }
}

// acc[pair (i, j), i <= j < P, row-major] += a[i] * a[j]
template <int P>
__device__ __forceinline__ void gram_update(float (&acc)[P * (P + 1) / 2],
                                            const float (&a)[P]) {
#pragma unroll
  for (int i = 0, k = 0; i < P; ++i)
#pragma unroll
    for (int j = i; j < P; ++j, ++k) acc[k] = fmaf(a[i], a[j], acc[k]);
}

// Floats a thread loads before its products, and blocks an SM at most:
// the fastest of 16 to 128 floats and 1 to 4 blocks on an H100 (W = 4 and
// 8, MobileNet's D).  At P = 8 the 128 floats leave room for one block.
// At most 8 vectors a row (scalar loads at P = 8 would spill).
__host__ __device__ constexpr int krum_stream_floats(int P) {
  return P == 4 ? 32 : 128;
}
constexpr int kKrumBlocksPerSm = 2;

// Vectors of V columns: thread t of the grid takes vectors t, t + n,
// t + 2n, ... (n the grid's threads), U of them a row at a time.
template <int P, int V>
__global__ void __launch_bounds__(kThreads)
krum_stream_kernel(const float* __restrict__ x, long long D, int W,
                   float* __restrict__ partial, unsigned* counter,
                   float* __restrict__ out) {
  constexpr int NP = P * (P + 1) / 2;
  constexpr int kPerRow = krum_stream_floats(P) / (P * V);
  constexpr int U = kPerRow < 1 ? 1 : kPerRow > 8 ? 8 : kPerRow;
  __shared__ float warp_sums[kThreads / kWarp][NP];
  __shared__ float gram[NP];
  __shared__ float scratch[kThreads];
  float acc[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) acc[k] = 0.f;
  const long long nv = D / V;
  const long long stride = (long long)gridDim.x * kThreads;
  long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; v + (U - 1) * stride < nv; v += U * stride) {
    float r[U][P][V];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int i = 0; i < P; ++i) {
        if (i < W) {
          load_vec<V>(x + (long long)i * D + (v + u * stride) * V, r[u][i]);
        } else {
#pragma unroll
          for (int e = 0; e < V; ++e) r[u][i][e] = 0.f;
        }
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        float a[P];
#pragma unroll
        for (int i = 0; i < P; ++i) a[i] = r[u][i][e];
        gram_update<P>(acc, a);
      }
  }
  for (; v < nv; v += stride) {
    float r[P][V];
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i < W) {
        load_vec<V>(x + (long long)i * D + v * V, r[i]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) r[i][e] = 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < V; ++e) {
      float a[P];
#pragma unroll
      for (int i = 0; i < P; ++i) a[i] = r[i][e];
      gram_update<P>(acc, a);
    }
  }

  // this block's Gram partial: warp shuffles, then the warps in order
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[warp][k] = s;
  }
  __syncthreads();
  const int n_pairs = W * (W + 1) / 2;
  if (threadIdx.x < n_pairs) {
    int p = threadIdx.x, i = 0;   // (i, j) of pair p in pair_index order
    while (p >= W - i) { p -= W - i; ++i; }
    const int k = i * P - i * (i - 1) / 2 + p;   // (i, i + p) among P rows
    float s = 0.f;
    for (int w = 0; w < kThreads / kWarp; ++w) s += warp_sums[w][k];
    partial[(long long)blockIdx.x * n_pairs + threadIdx.x] = s;
  }
  if (!last_block(counter)) return;
  reduce_partials(partial, gridDim.x, n_pairs, gram, scratch);
  krum_distances(gram, W, out);
}

__global__ void __launch_bounds__(kThreads)
krum_pairwise_kernel(const float* __restrict__ x, long long D, int W,
                     int tiles_per_block, float* __restrict__ partial,
                     unsigned* counter, float* __restrict__ out) {
  extern __shared__ float smem[];  // max(W * kKrumLd, 3 * kThreads)
  __shared__ float scratch[kThreads];
  const int n_pairs = W * (W + 1) / 2;
  const int slices = n_pairs >= kThreads ? 1 : kThreads / n_pairs;
  const int n_items = n_pairs * slices;

  float acc[kMaxItems];
  int ri[kMaxItems], rj[kMaxItems], rs[kMaxItems];
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    acc[k] = 0.f;
    ri[k] = rj[k] = 0;
    rs[k] = kKrumTile;  // no columns: an idle item
    const int item = threadIdx.x + k * kThreads;
    if (item < n_items) {
      int p = item / slices, i = 0;
      while (p >= W - i) { p -= W - i; ++i; }
      ri[k] = i;
      rj[k] = i + p;
      rs[k] = item % slices;
    }
  }

  const long long n_tiles = (D + kKrumTile - 1) / kKrumTile;
  const long long t0 = (long long)blockIdx.x * tiles_per_block;
  long long t1 = t0 + tiles_per_block;
  if (t1 > n_tiles) t1 = n_tiles;
  for (long long t = t0; t < t1; ++t) {
    const long long base = t * kKrumTile;
    for (int e = threadIdx.x; e < W * kKrumTile; e += kThreads) {
      const int i = e / kKrumTile, c = e % kKrumTile;
      const long long col = base + c;
      smem[i * kKrumLd + c] =
          col < D ? __ldg(x + (long long)i * D + col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxItems; ++k) {
      const float* a = smem + ri[k] * kKrumLd;
      const float* b = smem + rj[k] * kKrumLd;
      float s = acc[k];
      for (int c = rs[k]; c < kKrumTile; c += slices)
        s = fmaf(a[c], b[c], s);
      acc[k] = s;
    }
    __syncthreads();
  }

  // this block's Gram partial: slices summed in slice order
#pragma unroll
  for (int k = 0; k < kMaxItems; ++k) {
    const int item = threadIdx.x + k * kThreads;
    if (item < n_items) smem[item] = acc[k];
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_pairs; p += kThreads) {
    float s = 0.f;
    for (int q = 0; q < slices; ++q) s += smem[p * slices + q];
    partial[(long long)blockIdx.x * n_pairs + p] = s;
  }
  if (!last_block(counter)) return;

  float* gram = smem;  // n_pairs floats
  reduce_partials(partial, gridDim.x, n_pairs, gram, scratch);
  krum_distances(gram, W, out);
}

// ---------------------------------------------------------------------------
// Weiszfeld step
// ---------------------------------------------------------------------------
template <int P>
__global__ void __launch_bounds__(kThreads)
weiszfeld_sqdist_kernel(const float* __restrict__ x,
                        const float* __restrict__ z, long long D, int W,
                        float* __restrict__ partial, unsigned* counter,
                        float* __restrict__ sq) {
  __shared__ float warp_sums[kThreads / kWarp][P];
  __shared__ float scratch[kThreads];
  __shared__ float total[P];
  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
       col < D; col += stride) {
    const float zc = __ldg(z + col);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if (i < W) {
        const float d = __ldg(x + (long long)i * D + col) - zc;
        acc[i] = fmaf(d, d, acc[i]);
      }
    }
  }
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    float v = acc[i];
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < W) {
    float s = 0.f;
    for (int w = 0; w < kThreads / kWarp; ++w) s += warp_sums[w][threadIdx.x];
    partial[(long long)blockIdx.x * W + threadIdx.x] = s;
  }
  if (!last_block(counter)) return;
  reduce_partials(partial, gridDim.x, W, total, scratch);
  if (threadIdx.x < W) sq[threadIdx.x] = total[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
weiszfeld_wsum_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ wtotal, long long D, int W,
                      float* __restrict__ out) {
  const long long col = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (col >= D) return;
  float acc = 0.f;
  for (int i = 0; i < W; ++i)
    acc = __fadd_rn(acc, __fmul_rn(__ldg(w + i),
                                   __ldg(x + (long long)i * D + col)));
  out[col] = __fdiv_rn(acc, __ldg(wtotal));
}

int partial_blocks(long long work_items) {
  long long nb = work_items < kMaxBlocks ? work_items : kMaxBlocks;
  return (int)(nb < 1 ? 1 : nb);
}

// The streaming Krum kernel over as many blocks as the card holds at once
// (kKrumBlocksPerSm an SM at most, and no more than the
// vectors need), each vector V floats wide.
template <int P, int V>
int launch_krum_stream(const float* x, long long D, int W, float* partial,
                       unsigned* counter, float* out, cudaStream_t s) {
  constexpr int kMaxDevices = 64;
  static int resident[kMaxDevices] = {};   // SMs x blocks an SM, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, krum_stream_kernel<P, V>, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    per_sm = std::min(per_sm, kKrumBlocksPerSm);
    resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int nb = partial_blocks(
      std::min<long long>(resident[dev], (D / V + kThreads - 1) / kThreads));
  krum_stream_kernel<P, V><<<nb, kThreads, 0, s>>>(x, D, W, partial, counter,
                                                    out);
  return (int)cudaGetLastError();
}

// V from the base address and D: every row's vectors aligned
template <int P>
int launch_krum(const float* x, long long D, int W, float* partial,
                unsigned* counter, float* out, cudaStream_t s) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(x);
  if (D % 4 == 0 && base % 16 == 0)
    return launch_krum_stream<P, 4>(x, D, W, partial, counter, out, s);
  if (D % 2 == 0 && base % 8 == 0)
    return launch_krum_stream<P, 2>(x, D, W, partial, counter, out, s);
  return launch_krum_stream<P, 1>(x, D, W, partial, counter, out, s);
}

}  // namespace

// trim == 1: masked trimmed mean; trim >= 2: sorted trimmed mean;
// trim < 0: coordinate median.  x: (W, D) fp32; out: (D,) fp32.
extern "C" int rt_rowstat(const void* x, long long D, int W, int trim,
                          void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (W < 1 || W > kMaxW || D < 1) return (int)cudaErrorInvalidValue;
  if (W <= 4) return launch_rowstat<4, 2>(xf, D, W, trim, o, s);
  if (W <= 8) return launch_rowstat<8, 3>(xf, D, W, trim, o, s);
  if (W <= 16) return launch_rowstat<16, 4>(xf, D, W, trim, o, s);
  return launch_rowstat<32, 5>(xf, D, W, trim, o, s);
}

// Largest number of floats of block partials the scratch must hold.
extern "C" int rt_partial_floats(int W) {
  return kMaxBlocks * (W * (W + 1) / 2);
}

// x: (W, D) fp32; partial: rt_partial_floats(W) floats; counter: one
// zeroed uint32; out: (W, W) fp32.  The tile form, which
// rt_krum_pairwise takes above W = 8.
extern "C" int rt_krum_pairwise_tile(const void* x, long long D, int W,
                                     void* partial, void* counter, void* out,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W < 1 || W > kMaxW || D < 1) return (int)cudaErrorInvalidValue;
  const long long n_tiles = (D + kKrumTile - 1) / kKrumTile;
  const long long per = (n_tiles + kMaxBlocks - 1) / kMaxBlocks;
  const int nb = (int)((n_tiles + per - 1) / per);
  int smem_floats = W * kKrumLd;
  if (smem_floats < kMaxItems * kThreads) smem_floats = kMaxItems * kThreads;
  krum_pairwise_kernel<<<nb, kThreads, smem_floats * sizeof(float), s>>>(
      static_cast<const float*>(x), D, W, (int)per,
      static_cast<float*>(partial), static_cast<unsigned*>(counter),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// x: (W, D) fp32; partial: rt_partial_floats(W) floats; counter: one
// zeroed uint32; out: (W, W) fp32.
extern "C" int rt_krum_pairwise(const void* x, long long D, int W,
                                void* partial, void* counter, void* out,
                                void* stream) {
  if (W < 1 || W > kMaxW || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* pf = static_cast<float*>(partial);
  unsigned* cnt = static_cast<unsigned*>(counter);
  float* o = static_cast<float*>(out);
  if (W <= 4) return launch_krum<4>(xf, D, W, pf, cnt, o, s);
  if (W <= 8) return launch_krum<8>(xf, D, W, pf, cnt, o, s);
  return rt_krum_pairwise_tile(x, D, W, partial, counter, out, stream);
}

// x: (W, D), z: (D,) fp32; partial: rt_partial_floats(W) floats; counter:
// one zeroed uint32; sq: (W,) fp32.
extern "C" int rt_weiszfeld_sqdist(const void* x, const void* z,
                                   long long D, int W, void* partial,
                                   void* counter, void* sq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W < 1 || W > kMaxW || D < 1) return (int)cudaErrorInvalidValue;
  const int nb = partial_blocks((D + kThreads - 1) / kThreads);
  const float* xf = static_cast<const float*>(x);
  const float* zf = static_cast<const float*>(z);
  float* pf = static_cast<float*>(partial);
  unsigned* cnt = static_cast<unsigned*>(counter);
  float* o = static_cast<float*>(sq);
  if (W <= 4)
    weiszfeld_sqdist_kernel<4><<<nb, kThreads, 0, s>>>(xf, zf, D, W, pf,
                                                      cnt, o);
  else if (W <= 8)
    weiszfeld_sqdist_kernel<8><<<nb, kThreads, 0, s>>>(xf, zf, D, W, pf,
                                                      cnt, o);
  else if (W <= 16)
    weiszfeld_sqdist_kernel<16><<<nb, kThreads, 0, s>>>(xf, zf, D, W, pf,
                                                       cnt, o);
  else
    weiszfeld_sqdist_kernel<32><<<nb, kThreads, 0, s>>>(xf, zf, D, W, pf,
                                                       cnt, o);
  return (int)cudaGetLastError();
}

// x: (W, D), w: (W,), wtotal: (1,) fp32 on the device; out: (D,) fp32.
extern "C" int rt_weiszfeld_wsum(const void* x, const void* w,
                                 const void* wtotal, long long D, int W,
                                 void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W < 1 || W > kMaxW || D < 1) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((D + kThreads - 1) / kThreads);
  weiszfeld_wsum_kernel<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(wtotal), D, W, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
