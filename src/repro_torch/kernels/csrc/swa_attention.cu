// Sliding-window attention forward: the Hopper kernel behind
// repro_torch/kernels/swa_attention.py, compiled for sm_90a and bound
// through a plain C interface (ctypes).
//
// rt_swa_attention_fwd replaces the Pallas kernel
//   src/repro/kernels/swa_attention.py:swa_attention_fwd (body :24-78)
// Causal (or full) GQA attention with an optional sliding window:
// q (B, S, H, hd), k and v (B, S, KV, hd), bf16 or fp32; head h reads kv
// head h / G with G = H / KV; a query at position i attends to keys j with
// j <= i (causal) and j > i - window.  Everything is fp32 inside, as in the
// Pallas body (it casts q, k and v to f32): both the score product and the
// p.v product run in fp32, with an online softmax (running max m, running
// sum l, masked scores -1e30 as in the reference) and a final division by
// max(l, 1e-30).  The output is written in q's dtype.
//
// Routes: none.  The wrapper sends every bf16 call to swa_attention_tc.cu
// (wgmma) and every fp32 call to swa_attention_tf32.cu (3xTF32 mma.sync),
// at every head_dim.  This kernel stays as the design they are timed
// against: chip_smoke.cuda_core_attention launches it through this entry
// point, in either dtype.
//
// Bound: operations.  One call does 4 * B * H * hd multiply-adds per
// unmasked (query, key) pair; at SmolLM's long shape (B 8, S 2048, H 9,
// KV 3, hd 64, causal) that is 38.7 GFLOP: about 39 us at the bf16 dense
// tensor-core peak (989 TFLOP/s), 0.58 ms at the fp32 CUDA-core peak
// (67 TFLOP/s) that this kernel computes on; its 50 MB of q, k, v and o
// take about 15 us at 3.35 TB/s.  At Gemma-3's shape (B 1, S 2048, H 8,
// KV 4, hd 320, window 1024) it is 16.1 GFLOP (0.24 ms at the fp32 peak,
// 16 us at the bf16 peak) and 31.5 MB in bf16.
//
// Design (simple first: fp32 FMAs on the CUDA cores, no wgmma, TMA or
// tensor cores).  GQA is folded the reference's way: one 128-thread block
// per (batch, kv head, q tile), and a q tile holds BQ = 64 / G query
// positions times the G heads of the group, 64 "rows" (query, head) of
// which BQ * G are used.  Q's tile is staged in shared memory once; the kv
// loop then walks tiles of KEYS keys, only those that intersect
// [q_first - window + 1, q_last] (the window bounds what is read, as the
// Pallas kernel's fori_loop bounds do).  Per kv tile the block stages K and
// V in shared memory (fp32, zero past S).  The 128 threads are 16 row
// groups x 8 key groups: thread (ty, tx) computes rows 4 ty .. 4 ty + 3
// against keys tx + 8 j, j < KEYS / 8 (8 keys a thread at KEYS 64, 4 at
// KEYS 32), from float4 shared-memory reads (Q and K rows padded by 4
// floats so the keys of a quarter-warp fall in different banks), masks and
// scales them, and updates its rows' online softmax with the row max and
// sum reduced over the 8 threads that share a row (__shfl_xor_sync inside
// the warp).  The probabilities go through shared memory to the p.v
// product, where each thread accumulates 4 rows x hd/8 columns in
// registers (columns cg * 32 + 4 tx .. + 3, so hd is a multiple of 32).
// The TPU kernel's whole-sequence K/V strips in VMEM have no counterpart
// here: a block keeps one kv tile at a time.
//
// Shared memory (dynamic) is (64 (hd + 4) + KEYS (hd + 4) + KEYS hd +
// 64 (KEYS + 4)) x 4 bytes.  KEYS is 64 up to hd 128: 67 KB at hd 64,
// 115 KB at 128.  At hd 256 and 320 a 64-key tile would take 216 KB and
// 265 KB, the second over the 227 KB a block may have, so hd > 128 takes
// 32-key tiles: 92.7 KB at hd 160 (two blocks an SM), 141.8 KB at 256 and
// 174.6 KB at 320 (one block an SM).  The accumulator is 4 x hd/8 fp32
// registers a thread: 160 at hd 320.  ptxas (CUDA 12.8, -O3, sm_90a; the
// register report chip_smoke.py prints at set-up) gives, bf16 / fp32:
// 254 / 255 registers at hd 320, 238 / 248 at 256, 167 / 245 at 160, and
// no spills; up to 128 it gives 128-236, and the bf16 hd-128 instance
// spills 8 bytes (24 bytes of spill loads), as before hd 160 was added.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the first CUDA error of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // (query, head) rows of a q tile
constexpr int kThreads = 128;  // 16 row groups of 4 rows x 8 key/column groups
constexpr float kNegInf = -1e30f;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// keys of a kv tile: 64, or 32 where a 64-key tile's shared memory would
// leave no room for a block (hd 256) or exceed it (hd 320)
template <int HD>
constexpr int tile_keys() { return HD > 128 ? 32 : 64; }

template <int HD, int KEYS>
constexpr int smem_bytes() {
  return (kRows * (HD + 4) + KEYS * (HD + 4) + KEYS * HD +
          kRows * (KEYS + 4)) * 4;
}

template <typename T, int HD, int KEYS>
__global__ void __launch_bounds__(kThreads)
swa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int S, int H,
               int KV, int G, int BQ, int window, int causal, float scale) {
  constexpr int kStride = HD + 4;   // Q and K rows, padded
  constexpr int kCols = HD / 32;    // float4 column groups a thread owns
  constexpr int kKeyCols = KEYS / 8;  // keys a thread scores per tile
  constexpr int kPStride = KEYS + 4;
  static_assert(HD % 32 == 0 && KEYS % 8 == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // kRows x kStride
  float* Ks = Qs + kRows * kStride;          // KEYS x kStride
  float* Vs = Ks + KEYS * kStride;           // KEYS x HD
  float* Ps = Vs + KEYS * HD;                // kRows x kPStride

  const int tid = threadIdx.x;
  const int ty = tid / 8, tx = tid % 8;
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int q_last = min(q0 + BQ, S) - 1;
  const int n_rows = (q_last - q0 + 1) * G;

  // ---- the q tile: row r is query q0 + r / G, head kvh * G + r % G ----
  for (int idx = tid; idx < kRows * (HD / 4); idx += kThreads) {
    const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows) {
      const int s = q0 + r / G, g = r % G;
      val = load4(q + ((b * S + s) * H + kvh * G + g) * HD + c);
    }
    store4(Qs + r * kStride + c, val);
  }

  int qpos[4];
  float m[4], l[4], acc[4][HD / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = min(ty * 4 + i, n_rows - 1);   // unused rows copy a used one
    qpos[i] = q0 + r / G;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) acc[i][c] = 0.f;
  }

  const int lo_key = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int hi_key = causal ? q_last : S - 1;
  for (int kt = lo_key / KEYS; kt <= hi_key / KEYS; ++kt) {
    const int k0 = kt * KEYS;
    __syncthreads();   // the previous tile's K, V and P are read
    for (int idx = tid; idx < KEYS * (HD / 4); idx += kThreads) {
      const int r = idx / (HD / 4), c = (idx % (HD / 4)) * 4;
      float4 kv4 = make_float4(0.f, 0.f, 0.f, 0.f), vv4 = kv4;
      if (k0 + r < S) {
        const long long off = ((b * S + k0 + r) * KV + kvh) * HD + c;
        kv4 = load4(k + off);
        vv4 = load4(v + off);
      }
      store4(Ks + r * kStride + c, kv4);
      store4(Vs + r * HD + c, vv4);
    }
    __syncthreads();

    // scores of rows ty*4+i against keys k0 + tx + 8j
    float sc[4][kKeyCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kKeyCols; ++j) sc[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = load4(Qs + (ty * 4 + i) * kStride + d);
#pragma unroll
      for (int j = 0; j < kKeyCols; ++j) {
        const float4 kk = load4(Ks + (tx + 8 * j) * kStride + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) sc[i][j] = dot4(a[i], kk, sc[i][j]);
      }
    }

    // mask, scale, online softmax
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeyCols; ++j) {
        const int key = k0 + tx + 8 * j;
        const bool ok = key < S && (!causal || key <= qpos[i]) &&
                        (window <= 0 || key > qpos[i] - window);
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeyCols; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < kKeyCols; ++j)
        Ps[(ty * 4 + i) * kPStride + tx + 8 * j] = sc[i][j];
    }
    __syncthreads();

    // acc += P V over the tile's keys
#pragma unroll 2
    for (int kk = 0; kk < KEYS; kk += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = load4(Ps + (ty * 4 + i) * kPStride + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cg = 0; cg < kCols; ++cg) {
          const float4 vv = load4(Vs + (kk + e) * HD + cg * 32 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = e == 0 ? pa[i].x : e == 1 ? pa[i].y
                          : e == 2 ? pa[i].z : pa[i].w;
            acc[i][cg * 4 + 0] = fmaf(p, vv.x, acc[i][cg * 4 + 0]);
            acc[i][cg * 4 + 1] = fmaf(p, vv.y, acc[i][cg * 4 + 1]);
            acc[i][cg * 4 + 2] = fmaf(p, vv.z, acc[i][cg * 4 + 2]);
            acc[i][cg * 4 + 3] = fmaf(p, vv.w, acc[i][cg * 4 + 3]);
          }
        }
      }
    }
  }

  // ---- out = acc / max(l, 1e-30), in q's dtype ----
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= n_rows) continue;
    const float li = fmaxf(l[i], 1e-30f);
    const int s = q0 + r / G, g = r % G;
    T* dst = o + ((b * S + s) * H + kvh * G + g) * HD;
#pragma unroll
    for (int cg = 0; cg < kCols; ++cg) {
      const float4 val = make_float4(
          acc[i][cg * 4 + 0] / li, acc[i][cg * 4 + 1] / li,
          acc[i][cg * 4 + 2] / li, acc[i][cg * 4 + 3] / li);
      store4(dst + cg * 32 + tx * 4, val);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int window, int causal, float scale,
           cudaStream_t stream) {
  constexpr int KEYS = tile_keys<HD>();
  constexpr int bytes = smem_bytes<HD, KEYS>();
  static_assert(bytes <= 232448, "over the 227 KB a block may have");
  // the opt-in to more than 48 KB of shared memory, once per device (not
  // while a CUDA graph is being captured: the first call is never captured)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(swa_fwd_kernel<T, HD, KEYS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const int G = H / KV;
  const int BQ = kRows / G;
  dim3 grid((S + BQ - 1) / BQ, KV, B);
  swa_fwd_kernel<T, HD, KEYS><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H, KV, G, BQ, window,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v,
                void* o, int B, int S, int H, int KV, int window, int causal,
                float scale, cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, S, H, KV, window, causal, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, S, H, KV, window, causal, scale, s);
    case 96: return launch<T, 96>(q, k, v, o, B, S, H, KV, window, causal, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, S, H, KV, window, causal, scale, s);
    case 160: return launch<T, 160>(q, k, v, o, B, S, H, KV, window, causal, scale, s);
    case 256: return launch<T, 256>(q, k, v, o, B, S, H, KV, window, causal, scale, s);
    case 320: return launch<T, 320>(q, k, v, o, B, S, H, KV, window, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (q, k, v and o share it).  hd in {32, 64, 96,
// 128, 160, 256, 320}; H % KV == 0 and H / KV <= 64; window <= 0 means
// none.
int rt_swa_attention_fwd(const void* q, const void* k, const void* v,
                         void* o, int dtype, int B, int S, int H, int KV,
                         int hd, int window, int causal, float scale,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, o, B, S, H, KV, window, causal,
                              scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, o, B, S, H, KV, window,
                                      causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
