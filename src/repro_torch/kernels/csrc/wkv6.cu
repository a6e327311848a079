// Chunked RWKV6 WKV recurrence: the Hopper kernel behind
// repro_torch/kernels/wkv6.py, compiled for sm_90a and bound through a
// plain C interface (ctypes).
//
// rt_wkv6_chunked replaces the Pallas kernel
//   src/repro/kernels/wkv6.py:wkv6_chunked (body _wkv_kernel, :25-69)
// r, k, v, logw (B, T, H, N) and u (H, N), fp32 or bf16 (all five alike);
// y (B, T, H, N) in the inputs' dtype, everything fp32 inside.  Per (b, h)
// it walks T in chunks of c from a zero N x N state S and, per chunk, with
// L the inclusive cumsum of logw over the chunk and Lprev the exclusive one:
//   y_t = (r_t * exp(Lprev_t)) S + sum_{s<t} a[t,s] v_s + (r_t . (u*k_t)) v_t
//   a[t,s] = sum_n r_t[n] k_s[n] exp(Lprev_t[n] - L_s[n])
//   S <- exp(L_last) * S + sum_s (k_s * exp(L_last - L_s))^T v_s
// Every exponent is <= 0 (logw <= 0).  The Pallas body exponentiates the
// pairwise difference for all (t, s) and masks after; for s >= t that
// difference is positive and overflows fp32 under strong decay, where
// inf * 0 would give NaN here.  This kernel never computes the pairs with
// s > t, and the diagonal (s == t) carries the bonus term instead, so
// y_t = q_dec_t S + sum_{s<=t} a[t,s] v_s.  Lprev is taken as the
// exclusive running sum itself (not L - logw), so exp(Lprev_t - L_{t-1})
// is exactly 1, as in the exact recurrence.
//
// Bound: at the long shape (B 4, T 2048, H 64, N 64) the call reads four
// and writes one fp32 tensor of 33.5M elements, 671 MB, 0.20 ms at
// 3.35 TB/s.  The recurrence needs 5 N^2 + 6 N operations a token and head
// (the state update, r S, the bonus, one exp a channel), 10.9 GFLOP with
// 33.5 M exp, 0.16 ms at the fp32 CUDA-core peak of 67 TFLOP/s, so bytes
// bound it.  The chunked form here does more, about 16.4 GFLOP with
// 1.12 G exp at chunk 64 (the pairwise decays of each chunk's triangle).
//
// Design (simple first: fp32 FMAs and expf on the CUDA cores, no tensor
// cores, TMA or factored intra-chunk form).  One 512-thread block per
// (b, h) keeps S in shared memory for the whole sequence, as the Pallas
// kernel keeps it in VMEM; the TPU's sequential grid has no counterpart:
// the chunks are a loop inside the block.  Per chunk the block stages r,
// k, v and logw as fp32 in shared memory, scans L along t (one column per
// thread), computes the lower triangle of a (one (t, s) entry per thread
// per trip, a warp on 32 consecutive s of one t: r and Lprev are
// broadcast, k and L rows are padded by one float so the 32 rows fall in
// 32 banks), turns r into r * exp(Lprev) and k into k * exp(L_last - L) in
// place, writes y (a warp on 32 consecutive columns of one row) and
// updates S.  Shared memory at N = c = 64 is 115,712 bytes (dynamic,
// opted in once per device, never during a CUDA graph capture), so one
// block fits an SM.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the first CUDA error of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxChunk = 64;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// shared-memory floats for head dim N and chunk c: r, v, Lprev (c x N),
// k and L (c x (N + 1)), S (N x N), a (c x c), u and exp(L_last) (N each)
__host__ __device__ constexpr int smem_floats(int N, int c) {
  return 3 * c * N + 2 * c * (N + 1) + N * N + c * c + 2 * N;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ logw,
            const T* __restrict__ u, T* __restrict__ y, int T_len, int H,
            int c) {
  constexpr int P = N + 1;           // padded row of k and L
  extern __shared__ __align__(16) float smem[];
  float* sr = smem;                  // r, then r * exp(Lprev)    (c x N)
  float* sv = sr + c * N;            // v                         (c x N)
  float* sLp = sv + c * N;           // logw, then Lprev          (c x N)
  float* sk = sLp + c * N;           // k, then k * exp(L_last - L) (c x P)
  float* sL = sk + c * P;            // L                         (c x P)
  float* sS = sL + c * P;            // state                     (N x N)
  float* sa = sS + N * N;            // a, bonus on the diagonal  (c x c)
  float* su = sa + c * c;            // u                         (N)
  float* sdl = su + N;               // exp(L_last)               (N)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long step = (long long)H * N;            // t -> t + 1
  const long long base = ((long long)b * T_len * H + h) * N;

  for (int i = tid; i < N * N; i += kThreads) sS[i] = 0.f;
  for (int i = tid; i < N; i += kThreads) su[i] = to_f32(u[h * N + i]);

  for (int t0 = 0; t0 < T_len; t0 += c) {
    // ---- stage the chunk's tiles (a warp reads 32 consecutive n) ----
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const long long g = base + (t0 + t) * step + n;
      sr[i] = to_f32(r[g]);
      sv[i] = to_f32(v[g]);
      sLp[i] = to_f32(logw[g]);
      sk[t * P + n] = to_f32(k[g]);
    }
    __syncthreads();
    // ---- L (inclusive) and Lprev (exclusive) cumsums, a column each ----
    if (tid < N) {
      float acc = 0.f;
      for (int t = 0; t < c; ++t) {
        const float lw = sLp[t * N + tid];
        sLp[t * N + tid] = acc;
        acc += lw;
        sL[t * P + tid] = acc;
      }
      sdl[tid] = expf(acc);
    }
    __syncthreads();
    // ---- a[t, s] for s < t, the bonus r_t . (u * k_t) at s == t ----
    for (int i = tid; i < c * c; i += kThreads) {
      const int t = i / c, s = i % c;
      if (s > t) continue;
      const float* rt = sr + t * N;
      const float* ks = sk + s * P;
      float acc = 0.f;
      if (s == t) {
#pragma unroll 8
        for (int n = 0; n < N; ++n) acc = fmaf(rt[n] * su[n], ks[n], acc);
      } else {
        const float* lpt = sLp + t * N;
        const float* ls = sL + s * P;
#pragma unroll 8
        for (int n = 0; n < N; ++n)
          acc = fmaf(rt[n] * ks[n], expf(lpt[n] - ls[n]), acc);
      }
      sa[i] = acc;
    }
    __syncthreads();
    // ---- r <- r * exp(Lprev), k <- k * exp(L_last - L), in place ----
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N, n = i % N;
      sr[i] *= expf(sLp[i]);
      sk[t * P + n] *= expf(sL[(c - 1) * P + n] - sL[t * P + n]);
    }
    __syncthreads();
    // ---- y_t = q_dec_t S + sum_{s<=t} a[t, s] v_s ----
    for (int i = tid; i < c * N; i += kThreads) {
      const int t = i / N, m = i % N;
      const float* qt = sr + t * N;
      float acc = 0.f;
#pragma unroll 8
      for (int n = 0; n < N; ++n) acc = fmaf(qt[n], sS[n * N + m], acc);
      const float* at = sa + t * c;
      for (int s = 0; s <= t; ++s) acc = fmaf(at[s], sv[s * N + m], acc);
      store(y + base + (t0 + t) * step + m, acc);
    }
    __syncthreads();
    // ---- S <- exp(L_last) * S + sum_s k_dec_s^T v_s ----
    for (int i = tid; i < N * N; i += kThreads) {
      const int n = i / N, m = i % N;
      float acc = sdl[n] * sS[i];
      for (int s = 0; s < c; ++s) acc = fmaf(sk[s * P + n], sv[s * N + m], acc);
      sS[i] = acc;
    }
    __syncthreads();
  }
}

template <typename T, int N>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* y, int B, int T_len, int H, int c,
           cudaStream_t stream) {
  // the opt-in to more than 48 KB of shared memory, once per device, for
  // the largest chunk (not while a CUDA graph is being captured: the first
  // call is never captured)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(
        wkv6_kernel<T, N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_floats(N, kMaxChunk) * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const int bytes = smem_floats(N, c) * (int)sizeof(float);
  wkv6_kernel<T, N><<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(logw),
      static_cast<const T*>(u), static_cast<T*>(y), T_len, H, c);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_n(int N, const void* r, const void* k, const void* v,
               const void* logw, const void* u, void* y, int B, int T_len,
               int H, int c, cudaStream_t s) {
  switch (N) {
    case 16: return launch<T, 16>(r, k, v, logw, u, y, B, T_len, H, c, s);
    case 32: return launch<T, 32>(r, k, v, logw, u, y, B, T_len, H, c, s);
    case 64: return launch<T, 64>(r, k, v, logw, u, y, B, T_len, H, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = fp32, 1 = bf16 (r, k, v, logw, u and y share it).  N in
// {16, 32, 64}; c a power of two <= 64 that divides T.
int rt_wkv6_chunked(const void* r, const void* k, const void* v,
                    const void* logw, const void* u, void* y, int dtype,
                    int B, int T_len, int H, int N, int c, void* stream) {
  if (c < 1 || c > kMaxChunk || (c & (c - 1)) || T_len % c)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_n<float>(N, r, k, v, logw, u, y, B, T_len, H, c, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(N, r, k, v, logw, u, y, B, T_len, H,
                                     c, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
