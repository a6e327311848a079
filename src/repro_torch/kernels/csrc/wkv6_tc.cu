// Chunked RWKV6 WKV recurrence on Hopper's tensor cores: the route of
// repro_torch/kernels/wkv6.py for N in {32, 64} and chunk in {16, 32, 64}
// (the other shapes take wkv6.cu), compiled for sm_90a and bound through
// a plain C interface (ctypes).
//
// rt_wkv6_chunked_tc replaces the Pallas kernel
//   src/repro/kernels/wkv6.py:wkv6_chunked (body _wkv_kernel, :25-69)
// and computes what rt_wkv6_chunked (wkv6.cu) computes: r, k, v, logw
// (B, T, H, N) and u (H, N), fp32 or bf16 (all five alike); y (B, T, H, N)
// in the inputs' dtype, everything fp32 inside; per (b, h) the chunks of c
// from a zero N x N state S.  Its plain twin is ref.wkv6_subchunked.
//
// Bound (unchanged from wkv6.cu): at the long shape (B 4, T 2048, H 64,
// N 64) the call reads four and writes one fp32 tensor of 33.5M elements,
// 671.1 MB, 0.2003 ms at 3.35 TB/s (0.0501 ms at the train shape, T 512);
// the recurrence's 10.9 GFLOP take 0.16 ms at the fp32 peak, so bytes
// bound it.
//
// The two-level form.  L is the inclusive cumsum of logw * log2(e) over
// the chunk (log2 units, so a decay is one ex2.approx) and Lprev_t =
// L_{t-1}; w_t = exp2(logw_t * log2(e)) is the per-step decay.  The chunk
// is cut into sub-chunks of 16; E_i is L at the end of sub-chunk i and
// Lam_i = E_{i-1} (0 for i 0).
// - a's 16 x 16 diagonal blocks keep the exact pairwise decay for s < t,
//   formed as the running product prod_{s<m<t} w_m on the CUDA cores (no
//   exp, no factor above 1, exactly 1 for neighbours), and the bonus
//   r_t . (u * k_t) at s == t.  Pairs s > t are never formed.
// - Across sub-chunks (t in i, s in j < i):
//   a[t, s] = sum_n rho_t[n] D_ij[n] kap_s[n],
//   rho_t = r_t exp2(Lprev_t - Lam_i), kap_s = k_s exp2(E_j - L_s),
//   D_ij = exp2(Lam_i - E_j) (1 for j = i - 1).
//   Every exponent is <= 0 because L falls, so nothing overflows under any
//   decay; what underflows is below fp32's range in the exact answer too.
// - y = (rho * exp2(Lam)) S + a V and S <- exp2(L_last) S +
//   (kap * exp2(L_last - E))^T V.
// The four products (rho D kap^T, the S product, a V, the state update)
// run on the tensor cores as mma.sync.m16n8k8 TF32 with fp32
// accumulation, each fp32 operand split as hi = x truncated to TF32 and
// lo = x - hi (truncated to TF32 by the mma) and three products lo.hi +
// hi.lo + hi.hi (about 21 bits: one TF32 product, about 11, fails the fp32
// gate of 1e-4).
//
// Work per chunk and (b, h) at N = c = 64: 786,432 multiply-adds in the
// four products (three times that on the tensor cores; the first chunk
// skips the S product, the last the state update), 12,928 exps (w, rho,
// kap and 640 per-column factors) where wkv6.cu takes 137,280, and on the
// CUDA cores 2 N operations for each of the 480 pairs s < t inside
// sub-chunks.  At the long shape: 37.8 GFLOP of TF32 products (0.076 ms at
// the 495 TFLOP/s peak), 106 M exps.
//
// Design.  One 256-thread block (8 warps) per (b, h) keeps S in shared
// memory for the whole sequence, as the Pallas kernel keeps it in VMEM;
// the chunks are a loop inside the block.  Shared memory is 111,616 bytes
// at N = c = 64 and ptxas keeps the kernel at 128 registers or fewer, so
// two blocks share an SM and B*H = 256 blocks run as one wave on 132 SMs;
// each block's loads and CUDA-core phases overlap the other's.  The next
// chunk's tiles come in with cp.async (fp32) as soon as their buffers are
// free: logw after the decays, k after the state update (computed into
// registers before y and written back after it), r and v after y; the
// wait for v is deferred to the state update.  Per chunk:
// - the scan: a thread takes 16 rows of one column (a sub-chunk), then
//   adds the totals before its own, and keeps its L in registers;
// - the diagonal blocks: two warps a sub-chunk (a half of the columns
//   each); lane (rg, gq) holds rows rg + 4 kr and columns gq + 8 c, so a
//   row s of k and w is read once a step, broadcast to the row groups;
//   the rows' sums are reduce-scattered over the 8 column lanes (4
//   shuffles a step) and the second half's land in the transposed slot,
//   which y adds as it reads the block;
// - rho, kap and the per-column factors, by the scan threads;
// - the cross blocks (12 n8 tiles at c = 64, 3 to each SM sub-partition,
//   the hi.hi and small products in separate accumulators);
// - the state update, then y (a warp 16 rows and N / 2 columns, row
//   blocks paired so that each SM sub-partition gets the same number of
//   k-steps; written straight from the accumulators).
// Rows are padded (r, k, w and a by 4 floats, v and S by 8) so that the
// mma fragments are read without bank conflicts.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the first CUDA error of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 16;
constexpr int kMaxDevices = 64;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// an mma operand split as x = hi + lo
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// hi is x itself: the mma reads the top 19 bits of a TF32 operand, so it
// takes x truncated to TF32; lo = x - trunc(x), exact in fp32 (13 bits at
// most, truncated again by the mma).  Two operations, and finite for every
// finite x: a rounded hi (cvt.rna) carries into inf within half a TF32
// step of fp32's largest value, and a guard against that cost a quarter of
// the kernel's time.  An infinite x gives a NaN lo (inf - inf).
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// A (16 x 8, row major): a0 (g, t4), a1 (g + 8, t4), a2 (g, t4 + 4),
// a3 (g + 8, t4 + 4), with g = lane / 4 and t4 = lane % 4
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// B (8 x 8, k x n): b0 (k t4, n g), b1 (k t4 + 4, n g)
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A B in 3xTF32, the small products first.  D (16 x 8): d0 (g, 2 t4),
// d1 (g, 2 t4 + 1), d2 (g + 8, 2 t4), d3 (g + 8, 2 t4 + 1)
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}
// the same into two accumulators (hi.hi, and the two small products), for
// a warp with too few tiles to hide the mma latency of one chain
__device__ __forceinline__ void mma3(float (&hi)[4], float (&lo)[4],
                                     const FragA& a, const FragB& b) {
  mma(lo, a.lo, b.hi);
  mma(hi, a.hi, b.hi);
  mma(lo, a.hi, b.lo);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most `n` of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// A C x N tile (global rows `step` elements apart) into shared rows of P
// floats: fp32 by cp.async, 16 bytes a copy, to be waited for; bf16
// loaded 16 bytes at a time and widened in place.
template <int C, int N, int P>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long step, int tid) {
  constexpr int V = N / 4;
  for (int i = tid; i < C * V; i += kThreads) {
    const int t = i / V, c = i % V;
    cp_async16(dst + t * P + 4 * c, src + t * step + 4 * c);
  }
}
template <int C, int N, int P>
__device__ __forceinline__ void stage(float* dst, const __nv_bfloat16* src,
                                      long long step, int tid) {
  constexpr int V = N / 8;
  for (int i = tid; i < C * V; i += kThreads) {
    const int t = i / V, c = i % V;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + t * step + 8 * c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h[0]), f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]), f3 = __bfloat1622float2(h[3]);
    float4* d = reinterpret_cast<float4*>(dst + t * P + 8 * c);
    d[0] = make_float4(f0.x, f0.y, f1.x, f1.y);
    d[1] = make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

// shared-memory floats for head dim N and chunk c: r, k, w (c x (N + 4)),
// v (c x (N + 8)), S (N x (N + 8)), a (c x (c + 4)), u and exp2(L_last)
// (N each), the scan's sub-chunk totals, exp2(Lam) and exp2(L_last - E)
// (c / 16 x N each) and D (one N row per sub-chunk pair j < i)
__host__ __device__ constexpr int smem_floats(int N, int c) {
  return 3 * c * (N + 4) + c * (N + 8) + N * (N + 8) + c * (c + 4) +
         2 * N + 3 * (c / kSub) * N + (c / kSub) * (c / kSub - 1) / 2 * N;
}

// tiles of n8 columns a warp takes in a product whose output has `tiles`
// of them, so that the 8 warps share the work
__host__ __device__ constexpr int per_warp(int tiles) {
  return tiles >= 4 * kWarps ? 4 : (tiles >= 2 * kWarps ? 2 : 1);
}

template <typename T, int N, int C>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_tc_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ logw,
               const T* __restrict__ u, T* __restrict__ y, int T_len,
               int H) {
  constexpr int NS = C / kSub;          // sub-chunks a chunk
  constexpr int PR = N + 4, PV = N + 8, PA = C + 4;
  constexpr int NP = NS * (NS - 1) / 2; // sub-chunk pairs j < i
  constexpr int NT8 = N / 8;            // n8 tiles across N
  extern __shared__ __align__(16) float smem[];
  float* sR = smem;              // r, then rho                 (C x PR)
  float* sK = sR + C * PR;       // k, then kap                 (C x PR)
  float* sL = sK + C * PR;       // logw, then w                (C x PR)
  float* sV = sL + C * PR;       // v                           (C x PV)
  float* sS = sV + C * PV;       // state                       (N x PV)
  float* sA = sS + N * PV;       // a                           (C x PA)
  float* sU = sA + C * PA;       // u                           (N)
  float* sDec = sU + N;          // exp2(L_last)                (N)
  float* sSeg = sDec + N;        // the scan's sub-chunk totals (NS x N)
  float* sF = sSeg + NS * N;     // exp2(Lam_i)                 (NS x N)
  float* sG = sF + NS * N;       // exp2(L_last - E_j)          (NS x N)
  float* sD = sG + NS * N;       // exp2(Lam_i - E_j), j < i    (NP x N)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long step = (long long)H * N;            // t -> t + 1
  const long long base = ((long long)b * T_len * H + h) * N;

  for (int i = tid; i < N * PV; i += kThreads) sS[i] = 0.f;
  for (int i = tid; i < N; i += kThreads) sU[i] = to_f32(u[h * N + i]);
  stage<C, N, PR>(sR, r + base, step, tid);
  stage<C, N, PR>(sK, k + base, step, tid);
  stage<C, N, PR>(sL, logw + base, step, tid);
  cp_async_commit();
  stage<C, N, PV>(sV, v + base, step, tid);
  cp_async_commit();

  for (int t0 = 0; t0 < T_len; t0 += C) {
    const bool more = t0 + C < T_len;
    const long long next = base + (long long)(t0 + C) * step;
    // r, k and logw of this chunk (v may still be in flight: the state
    // update waits for it)
    cp_async_wait_prior<1>();
    __syncthreads();

    // ---- L: inclusive cumsum of logw * log2(e) along t, in two levels:
    // a thread scans 16 rows of one column (one sub-chunk) and keeps its L
    // in registers; logw is replaced in place by the per-step decay
    // w = exp2(logw * log2(e)).  NS * N <= 256 threads ----
    const int sn = tid % N, sseg = tid / N;
    const bool scan = tid < NS * N;
    float loc[kSub];
    if (scan) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        float* p = sL + (sseg * kSub + j) * PR + sn;
        const float lw = *p * kLog2e;
        acc += lw;
        loc[j] = acc;
        *p = ex2(lw);
      }
      sSeg[sseg * N + sn] = acc;
    }
    __syncthreads();
    // E_j, the L at the end of sub-chunk j, is the running sum of the
    // sub-chunk totals; Lam of a thread's sub-chunk is the E before it
    float lam = 0.f, E[NS];
    if (scan) {
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        E[j] = (j ? E[j - 1] : 0.f) + sSeg[j * N + sn];
        if (j < sseg) lam = E[j];
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j) loc[j] += lam;
    }

    // ---- a's diagonal blocks: for s < t, sum_n r_t k_s prod_{s<m<t} w_m
    // (the exact pairwise decay as a running product of the per-step
    // decays: no exps, nothing above 1); the bonus r_t . (u * k_t) at
    // s == t.  Two warps a sub-chunk, one per half of the columns; lane
    // (rg, gq) holds rows rg + 4 kr (kr 0..3) and columns h N / 2 + gq +
    // 8 c, so the whole warp reads one row s of k and w a step, each
    // element once, broadcast to the 4 row groups.  Rows with t <= s
    // start later (s < 4 kr + 4 for kr's stage).  The 4 rows' sums over a
    // lane's columns are reduce-scattered over the 8 column lanes; half 1
    // leaves its sums in the transposed slot a[s][t], which y adds when it
    // reads the diagonal block ----
    {
      constexpr int CL = N / 16;       // columns a lane
      const int gq = lane & 7, rg = lane >> 3;
      const int i0 = ((warp >> 1) % NS) * kSub, half = warp & 1;
      const bool mine = (warp >> 1) < NS;   // c < 64: warps repeat
      const int cb = half * (N / 2) + gq;
      // rd = r_t prod_{s<m<t} w_m, reset to r_t until row t is past s
      float rt[4][CL], rd[4][CL];
#pragma unroll
      for (int kr = 0; kr < 4; ++kr)
#pragma unroll
        for (int c = 0; c < CL; ++c) {
          rt[kr][c] = sR[(i0 + rg + 4 * kr) * PR + cb + 8 * c];
          rd[kr][c] = rt[kr][c];
        }
#pragma unroll
      for (int s = kSub - 2; s >= 0; --s) {
        float ks[CL], ws[CL], part[4];
#pragma unroll
        for (int c = 0; c < CL; ++c) {
          ks[c] = sK[(i0 + s) * PR + cb + 8 * c];
          ws[c] = sL[(i0 + s) * PR + cb + 8 * c];
        }
#pragma unroll
        for (int kr = 0; kr < 4; ++kr) {
          part[kr] = 0.f;
          if (4 * kr + 3 <= s) continue;          // no row of kr is past s
          const bool live = rg + 4 * kr > s;
#pragma unroll
          for (int c = 0; c < CL; ++c) {
            part[kr] = fmaf(rd[kr][c], ks[c], part[kr]);
            rd[kr][c] = live ? rd[kr][c] * ws[c] : rt[kr][c];
          }
          if (!live) part[kr] = 0.f;
        }
        // reduce-scatter over gq: lane bit 2 keeps rows {2 b2, 2 b2 + 1},
        // bit 1 one of them, bit 0 sums the last pair
        const bool b2 = gq & 4, b1 = gq & 2;
        float x0 = b2 ? part[0] : part[2], x1 = b2 ? part[1] : part[3];
        float y0 = (b2 ? part[2] : part[0]) + __shfl_xor_sync(0xffffffffu, x0, 4);
        float y1 = (b2 ? part[3] : part[1]) + __shfl_xor_sync(0xffffffffu, x1, 4);
        float z = (b1 ? y1 : y0) + __shfl_xor_sync(0xffffffffu, b1 ? y0 : y1, 2);
        z += __shfl_xor_sync(0xffffffffu, z, 1);
        const int kr = (b2 ? 2 : 0) + (b1 ? 1 : 0);
        const int t = rg + 4 * kr;
        if (mine && (gq & 1) == 0 && t > s) {
          if (half == 0)
            sA[(i0 + t) * PA + i0 + s] = z;
          else
            sA[(i0 + s) * PA + i0 + t] = z;
        }
      }
      // the bonus: each warp 8 rows of its sub-chunk over all N columns,
      // lane (row, 4 column groups)
      {
        constexpr int CB = N / 4;
        const int t = i0 + half * 8 + (lane >> 2), nb = (lane & 3) * CB;
        float bonus = 0.f;
#pragma unroll
        for (int c = 0; c < CB; ++c)
          bonus = fmaf(sR[t * PR + nb + c] * sU[nb + c], sK[t * PR + nb + c],
                       bonus);
        bonus += __shfl_xor_sync(0xffffffffu, bonus, 1);
        bonus += __shfl_xor_sync(0xffffffffu, bonus, 2);
        if (mine && (lane & 3) == 0) sA[t * PA + t] = bonus;
      }
    }
    __syncthreads();

    // ---- rho = r exp2(Lprev - Lam_i), kap = k exp2(E_i - L) in place, by
    // the scan threads from their registers, and the per-column factors of
    // their sub-chunk ----
    if (scan) {
      const int i0 = sseg * kSub;
      float rv[kSub], kv[kSub];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        rv[j] = sR[(i0 + j) * PR + sn];
        kv[j] = sK[(i0 + j) * PR + sn];
      }
      const float end = loc[kSub - 1], last = E[NS - 1];
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        sR[(i0 + j) * PR + sn] = rv[j] * ex2((j ? loc[j - 1] : lam) - lam);
        sK[(i0 + j) * PR + sn] = kv[j] * ex2(end - loc[j]);
      }
      sF[sseg * N + sn] = sseg ? ex2(lam) : 1.f;
      sG[sseg * N + sn] = sseg == NS - 1 ? 1.f : ex2(last - end);
#pragma unroll
      for (int j = 0; j < NS - 1; ++j)
        if (j < sseg)
          sD[(sseg * (sseg - 1) / 2 + j) * N + sn] =
              j == sseg - 1 ? 1.f : ex2(lam - E[j]);
      if (sseg == 0) sDec[sn] = ex2(last);
    }
    __syncthreads();
    if (more) {
      stage<C, N, PR>(sL, logw + next, step, tid);
      cp_async_commit();
    }

    // ---- a across sub-chunks: (rho_i * D_ij) kap_j^T, two n8 tiles a
    // pair.  At c = 64 the 6 pairs' 12 tiles go 2, 2, 2, 2, 1, 1, 1, 1 to
    // the 8 warps, 3 to each SM sub-partition (warps w and w + 4) ----
    {
      int pair = warp, nt0 = 0, nt1 = 2;
      if (NP > kWarps / 2 && warp >= kWarps / 2) {
        pair = kWarps / 2 + ((warp - kWarps / 2) >> 1);
        nt0 = (warp - kWarps / 2) & 1;
        nt1 = nt0 + 1;
      }
      if (pair < NP) {
        int i = 1;
        while (pair >= i * (i + 1) / 2) ++i;
        const int j = pair - i * (i - 1) / 2;
        const float* dij = sD + pair * N;
        const float* ra = sR + (i * kSub + g) * PR;
        float acc[2][4] = {}, lo[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < N; kk += 8) {
          const float d0 = dij[kk + t4], d1 = dij[kk + t4 + 4];
          const FragA fa = frag_a(ra[kk + t4] * d0, ra[8 * PR + kk + t4] * d0,
                                  ra[kk + t4 + 4] * d1,
                                  ra[8 * PR + kk + t4 + 4] * d1);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            if (nt < nt0 || nt >= nt1) continue;
            const float* kb = sK + (j * kSub + nt * 8 + g) * PR + kk;
            mma3(acc[nt], lo[nt], fa, frag_b(kb[t4], kb[t4 + 4]));
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (nt < nt0 || nt >= nt1) continue;
          float* out = sA + (i * kSub + g) * PA + j * kSub + nt * 8 + 2 * t4;
          out[0] = acc[nt][0] + lo[nt][0];
          out[1] = acc[nt][1] + lo[nt][1];
          out[8 * PA] = acc[nt][2] + lo[nt][2];
          out[8 * PA + 1] = acc[nt][3] + lo[nt][3];
        }
      }
    }
    // v (the logw prefetch, committed after it, may stay in flight)
    if (more)
      cp_async_wait_prior<1>();
    else
      cp_async_wait_prior<0>();
    __syncthreads();

    // ---- S <- exp2(L_last) S + (kap * exp2(L_last - E))^T V, into
    // registers (skipped after the last chunk: the final state is not an
    // output): a warp takes 16 rows of S and ST n8 tiles, and writes them
    // back once y has read the old S ----
    constexpr int ST = per_warp((N / 16) * NT8), SG = NT8 / ST;
    static_assert((N / 16) * SG == kWarps, "one state task a warp");
    const int nrow = (warp / SG) * 16 + g, sm0 = (warp % SG) * ST * 8;
    float sacc[ST][4];
    if (more) {
      const float dec0 = sDec[nrow], dec1 = sDec[nrow + 8];
#pragma unroll
      for (int nt = 0; nt < ST; ++nt) {
        const float* sp = sS + nrow * PV + sm0 + nt * 8 + 2 * t4;
        sacc[nt][0] = sp[0] * dec0;
        sacc[nt][1] = sp[1] * dec0;
        sacc[nt][2] = sp[8 * PV] * dec1;
        sacc[nt][3] = sp[8 * PV + 1] * dec1;
      }
#pragma unroll 2
      for (int kk = 0; kk < C; kk += 8) {
        const float* gj = sG + (kk / kSub) * N;
        const float g0 = gj[nrow], g1 = gj[nrow + 8];
        const float* kc = sK + (kk + t4) * PR + nrow;
        const FragA fa = frag_a(kc[0] * g0, kc[8] * g1, kc[4 * PR] * g0,
                                kc[4 * PR + 8] * g1);
#pragma unroll
        for (int nt = 0; nt < ST; ++nt) {
          const float* vb = sV + (kk + t4) * PV + sm0 + nt * 8 + g;
          mma3(sacc[nt], fa, frag_b(vb[0], vb[4 * PV]));
        }
      }
    }
    __syncthreads();
    if (more) {                 // kap is read: the next k may come in
      stage<C, N, PR>(sK, k + next, step, tid);
      cp_async_commit();
    }

    // ---- y = (rho * exp2(Lam)) S + a V: a warp takes 16 rows (one
    // sub-chunk) and YT n8 tiles ----
    {
      constexpr int YT = per_warp(NS * NT8), GROUPS = NT8 / YT;
      for (int task = warp; task < NS * GROUPS; task += kWarps) {
        // row block i takes 8 + 2 (i + 1) k-steps: at c = 64 warps w and
        // w + 4 (one SM sub-partition) get row blocks i and 3 - i
        const bool pairs = NS == 4 && GROUPS == 2;
        const int i = pairs ? (task < 4 ? task : 7 - task) : task / GROUPS;
        const int m0 = (pairs ? task >> 2 : task % GROUPS) * YT * 8;
        const int row = i * kSub + g;
        float acc[YT][4] = {};
        if (t0 > 0) {           // S is 0 before the first chunk
          const float* fi = sF + i * N;
          const float* ra = sR + row * PR;
#pragma unroll 2
          for (int kk = 0; kk < N; kk += 8) {
            const float f0 = fi[kk + t4], f1 = fi[kk + t4 + 4];
            const FragA fa = frag_a(
                ra[kk + t4] * f0, ra[8 * PR + kk + t4] * f0,
                ra[kk + t4 + 4] * f1, ra[8 * PR + kk + t4 + 4] * f1);
#pragma unroll
            for (int nt = 0; nt < YT; ++nt) {
              const float* sb = sS + (kk + t4) * PV + m0 + nt * 8 + g;
              mma3(acc[nt], fa, frag_b(sb[0], sb[4 * PV]));
            }
          }
        }
        const float* aa = sA + row * PA;
#pragma unroll 2
        for (int kk = 0; kk < i * kSub; kk += 8) {
          const FragA fa = frag_a(aa[kk + t4], aa[8 * PA + kk + t4],
                                  aa[kk + t4 + 4], aa[8 * PA + kk + t4 + 4]);
#pragma unroll
          for (int nt = 0; nt < YT; ++nt) {
            const float* vb = sV + (kk + t4) * PV + m0 + nt * 8 + g;
            mma3(acc[nt], fa, frag_b(vb[0], vb[4 * PV]));
          }
        }
        // the diagonal block: a[t][s] (s < t) is the sum of the two column
        // halves' slots a[t][s] and a[s][t]; a[t][t] holds the bonus
#pragma unroll
        for (int kk = i * kSub; kk < (i + 1) * kSub; kk += 8) {
          float e[4];
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int t = row + (x & 1) * 8, sc = kk + t4 + (x >> 1) * 4;
            const float lo = sA[t * PA + sc], up = sA[sc * PA + t];
            e[x] = sc < t ? lo + up : (sc == t ? lo : 0.f);
          }
          const FragA fa = frag_a(e[0], e[1], e[2], e[3]);
#pragma unroll
          for (int nt = 0; nt < YT; ++nt) {
            const float* vb = sV + (kk + t4) * PV + m0 + nt * 8 + g;
            mma3(acc[nt], fa, frag_b(vb[0], vb[4 * PV]));
          }
        }
        T* out = y + base + (long long)(t0 + row) * step + m0 + 2 * t4;
#pragma unroll
        for (int nt = 0; nt < YT; ++nt) {
          store2(out + nt * 8, acc[nt][0], acc[nt][1]);
          store2(out + 8 * step + nt * 8, acc[nt][2], acc[nt][3]);
        }
      }
    }
    if (!more) break;
    __syncthreads();            // y has read S, rho, a and v
#pragma unroll
    for (int nt = 0; nt < ST; ++nt) {
      float* sp = sS + nrow * PV + sm0 + nt * 8 + 2 * t4;
      sp[0] = sacc[nt][0];
      sp[1] = sacc[nt][1];
      sp[8 * PV] = sacc[nt][2];
      sp[8 * PV + 1] = sacc[nt][3];
    }
    stage<C, N, PR>(sR, r + next, step, tid);
    cp_async_commit();
    stage<C, N, PV>(sV, v + next, step, tid);
    cp_async_commit();
  }
}

template <typename T, int N, int C>
int launch(const void* r, const void* k, const void* v, const void* logw,
           const void* u, void* y, int B, int T_len, int H,
           cudaStream_t stream) {
  const int bytes = smem_floats(N, C) * (int)sizeof(float);
  // the opt-in to more than 48 KB of shared memory and the carve-out that
  // fits two blocks an SM, once per device (not while a CUDA graph is
  // being captured: the first call is never captured)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(wkv6_tc_kernel<T, N, C>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(wkv6_tc_kernel<T, N, C>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  wkv6_tc_kernel<T, N, C><<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(logw),
      static_cast<const T*>(u), static_cast<T*>(y), T_len, H);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int dispatch_c(int c, const void* r, const void* k, const void* v,
               const void* logw, const void* u, void* y, int B, int T_len,
               int H, cudaStream_t s) {
  switch (c) {
    case 16: return launch<T, N, 16>(r, k, v, logw, u, y, B, T_len, H, s);
    case 32: return launch<T, N, 32>(r, k, v, logw, u, y, B, T_len, H, s);
    case 64: return launch<T, N, 64>(r, k, v, logw, u, y, B, T_len, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_n(int N, int c, const void* r, const void* k, const void* v,
               const void* logw, const void* u, void* y, int B, int T_len,
               int H, cudaStream_t s) {
  switch (N) {
    case 32: return dispatch_c<T, 32>(c, r, k, v, logw, u, y, B, T_len, H, s);
    case 64: return dispatch_c<T, 64>(c, r, k, v, logw, u, y, B, T_len, H, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The interface of rt_wkv6_chunked.  dtype: 0 = fp32, 1 = bf16 (r, k, v,
// logw, u and y share it, 16-byte aligned).  N in {32, 64}; c in {16, 32,
// 64} and divides T.
int rt_wkv6_chunked_tc(const void* r, const void* k, const void* v,
                       const void* logw, const void* u, void* y, int dtype,
                       int B, int T_len, int H, int N, int c, void* stream) {
  if (T_len % c) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_n<float>(N, c, r, k, v, logw, u, y, B, T_len, H, s);
  if (dtype == 1)
    return dispatch_n<__nv_bfloat16>(N, c, r, k, v, logw, u, y, B, T_len, H,
                                     s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
