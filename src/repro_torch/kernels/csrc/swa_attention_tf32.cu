// Sliding-window attention forward in fp32 on Hopper's tensor cores: the
// fp32 route of repro_torch/kernels/swa_attention.py, compiled for sm_90a
// and bound through a plain C interface (ctypes).
//
// rt_swa_attention_fwd_tf32 replaces, for fp32 inputs, the Pallas kernel
//   src/repro/kernels/swa_attention.py:swa_attention_fwd (body :24-78)
// and computes what it computes: causal (or full) GQA attention with an
// optional sliding window (query i attends to keys j in (i - window, i]),
// an online softmax in fp32 with masked scores at -1e30 after the scale,
// division by max(l, 1e-30).  q (B, S, H, hd), k and v (B, S, KV, hd), all
// fp32, hd in {32, 64, 96, 128, 160, 256, 320}; head h reads kv head
// h / (H / KV).  It takes the place of the CUDA-core kernel of
// swa_attention.cu on the fp32 route at every head_dim.
//
// Bound: operations.  The function does 4 * hd multiply-adds per unmasked
// (query, key) pair and head: 38.67 GFLOP at SmolLM's long shape (B 8,
// S 2048, 9/3 heads, hd 64, causal), 0.577 ms at the fp32 peak outside
// the tensor cores (67 TFLOP/s); its 100.7 MB of fp32 q, k, v and o take
// 0.030 ms at 3.35 TB/s.  This design runs both products on the tensor
// cores as three TF32 products each (below): at the TF32 peak of 495
// TFLOP/s its own least time there is 0.234 ms.  The softmax takes one
// exp2 per row and key of the tiles visited on the multi-function unit
// (16 a clock per SM): 161 M at SmolLM's long shape, about 0.04 ms, under
// the products.
//
// Precision.  A TF32 product reads 10 bits of each operand's mantissa; one
// such product misses the port's fp32 gate (2e-5 absolute against the
// fp32 plain version).  Each fp32 operand x is taken as hi + lo, hi = x
// truncated to TF32 (the mma reads x itself and drops its 13 low mantissa
// bits) and lo = x - trunc(x), exact in fp32 and formed in registers from
// the fragment just loaded, and each product as hi.hi + (lo.hi + hi.lo)
// (lo.lo is dropped): about 21 bits, the arithmetic of wkv6_tc.cu.  The
// mma also truncates (rounds toward zero) each sum it forms, a bias that
// grows with the sums run through it: with all three products in one
// accumulator and O carried through the mma from tile to tile, errors
// reached 1.1e-5 at hd 320 on the card.  So hi.hi and the small
// products accumulate apart and are added in fp32, and each kv tile's
// P.V starts from zero and is added to O in fp32 (O = O corr + P.V, one
// FMA), which keeps every truncated sum to one tile's keys or one row's
// head_dim.  tests/test_torch_swa_tf32x3.py emulates the arithmetic.
//
// Design.  mma.sync.m16n8k8 (TF32, fp32 accumulation), which takes fp32
// registers and B in either layout; TF32 wgmma reads B from shared memory
// K-major only, so V (hd-contiguous) would need a transposed copy, and the
// lo parts of K and V tiles of their own.  GQA is folded as in
// swa_attention.cu: one block of 4 warps (8 at hd 320, below) per (batch,
// kv head, q tile), a q tile holding BQ = 64 / G query positions times the
// G heads of the group, 64 (query, head) rows, 16 to a warp; the q tiles
// run in reverse order, so the long causal tiles start first.  The kv loop
// walks only the tiles of BN keys that meet [q_first - window + 1, q_last]
// and masks by position only on tiles that cross the diagonal, the
// window's edge or S.
// K and V tiles (rows padded by 4 floats: both fragments are read without
// bank conflicts) come by cp.async into one buffer each, rows past S as
// zeros: K of the next tile loads while P.V runs and V of the next while
// Q.K^T runs.  Per kv tile a warp
//  - takes S = Q.K^T for its 16 rows;
//  - scales and masks S, and updates the rows' running max and sum (the
//    4 threads of a row reduce the max by two shuffles; each keeps its
//    share of the sum until the end);
//  - takes O = O corr + P.V with P straight from S's accumulators: the
//    m16n8 accumulator holds a row's keys 2t, 2t + 1 where the A fragment
//    wants t, t + 4, so P.V's k step takes its 8 keys in the order 0, 2,
//    4, 6, 1, 3, 5, 7 and reads V's rows in that order too.  P never
//    leaves the registers.
// Each output row depends on its own q row and the keys it attends to
// alone (no split of the keys across blocks; a tile whose keys a row
// masks adds exact zeros), so a row's output does not change with the
// batch, the heads or the q tile it shares.  A warp that owns all of O's
// columns holds hd / 2 fp32 registers a thread (128 at hd 256), so the kv
// tiles narrow as hd grows, 64 keys at hd <= 64, 32 at 96 and 128, 16 at
// 160 and 256; Q's fragments stay in registers at hd <= 64 and are read
// from shared memory above, fewer k steps unrolled at once at 128, 160 and
// 320 (``s_unroll``).
//
// At hd 320 (gemma3-4b) O alone would hold 160 registers a thread, and
// every form of that layout spilled.  There the block has 8 warps (256
// threads) for the same 64 rows (``col_split``): warps 2i and 2i + 1 share
// rows 16i..16i + 15 and each owns 160 of O's columns, 80 registers a
// thread.  Each warp of a pair takes Q.K^T over its own 160 of hd (20 of
// the 40 k steps), adds its hi.hi and small products in fp32, writes that
// 16 x BN partial to shared memory, meets its partner at a named barrier
// (bar.sync 1 + i, 64: the pairs run apart, no block-wide barrier) and
// adds the partner's partial to its own.  fp32 addition commutes, so both
// warps hold S bit for bit, run the same scale, mask and online softmax
// (their m and l agree exactly) and take P.V over their own columns with
// P in registers, as above.  The kv tiles there hold 32 keys (in the
// first forms, all of which spilled, 16 keys took 17% longer and each warp
// taking the whole S, no exchange but 1.5x the products, 33% longer).
// Its 80 registers of O, 32 of P and the fragments in flight fill the 255
// a thread may have, so the layout keeps nothing else across the kv loop:
// the k and v rows' pointers and the output's indices are read afresh
// from the special registers (``kv_rows``, ``place``), the rows' positions
// are taken where a tile is masked, and P.V is fenced (``__syncwarp``)
// every two n tiles of O.  ptxas then reports no spill at any head_dim
// (-O3, sm_90a).
//
// Shared memory is (64 + 2 BN) (hd + 4) x 4 bytes, and at hd 320 the
// pairs' partials (8 warps x 16 x BN x 4 bytes) besides: 27.6 KB at hd 32,
// 52.2 KB at 64, 51.2 KB at 96, 67.6 KB at 128, 63.0 KB at 160, 99.8 KB at
// 256 and 182.3 KB at 320 (one block an SM).
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the first CUDA error of the launch.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;              // (query, head) rows of a q tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;

// keys of a kv tile
template <int HD>
__host__ __device__ constexpr int tile_keys() {
  return HD <= 64 ? 64 : HD <= 128 ? 32 : HD <= 256 ? 16 : 32;
}
// warps that share a group of 16 rows, each owning HD / col_split of O's
// columns and of Q.K^T's k steps
template <int HD>
__host__ __device__ constexpr int col_split() {
  return HD <= 256 ? 1 : 2;
}
template <int HD>
__host__ __device__ constexpr int block_threads() {
  return 4 * 32 * col_split<HD>();
}
// Q's fragments kept in registers across the kv loop (else read from the
// q tile in shared memory at each step)
template <int HD>
__host__ __device__ constexpr bool q_in_registers() { return HD <= 64; }
// k steps of Q.K^T a warp unrolls together: fewer at hd 128, 160 and 320,
// where a full unroll spills (ptxas, -O3, sm_90a)
template <int HD>
__host__ __device__ constexpr int s_unroll() {
  return HD == 128 ? 4 : HD == 160 ? 2 : HD == 320 ? 10 : HD / 8;
}

template <int HD>
__host__ __device__ constexpr int smem_bytes() {
  return (kRows + 2 * tile_keys<HD>()) * (HD + 4) * 4 +
         (col_split<HD>() > 1 ? block_threads<HD>() * tile_keys<HD>() / 2 * 4
                              : 0);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// an mma operand split as x = hi + lo
struct FragA { uint32_t hi[4], lo[4]; };
struct FragB { uint32_t hi[2], lo[2]; };

// hi is x itself (the mma reads its top 19 bits: x truncated to TF32);
// lo = x - trunc(x), exact in fp32, truncated again by the mma
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u));
}

// A (16 x 8, row major): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4), with g = lane / 4 and t = lane % 4
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}

// B (8 x 8, k x n): b0 (k t, n g), b1 (k t + 4, n g)
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

// A B in 3xTF32: hi.hi into `hi`, the two small products into `lo`, to
// be summed in fp32 by the caller.  The mma truncates each sum it forms
// (toward zero), so a sum kept apart from the larger hi.hi one loses bits
// of its own size only.  D (16 x 8): d0 (g, 2t), d1 (g, 2t + 1),
// d2 (g + 8, 2t), d3 (g + 8, 2t + 1)
__device__ __forceinline__ void mma3(float (&hi)[4], float (&lo)[4],
                                     const FragA& a, const FragB& b) {
  mma(lo, a.lo, b.hi);
  mma(lo, a.hi, b.lo);
  mma(hi, a.hi, b.hi);
}

// 16 bytes global -> shared, zeros where !valid (src-size 0)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most one of this thread's committed groups is in flight
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// the two warps of row group `group` (barrier 0 is __syncthreads)
__device__ __forceinline__ void pair_sync(int group) {
  asm volatile("bar.sync %0, 64;" ::"r"(1 + group) : "memory");
}

// A block's k or v rows of this (batch, kv head), from a fresh read of
// the special registers (volatile asm, never merged with an earlier read):
// at hd 320 the pointer held across the kv loop took a register the layout
// has not got, and ptxas spilled it
__device__ __forceinline__ const float* kv_rows(const float* x, int S,
                                                int KV, int HD) {
  unsigned by, bz;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(by));
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(bz));
  return x + ((long long)bz * S * KV + by) * HD;
}

// Where a thread writes its two output rows: row r0 (r0 + 8 the other) of
// the q tile at q0 with n_rows used rows, its first column, its kv head
// and batch entry.  `place` reads them afresh from the special registers
// (as kv_rows, and for the same reason) for the hd-320 layout's output.
struct Place {
  int r0, col, q0, n_rows, kvh;
  long long b;
};
template <int HD>
__device__ __forceinline__ Place place(int S, int G, int BQ) {
  unsigned tid, bx, by, bz, nx;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(by));
  asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(bz));
  asm volatile("mov.u32 %0, %%nctaid.x;" : "=r"(nx));
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = int(nx - 1 - bx) * BQ;
  return {16 * (warp / col_split<HD>()) + lane / 4,
          warp % col_split<HD>() * (HD / col_split<HD>()) + 2 * (lane % 4),
          q0, (min(q0 + BQ, S) - q0) * G, int(by), (long long)bz};
}

// BN rows of k or v from key k0 (rows past S as zeros) into rows of
// HD + 4 floats; `src` is key 0 of this (batch, kv head), rows `step`
// floats apart
template <int HD, int BN>
__device__ __forceinline__ void stage_kv(float* dst, const float* src,
                                         int step, int k0, int S,
                                         int tid) {
  constexpr int V = HD / 4;
  for (int i = tid; i < BN * V; i += block_threads<HD>()) {
    const int r = i / V, c = 4 * (i % V);
    const bool ok = k0 + r < S;
    cp_async16(dst + r * (HD + 4) + c,
               ok ? src + (long long)(k0 + r) * step + c : src, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(block_threads<HD>(), 1)
swa_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o, int S,
                int H, int KV, int G, int BQ, int window, int causal,
                float scale) {
  constexpr int BN = tile_keys<HD>();
  constexpr int SPLIT = col_split<HD>();
  constexpr int THREADS = block_threads<HD>();
  constexpr int LD = HD + 4;          // padded row of Q, K and V tiles
  constexpr int HW = HD / SPLIT;      // O's columns and hd a warp takes
  constexpr int KD = HW / 8;          // k steps of Q.K^T a warp takes
  constexpr int NT = BN / 8;          // n tiles of S, k steps of P.V
  constexpr int OT = HW / 8;          // n tiles of O a warp owns
  constexpr bool kQRegs = q_in_registers<HD>();
  static_assert(HD % 32 == 0 && HW % 8 == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // kRows x LD
  float* Ks = Qs + kRows * LD;        // BN x LD
  float* Vs = Ks + BN * LD;           // BN x LD
  float* Xs = Vs + BN * LD;           // SPLIT > 1: a float4 a lane a n tile

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int group = warp / SPLIT;     // this warp's 16 rows
  const int col0 = warp % SPLIT * HW; // its first column of O and of hd
  const int kvh = blockIdx.y;
  const long long b = blockIdx.z;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // long tiles first
  const int q_last = min(q0 + BQ, S) - 1;
  const int n_rows = (q_last - q0 + 1) * G;
  const int step = KV * HD;           // floats between keys
  const float* kb = k + (b * S * KV + kvh) * HD;
  const float* vb = v + (b * S * KV + kvh) * HD;
  const int lo_key = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int hi_key = causal ? q_last : S - 1;
  const int t_first = lo_key / BN, t_last = hi_key / BN;

  // ---- the q tile (row r: query q0 + r / G, head kvh * G + r % G) ----
  for (int i = tid; i < kRows * (HD / 4); i += THREADS) {
    const int r = i / (HD / 4), c = 4 * (i % (HD / 4));
    const bool ok = r < n_rows;
    const float* src =
        ok ? q + ((b * S + q0 + r / G) * H + kvh * G + r % G) * HD + c : q;
    cp_async16(Qs + r * LD + c, src, ok);
  }

  // this thread's rows: r0 = 16 group + g and r1 = r0 + 8 (unused rows
  // take the last used row's position and are not written); at hd 320
  // the positions are taken where a tile is masked, not held
  const int r0 = 16 * group + g, r1 = r0 + 8;
  const int qpos0 = q0 + min(r0, n_rows - 1) / G;
  const int qpos1 = q0 + min(r1, n_rows - 1) / G;
  float qf[kQRegs ? KD : 1][4];

  // K, then V, of the first kv tile (the first group holds Q too)
  stage_kv<HD, BN>(Ks, kb, step, t_first * BN, S, tid);
  cp_async_commit();
  stage_kv<HD, BN>(Vs, vb, step, t_first * BN, S, tid);
  cp_async_commit();
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float oacc[OT][4];
#pragma unroll
  for (int c = 0; c < OT; ++c)
    oacc[c][0] = oacc[c][1] = oacc[c][2] = oacc[c][3] = 0.f;

  for (int kt = t_first; kt <= t_last; ++kt) {
    const int k0 = kt * BN;
    cp_async_wait_all_but_one();    // Q and this tile's K are in
    __syncthreads();
    if (kQRegs && kt == t_first) {
#pragma unroll
      for (int kk = 0; kk < (kQRegs ? KD : 1); ++kk) {
        qf[kk][0] = Qs[r0 * LD + col0 + 8 * kk + t];
        qf[kk][1] = Qs[r1 * LD + col0 + 8 * kk + t];
        qf[kk][2] = Qs[r0 * LD + col0 + 8 * kk + t + 4];
        qf[kk][3] = Qs[r1 * LD + col0 + 8 * kk + t + 4];
      }
    }

    // ---- S = Q K^T: keys k0 + 8 j + 2 t (+1) of rows r0 (s[j][0..1])
    // and r1 (s[j][2..3]), over this warp's hd; hi.hi in s, the small
    // products in sl ----
    float s[NT][4], sl[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = sl[j][e] = 0.f;
#pragma unroll (s_unroll<HD>())
    for (int kk = 0; kk < KD; ++kk) {
      FragA a;
      if constexpr (kQRegs) {
        a = frag_a(qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3]);
      } else {
        const float* qr = Qs + col0 + 8 * kk + t;
        a = frag_a(qr[r0 * LD], qr[r1 * LD], qr[r0 * LD + 4],
                   qr[r1 * LD + 4]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float* kr = Ks + (8 * j + g) * LD + col0 + 8 * kk + t;
        mma3(s[j], sl[j], a, frag_b(kr[0], kr[4]));
      }
    }
    __syncthreads();                // every warp is done with K
    if (kt < t_last)
      stage_kv<HD, BN>(Ks, SPLIT > 1 ? kv_rows(k, S, KV, HD) : kb, step,
                       k0 + BN, S, tid);
    cp_async_commit();
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += sl[j][e];
    if constexpr (SPLIT > 1) {
      // the pair's partials: each warp adds its partner's to its own (the
      // sum commutes, so both hold S bit for bit); the buffer is written
      // again only after the next tile's block-wide barriers
      float4* xs = reinterpret_cast<float4*>(Xs) + warp * NT * 32 + lane;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        xs[32 * j] = make_float4(s[j][0], s[j][1], s[j][2], s[j][3]);
      pair_sync(group);
      const float4* px =
          reinterpret_cast<const float4*>(Xs) + (warp ^ 1) * NT * 32 + lane;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float4 x = px[32 * j];
        s[j][0] += x.x;
        s[j][1] += x.y;
        s[j][2] += x.z;
        s[j][3] += x.w;
      }
    }

    // ---- scale, mask, online softmax ----
    const bool masked = (causal && k0 + BN - 1 > q0) ||
                        (window > 0 && k0 <= q_last - window) ||
                        k0 + BN > S;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale;
        if (masked) {
          const int key = k0 + 8 * j + 2 * t + (e & 1);
          const int qp =
              SPLIT > 1 ? q0 + min(e < 2 ? r0 : r1, n_rows - 1) / G
                        : e < 2 ? qpos0 : qpos1;
          const bool ok = key < S && (!causal || key <= qp) &&
                          (window <= 0 || key > qp - window);
          x = ok ? x : kNegInf;
        }
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    // exp(x - n) as exp2((x - n) log2 e): x - n is exactly 0 where a
    // row has seen masked scores alone (as in the reference, p is then
    // 1 until a real score comes and its correction, exp(-1e30 - n), is
    // 0); an FMA would leave the rounding of n log2 e there instead
    const float c0 = ex2((m0 - n0) * kLog2e), c1 = ex2((m1 - n1) * kLog2e);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = ex2((s[j][0] - n0) * kLog2e);
      s[j][1] = ex2((s[j][1] - n0) * kLog2e);
      s[j][2] = ex2((s[j][2] - n1) * kLog2e);
      s[j][3] = ex2((s[j][3] - n1) * kLog2e);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = l0 * c0 + sum0;            // this thread's share of the row sum
    l1 = l1 * c1 + sum1;
    m0 = n0;
    m1 = n1;
    // P's A fragments: k step j takes keys 8 j + (0, 2, 4, 6, 1, 3, 5,
    // 7), so S's accumulator is the fragment as it stands
    FragA p[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j)
      p[j] = frag_a(s[j][0], s[j][2], s[j][1], s[j][3]);

    cp_async_wait_all_but_one();    // this tile's V is in
    __syncthreads();
    // ---- O = O corr + P V: each n tile's product over the tile's keys
    // from zero, then added to O in fp32 (the mma truncates its sums, so
    // O never runs through it) ----
    const float* vr = Vs + 2 * t * LD + col0 + g;
#pragma unroll
    for (int c = 0; c < OT; ++c) {
      float dh[4] = {0.f, 0.f, 0.f, 0.f}, dl[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mma3(dh, dl, p[j], frag_b(vr[8 * j * LD + 8 * c],
                                  vr[(8 * j + 1) * LD + 8 * c]));
      oacc[c][0] = fmaf(oacc[c][0], c0, dh[0] + dl[0]);
      oacc[c][1] = fmaf(oacc[c][1], c0, dh[1] + dl[1]);
      oacc[c][2] = fmaf(oacc[c][2], c1, dh[2] + dl[2]);
      oacc[c][3] = fmaf(oacc[c][3], c1, dh[3] + dl[3]);
      // at hd 320 two n tiles at a time: unfenced, ptxas hoists the V
      // loads of more n tiles than the layout has registers for
      if constexpr (SPLIT > 1)
        if (c % 2 == 1) __syncwarp();
    }
    __syncthreads();                // every warp is done with V
    if (kt < t_last)
      stage_kv<HD, BN>(Vs, SPLIT > 1 ? kv_rows(v, S, KV, HD) : vb, step,
                       k0 + BN, S, tid);
    cp_async_commit();
  }

  // ---- out = O / max(l, 1e-30), the row sums reduced over the quad --
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  Place at{r0, col0 + 2 * t, q0, n_rows, kvh, b};
  if constexpr (SPLIT > 1) at = place<HD>(S, G, BQ);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = at.r0 + 8 * half;
    if (r >= at.n_rows) continue;
    const float li = half ? l1 : l0;
    float* dst = o + ((at.b * S + at.q0 + r / G) * H + at.kvh * G + r % G) *
                         HD + at.col;
#pragma unroll
    for (int c = 0; c < OT; ++c)
      *reinterpret_cast<float2*>(dst + 8 * c) =
          make_float2(oacc[c][2 * half] / li, oacc[c][2 * half + 1] / li);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, float* o, int B,
           int S, int H, int KV, int window, int causal, float scale,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  static_assert(bytes <= 232448, "over the 227 KB a block may have");
  // the opt-in to more than 48 KB of shared memory, once per device (not
  // while a CUDA graph is being captured: the first call is never captured)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(swa_tf32_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const int G = H / KV;
  const int BQ = kRows / G;
  dim3 grid((S + BQ - 1) / BQ, KV, B);
  swa_tf32_kernel<HD><<<grid, block_threads<HD>(), bytes, stream>>>(
      q, k, v, o, S, H, KV, G, BQ, window, causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// fp32 q, k, v and o.  hd in {32, 64, 96, 128, 160, 256, 320}; H % KV == 0 and
// H / KV <= 64; window <= 0 means none.
int rt_swa_attention_fwd_tf32(const void* q, const void* k, const void* v,
                              void* o, int B, int S, int H, int KV, int hd,
                              int window, int causal, float scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  switch (hd) {
    case 32: return launch<32>(qf, kf, vf, of, B, S, H, KV, window, causal, scale, s);
    case 64: return launch<64>(qf, kf, vf, of, B, S, H, KV, window, causal, scale, s);
    case 96: return launch<96>(qf, kf, vf, of, B, S, H, KV, window, causal, scale, s);
    case 128: return launch<128>(qf, kf, vf, of, B, S, H, KV, window, causal, scale, s);
    case 160: return launch<160>(qf, kf, vf, of, B, S, H, KV, window, causal, scale, s);
    case 256: return launch<256>(qf, kf, vf, of, B, S, H, KV, window, causal, scale, s);
    case 320: return launch<320>(qf, kf, vf, of, B, S, H, KV, window, causal, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
