// Sliding-window attention forward on Hopper's tensor cores: the bf16
// route of repro_torch/kernels/swa_attention.py, compiled for sm_90a and
// bound through a plain C interface (ctypes).
//
// rt_swa_attention_fwd_wgmma replaces, for bf16 inputs, the Pallas kernel
//   src/repro/kernels/swa_attention.py:swa_attention_fwd (body :24-78)
// and computes what it computes: causal (or full) GQA attention with an
// optional sliding window (query i attends to keys j in (i - window, i]),
// an online softmax in fp32 with masked scores at -1e30 after the scale,
// division by max(l, 1e-30), output in q's dtype.  q (B, S, H, hd), k and
// v (B, S, KV, hd), bf16; head h reads kv head h / (H / KV).  fp32 inputs
// keep the CUDA-core kernel of swa_attention.cu.
//
// Bound: operations.  The function does 4 * hd multiply-adds per unmasked
// (query, key) pair and head: 38.67 GFLOP at SmolLM's long shape (B 8,
// S 2048, 9/3 heads, hd 64, causal), 0.0391 ms at the bf16 tensor-core
// peak of 989 TFLOP/s; its 50 MB of q, k, v and o take 0.015 ms at
// 3.35 TB/s.  This design does three bf16 products where the function
// needs two (below), so its own least time there is 0.0587 ms.  At hd 64
// the softmax is as costly as the products: one exp2 per score on the
// multi-function unit (16 a clock per SM) takes about as long as the
// score's share of the wgmmas.  At Gemma-3's shape (B 1, S 2048, 8/4
// heads, hd 320) the function is 16.11 GFLOP with a window of 1024 and
// 21.49 causal, 0.0163 and 0.0217 ms at peak; the softmax costs about a
// quarter of the products there, so the products are the limit.
//
// Precision.  The Pallas body computes both products in fp32.  Q.K^T from
// bf16 operands with fp32 accumulation is exact up to the order of the
// sums.  P is fp32: rounded once to bf16 (as FlashAttention does) it
// breaks the port's gate of one bf16 step against the fp32 plain version
// in about 10% of the outputs, so P is split into hi = bf16(P) and
// lo = bf16(P - hi) (P - hi is exact in fp32) and P.V is taken as
// P_hi.V + P_lo.V, two wgmmas into one fp32 accumulator: hi + lo is P to
// within 2^-16 of P.  Both roundings are to nearest (ties away from zero)
// by an integer add on the fp32 bit pattern and a byte permute, which keeps
// them off the conversion unit (truncating instead, an error of up to
// 2^-14 P, all of one sign, breaks the gate in rare outputs).
// tests/test_torch_swa_precision.py emulates this arithmetic.  l is summed
// from the fp32 P.
//
// Design.  A block takes one q head and kBM = 128 queries: two consumer
// warpgroups of 64 rows each and a producer warpgroup, whose first thread
// issues every TMA load while the others idle, so the producer gives its
// registers to the consumers (setmaxnreg).  The grid is (H, B, q tiles),
// the q tiles in reverse order, so the long causal tiles start first and
// the G heads of a kv head run side by side (GQA's reuse of K and V comes
// from L2: one (b, kv head) strip is 0.5 MB at the long shape).  TMA moves
// every tile: 4-D tensor maps (hd, heads, S, B) with 128-byte swizzle and
// 64-element boxes along hd (hd 128 takes two boxes, 256 four, 320 five;
// hd 32, 96 and 160 read zeros past hd), so rows past S arrive as zeros
// and the TMA store of O clips them.  K and V run through a kStages-deep
// ring on mbarriers.  The kv loop walks only the tiles that meet
// [q_first - window + 1, q_last].
// Per kv tile a consumer warpgroup issues S = Q.K^T (wgmma, both operands
// in shared memory, K-major) together with the previous tile's P.V, with
// P from registers (the accumulator fragment of S is the A fragment of the
// next wgmma after packing pairs into bf16x2; V is the MN-major B operand),
// and runs the softmax of S while P.V is on the tensor cores: it scales the
// fp32 scores inside the exponent's FFMA, masks by position only where the
// tile crosses the diagonal, the window's edge or S, and reduces row max
// and sum across the 4 threads of a row.  The two warpgroups take turns to
// issue their wgmmas (named barriers), so one's softmax runs while the
// other's products do.  Keys per kv tile: 128 at hd <= 64, 64 at hd 96 to
// 160, 32 at hd 256 and 320, where O alone holds 128 and 160 fp32
// registers a thread (the table at Tile): with S and P at 16 each, the
// consumers fit in the 240 registers setmaxnreg gives them.  Above hd 128
// P.V runs as products of 128 and 64 columns (wgmma's N stops at 256).
// At Gemma-3's causal shape the grid is 128 blocks on 132 SMs, one wave:
// the longest block (the last q tile, 2048 keys) carries twice the mean,
// and the layer takes as long as that block.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns the first CUDA error of the launch
// (cudaErrorInvalidValue where a tensor map cannot be made).
#include <cuda.h>  // CUtensorMap; the CUDA driver is reached at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;                     // queries of a block
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
constexpr int kBox = 64 * 128;               // bytes of a 64-row box
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;
constexpr int kSmemLimit = 232448;           // a block's on sm_90

// HDP: hd padded to a multiple of 64.  Keys of a kv tile and depth of the
// K/V ring, from the registers and shared memory of each width:
//   HDP   kBK  stages  shared memory  O + S + P_hi/lo registers a thread
//    64   128    3     ~113 KB         32 + 64 + 64
//   128    64    3     ~129 KB         64 + 32 + 32
//   192    64    3     ~193 KB         96 + 32 + 32   (hd 160)
//   256    32    4     ~193 KB        128 + 16 + 16
//   320    32    3     ~201 KB        160 + 16 + 16
template <int HDP>
struct Tile {
  static constexpr int kBoxes = HDP / 64;               // boxes along hd
  static constexpr int kBK = HDP == 64 ? 128 : HDP <= 192 ? 64 : 32;
  static constexpr int kStages = HDP == 256 ? 4 : 3;    // K/V ring depth
  static constexpr int kHalf = kBox * kBoxes;           // one warpgroup's Q
  static constexpr int kKV = kBK * 128 * kBoxes;        // one K or V tile
  static constexpr int kSmem = 2 * kHalf + 2 * kStages * kKV + 1024;
  static_assert(kSmem <= kSmemLimit, "K/V ring over the shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// waits for the phase of `bar` with this parity to complete; a wait of
// more than about ten seconds traps, so a lost arrival fails the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  long long start = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// one box of a 4-D tensor map into shared memory; completes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile whose rows
// are 128 bytes: lbo is the byte stride between 64-element column blocks
// (MN-major operands only), sbo the stride between groups of 8 rows.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of a wgmma's registers
// across the asynchronous wgmma and its wait (and from reusing them)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

#define F8(i)                                                         \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),         \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// D (64 x 32, fp32) (+)= A (64 x 16, shared memory, K-major) . B (16 x 32,
// shared memory, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, fp32) (+)= A (64 x 16, shared memory, K-major) . B (16 x 64,
// shared memory, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, fp32) (+)= A (64 x 16, shared memory, K-major) . B (16 x 128,
// shared memory, K-major); scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 16, registers) . B (16 x 64, shared memory,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, fp32) += A (64 x 16, registers) . B (16 x 128, shared memory,
// MN-major: the transpose bit).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}


#undef F8

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// S = Q K^T over hd (no commit)
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&sc)[Tile<HDP>::kBK / 2],
                                         const uint8_t* Qh,
                                         const uint8_t* Kt) {
  constexpr int BK = Tile<HDP>::kBK;
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk) {
    const int c = kk / 4, off = (kk % 4) * 32;
    wgmma_ss(sc, smem_desc(Qh + c * kBox + off, 16, 1024),
             smem_desc(Kt + c * BK * 128 + off, 16, 1024), kk > 0);
  }
}

// the N columns of an accumulator from column c0 on (a multiple of 8):
// 8-column groups are 4 consecutive registers of the fragment
template <int N, int M>
__device__ __forceinline__ float (&cols(float (&o)[M], int c0))[N / 2] {
  return *reinterpret_cast<float(*)[N / 2]>(&o[c0 / 2]);
}

// O += P_hi V + P_lo V over the tile's keys (no commit); V's tile is
// (BK keys) x (hd), hd contiguous.  wgmma's N is at most 256 and a B
// operand spans whole 64-column boxes, so above hd 128 O is taken in
// 128-column products and a last 64-column one (192: 128 + 64; 256:
// 128 + 128; 320: 128 + 128 + 64).
template <int HDP>
__device__ __forceinline__ void issue_pv(
    float (&o)[HDP / 2], const uint32_t (&hi)[Tile<HDP>::kBK / 16][4],
    const uint32_t (&lo)[Tile<HDP>::kBK / 16][4], const uint8_t* Vt) {
  constexpr int BK = Tile<HDP>::kBK;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint8_t* vk = Vt + kk * 16 * 128;
    if constexpr (HDP <= 128) {
      const uint64_t dv = smem_desc(vk, BK * 128, 1024);
      wgmma_rs(o, hi[kk], dv);
      wgmma_rs(o, lo[kk], dv);
    } else {
#pragma unroll
      for (int c = 0; c < HDP / 128; ++c) {
        const uint64_t dv = smem_desc(vk + 2 * c * BK * 128, BK * 128, 1024);
        wgmma_rs(cols<128>(o, 128 * c), hi[kk], dv);
        wgmma_rs(cols<128>(o, 128 * c), lo[kk], dv);
      }
      if constexpr (HDP % 128 != 0) {
        const uint64_t dv = smem_desc(vk + (HDP / 64 - 1) * BK * 128,
                                      BK * 128, 1024);
        wgmma_rs(cols<64>(o, HDP - 64), hi[kk], dv);
        wgmma_rs(cols<64>(o, HDP - 64), lo[kk], dv);
      }
    }
  }
}

// Where this thread's scores sit: rows qpos[0] and qpos[1], and sc[i] is
// row qpos[(i / 2) % 2], key k0 + col + 8 (i / 4) + i % 2.
struct Rows {
  int qpos[2], col, first, last;
};

// The online softmax of one tile, in place: sc becomes p (log2 domain,
// masked scores at -1e30 after the scale), m the running max, l this
// thread's share of the running sum; returns the correction of what came
// before in corr.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], int k0,
                                             const Rows& rw, int S,
                                             int window, int causal,
                                             float scale_log2) {
  float c = scale_log2;
  if (k0 + BK > S || (causal && k0 + BK - 1 > rw.first) ||
      (window > 0 && k0 <= rw.last - window)) {
    // keys k0 + col + d of row r are kept for d - d0[r] in [0, span[r]]
    // (span < 0 only for rows past S, which are never stored)
    int d0[2], span[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lo_k = window > 0 ? max(rw.qpos[r] - window + 1, 0) : 0;
      const int hi_k = causal ? min(rw.qpos[r], S - 1) : S - 1;
      d0[r] = lo_k - k0 - rw.col;
      span[r] = hi_k - lo_k;
    }
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int r = (i / 2) % 2;
      const bool ok = static_cast<unsigned>(8 * (i / 4) + i % 2 - d0[r]) <=
                      static_cast<unsigned>(span[r]);
      sc[i] = ok ? sc[i] * scale_log2 : kMasked;
    }
    c = 1.f;   // scaled already
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx4[4] = {kMasked, kMasked, kMasked, kMasked};   // 4 chains
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx4[j % 4] = fmaxf(mx4[j % 4],
                         fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
    float mx = fmaxf(fmaxf(mx4[0], mx4[1]), fmaxf(mx4[2], mx4[3])) * c;
    mx = fmaxf(mx, m[r]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[r] = ex2(m[r] - mx);
    m[r] = mx;
    float sum4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(fmaf(sc[4 * j + 2 * r + e], c, -mx));
        sc[4 * j + 2 * r + e] = p;
        sum4[(2 * j + e) % 4] += p;
      }
    l[r] = l[r] * corr[r] + ((sum4[0] + sum4[1]) + (sum4[2] + sum4[3]));
  }
}

// The top 16 bits of the bf16 pair (a, b) rounded to nearest (ties away
// from zero): an integer add on the fp32 bit patterns and a byte permute,
// off the conversion unit.
__device__ __forceinline__ uint32_t round_pair(uint32_t a, uint32_t b) {
  return __byte_perm(a + 0x8000u, b + 0x8000u, 0x7632);
}

// P as the A fragments of P.V (k-step kk takes sc[8 kk .. 8 kk + 7]),
// split into hi = bf16(P) and lo = bf16(P - hi), both rounded to nearest
template <int BK>
__device__ __forceinline__ void split_p(const float (&sc)[BK / 2],
                                        uint32_t (&hi)[BK / 16][4],
                                        uint32_t (&lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sc[8 * kk + 2 * i], b = sc[8 * kk + 2 * i + 1];
      const uint32_t h = round_pair(__float_as_uint(a), __float_as_uint(b));
      hi[kk][i] = h;
      const float ra = a - __uint_as_float(h << 16);           // exact
      const float rb = b - __uint_as_float(h & 0xffff0000u);
      lo[kk][i] = round_pair(__float_as_uint(ra), __float_as_uint(rb));
    }
  }
}

// The consumer warpgroups take turns to issue their wgmmas: warpgroup wg
// waits at named barrier 3 + wg for its turn and hands it on at the
// other's.
__device__ __forceinline__ void take_turn(int wg) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
}
__device__ __forceinline__ void pass_turn(int wg) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - wg) : "memory");
}

template <int HDP>
__global__ void __launch_bounds__(kThreads, 1)
swa_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap omap, int S, int G,
                 int window, int causal, float scale_log2) {
  using T = Tile<HDP>;
  constexpr int BK = T::kBK;
  extern __shared__ uint8_t smem_raw[];
  constexpr int kStages = T::kStages;
  __shared__ __align__(8) uint64_t bars[1 + 3 * kStages];
  // 128-byte swizzle repeats every 1024 bytes: tiles start on that grid
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Ks = Qs + 2 * T::kHalf;           // [kStages][boxes][BK][64]
  uint8_t* Vs = Ks + kStages * T::kKV;
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;               // [kStages]: the K/V ring
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty = full_v + kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;   // long tiles first
  const int lo_key = window > 0 ? max(q0 - window + 1, 0) : 0;
  const int hi_key = causal ? min(q0 + kBM, S) - 1 : S - 1;
  const int t_lo = lo_key / BK;
  const int n_tiles = hi_key / BK - t_lo + 1;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= kConsumers / 32) {
    // ---- producer: Q, then the K/V ring; its registers go to the
    // consumers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == kConsumers) {
      const int kvh = h / G;
      mbar_expect_tx(full_q, 2 * T::kHalf);
      for (int half = 0; half < 2; ++half)
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(Qs + half * T::kHalf + c * kBox, &qmap, full_q, c * 64, h,
                   q0 + 64 * half, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, k0 = (t_lo + t) * BK;
        mbar_wait(&empty[s], ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(&full_k[s], T::kKV);
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(Ks + s * T::kKV + c * BK * 128, &kmap, &full_k[s], c * 64,
                   kvh, k0, b);
        mbar_expect_tx(&full_v[s], T::kKV);
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(Vs + s * T::kKV + c * BK * 128, &vmap, &full_v[s], c * 64,
                   kvh, k0, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg + [0, 64) ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int wg = warp / 4;
  const int tid = threadIdx.x % 128;
  const int row = 16 * (tid / 32) + lane / 4;   // and row + 8
  Rows rw;
  rw.first = q0 + 64 * wg;
  rw.last = rw.first + 63;
  rw.qpos[0] = rw.first + row;
  rw.qpos[1] = rw.first + row + 8;
  rw.col = 2 * (lane % 4);
  uint8_t* Qh = Qs + wg * T::kHalf;

  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m[2] = {kMasked, kMasked};   // running max, log2 domain
  float l[2] = {0.f, 0.f};           // this thread's share of the sum
  float sc[BK / 2], corr[2];
  uint32_t hi[BK / 16][4], lo[BK / 16][4];

  if (wg == 1) pass_turn(wg);   // warpgroup 0 takes the first turn
  mbar_wait(full_q, 0);
  // the first tile: S, its softmax and P
  mbar_wait(&full_k[0], 0);
  take_turn(wg);
  wgmma_fence();
  issue_qk<HDP>(sc, Qh, Ks);
  wgmma_commit();
  pass_turn(wg);
  wgmma_wait_all();
  fence_regs(sc);
  softmax_tile<BK>(sc, m, l, corr, t_lo * BK, rw, S, window, causal,
                   scale_log2);
  split_p<BK>(sc, hi, lo);
  // then per tile t: S of t and P.V of t - 1 on the tensor cores while the
  // softmax of t runs
  for (int t = 1; t < n_tiles; ++t) {
    const int s = t % kStages, sp = (t - 1) % kStages;
    mbar_wait(&full_k[s], (t / kStages) & 1);
    mbar_wait(&full_v[sp], ((t - 1) / kStages) & 1);
    take_turn(wg);
    fence_regs(o);
    wgmma_fence();
    issue_qk<HDP>(sc, Qh, Ks + s * T::kKV);
    wgmma_commit();
    issue_pv<HDP>(o, hi, lo, Vs + sp * T::kKV);
    wgmma_commit();
    pass_turn(wg);
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    fence_regs(sc);
    softmax_tile<BK>(sc, m, l, corr, (t_lo + t) * BK, rw, S, window, causal,
                     scale_log2);
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(hi);
    fence_regs(lo);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[sp]);
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) o[i] *= corr[(i / 2) % 2];
    split_p<BK>(sc, hi, lo);
  }
  // the last tile's P.V
  const int sl = (n_tiles - 1) % kStages;
  mbar_wait(&full_v[sl], ((n_tiles - 1) / kStages) & 1);
  take_turn(wg);
  fence_regs(o);
  wgmma_fence();
  issue_pv<HDP>(o, hi, lo, Vs + sl * T::kKV);
  wgmma_commit();
  if (wg == 0) pass_turn(wg);   // warpgroup 1's turn is the last
  wgmma_wait_all();
  fence_regs(o);
  fence_regs(hi);
  fence_regs(lo);

  // ---- out = o / max(l, 1e-30) in bf16, staged in this warpgroup's Q
  // rows (its wgmmas are done) for a TMA store that clips past S and hd ----
  float rcp[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    rcp[r] = __frcp_rn(fmaxf(sum, 1e-30f));
  }
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      const int off = (j / 8) * kBox + rr * 128 +
                      (((j % 8) ^ (rr % 8)) * 16) + rw.col * 2;
      *reinterpret_cast<uint32_t*>(Qh + off) =
          as_u32(__floats2bfloat162_rn(o[4 * j + 2 * r] * rcp[r],
                                       o[4 * j + 2 * r + 1] * rcp[r]));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (tid == 0 && rw.first < S) {
    for (int c = 0; c < T::kBoxes; ++c)
      tma_store(&omap, Qh + c * kBox, c * 64, h, rw.first, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the CUDA driver the runtime has loaded, so
// the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 (B, S, heads, hd) tensor as a 4-D map (hd, heads, S, B) with
// boxes of 64 hd-elements x `rows` positions of one head and batch
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads,
              int hd, int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2,
                                 (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int S, int H, int KV, int hd, int window, int causal, float scale,
           cudaStream_t stream) {
  // the opt-in to more than 48 KB of shared memory, once per device (not
  // while a CUDA graph is being captured: the first call is never captured)
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(swa_wgmma_kernel<HDP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<HDP>::kSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  CUtensorMap qm, km, vm, om;
  if (!make_map(&qm, q, B, S, H, hd, 64) ||
      !make_map(&km, k, B, S, KV, hd, Tile<HDP>::kBK) ||
      !make_map(&vm, v, B, S, KV, hd, Tile<HDP>::kBK) ||
      !make_map(&om, o, B, S, H, hd, 64))
    return (int)cudaErrorInvalidValue;
  // heads fastest, so the G heads of a kv head run side by side
  dim3 grid(H, B, (S + kBM - 1) / kBM);
  swa_wgmma_kernel<HDP><<<grid, kThreads, Tile<HDP>::kSmem, stream>>>(
      qm, km, vm, om, S, H / KV, window, causal, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q, k, v and o.  hd in {32, 64, 96, 128, 160, 256, 320};
// H % KV == 0; window <= 0 means none.
int rt_swa_attention_fwd_wgmma(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int H, int KV, int hd,
                               int window, int causal, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hd == 32 || hd == 64)
    return launch<64>(q, k, v, o, B, S, H, KV, hd, window, causal, scale, s);
  if (hd == 96 || hd == 128)
    return launch<128>(q, k, v, o, B, S, H, KV, hd, window, causal, scale, s);
  if (hd == 160)
    return launch<192>(q, k, v, o, B, S, H, KV, hd, window, causal, scale, s);
  if (hd == 256)
    return launch<256>(q, k, v, o, B, S, H, KV, hd, window, causal, scale, s);
  if (hd == 320)
    return launch<320>(q, k, v, o, B, S, H, KV, hd, window, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
