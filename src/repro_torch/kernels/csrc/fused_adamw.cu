// Fused AdamW: the Hopper kernel behind repro_torch/kernels/fused_adamw.py,
// compiled for sm_90a and bound through a plain C interface (ctypes).
//
// rt_fused_adamw replaces the Pallas kernel
//   src/repro/kernels/fused_adamw.py:fused_adamw_flat
// One pass over a leaf: it reads g and p (fp32 or bf16, each in its own
// dtype) and the fp32 moments m and v, writes m' and v' in place over m
// and v, and writes the update u in p's dtype:
//   m' = b1*m + (1-b1)*g
//   v' = b2*v + ((1-b2)*g)*g
//   u  = -lr * ((m'/c1) / (sqrt(v'/c2) + eps) + wd*p)
// c1 and c2 (the bias corrections of this step) are fp32 scalars in device
// memory, so the step count never makes the host wait on the device.
//
// Bound: bytes.  For a bf16 parameter with a bf16 gradient one element
// moves 22 bytes (read g 2, m 4, v 4, p 2; write u 2, m 4, v 4); the 12
// leaves of SmolLM-135M (162,826,560 parameters) move 3.58 GB a step,
// about 1.07 ms at 3.35 TB/s.  Operations are ~15 per element, far below
// the rate at which the card could do them.
//
// Design: a grid-stride elementwise loop, one element a thread per trip,
// neighbouring threads on neighbouring elements so every load and store
// is coalesced; enough blocks to fill the SMs several times over.  Each
// operation is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn), so nvcc cannot contract a multiply and an add
// into one fma, and the result equals the plain PyTorch version (one
// rounded op at a time, in this order) bit for bit.  1-b1 and 1-b2 arrive
// as host doubles rounded to float, as both frameworks round them.  The
// TPU kernel's (256, 256) VMEM tiles and its padding of the leaf have no
// counterpart: the ragged end is masked by the loop bound.
//
// The entry point launches on the caller's stream, allocates nothing,
// does not synchronise, and returns cudaGetLastError() of the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

template <typename TG, typename TP>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const TG* __restrict__ g, float* __restrict__ m,
                   float* __restrict__ v, const TP* __restrict__ p,
                   TP* __restrict__ u, long long n,
                   const float* __restrict__ c1p,
                   const float* __restrict__ c2p, float neg_lr, float b1,
                   float b2, float one_minus_b1, float one_minus_b2,
                   float eps, float wd) {
  const float c1 = *c1p;
  const float c2 = *c2p;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    const float gf = to_f32(g[i]);
    const float pf = to_f32(p[i]);
    const float mn = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(one_minus_b1, gf));
    const float vn = __fadd_rn(__fmul_rn(b2, v[i]),
                               __fmul_rn(__fmul_rn(one_minus_b2, gf), gf));
    const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(vn, c2)), eps);
    const float t = __fadd_rn(__fdiv_rn(__fdiv_rn(mn, c1), den),
                              __fmul_rn(wd, pf));
    m[i] = mn;
    v[i] = vn;
    u[i] = from_f32<TP>(__fmul_rn(neg_lr, t));
  }
}

template <typename TG, typename TP>
void launch(const void* g, float* m, float* v, const void* p, void* u,
            long long n, const float* c1, const float* c2, float neg_lr,
            float b1, float b2, float omb1, float omb2, float eps, float wd,
            int sms, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  fused_adamw_kernel<TG, TP><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const TG*>(g), m, v, static_cast<const TP*>(p),
      static_cast<TP*>(u), n, c1, c2, neg_lr, b1, b2, omb1, omb2, eps, wd);
}

}  // namespace

extern "C" {

// g_dtype, p_dtype: 0 = fp32, 1 = bf16.  n > 0.  omb1 = (float)(1 - b1),
// omb2 = (float)(1 - b2), computed in double by the caller.
int rt_fused_adamw(const void* g, int g_dtype, void* m, void* v,
                   const void* p, int p_dtype, void* u, long long n,
                   const void* c1, const void* c2, float neg_lr, float b1,
                   float b2, float omb1, float omb2, float eps, float wd,
                   int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* mf = static_cast<float*>(m);
  float* vf = static_cast<float*>(v);
  const float* c1f = static_cast<const float*>(c1);
  const float* c2f = static_cast<const float*>(c2);
  if (g_dtype == 0 && p_dtype == 0) {
    launch<float, float>(g, mf, vf, p, u, n, c1f, c2f, neg_lr, b1, b2, omb1,
                         omb2, eps, wd, sms, s);
  } else if (g_dtype == 0 && p_dtype == 1) {
    launch<float, __nv_bfloat16>(g, mf, vf, p, u, n, c1f, c2f, neg_lr, b1,
                                 b2, omb1, omb2, eps, wd, sms, s);
  } else if (g_dtype == 1 && p_dtype == 0) {
    launch<__nv_bfloat16, float>(g, mf, vf, p, u, n, c1f, c2f, neg_lr, b1,
                                 b2, omb1, omb2, eps, wd, sms, s);
  } else if (g_dtype == 1 && p_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(g, mf, vf, p, u, n, c1f, c2f,
                                         neg_lr, b1, b2, omb1, omb2, eps, wd,
                                         sms, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
