// RG-LRU linear recurrence for Hopper (sm_90a), forward and backward.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan (the Pallas TPU
// kernel: grid (B, W / BLOCK_W, S / CHUNK), the (BLOCK_W,) state in VMEM
// scratch carried across the sequential chunk axis). The backward has no
// TPU counterpart: jax cannot reverse-differentiate a pallas_call, so the
// reference trains through its associative scan.
//
//   h_t = a_t * h_{t-1} + u_t,  h_{-1} = 0;  a, u (B, S, W) -> hs (B, S, W)
//   f32 and h_final (B, W) f32, whatever a's and u's types.
//
// What bounds it on the H100: bytes. Forward: a and u read once, hs
// written once (12 bytes a step in f32); backward: a, the saved hs and the
// incoming gradient read once, da and du written once (20 bytes a step).
// One multiply-add a step is nothing beside that.
//
// Design. A thread per (b, w) walks S; neighbouring threads take
// neighbouring channels, so every step's loads and stores are coalesced
// rows of W. The forward rounds the multiply and the add on their own, as
// the plain version does (a*h, then + u), so the two agree bit for bit.
// The backward walks S in reverse carrying g_t = dhs_t + a_{t+1} g_{t+1}
// (h_final's gradient enters at t = S-1) and writes du_t = g_t and
// da_t = g_t h_{t-1}, reading h_{t-1} from the saved hs. Nothing is summed
// across threads, so there is no reduction and no atomic.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const void* p, bool bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, bool bf16, size_t i,
                                      float v) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__global__ void __launch_bounds__(kThreads)
    rglru_fwd_kernel(const void* __restrict__ a, const void* __restrict__ u,
                     float* __restrict__ hs, float* __restrict__ h_final,
                     int B, int S, int W, bool a_bf16, bool u_bf16) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)B * W) return;
  const size_t b = idx / W, w = idx % W;
  float h = 0.f;
#pragma unroll 8
  for (int t = 0; t < S; ++t) {
    const size_t i = (b * S + t) * W + w;
    h = __fadd_rn(__fmul_rn(load(a, a_bf16, i), h), load(u, u_bf16, i));
    hs[i] = h;
  }
  h_final[idx] = h;
}

__global__ void __launch_bounds__(kThreads)
    rglru_bwd_kernel(const void* __restrict__ a,
                     const float* __restrict__ hs,
                     const float* __restrict__ dhs,
                     const float* __restrict__ dh_final,
                     void* __restrict__ da, void* __restrict__ du, int B,
                     int S, int W, bool a_bf16, bool u_bf16) {
  const size_t idx = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= (size_t)B * W) return;
  const size_t b = idx / W, w = idx % W;
  float carry = dh_final != nullptr ? dh_final[idx] : 0.f;
#pragma unroll 8
  for (int t = S - 1; t >= 0; --t) {
    const size_t i = (b * S + t) * W + w;
    const float g = dhs[i] + carry;
    const float h_prev = t > 0 ? hs[i - W] : 0.f;
    store(du, u_bf16, i, g);
    store(da, a_bf16, i, g * h_prev);
    carry = load(a, a_bf16, i) * g;
  }
}

}  // namespace

// a, u (B, S, W), each float32 or bfloat16 (a_bf16, u_bf16) -> hs
// (B, S, W) f32, h_final (B, W) f32.
extern "C" int acar_rglru_scan_fwd(const void* a, const void* u, void* hs,
                                   void* h_final, int B, int S, int W,
                                   int a_bf16, int u_bf16, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
  const int blocks = (int)(((size_t)B * W + kThreads - 1) / kThreads);
  rglru_fwd_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      a, u, static_cast<float*>(hs), static_cast<float*>(h_final), B, S, W,
      a_bf16 != 0, u_bf16 != 0);
  return (int)cudaGetLastError();
}

// The gradients of the forward above: dhs (B, S, W) f32 and dh_final
// (B, W) f32 or null -> da, du (B, S, W) in a's and u's types.
extern "C" int acar_rglru_scan_bwd(const void* a, const void* hs,
                                   const void* dhs, const void* dh_final,
                                   void* da, void* du, int B, int S, int W,
                                   int a_bf16, int u_bf16, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
  const int blocks = (int)(((size_t)B * W + kThreads - 1) / kThreads);
  rglru_bwd_kernel<<<blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const float*>(hs), static_cast<const float*>(dhs),
      static_cast<const float*>(dh_final), da, du, B, S, W, a_bf16 != 0,
      u_bf16 != 0);
  return (int)cudaGetLastError();
}
