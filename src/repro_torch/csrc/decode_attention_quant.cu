// GQA decode attention over an int8-quantised contiguous KV cache, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention_quant.py::decode_attention_quant
// (the Pallas TPU kernel: grid (B, KV, S / block), int8 blocks widened on
// the VPU after the VMEM load, scales folded into the scores and the
// probabilities).
//
// Computes, for every row b and query head h = kv * G + g, over positions
// s < length of the int8 codes k/v (B, S, KV, D) and their float32
// per-vector scales (B, S, KV):
//   scores_s = (q[b, h] / sqrt(D) . k[b, s]) * k_scale[b, s]
//   out[b, h] = sum_s (softmax(scores)_s * v_scale[b, s]) * v[b, s]
// length is one scalar for the whole batch (the lockstep wave's pos + 1),
// passed as a launch argument.
//
// What bounds it on the H100: bytes — D + 4 bytes per cached vector, about
// half the bf16 cache's 2 * D, and far below the flop ridge.
//
// Design: decode_core.cuh's loop (one CTA per (row, kv head) carrying all G
// query heads, 32-key tiles, float32 online softmax, fixed order, no
// atomics). Device memory sees only the int8 codes and the float32 scales:
// the codes widen to float32 in registers on their way into shared memory,
// and no dequantised copy of the cache exists anywhere.
#include "decode_core.cuh"

#include <stdint.h>

namespace {

using acar::decode::kMaxD;
using acar::decode::kMaxG;
using acar::decode::kThreads;

struct QuantCacheLoader {
  const int8_t* k;  // this (row, kv head)'s position 0
  const int8_t* v;
  const float* k_scale;
  const float* v_scale;
  int KV;
  int D;
  __device__ __forceinline__ void load(int pos, int d, float& kf,
                                       float& vf) const {
    const size_t off = (size_t)pos * KV * D + d;
    kf = (float)k[off];
    vf = (float)v[off];
  }
  __device__ __forceinline__ void scales(int pos, float& ks,
                                         float& vs) const {
    const size_t off = (size_t)pos * KV;
    ks = k_scale[off];
    vs = v_scale[off];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_quant_kernel(const T* __restrict__ q,
                        const int8_t* __restrict__ k_codes,
                        const float* __restrict__ k_scale,
                        const int8_t* __restrict__ v_codes,
                        const float* __restrict__ v_scale, T* __restrict__ out,
                        int S, int KV, int G, int D, int length, float scale) {
  __shared__ acar::decode::Smem sm;
  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const size_t row = ((size_t)b * S * KV + kv) * D;
  const size_t srow = (size_t)b * S * KV + kv;
  const QuantCacheLoader ld{k_codes + row, v_codes + row, k_scale + srow,
                            v_scale + srow, KV, D};
  const size_t head0 = ((size_t)b * KV * G + kv * G) * D;
  acar::decode::attend(sm, q + head0, out + head0, G, D, length, scale, ld);
}

}  // namespace

extern "C" int acar_decode_attention_quant(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, void* out, int B, int H, int KV,
    int D, int S, int length, int dtype, void* stream) {
  const int G = H / KV;
  if (G > kMaxG || D > kMaxD || H % KV != 0 || length < 0 || length > S)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, KV);
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* kc = static_cast<const int8_t*>(k_codes);
  const int8_t* vc = static_cast<const int8_t*>(v_codes);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  if (dtype == acar::kBF16) {
    using T = __nv_bfloat16;
    decode_quant_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(q), kc, ks, vc, vs, static_cast<T*>(out), S, KV,
        G, D, length, scale);
  } else {
    decode_quant_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), kc, ks, vc, vs,
        static_cast<float*>(out), S, KV, G, D, length, scale);
  }
  return (int)cudaGetLastError();
}
