// GQA decode attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas TPU kernel: grid (B, KV, S / BLOCK_S), one 512-key block per grid
// step, online softmax in VMEM scratch, caches off the block grid padded).
//
// Computes, for every row b and query head h = kv * G + g:
//   out[b, h] = softmax_s(q[b, h] . k[b, s] / sqrt(D)) @ v[b, s]
// over the positions s < length of k_cache/v_cache (B, S, KV, D). length is
// one scalar for the whole batch (the lockstep wave's pos + 1) and arrives
// as a launch argument, so a call copies nothing to the card.
//
// What bounds it on the H100: bytes. A decode token reads each cached key
// and value of its row once and does 4*D flops per key and query head, far
// below the card's ~295 flop/byte ridge; at serving shapes (a few dozen
// rows, a hundred-odd positions) the call moves a few megabytes at most, so
// launch latency and the per-tile barriers dominate.
//
// Design: decode_core.cuh's loop, one CTA per (row, kv head) with all G
// query heads, over 32-key tiles read straight from the row's cache. Any S
// works (no padding to a block grid): the last tile is masked by length, and
// positions at or past length are never read. Split-KV and TMA loads are
// later work.
#include "decode_core.cuh"

namespace {

using acar::decode::kMaxD;
using acar::decode::kMaxG;
using acar::decode::kThreads;

template <typename T>
struct CacheLoader {
  const T* k;  // this (row, kv head)'s position 0
  const T* v;
  int stride;  // elements between consecutive positions (KV * D)
  __device__ __forceinline__ void load(int pos, int d, float& kf,
                                       float& vf) const {
    const size_t off = (size_t)pos * stride + d;
    kf = acar::to_f32(k[off]);
    vf = acar::to_f32(v[off]);
  }
  __device__ __forceinline__ void scales(int, float& ks, float& vs) const {
    ks = 1.f;
    vs = 1.f;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k_cache,
                  const T* __restrict__ v_cache, T* __restrict__ out, int S,
                  int KV, int G, int D, int length, float scale) {
  __shared__ acar::decode::Smem sm;
  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const size_t row = ((size_t)b * S * KV + kv) * D;
  const CacheLoader<T> ld{k_cache + row, v_cache + row, KV * D};
  const size_t head0 = ((size_t)b * KV * G + kv * G) * D;
  acar::decode::attend(sm, q + head0, out + head0, G, D, length, scale, ld);
}

}  // namespace

extern "C" int acar_decode_attention(const void* q, const void* k_cache,
                                     const void* v_cache, void* out, int B,
                                     int H, int KV, int D, int S, int length,
                                     int dtype, void* stream) {
  const int G = H / KV;
  if (G > kMaxG || D > kMaxD || H % KV != 0 || length < 0 || length > S)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(B, KV);
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == acar::kBF16) {
    using T = __nv_bfloat16;
    decode_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_cache),
        static_cast<const T*>(v_cache), static_cast<T*>(out), S, KV, G, D,
        length, scale);
  } else {
    decode_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_cache),
        static_cast<const float*>(v_cache), static_cast<float*>(out), S, KV,
        G, D, length, scale);
  }
  return (int)cudaGetLastError();
}
