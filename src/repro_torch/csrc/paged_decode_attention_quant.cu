// Paged GQA decode attention over int8-quantised KV pages, for Hopper
// (sm_90a).
//
// Replaces:
// src/repro/kernels/paged_decode_attention_quant.py::paged_decode_attention_quant
// (the Pallas TPU kernel: grid (B, KV, NB), one page per grid step through
// the scalar-prefetched block table, int8 pages widened on the VPU, scales
// folded into the scores and the probabilities).
//
// Computes, for every row b and query head h = kv * G + g, over the
// positions s < lengths[b] of the row, whose int8 codes live in pages
// k_pages/v_pages (P, page_size, KV, D) and whose float32 per-vector scales
// live in k_scale_pages/v_scale_pages (P, page_size, KV), all addressed
// through block_table (B, NB):
//   scores_s = (q[b, h] / sqrt(D) . k_s) * k_scale_s
//   out[b, h] = sum_s (softmax(scores)_s * v_scale_s) * v_s
//
// What bounds it on the H100: bytes — D + 4 bytes per cached vector and
// head, about half the bf16 pages' 2 * D, far below the flop ridge.
//
// Design: decode_core.cuh's loop (one CTA per (row, kv head) carrying all G
// query heads, 32-key tiles, float32 online softmax, fixed order, no
// atomics). Each position is translated to (page id, slot) through the
// block table inside the loader, and only positions below lengths[b] are
// loaded: spare block-table slots hold valid page ids whose bytes are stale,
// and they are never read. The codes widen to float32 in registers; device
// memory sees only codes and scales.
#include "decode_core.cuh"

#include <stdint.h>

namespace {

using acar::decode::kMaxD;
using acar::decode::kMaxG;
using acar::decode::kThreads;

struct QuantPageLoader {
  const int8_t* k_pages;
  const int8_t* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* table;  // this row's block table
  int kv;
  int KV;
  int D;
  int page_size;
  __device__ __forceinline__ size_t vec(int pos) const {
    const size_t page = (size_t)table[pos / page_size];
    return (page * page_size + pos % page_size) * KV + kv;
  }
  __device__ __forceinline__ void load(int pos, int d, float& kf,
                                       float& vf) const {
    const size_t off = vec(pos) * D + d;
    kf = (float)k_pages[off];
    vf = (float)v_pages[off];
  }
  __device__ __forceinline__ void scales(int pos, float& ks,
                                         float& vs) const {
    const size_t off = vec(pos);
    ks = k_scale[off];
    vs = v_scale[off];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_quant_kernel(
    const T* __restrict__ q, const int8_t* __restrict__ k_pages,
    const float* __restrict__ k_scale, const int8_t* __restrict__ v_pages,
    const float* __restrict__ v_scale, const int* __restrict__ block_table,
    const int* __restrict__ lengths, T* __restrict__ out, int KV, int G,
    int D, int page_size, int NB, float scale) {
  __shared__ acar::decode::Smem sm;
  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  int len = lengths[b];
  if (len > NB * page_size) len = NB * page_size;
  const QuantPageLoader ld{k_pages, v_pages, k_scale, v_scale,
                           block_table + (size_t)b * NB,
                           kv, KV, D, page_size};
  const size_t head0 = ((size_t)b * KV * G + kv * G) * D;
  acar::decode::attend(sm, q + head0, out + head0, G, D, len, scale, ld);
}

}  // namespace

extern "C" int acar_paged_decode_attention_quant(
    const void* q, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* block_table,
    const void* lengths, void* out, int B, int H, int KV, int D,
    int page_size, int NB, int dtype, void* stream) {
  const int G = H / KV;
  if (G > kMaxG || D > kMaxD || H % KV != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, KV);
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* kp = static_cast<const int8_t*>(k_pages);
  const int8_t* vp = static_cast<const int8_t*>(v_pages);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* bt = static_cast<const int*>(block_table);
  const int* ln = static_cast<const int*>(lengths);
  if (dtype == acar::kBF16) {
    using T = __nv_bfloat16;
    paged_decode_quant_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(q), kp, ks, vp, vs, bt, ln,
        static_cast<T*>(out), KV, G, D, page_size, NB, scale);
  } else {
    paged_decode_quant_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), kp, ks, vp, vs, bt, ln,
        static_cast<float*>(out), KV, G, D, page_size, NB, scale);
  }
  return (int)cudaGetLastError();
}
