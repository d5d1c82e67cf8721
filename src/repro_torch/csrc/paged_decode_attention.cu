// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode_attention.py::paged_decode_attention
// (the Pallas TPU kernel: grid (B, KV, NB), one page per grid step, online
// softmax in VMEM scratch).
//
// Computes, for every row b and query head h = kv * G + g:
//   out[b, h] = softmax_s(q[b, h] . k[s] / sqrt(D)) @ v[s]
// over the key positions s < lengths[b] of the row, whose K/V live in pages
// k_pages/v_pages (P, page_size, KV, D) addressed through block_table (B, NB).
//
// What bounds it on the H100: bytes. One decode token reads every cached key
// and value of its row once and does 4*D flops per key and query head, far
// below the card's ~295 flop/byte ridge. At serving shapes (a few dozen rows,
// a hundred-odd positions) the whole call moves well under a megabyte, so in
// practice launch latency and the per-tile barriers dominate.
//
// Design: one CTA per (row, kv head) carries all G query heads, so each K/V
// element is read from device memory once and used G times. The CTA walks
// the row's positions in tiles of kTile keys, translating each position to
// (page id, slot) through the block table itself: only positions below
// lengths[b] are ever loaded, so spare block-table slots and stale bytes past
// the row's length are never read. The online-softmax state (m, l, acc) stays
// in shared memory in float32 across tiles; the sum over keys runs in a fixed
// order with no atomics and no split across CTAs, so the result does not
// depend on the batch. It finishes with acc / max(l, 1e-30) as the Pallas
// kernel does. Split-KV, TMA page loads and wgmma are later work.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // key positions per iteration
constexpr int kMaxD = 128;
constexpr int kMaxG = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ block_table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int KV, int G, int D, int page_size, int NB,
                        float scale) {
  __shared__ float qs[kMaxG][kMaxD];
  __shared__ float ks[kTile][kMaxD + 1];
  __shared__ float vs[kTile][kMaxD + 1];
  __shared__ float ps[kMaxG][kTile];
  __shared__ float acc[kMaxG][kMaxD];
  __shared__ float m_run[kMaxG];
  __shared__ float l_run[kMaxG];
  __shared__ float alpha_s[kMaxG];

  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int tid = threadIdx.x;
  const int H = KV * G;

  int len = lengths[b];
  if (len > NB * page_size) len = NB * page_size;

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    qs[g][d] = acar::to_f32(q[((size_t)b * H + kv * G + g) * D + d]) * scale;
    acc[g][d] = 0.f;
  }
  if (tid < G) {
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  __syncthreads();

  const int* bt = block_table + (size_t)b * NB;
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int nk = min(kTile, len - t0);
    // K/V tile: positions [t0, t0 + nk), each through its page id
    for (int i = tid; i < nk * D; i += kThreads) {
      const int s = i / D, d = i % D;
      const int pos = t0 + s;
      const size_t page = (size_t)bt[pos / page_size];
      const size_t off =
          ((page * page_size + pos % page_size) * KV + kv) * D + d;
      ks[s][d] = acar::to_f32(k_pages[off]);
      vs[s][d] = acar::to_f32(v_pages[off]);
    }
    __syncthreads();

    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, s = i % kTile;
      float sc = -INFINITY;
      if (s < nk) {
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qs[g][d], ks[s][d], a);
        sc = a;
      }
      ps[g][s] = sc;
    }
    __syncthreads();

    if (tid < G) {
      const int g = tid;
      float mt = -INFINITY;
      for (int s = 0; s < nk; ++s) mt = fmaxf(mt, ps[g][s]);
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, mt);
      const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
      float lsum = 0.f;
      for (int s = 0; s < nk; ++s) {
        const float p = expf(ps[g][s] - m_new);
        ps[g][s] = p;
        lsum += p;
      }
      l_run[g] = l_run[g] * alpha + lsum;
      m_run[g] = m_new;
      alpha_s[g] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float a = acc[g][d] * alpha_s[g];
      for (int s = 0; s < nk; ++s) a = fmaf(ps[g][s], vs[s][d], a);
      acc[g][d] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float l = fmaxf(l_run[g], 1e-30f);
    out[((size_t)b * H + kv * G + g) * D + d] =
        acar::from_f32<T>(acc[g][d] / l);
  }
}

}  // namespace

extern "C" int acar_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, void* out, int B, int H,
    int KV, int D, int page_size, int NB, int dtype, void* stream) {
  const int G = H / KV;
  if (G > kMaxG || D > kMaxD || H % KV != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, KV);
  const float scale = 1.0f / sqrtf((float)D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == acar::kBF16) {
    using T = __nv_bfloat16;
    paged_decode_kernel<T><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), static_cast<const int*>(block_table),
        static_cast<const int*>(lengths), static_cast<T*>(out), KV, G, D,
        page_size, NB, scale);
  } else {
    paged_decode_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages),
        static_cast<const int*>(block_table), static_cast<const int*>(lengths),
        static_cast<float*>(out), KV, G, D, page_size, NB, scale);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* acar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
