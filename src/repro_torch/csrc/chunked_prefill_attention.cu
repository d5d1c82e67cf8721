// Paged chunked-prefill GQA attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/chunked_prefill_attention.py::chunked_prefill_attention
// (the Pallas TPU kernel: grid (B, KV, ceil(prompt_len / page)), one page per
// grid step, online softmax per (chunk position, group head) in VMEM).
//
// Computes, for every row b, chunk position c and query head h = kv * G + g:
//   out[b, c, h] = softmax_s(q[b, c, h] . k[s] / sqrt(D)) @ v[s]
// over key positions s <= q_positions[b, c] (causal), with the keys read from
// the pages k_pages/v_pages (P, page_size, KV, D) through block_table (B, NB).
// The chunk's own K/V is already in the pages when the kernel runs.
//
// What bounds it on the H100: at serving shapes (chunks of 8..32 tokens over a
// prompt of about a hundred) neither bytes nor flops: the call reads a few
// hundred kilobytes and does a few tens of megaflops, so launch latency and
// the per-tile barriers dominate. At long prompts it becomes bound by the
// K/V bytes it streams, which each CTA reads once for its C*G query rows.
//
// Design: one CTA per (row, kv head, block of kQB query rows); a query row is
// one (chunk position, group head) pair, so the K/V tile a CTA loads serves
// every query head of its kv head. The CTA walks key positions in tiles of
// kTile up to min(prompt_len, largest query position of its rows + 1): the
// static prompt length bounds the page walk (never the block table's width),
// and no key past the last query position can be attended. Each query row
// masks its own keys with key_pos <= q_positions[b, c]; a masked key adds
// nothing, so stale bytes in recycled pages never reach the sum. The online
// softmax (m, l, acc) lives in shared memory in float32, the sum over keys
// runs in a fixed order with no atomics, and it finishes with
// acc / max(l, 1e-30) as the Pallas kernel does. Query-tile wgmma and TMA
// page streaming are later work.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // key positions per iteration
constexpr int kQB = 32;    // query rows (chunk position x group head) per CTA
constexpr int kMaxD = 128;

size_t smem_bytes(int D) {
  return sizeof(float) *
             ((size_t)2 * kQB * D + (size_t)2 * kTile * (D + 1) +
              (size_t)kQB * kTile + 3 * kQB) +
         sizeof(int) * kQB;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chunked_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ q_positions, T* __restrict__ out, int C, int KV,
    int G, int D, int page_size, int NB, int prompt_len, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // kQB x D
  float* ks = qs + kQB * D;               // kTile x (D + 1)
  float* vs = ks + kTile * (D + 1);       // kTile x (D + 1)
  float* ps = vs + kTile * (D + 1);       // kQB x kTile
  float* acc = ps + kQB * kTile;          // kQB x D
  float* m_run = acc + kQB * D;           // kQB
  float* l_run = m_run + kQB;             // kQB
  float* alpha_s = l_run + kQB;           // kQB
  int* qpos_s = reinterpret_cast<int*>(alpha_s + kQB);  // kQB
  __shared__ int key_end_s;

  const int b = blockIdx.x;
  const int kv = blockIdx.y;
  const int r0 = blockIdx.z * kQB;
  const int tid = threadIdx.x;
  const int H = KV * G;
  const int nq = min(kQB, C * G - r0);

  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int c = (r0 + r) / G, g = (r0 + r) % G;
    qs[r * D + d] =
        acar::to_f32(q[(((size_t)b * C + c) * H + kv * G + g) * D + d]) *
        scale;
    acc[r * D + d] = 0.f;
  }
  if (tid < nq) {
    qpos_s[tid] = q_positions[(size_t)b * C + (r0 + tid) / G];
    m_run[tid] = -INFINITY;
    l_run[tid] = 0.f;
  }
  __syncthreads();
  if (tid == 0) {
    int last = -1;
    for (int r = 0; r < nq; ++r) last = max(last, qpos_s[r]);
    key_end_s = min(prompt_len, min(last + 1, NB * page_size));
  }
  __syncthreads();
  const int key_end = key_end_s;

  const int* bt = block_table + (size_t)b * NB;
  for (int t0 = 0; t0 < key_end; t0 += kTile) {
    const int nk = min(kTile, key_end - t0);
    for (int i = tid; i < nk * D; i += kThreads) {
      const int s = i / D, d = i % D;
      const int pos = t0 + s;
      const size_t page = (size_t)bt[pos / page_size];
      const size_t off =
          ((page * page_size + pos % page_size) * KV + kv) * D + d;
      ks[s * (D + 1) + d] = acar::to_f32(k_pages[off]);
      vs[s * (D + 1) + d] = acar::to_f32(v_pages[off]);
    }
    __syncthreads();

    for (int i = tid; i < nq * kTile; i += kThreads) {
      const int r = i / kTile, s = i % kTile;
      float sc = -INFINITY;
      if (s < nk && t0 + s <= qpos_s[r]) {
        const float* qr = qs + r * D;
        const float* kr = ks + s * (D + 1);
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(qr[d], kr[d], a);
        sc = a;
      }
      ps[r * kTile + s] = sc;
    }
    __syncthreads();

    if (tid < nq) {
      const int r = tid;
      float* pr = ps + r * kTile;
      float mt = -INFINITY;
      for (int s = 0; s < nk; ++s) mt = fmaxf(mt, pr[s]);
      const float m_old = m_run[r];
      const float m_new = fmaxf(m_old, mt);
      const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
      float lsum = 0.f;
      for (int s = 0; s < nk; ++s) {
        const float p = (pr[s] == -INFINITY) ? 0.f : expf(pr[s] - m_new);
        pr[s] = p;
        lsum += p;
      }
      l_run[r] = l_run[r] * alpha + lsum;
      m_run[r] = m_new;
      alpha_s[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < nq * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const float* pr = ps + r * kTile;
      float a = acc[i] * alpha_s[r];
      for (int s = 0; s < nk; ++s) {
        if (pr[s] != 0.f) a = fmaf(pr[s], vs[s * (D + 1) + d], a);
      }
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int c = (r0 + r) / G, g = (r0 + r) % G;
    const float l = fmaxf(l_run[r], 1e-30f);
    out[(((size_t)b * C + c) * H + kv * G + g) * D + d] =
        acar::from_f32<T>(acc[i] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* q_positions, void* out,
                   int B, int C, int H, int KV, int D, int page_size, int NB,
                   int prompt_len, cudaStream_t st) {
  const int G = H / KV;
  const size_t smem = smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunked_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, KV, (C * G + kQB - 1) / kQB);
  chunked_prefill_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(q_positions), static_cast<T*>(out), C, KV, G, D,
      page_size, NB, prompt_len, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

extern "C" int acar_chunked_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* q_positions, void* out, int B, int C,
    int H, int KV, int D, int page_size, int NB, int prompt_len, int dtype,
    void* stream) {
  if (D > kMaxD || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == acar::kBF16) {
    return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, block_table,
                                      q_positions, out, B, C, H, KV, D,
                                      page_size, NB, prompt_len, st);
  }
  return (int)launch<float>(q, k_pages, v_pages, block_table, q_positions,
                            out, B, C, H, KV, D, page_size, NB, prompt_len,
                            st);
}
