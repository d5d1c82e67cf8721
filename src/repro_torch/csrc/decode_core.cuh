// The single-token GQA decode loop shared by the int8-cache and int8-page
// decode kernels (decode_attention_quant.cu,
// paged_decode_attention_quant.cu). The bf16/f32 paged and dense-cache
// decodes run the split-KV cluster loop of decode_split.cuh instead.
//
// One CTA serves one (row, kv head) and carries all G query heads of that
// kv head, so each cached key and value is read from device memory once and
// used G times. The CTA walks the valid positions [0, len) in tiles of
// kTile keys: positions at or past len are never loaded. A Loader maps a
// position to its key and value (widened to float32) and to its two scales:
//
//   scores_s = (q . k_s) * k_scale_s
//   out      = sum_s (p_s * v_scale_s) * v_s / sum_s p_s
//
// which is the folded-scale int8 attention of the reference's
// decode_attention_quant (a Loader with both scales 1 would give plain
// attention: x * 1.0f is exact). The online-softmax state (m, l,
// acc) stays in shared memory in float32; the key sum runs in one fixed
// order with no atomics and no split across CTAs, so a row's result does
// not depend on the batch. It finishes with acc / max(l, 1e-30), as the
// Pallas kernels do.
#pragma once

#include "common.cuh"

#include <math.h>

namespace acar {
namespace decode {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // key positions per iteration
constexpr int kMaxD = 128;
constexpr int kMaxG = 8;

struct Smem {
  float qs[kMaxG][kMaxD];
  float ks[kTile][kMaxD + 1];
  float vs[kTile][kMaxD + 1];
  float k_scale[kTile];
  float v_scale[kTile];
  float ps[kMaxG][kTile];
  float acc[kMaxG][kMaxD];
  float m_run[kMaxG];
  float l_run[kMaxG];
  float alpha[kMaxG];
};

// q and out point at the G query heads of this (row, kv head): G*D values.
// Loader: load(pos, d, &k, &v) and scales(pos, &k_scale, &v_scale).
template <typename TQ, typename Loader>
__device__ __forceinline__ void attend(Smem& sm, const TQ* __restrict__ q,
                                       TQ* __restrict__ out, int G, int D,
                                       int len, float scale,
                                       const Loader& ld) {
  const int tid = threadIdx.x;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    sm.qs[g][d] = to_f32(q[g * D + d]) * scale;
    sm.acc[g][d] = 0.f;
  }
  if (tid < G) {
    sm.m_run[tid] = -INFINITY;
    sm.l_run[tid] = 0.f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int nk = min(kTile, len - t0);
    for (int i = tid; i < nk * D; i += kThreads) {
      const int s = i / D, d = i % D;
      ld.load(t0 + s, d, sm.ks[s][d], sm.vs[s][d]);
    }
    if (tid < nk) ld.scales(t0 + tid, sm.k_scale[tid], sm.v_scale[tid]);
    __syncthreads();

    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, s = i % kTile;
      float sc = -INFINITY;
      if (s < nk) {
        float a = 0.f;
        for (int d = 0; d < D; ++d) a = fmaf(sm.qs[g][d], sm.ks[s][d], a);
        sc = a * sm.k_scale[s];
      }
      sm.ps[g][s] = sc;
    }
    __syncthreads();

    if (tid < G) {
      const int g = tid;
      float mt = -INFINITY;
      for (int s = 0; s < nk; ++s) mt = fmaxf(mt, sm.ps[g][s]);
      const float m_old = sm.m_run[g];
      const float m_new = fmaxf(m_old, mt);
      const float alpha = (m_old == -INFINITY) ? 0.f : expf(m_old - m_new);
      float lsum = 0.f;
      for (int s = 0; s < nk; ++s) {
        const float p = expf(sm.ps[g][s] - m_new);
        lsum += p;
        sm.ps[g][s] = p * sm.v_scale[s];  // v scale folded into p
      }
      sm.l_run[g] = sm.l_run[g] * alpha + lsum;
      sm.m_run[g] = m_new;
      sm.alpha[g] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float a = sm.acc[g][d] * sm.alpha[g];
      for (int s = 0; s < nk; ++s) a = fmaf(sm.ps[g][s], sm.vs[s][d], a);
      sm.acc[g][d] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float l = fmaxf(sm.l_run[g], 1e-30f);
    out[g * D + d] = from_f32<TQ>(sm.acc[g][d] / l);
  }
}

}  // namespace decode
}  // namespace acar
