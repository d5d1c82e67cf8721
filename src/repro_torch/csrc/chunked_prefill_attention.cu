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
// hundred kilobytes and does a few tens of megaflops (under a microsecond
// either way), so latency bounds it: the launch, the dependent steps of each
// key tile, the page loads. At long prompts it becomes bound by the K/V
// bytes it streams, which each CTA reads once for its query rows.
//
// bf16 design: a query row is one (chunk position, group head) pair, row
// r = c * G + g of its (b, kv head), so one K/V tile serves every query head
// of a kv head. Each warp owns a fixed 16 rows, a CTA four warps (64 rows):
// grid (B, KV, ceil(C*G / 64)). mma.sync.m16n8k16 computes q.k^T and p.v in
// bf16 with f32 accumulators; the online softmax (m, l, the 16 x D output)
// stays in registers, one row's state in the four lanes of a quad, its
// maxima and sums reduced by quad shuffles. The CTA walks key tiles of
// kTile = 32 positions from position 0 up to the last position any of its
// rows may attend; each tile's K and V rows (one (position, kv head) row of
// d 64 is 128 contiguous bytes of a page) come in by 16-byte cp.async,
// double-buffered, and positions past that end are filled with zeros. A
// warp skips the tiles past its own rows' last position. p is rounded to
// bf16 for the p.v product (its f32 value feeds l), as flash attention does.
// Why mma.sync and not wgmma/TMA: a serving call is 96 query rows of a kv
// head against at most 97 keys at d 64, gathered 8 positions a page
// through the block table. wgmma's 64-row tiles would leave most of a
// warpgroup idle, and TMA's regular boxes cannot follow the page gather:
// neither shortens a call this small.
//
// Invariance: a key masked for a row (s > q_positions[b, c]) gets p = 0
// exactly, its tile leaves m unchanged (alpha exactly 1) and adds exactly 0
// to l and the output, so a row's bits do not depend on C, on which rows
// share its warp, or on how far the other rows reach. The tile size is a
// constant; no split-KV, no atomics, one fixed order per row. It finishes
// with acc / max(l, 1e-30) as the Pallas kernel does. Built for head_dim
// 64 (smollm-135m) and 128 (llama3-8b, deepseek-7b) from one template: the
// d-128 instance keeps the tiling, 16-row warp tiles and 32 keys a stage,
// with twice the registers for q and the f32 accumulator and 34,816 bytes
// of staged K/V (the wrapper raises for another head_dim).
//
// float32 (the reduced f32 models only; TF32 is off, so f32 operands never
// go through the tensor cores): the first version's CUDA-core kernel,
// unchanged bit for bit. One CTA per (row, kv head, block of kQB query
// rows) walks key tiles of kTile up to min(prompt_len, largest query
// position of its rows + 1); the online softmax (m, l, acc) lives in shared
// memory in float32, the sum over keys runs in a fixed order with no
// atomics.
#include "common.cuh"
#include "hopper.cuh"

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

// ---------------------------------------------------------------------
// bf16: mma.sync kernel
// ---------------------------------------------------------------------
namespace hp = acar::hopper;
using bf16 = __nv_bfloat16;

constexpr int kMmaWarps = 4;
constexpr int kMmaRows = 16 * kMmaWarps;  // query rows per CTA
constexpr int kKT = 32;                   // key positions per tile

template <int kD>
__global__ void __launch_bounds__(32 * kMmaWarps) chunked_prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ q_positions, bf16* __restrict__ out, int C,
    int KV, int G, int page_size, int NB, int prompt_len, float scale) {
  // K and V rows padded by 16 bytes: ldmatrix's 8 row addresses of a phase
  // then fall in distinct banks, and every row stays 16-byte aligned
  constexpr int kStride = kD + 8;
  __shared__ __align__(16) bf16 ks[2][kKT][kStride];
  __shared__ __align__(16) bf16 vs[2][kKT][kStride];
  __shared__ int warp_end_s[kMmaWarps];

  const int b = blockIdx.x, kv = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;  // mma group and thread in group
  const int H = KV * G, R = C * G;
  const int row0 = blockIdx.z * kMmaRows + warp * 16;

  // lane l < 16 reads the position of the warp's row l (-1: past C*G)
  int my_pos = -1;
  if (lane < 16 && row0 + lane < R)
    my_pos = q_positions[(size_t)b * C + (row0 + lane) / G];
  int wmax = my_pos;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
  // this thread's rows gq and gq + 8; a row past C*G attends key 0 only,
  // so its softmax stays finite, and is never stored
  const int pos_a = __shfl_sync(0xffffffffu, my_pos, gq);
  const int pos_b = __shfl_sync(0xffffffffu, my_pos, gq + 8);
  const int qp[2] = {max(pos_a, 0), max(pos_b, 0)};
  const int wend = min(prompt_len, min(wmax + 1, NB * page_size));
  if (lane == 0) warp_end_s[warp] = wend;

  uint32_t qf[kD / 16][4];
  const int ra = row0 + gq, rb = ra + 8;
  const bf16* qa = q + (((size_t)b * C + ra / G) * H + kv * G + ra % G) * kD;
  const bf16* qb = q + (((size_t)b * C + rb / G) * H + kv * G + rb % G) * kD;
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int d = 16 * kk + 2 * tq;
    qf[kk][0] = pos_a >= 0 ? *reinterpret_cast<const uint32_t*>(qa + d) : 0u;
    qf[kk][1] = pos_b >= 0 ? *reinterpret_cast<const uint32_t*>(qb + d) : 0u;
    qf[kk][2] =
        pos_a >= 0 ? *reinterpret_cast<const uint32_t*>(qa + d + 8) : 0u;
    qf[kk][3] =
        pos_b >= 0 ? *reinterpret_cast<const uint32_t*>(qb + d + 8) : 0u;
  }
  __syncthreads();
  int cta_end = 0;
#pragma unroll
  for (int w = 0; w < kMmaWarps; ++w) cta_end = max(cta_end, warp_end_s[w]);

  float o[kD / 8][4];
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};

  const int* bt = block_table + (size_t)b * NB;
  // one tile of K and V rows into buffer `buf`; positions at or past
  // cta_end are zero-filled (never read from a page)
  auto load_tile = [&](int tile, int buf) {
    constexpr int kChunks = kD / 8;  // 16-byte chunks per key row
    for (int i = threadIdx.x; i < kKT * kChunks; i += 32 * kMmaWarps) {
      const int s = i / kChunks, c = i % kChunks;
      const int pos = tile * kKT + s;
      const bool valid = pos < cta_end;
      size_t off = 0;
      if (valid) {
        const size_t page = (size_t)bt[pos / page_size];
        off = ((page * page_size + pos % page_size) * KV + kv) * kD + c * 8;
      }
      hp::cp_async16(&ks[buf][s][c * 8], k_pages + off, valid ? 16u : 0u);
      hp::cp_async16(&vs[buf][s][c * 8], v_pages + off, valid ? 16u : 0u);
    }
    hp::cp_async_commit();
  };

  // ldmatrix row addresses: lane gives row lane%8 of matrix lane/8
  const int mi = lane / 8, ri = lane % 8;
  const int n_tiles = (cta_end + kKT - 1) / kKT;
  if (n_tiles > 0) load_tile(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(it + 1, buf ^ 1);
      hp::cp_async_wait<1>();
    } else {
      hp::cp_async_wait<0>();
    }
    __syncthreads();
    const int t0 = it * kKT;
    if (t0 < wend) {
      // s = q . k^T: 16 rows x kKT keys, f32
      float sc[kKT / 8][4];
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j)
        sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
        for (int jp = 0; jp < kKT / 16; ++jp) {
          uint32_t kf[4];
          hp::ldmatrix_x4(kf, &ks[buf][16 * jp + 8 * (mi >> 1) + ri]
                                 [16 * kk + 8 * (mi & 1)]);
          hp::mma_bf16_16816(sc[2 * jp], qf[kk], kf);
          hp::mma_bf16_16816(sc[2 * jp + 1], qf[kk], kf + 2);
        }
      }
      // scale, mask (key position <= query position), row maxima
      float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = t0 + 8 * j + 2 * tq + (e & 1);
          const bool ok = kp <= qp[e >> 1] && kp < prompt_len;
          sc[j][e] = ok ? sc[j][e] * scale : -INFINITY;
          mt[e >> 1] = fmaxf(mt[e >> 1], sc[j][e]);
        }
      }
      float alpha[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        mt[x] = fmaxf(mt[x], __shfl_xor_sync(0xffffffffu, mt[x], 1));
        mt[x] = fmaxf(mt[x], __shfl_xor_sync(0xffffffffu, mt[x], 2));
        const float m_new = fmaxf(m[x], mt[x]);
        alpha[x] = (m[x] == -INFINITY) ? 0.f : expf(m[x] - m_new);
        m[x] = m_new;
      }
      // p in f32 for l; rounded to bf16 for p . v
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              sc[j][e] == -INFINITY ? 0.f : expf(sc[j][e] - m[e >> 1]);
          sc[j][e] = p;
          ls[e >> 1] += p;
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) l[x] = l[x] * alpha[x] + ls[x];
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[j][0] *= alpha[0];
        o[j][1] *= alpha[0];
        o[j][2] *= alpha[1];
        o[j][3] *= alpha[1];
      }
#pragma unroll
      for (int k2 = 0; k2 < kKT / 16; ++k2) {
        const uint32_t pa[4] = {
            hp::pack_bf16x2(sc[2 * k2][0], sc[2 * k2][1]),
            hp::pack_bf16x2(sc[2 * k2][2], sc[2 * k2][3]),
            hp::pack_bf16x2(sc[2 * k2 + 1][0], sc[2 * k2 + 1][1]),
            hp::pack_bf16x2(sc[2 * k2 + 1][2], sc[2 * k2 + 1][3])};
#pragma unroll
        for (int jp = 0; jp < kD / 16; ++jp) {
          uint32_t vf[4];
          hp::ldmatrix_x4_trans(vf, &vs[buf][16 * k2 + 8 * (mi & 1) + ri]
                                       [16 * jp + 8 * (mi >> 1)]);
          hp::mma_bf16_16816(o[2 * jp], pa, vf);
          hp::mma_bf16_16816(o[2 * jp + 1], pa, vf + 2);
        }
      }
    }
    __syncthreads();
  }

  // l over the quad's columns, in one order for every lane
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 1);
    l[x] += __shfl_xor_sync(0xffffffffu, l[x], 2);
    l[x] = fmaxf(l[x], 1e-30f);
  }
  bf16* oa = out + (((size_t)b * C + ra / G) * H + kv * G + ra % G) * kD;
  bf16* ob = out + (((size_t)b * C + rb / G) * H + kv * G + rb % G) * kD;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int d = 8 * j + 2 * tq;
    if (pos_a >= 0)
      *reinterpret_cast<uint32_t*>(oa + d) =
          hp::pack_bf16x2(o[j][0] / l[0], o[j][1] / l[0]);
    if (pos_b >= 0)
      *reinterpret_cast<uint32_t*>(ob + d) =
          hp::pack_bf16x2(o[j][2] / l[1], o[j][3] / l[1]);
  }
}

template <int kD>
cudaError_t launch_mma(const void* q, const void* k_pages,
                       const void* v_pages, const void* block_table,
                       const void* q_positions, void* out, int B, int C,
                       int H, int KV, int page_size, int NB, int prompt_len,
                       cudaStream_t st) {
  const int G = H / KV;
  const dim3 grid(B, KV, (C * G + kMmaRows - 1) / kMmaRows);
  chunked_prefill_mma_kernel<kD><<<grid, 32 * kMmaWarps, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(q_positions), static_cast<bf16*>(out), C, KV, G,
      page_size, NB, prompt_len, 1.0f / sqrtf((float)kD));
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
    // head_dim 128 keeps the d-64 tiling (16-row warp tiles, 32 keys a
    // stage): its f32 accumulator doubles to 64 registers a thread and
    // its two staged K/V tiles take 34,816 bytes of shared memory
    if (D == 64)
      return (int)launch_mma<64>(q, k_pages, v_pages, block_table,
                                 q_positions, out, B, C, H, KV, page_size,
                                 NB, prompt_len, st);
    if (D == 128)
      return (int)launch_mma<128>(q, k_pages, v_pages, block_table,
                                  q_positions, out, B, C, H, KV, page_size,
                                  NB, prompt_len, st);
    return (int)cudaErrorInvalidValue;
  }
  return (int)launch<float>(q, k_pages, v_pages, block_table, q_positions,
                            out, B, C, H, KV, D, page_size, NB, prompt_len,
                            st);
}
