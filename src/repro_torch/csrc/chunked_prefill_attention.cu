// Paged chunked-prefill GQA attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/chunked_prefill_attention.py::chunked_prefill_attention
// (the Pallas TPU kernel: grid (B, KV, ceil(prompt_len / page)), one page per
// grid step, online softmax per (chunk position, group head) in VMEM).
//
// Computes, for every row b, chunk position c and query head h = kv * G + g:
//   out[b, c, h] = softmax_s(q[b, c, h] . k[s] / sqrt(Dk)) @ v[s]
// over key positions s <= q_positions[b, c] (causal), with the keys read from
// the pages k_pages (P, page_size, KV, Dk) and v_pages (P, page_size, KV, Dv)
// through block_table (B, NB); q has Dk elements a head, out Dv. The chunk's
// own K/V is already in the pages when the kernel runs.
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
// with acc / max(l, 1e-30) as the Pallas kernel does.
//
// Head widths: Dk and Dv multiples of 8 up to 256, equal or not, from one
// template in three families by the wider of the two: up to 64 (smollm-135m),
// up to 128 (llama3-8b, deepseek-7b) and up to 256 (recurrentgemma-2b). Each
// keeps the tiling (16-row warp tiles, 32 keys a stage); a width below its
// family's runs the same mma sequence over the 16-column steps it has, its
// ragged last step reading zeros past the width (cp.async's zero fill, zero
// q fragments), which add exact zero products, so a width's bits are those
// of a family of its own size. Up to 128, q's fragments live in registers
// (the 128 family: 64 f32 accumulator registers a thread, 34,816 bytes of
// staged K/V); at 256 the accumulator takes 128 registers, so q stays in
// shared memory and each step reads its fragment by ldmatrix (101,376 bytes
// of dynamic shared memory).
//
// float32 (the reduced f32 models only; TF32 is off, so f32 operands never
// go through the tensor cores): the first version's CUDA-core kernel, any
// Dk and Dv up to 256, unchanged bit for bit where Dk = Dv. One CTA per
// (row, kv head, block of kQB query rows) walks key tiles of kTile up to
// min(prompt_len, largest query position of its rows + 1); the online
// softmax (m, l, acc) lives in shared memory in float32, the sum over keys
// runs in a fixed order with no atomics.
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;  // key positions per iteration
constexpr int kQB = 32;    // query rows (chunk position x group head) per CTA
constexpr int kMaxD = 256;

size_t smem_bytes(int Dk, int Dv) {
  return sizeof(float) *
             ((size_t)kQB * (Dk + Dv) + (size_t)kTile * (Dk + Dv + 2) +
              (size_t)kQB * kTile + 3 * kQB) +
         sizeof(int) * kQB;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) chunked_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ q_positions, T* __restrict__ out, int C, int KV,
    int G, int Dk, int Dv, int page_size, int NB, int prompt_len,
    float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // kQB x Dk
  float* ks = qs + kQB * Dk;              // kTile x (Dk + 1)
  float* vs = ks + kTile * (Dk + 1);      // kTile x (Dv + 1)
  float* ps = vs + kTile * (Dv + 1);      // kQB x kTile
  float* acc = ps + kQB * kTile;          // kQB x Dv
  float* m_run = acc + kQB * Dv;          // kQB
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

  for (int i = tid; i < nq * Dk; i += kThreads) {
    const int r = i / Dk, d = i % Dk;
    const int c = (r0 + r) / G, g = (r0 + r) % G;
    qs[r * Dk + d] =
        acar::to_f32(q[(((size_t)b * C + c) * H + kv * G + g) * Dk + d]) *
        scale;
  }
  for (int i = tid; i < nq * Dv; i += kThreads) acc[i] = 0.f;
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
    for (int i = tid; i < nk * Dk; i += kThreads) {
      const int s = i / Dk, d = i % Dk;
      const int pos = t0 + s;
      const size_t page = (size_t)bt[pos / page_size];
      const size_t slot = (page * page_size + pos % page_size) * KV + kv;
      ks[s * (Dk + 1) + d] = acar::to_f32(k_pages[slot * Dk + d]);
    }
    for (int i = tid; i < nk * Dv; i += kThreads) {
      const int s = i / Dv, d = i % Dv;
      const int pos = t0 + s;
      const size_t page = (size_t)bt[pos / page_size];
      const size_t slot = (page * page_size + pos % page_size) * KV + kv;
      vs[s * (Dv + 1) + d] = acar::to_f32(v_pages[slot * Dv + d]);
    }
    __syncthreads();

    for (int i = tid; i < nq * kTile; i += kThreads) {
      const int r = i / kTile, s = i % kTile;
      float sc = -INFINITY;
      if (s < nk && t0 + s <= qpos_s[r]) {
        const float* qr = qs + r * Dk;
        const float* kr = ks + s * (Dk + 1);
        float a = 0.f;
        for (int d = 0; d < Dk; ++d) a = fmaf(qr[d], kr[d], a);
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

    for (int i = tid; i < nq * Dv; i += kThreads) {
      const int r = i / Dv, d = i % Dv;
      const float* pr = ps + r * kTile;
      float a = acc[i] * alpha_s[r];
      for (int s = 0; s < nk; ++s) {
        if (pr[s] != 0.f) a = fmaf(pr[s], vs[s * (Dv + 1) + d], a);
      }
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < nq * Dv; i += kThreads) {
    const int r = i / Dv, d = i % Dv;
    const int c = (r0 + r) / G, g = (r0 + r) % G;
    const float l = fmaxf(l_run[r], 1e-30f);
    out[(((size_t)b * C + c) * H + kv * G + g) * Dv + d] =
        acar::from_f32<T>(acc[i] / l);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const void* block_table, const void* q_positions, void* out,
                   int B, int C, int H, int KV, int Dk, int Dv, int page_size,
                   int NB, int prompt_len, cudaStream_t st) {
  const int G = H / KV;
  const size_t smem = smem_bytes(Dk, Dv);
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
      static_cast<const int*>(q_positions), static_cast<T*>(out), C, KV, G, Dk,
      Dv, page_size, NB, prompt_len, 1.0f / sqrtf((float)Dk));
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

// kD: the family's width (64, 128 or 256), Dk and Dv <= kD multiples of 8.
// K and V rows padded by 16 bytes: ldmatrix's 8 row addresses of a phase
// then fall in distinct banks, and every row stays 16-byte aligned.
template <int kD>
struct MmaSmem {
  static constexpr bool kQSmem = kD > 128;  // q's fragments by ldmatrix
  static constexpr int kStride = kD + 8;
  static constexpr int kKV = 2 * kKT * kStride;  // one operand's two tiles
  static constexpr int kBytes =
      (2 * kKV + (kQSmem ? kMmaRows * kStride : 0)) * 2;
};

template <int kD>
__global__ void __launch_bounds__(32 * kMmaWarps) chunked_prefill_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pages,
    const bf16* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ q_positions, bf16* __restrict__ out, int C,
    int KV, int G, int Dk, int Dv, int page_size, int NB, int prompt_len,
    float scale) {
  using L = MmaSmem<kD>;
  constexpr int kStride = L::kStride;
  extern __shared__ __align__(16) bf16 mma_smem[];
  bf16(*ks)[kKT][kStride] =
      reinterpret_cast<bf16(*)[kKT][kStride]>(mma_smem);
  bf16(*vs)[kKT][kStride] =
      reinterpret_cast<bf16(*)[kKT][kStride]>(mma_smem + L::kKV);
  bf16(*qs)[kStride] =
      reinterpret_cast<bf16(*)[kStride]>(mma_smem + 2 * L::kKV);
  __shared__ int warp_end_s[kMmaWarps];

  const int b = blockIdx.x, kv = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;  // mma group and thread in group
  const int H = KV * G, R = C * G;
  const int row0 = blockIdx.z * kMmaRows + warp * 16;
  const int nkk = (Dk + 15) / 16;  // 16-column steps of q . k
  const int nvj = (Dv + 15) / 16;  // 16-column steps of p . v

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

  // q's fragments: in registers up to 128, else in shared memory (the
  // CTA's 64 rows, zero past Dk and past C*G)
  uint32_t qf[L::kQSmem ? 1 : kD / 16][4];
  const int ra = row0 + gq, rb = ra + 8;
  if constexpr (L::kQSmem) {
    const int rows0 = blockIdx.z * kMmaRows;
    for (int i = threadIdx.x; i < kMmaRows * (kD / 8); i += 32 * kMmaWarps) {
      const int r = i / (kD / 8), c = i % (kD / 8);
      const int row = rows0 + r;
      const bool ok = row < R && c * 8 < Dk;
      const bf16* src =
          ok ? q + (((size_t)b * C + row / G) * H + kv * G + row % G) * Dk +
                   c * 8
             : q;
      hp::cp_async16(&qs[r][c * 8], src, ok ? 16u : 0u);
    }
    hp::cp_async_commit();
    hp::cp_async_wait<0>();
  } else {
    const bf16* qa = q + (((size_t)b * C + ra / G) * H + kv * G + ra % G) * Dk;
    const bf16* qb = q + (((size_t)b * C + rb / G) * H + kv * G + rb % G) * Dk;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const int d = 16 * kk + 2 * tq;
      const bool lo = d < Dk, hi = d + 8 < Dk;
      qf[kk][0] = pos_a >= 0 && lo
                      ? *reinterpret_cast<const uint32_t*>(qa + d) : 0u;
      qf[kk][1] = pos_b >= 0 && lo
                      ? *reinterpret_cast<const uint32_t*>(qb + d) : 0u;
      qf[kk][2] = pos_a >= 0 && hi
                      ? *reinterpret_cast<const uint32_t*>(qa + d + 8) : 0u;
      qf[kk][3] = pos_b >= 0 && hi
                      ? *reinterpret_cast<const uint32_t*>(qb + d + 8) : 0u;
    }
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
  // cta_end, and columns past Dk (K) or Dv (V), are zero-filled (never
  // read from a page)
  auto load_tile = [&](int tile, int buf) {
    constexpr int kChunks = kD / 8;  // 16-byte chunks per staged row
    for (int i = threadIdx.x; i < kKT * kChunks; i += 32 * kMmaWarps) {
      const int s = i / kChunks, c = i % kChunks;
      const int pos = tile * kKT + s;
      const bool valid = pos < cta_end;
      size_t slot = 0;
      if (valid) {
        const size_t page = (size_t)bt[pos / page_size];
        slot = (page * page_size + pos % page_size) * KV + kv;
      }
      const bool kin = valid && c * 8 < Dk, vin = valid && c * 8 < Dv;
      hp::cp_async16(&ks[buf][s][c * 8],
                     k_pages + (kin ? slot * Dk + c * 8 : 0), kin ? 16u : 0u);
      hp::cp_async16(&vs[buf][s][c * 8],
                     v_pages + (vin ? slot * Dv + c * 8 : 0), vin ? 16u : 0u);
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
        if (kk < nkk) {
          const uint32_t* a = qf[L::kQSmem ? 0 : kk];
          if constexpr (L::kQSmem)
            hp::ldmatrix_x4(qf[0], &qs[warp * 16 + 8 * (mi & 1) + ri]
                                      [16 * kk + 8 * (mi >> 1)]);
#pragma unroll
          for (int jp = 0; jp < kKT / 16; ++jp) {
            uint32_t kf[4];
            hp::ldmatrix_x4(kf, &ks[buf][16 * jp + 8 * (mi >> 1) + ri]
                                   [16 * kk + 8 * (mi & 1)]);
            hp::mma_bf16_16816(sc[2 * jp], a, kf);
            hp::mma_bf16_16816(sc[2 * jp + 1], a, kf + 2);
          }
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
          if (jp < nvj) {
            uint32_t vf[4];
            hp::ldmatrix_x4_trans(vf, &vs[buf][16 * k2 + 8 * (mi & 1) + ri]
                                         [16 * jp + 8 * (mi >> 1)]);
            hp::mma_bf16_16816(o[2 * jp], pa, vf);
            hp::mma_bf16_16816(o[2 * jp + 1], pa, vf + 2);
          }
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
  bf16* oa = out + (((size_t)b * C + ra / G) * H + kv * G + ra % G) * Dv;
  bf16* ob = out + (((size_t)b * C + rb / G) * H + kv * G + rb % G) * Dv;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int d = 8 * j + 2 * tq;
    if (8 * j >= Dv) break;
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
                       int H, int KV, int Dk, int Dv, int page_size, int NB,
                       int prompt_len, cudaStream_t st) {
  const int G = H / KV;
  constexpr int kBytes = MmaSmem<kD>::kBytes;
  if (kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunked_prefill_mma_kernel<kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B, KV, (C * G + kMmaRows - 1) / kMmaRows);
  chunked_prefill_mma_kernel<kD><<<grid, 32 * kMmaWarps, kBytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pages),
      static_cast<const bf16*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(q_positions), static_cast<bf16*>(out), C, KV, G,
      Dk, Dv, page_size, NB, prompt_len, 1.0f / sqrtf((float)Dk));
  return cudaGetLastError();
}

}  // namespace

extern "C" int acar_chunked_prefill_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* q_positions, void* out, int B, int C,
    int H, int KV, int Dk, int Dv, int page_size, int NB, int prompt_len,
    int dtype, void* stream) {
  const int D = Dk > Dv ? Dk : Dv;
  if (Dk <= 0 || Dv <= 0 || D > kMaxD || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == acar::kBF16) {
    // 16-byte cp.async rows: the widths must be multiples of 8
    if (Dk % 8 != 0 || Dv % 8 != 0) return (int)cudaErrorInvalidValue;
    if (D <= 64)
      return (int)launch_mma<64>(q, k_pages, v_pages, block_table,
                                 q_positions, out, B, C, H, KV, Dk, Dv,
                                 page_size, NB, prompt_len, st);
    if (D <= 128)
      return (int)launch_mma<128>(q, k_pages, v_pages, block_table,
                                  q_positions, out, B, C, H, KV, Dk, Dv,
                                  page_size, NB, prompt_len, st);
    return (int)launch_mma<256>(q, k_pages, v_pages, block_table,
                                q_positions, out, B, C, H, KV, Dk, Dv,
                                page_size, NB, prompt_len, st);
  }
  return (int)launch<float>(q, k_pages, v_pages, block_table, q_positions,
                            out, B, C, H, KV, Dk, Dv, page_size, NB,
                            prompt_len, st);
}
