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
// go through the tensor cores): chunked_prefill_f32_kernel, a flash
// attention on the CUDA cores laid out like the bf16 kernel: rows r =
// c * G + g, each warp a fixed 8 of them, a CTA four warps (32 rows):
// grid (B, KV, ceil(C*G / 32)). The CTA walks key tiles of 32 positions
// from 0; q's rows and each tile's K and V rows come in by cp.async (K and
// V through a ring of 4 tiles at d 64, else 2) into rows padded to kD +
// 4 floats (16-byte copies where Dk and Dv are multiples of 4, else
// 4-byte copies), the tiles' page ids read once a page by warp 0 and kept
// as slots a ring ahead. A lane owns one key of the tile: its 8 scores
// (one fmaf chain over d each, q and k by 16-byte loads, q scaled once in
// shared memory) feed the online softmax in registers, the row
// maxima reduced by warp shuffles and l kept as the lane's share, summed
// by a butterfly at the end; p goes once through shared memory for p . v,
// where a lane owns kD / 32 output columns of the warp's 8 rows (8 at d
// 256, so the accumulator stays in registers). Any Dk and Dv up to 256,
// in three families by the wider (64, 128, 256); zeros past a width add
// exact zero products. What bounds it at the serving shapes: latency (a
// few key tiles of dependent steps); at long prompts the FMAs and the
// shared-memory reads of q and k. Masking and order as in bf16: a masked
// key has p = 0 and leaves m and l unchanged, the tile is a constant, no
// split-KV, and it finishes with acc / max(l, 1e-30).
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>

namespace {

constexpr int kMaxD = 256;

// ---------------------------------------------------------------------
// float32: a register-tiled flash attention on the CUDA cores
// ---------------------------------------------------------------------
namespace hp = acar::hopper;

constexpr int kF32Warps = 4;
constexpr int kF32WarpRows = 8;                      // query rows a warp
constexpr int kF32Rows = kF32Warps * kF32WarpRows;  // query rows a CTA
constexpr int kF32KT = 32;                           // keys a tile: one a lane

// kD: the family's width (64, 128 or 256), Dk and Dv <= kD. Rows of K, V
// and q padded to kD + 4 floats (4 mod 32): eight lanes reading 16 bytes
// each of eight different key rows hit 32 distinct banks. K and V tiles
// in a ring of kStages: 4 at d 64, else 2 (three at d 128 leave one CTA
// an SM).
template <int kD>
struct F32Smem {
  static constexpr int kStride = kD + 4;
  static constexpr int kStages = kD <= 64 ? 4 : 2;
  static constexpr int kKV = kF32KT * kStride;  // one operand's tile
  static constexpr int kFloats = 2 * kStages * kKV + kF32Rows * kStride +
                                 kF32Warps * kF32KT * kF32WarpRows;
  // + the ring's key slots
  static constexpr int kBytes = kFloats * 4 + kStages * kF32KT * 8;
};

// vec: Dk and Dv multiples of 4 and q and the pages 16-byte aligned, so q,
// K and V rows come in by 16-byte copies; else by 4-byte copies
template <int kD>
__global__ void __launch_bounds__(32 * kF32Warps) chunked_prefill_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ q_positions, float* __restrict__ out, int C,
    int KV, int G, int Dk, int Dv, int page_size, int NB, int prompt_len,
    float scale, int vec) {
  using L = F32Smem<kD>;
  constexpr int S = L::kStride;
  constexpr int kStages = L::kStages;
  constexpr int kCols = kD / 32;  // output columns a lane
  extern __shared__ __align__(16) float f32_smem[];
  float* ks = f32_smem;                   // [kStages][kF32KT][S]
  float* vs = ks + kStages * L::kKV;      // [kStages][kF32KT][S]
  float* qs = vs + kStages * L::kKV;      // [kF32Rows][S], scaled
  float* ps = qs + kF32Rows * S;          // [warp][key][row]
  long long* slots = reinterpret_cast<long long*>(
      ps + kF32Warps * kF32KT * kF32WarpRows);  // [kStages][kF32KT]
  __shared__ int warp_end_s[kF32Warps];

  const int b = blockIdx.x, kv = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int H = KV * G, R = C * G;
  const int r0 = blockIdx.z * kF32Rows;

  // q's rows by cp.async, zero past Dk and past C*G (scaled in place once
  // they are in)
  constexpr int kQWidth = kD / 4;  // a thread's copies: 4 floats, or 1
  auto q_row = [&](int r) {
    const int row = r0 + r;
    return q + (((size_t)b * C + row / G) * H + kv * G + row % G) * Dk;
  };
  if (vec) {
    for (int i = threadIdx.x; i < kF32Rows * kQWidth; i += 32 * kF32Warps) {
      const int r = i / kQWidth, d = (i % kQWidth) * 4;
      const bool in = r0 + r < R && d < Dk;
      hp::cp_async16(qs + r * S + d, in ? q_row(r) + d : q, in ? 16u : 0u);
    }
  } else {
    for (int i = threadIdx.x; i < kF32Rows * kD; i += 32 * kF32Warps) {
      const int r = i / kD, d = i % kD;
      const bool in = r0 + r < R && d < Dk;
      hp::cp_async4_zfill(qs + r * S + d, in ? q_row(r) + d : q,
                          in ? 4u : 0u);
    }
  }
  hp::cp_async_commit();
  // lane i < 8 reads the position of the warp's row i (-1: past C*G)
  const int wrow0 = r0 + warp * kF32WarpRows;
  int my_pos = -1;
  if (lane < kF32WarpRows && wrow0 + lane < R)
    my_pos = q_positions[(size_t)b * C + (wrow0 + lane) / G];
  int wmax = my_pos;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    wmax = max(wmax, __shfl_xor_sync(0xffffffffu, wmax, o));
  // a row past C*G attends key 0 only, so its softmax stays finite, and
  // is never stored
  int qp[kF32WarpRows];
  bool live[kF32WarpRows];
#pragma unroll
  for (int i = 0; i < kF32WarpRows; ++i) {
    const int p = __shfl_sync(0xffffffffu, my_pos, i);
    live[i] = p >= 0;
    qp[i] = max(p, 0);
  }
  const int wend = min(prompt_len, min(wmax + 1, NB * page_size));
  if (lane == 0) warp_end_s[warp] = wend;
  __syncthreads();
  int cta_end = 0;
#pragma unroll
  for (int w = 0; w < kF32Warps; ++w) cta_end = max(cta_end, warp_end_s[w]);
  const int n_tiles = (cta_end + kF32KT - 1) / kF32KT;

  const int* bt = block_table + (size_t)b * NB;
  // warp 0: the slots of tile `tile`'s keys (-1 at or past cta_end).
  // Each page id is read once, by the lane of the page's first key in the
  // tile (read_page), and passed to the others by a shuffle (put_slots,
  // into slots[buf]), so a read's latency can pass behind a tile's work
  auto read_page = [&](int tile) {
    const int pos = tile * kF32KT + lane;
    return lane == max(0, lane - pos % page_size) && pos < cta_end
               ? bt[pos / page_size] : 0;
  };
  auto put_slots = [&](int tile, int buf, int page) {
    const int pos = tile * kF32KT + lane, in = pos % page_size;
    page = __shfl_sync(0xffffffffu, page, max(0, lane - in));
    slots[buf * kF32KT + lane] =
        pos < cta_end ? ((long long)page * page_size + in) * KV + kv : -1;
  };
  // one tile's K and V rows into buffer `buf`, zero past Dk / Dv and
  // past cta_end
  auto load_tile = [&](int buf) {
    float* kd = ks + buf * L::kKV;
    float* vd = vs + buf * L::kKV;
    const long long* sl = slots + buf * kF32KT;
    if (vec) {
      constexpr int kChunks = kD / 4;
      for (int i = threadIdx.x; i < kF32KT * kChunks; i += 32 * kF32Warps) {
        const int s = i / kChunks, c = (i % kChunks) * 4;
        const long long slot = sl[s];
        const bool kin = slot >= 0 && c < Dk, vin = slot >= 0 && c < Dv;
        hp::cp_async16(kd + s * S + c, kin ? k_pages + slot * Dk + c : k_pages,
                       kin ? 16u : 0u);
        hp::cp_async16(vd + s * S + c, vin ? v_pages + slot * Dv + c : v_pages,
                       vin ? 16u : 0u);
      }
    } else {
      for (int i = threadIdx.x; i < kF32KT * kD; i += 32 * kF32Warps) {
        const int s = i / kD, c = i % kD;
        const long long slot = sl[s];
        const bool kin = slot >= 0 && c < Dk, vin = slot >= 0 && c < Dv;
        hp::cp_async4_zfill(kd + s * S + c,
                            kin ? k_pages + slot * Dk + c : k_pages,
                            kin ? 4u : 0u);
        hp::cp_async4_zfill(vd + s * S + c,
                            vin ? v_pages + slot * Dv + c : v_pages,
                            vin ? 4u : 0u);
      }
    }
  };

  float o[kF32WarpRows][kCols];
  float m[kF32WarpRows], l[kF32WarpRows];  // l: this lane's keys only
#pragma unroll
  for (int i = 0; i < kF32WarpRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o[i][j] = 0.f;
  }
  // output columns of this lane: 2 lane, + 1 at kD 64; else 4 lane + 128 j
  // .. + 3, so a warp's 16-byte reads of a V row are contiguous
  auto col_of = [&](int j) {
    return kD == 64 ? 2 * lane + j : 4 * lane + 128 * (j / 4) + j % 4;
  };

  if (warp == 0) {
    for (int t = 0; t < kStages && t < n_tiles; ++t)
      put_slots(t, t, read_page(t));
  }
  __syncthreads();
  // tiles 0 .. kStages - 2 in flight; q's copies are in, scaled by the
  // threads that made them
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    hp::cp_async_commit();
  }
  hp::cp_async_wait<kStages - 1>();
  if (vec) {
    for (int i = threadIdx.x; i < kF32Rows * kQWidth; i += 32 * kF32Warps) {
      float4* p = reinterpret_cast<float4*>(qs + (i / kQWidth) * S +
                                            (i % kQWidth) * 4);
      const float4 v = *p;
      *p = make_float4(v.x * scale, v.y * scale, v.z * scale, v.w * scale);
    }
  } else {
    for (int i = threadIdx.x; i < kF32Rows * kD; i += 32 * kF32Warps)
      qs[(i / kD) * S + i % kD] *= scale;
  }
  float* pw = ps + warp * kF32KT * kF32WarpRows;
  const float* qw = qs + warp * kF32WarpRows * S;
  const int nd4 = (Dk + 3) / 4;  // past Dk: zeros in q and K
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it % kStages;
    hp::cp_async_wait<kStages - 2>();
    // tile it is in, q is scaled, the slots of tile it + kStages - 1 are
    // written, and every warp is done with that tile's buffer
    __syncthreads();
    if (it + kStages - 1 < n_tiles) load_tile((it + kStages - 1) % kStages);
    hp::cp_async_commit();
    // tile it + kStages's slots take tile it's place (its loads are issued)
    const bool slots_ahead = warp == 0 && it + kStages < n_tiles;
    const int page = slots_ahead ? read_page(it + kStages) : 0;
    const int t0 = it * kF32KT;
    if (t0 < wend) {  // else past all of this warp's rows
      const float* kb = ks + buf * L::kKV;
      const float* vb = vs + buf * L::kKV;

      // s = q . k: this lane's key t0 + lane against the warp's 8 rows, one
      // fmaf chain over d in order
      float sc[kF32WarpRows];
#pragma unroll
      for (int i = 0; i < kF32WarpRows; ++i) sc[i] = 0.f;
      const float* kr = kb + lane * S;
#pragma unroll 4
      for (int d4 = 0; d4 < nd4; ++d4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + 4 * d4);
#pragma unroll
        for (int i = 0; i < kF32WarpRows; ++i) {
          const float4 qq =
              *reinterpret_cast<const float4*>(qw + i * S + 4 * d4);
          sc[i] = fmaf(qq.x, kk.x, sc[i]);
          sc[i] = fmaf(qq.y, kk.y, sc[i]);
          sc[i] = fmaf(qq.z, kk.z, sc[i]);
          sc[i] = fmaf(qq.w, kk.w, sc[i]);
        }
      }
      // mask (key position <= query position), the online softmax: row
      // maxima over the warp, p in f32, l this lane's share
      const int kp = t0 + lane;
#pragma unroll
      for (int i = 0; i < kF32WarpRows; ++i) {
        const float s = kp <= qp[i] && kp < prompt_len ? sc[i] : -INFINITY;
        float mt = s;
#pragma unroll
        for (int x = 16; x > 0; x >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, x));
        const float m_new = fmaxf(m[i], mt);
        const float alpha = m[i] == -INFINITY ? 0.f : expf(m[i] - m_new);
        m[i] = m_new;
        const float p = s == -INFINITY ? 0.f : expf(s - m_new);
        l[i] = l[i] * alpha + p;
#pragma unroll
        for (int j = 0; j < kCols; ++j) o[i][j] *= alpha;
        sc[i] = p;
      }
      *reinterpret_cast<float4*>(pw + lane * kF32WarpRows) =
          make_float4(sc[0], sc[1], sc[2], sc[3]);
      *reinterpret_cast<float4*>(pw + lane * kF32WarpRows + 4) =
          make_float4(sc[4], sc[5], sc[6], sc[7]);
      __syncwarp();
      // o += p . v over the tile's keys in order; keys at or past the
      // warp's end have p = 0 for all its rows and are skipped
      const int nk = min(kF32KT, wend - t0);
      for (int s = 0; s < nk; ++s) {
        const float4 pa = *reinterpret_cast<const float4*>(pw + s * kF32WarpRows);
        const float4 pb =
            *reinterpret_cast<const float4*>(pw + s * kF32WarpRows + 4);
        const float pr[kF32WarpRows] = {pa.x, pa.y, pa.z, pa.w,
                                        pb.x, pb.y, pb.z, pb.w};
        const float* vr = vb + s * S;
        float vv[kCols];
        if constexpr (kD == 64) {
          const float2 v2 = *reinterpret_cast<const float2*>(vr + 2 * lane);
          vv[0] = v2.x;
          vv[1] = v2.y;
        } else {
#pragma unroll
          for (int j = 0; j < kCols / 4; ++j) {
            const float4 v4 =
                *reinterpret_cast<const float4*>(vr + 4 * lane + 128 * j);
            vv[4 * j] = v4.x;
            vv[4 * j + 1] = v4.y;
            vv[4 * j + 2] = v4.z;
            vv[4 * j + 3] = v4.w;
          }
        }
#pragma unroll
        for (int i = 0; i < kF32WarpRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) o[i][j] = fmaf(pr[i], vv[j], o[i][j]);
      }
      __syncwarp();  // p is read before the next tile writes it
    }
    if (slots_ahead) put_slots(it + kStages, buf, page);
  }

  // l over the warp's lanes: a butterfly, the same bits on every lane
#pragma unroll
  for (int i = 0; i < kF32WarpRows; ++i) {
#pragma unroll
    for (int x = 16; x > 0; x >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
    l[i] = fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < kF32WarpRows; ++i) {
    if (!live[i]) continue;
    const int row = wrow0 + i, c = row / G, g = row % G;
    float* orow = out + (((size_t)b * C + c) * H + kv * G + g) * Dv;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      if (col_of(j) < Dv) orow[col_of(j)] = o[i][j] / l[i];
  }
}

template <int kD>
cudaError_t launch_f32(const void* q, const void* k_pages,
                       const void* v_pages, const void* block_table,
                       const void* q_positions, void* out, int B, int C,
                       int H, int KV, int Dk, int Dv, int page_size, int NB,
                       int prompt_len, cudaStream_t st) {
  const int G = H / KV;
  constexpr int kBytes = F32Smem<kD>::kBytes;
  if (kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunked_prefill_f32_kernel<kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
  }
  const int vec = Dk % 4 == 0 && Dv % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k_pages) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v_pages) % 16 == 0;
  const dim3 grid(B, KV, (C * G + kF32Rows - 1) / kF32Rows);
  chunked_prefill_f32_kernel<kD><<<grid, 32 * kF32Warps, kBytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), static_cast<const int*>(block_table),
      static_cast<const int*>(q_positions), static_cast<float*>(out), C, KV, G,
      Dk, Dv, page_size, NB, prompt_len, 1.0f / sqrtf((float)Dk), vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// bf16: mma.sync kernel
// ---------------------------------------------------------------------
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
  if (D <= 64)
    return (int)launch_f32<64>(q, k_pages, v_pages, block_table, q_positions,
                               out, B, C, H, KV, Dk, Dv, page_size, NB,
                               prompt_len, st);
  if (D <= 128)
    return (int)launch_f32<128>(q, k_pages, v_pages, block_table,
                                q_positions, out, B, C, H, KV, Dk, Dv,
                                page_size, NB, prompt_len, st);
  return (int)launch_f32<256>(q, k_pages, v_pages, block_table, q_positions,
                              out, B, C, H, KV, Dk, Dv, page_size, NB,
                              prompt_len, st);
}
