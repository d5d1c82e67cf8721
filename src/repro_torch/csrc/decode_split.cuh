// The split-KV single-token GQA decode shared by the four decode kernels,
// for Hopper (sm_90a): the paged decode (paged_decode_attention.cu), the
// dense-cache decode (decode_attention.cu) and their int8 counterparts
// (paged_decode_attention_quant.cu, decode_attention_quant.cu).
//
// Computes, for the G query heads h = kv * G + g of one (row, kv head):
//   out[h] = softmax_s(q[h] . k[s] / sqrt(Dk)) @ v[s]    over s < len
// or, over int8 codes with f32 per-vector scales (Rows::kQuant),
//   scores_s = (q[h] / sqrt(Dk) . k_codes[s]) * k_scale[s]
//   out[h]   = sum_s (softmax(scores)_s * v_scale[s]) * v_codes[s]
// with an f32 online softmax (in base 2: log2(e) is folded into q's scale),
// finished as acc / max(l, 1e-30), as the Pallas kernels do. q and out are
// TQ (f32 or bf16); the cache holds TKV (TQ, or int8_t codes). A Rows
// loader gives the slot index of a position (through the block table when
// paged, the position itself in a contiguous cache); the key rows (Dk
// contiguous elements) sit at index * kstride of k, the value rows (Dv)
// at index * vstride of v, the two scales at index * sstride of k_scale
// and v_scale. q has Dk elements a head, out Dv.
//
// Head widths. Dk and Dv each up to kMaxD (256), equal or not (DeepSeek's
// 192 / 128). Two families of instantiations: up to kWideD (128) a lane
// holds one 16-byte vector of a key row (kR = 1); above, two (kR = 2), so
// that f32 at 256 still takes one warp a row. The lanes follow the wider
// of Dk and Dv; past a row's own width K, V and q read zeros.
//
// G-tiles. A cluster serves at most tile_heads(G, D) query heads (q, acc
// and the partials of all its heads live in registers and shared memory):
// up to kMaxG (8) at head widths up to kWideD, kMaxGWide (4) above, where
// a head's q and acc take twice the registers and its partials twice the
// shared memory. A kv head whose G fits is one tile of exactly G (above
// kWideD: 1, or tiles of 4 for any other G); a larger G (granite-34b's
// multi-query attention: 48 heads on one kv head) runs g_tiles(G, D)
// clusters over the same kv head's keys, the last tile ragged: its
// missing heads read zeros for q and write nothing. The plan is a
// function of G and the head widths alone, never of the batch or the
// lengths, and a head's arithmetic does not depend on the other heads of
// its tile, so a head's bits do not depend on the tiling. Each tile reads
// the kv head's K/V once: a G of 48 reads them six times (left for a
// later redesign: more heads a cluster, or a tile loop inside one
// cluster).
//
// One launch, one cluster of kSplit CTAs per (row, kv head, G-tile):
// - Key ranges. Rank r of the cluster takes the positions
//   [r * chunk, (r + 1) * chunk) clipped to len, chunk = ceil(len / kSplit)
//   rounded up to kGran. The ranges depend on the row's own length and on
//   constants only (never on the batch, the block table's width or the
//   longest row), so a row's bits do not depend on its neighbours. A rank
//   whose range is empty contributes m = -inf, l = 0. The kernels' Python
//   wrappers mirror this arithmetic as split_ranges(); the library exports
//   range_start() itself (paged_decode_attention.cu) to check them.
// - Inside a CTA. q and tiles of kTile keys go to shared memory by 16-byte
//   cp.async, kStages tiles in flight, one barrier a tile; a tile's kTile
//   k- and v-scales (int8) go by 4-byte cp.async in the same commit group.
//   One lane per key computes a tile's slot indices kStages tiles ahead. A
//   paged loader copies the page ids of a window of kWin positions once
//   per page (4-byte cp.async), the next window's in flight with the
//   current one's tiles. Each lane holds kVec elements of a key row (16
//   bytes of f32 or bf16; 8 int8 codes, an 8-byte shared load widened in
//   registers, so that q and acc take as many registers as bf16's), kR
//   such vectors lpk * kVec elements apart, and the matching slices of q,
//   prescaled, in registers for all G heads; lpk lanes (a power of two)
//   cover a row, so a warp scores 32 / lpk keys at once, each dot product
//   reduced by a fixed xor-shuffle butterfly. The
//   running max is one per warp (a shuffle max over the keys of each
//   step), so the lanes' sums l and acc share it and add up across the
//   warp at the end with no exponentials; warps merge through shared
//   memory in warp order. There is no serial phase on a few threads.
// - Cluster combine. Each rank stores its (m, l, acc[G][D]) into rank 0's
//   shared memory over distributed shared memory and arrives on an
//   mbarrier there; rank 0 waits for all kSplit ranks, merges the partials
//   in rank order 0..kSplit-1 and writes the G * D outputs. A cluster
//   barrier arrived at the start and waited before the first remote store
//   makes sure rank 0's mbarrier is initialised and every CTA has started.
//   No atomics on data, no workspace in device memory, no second kernel.
//
// Tensor cores are not the lever: with a few query heads per kv head an
// mma tile would be mostly empty, and the bound is bytes and latency.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace acar {
namespace split {

constexpr int kSplit = 8;    // CTAs per cluster: key ranges of a (row, kv)
constexpr int kGran = 16;    // a range's length is a multiple of this
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;    // keys per pipeline stage
constexpr int kStages = 3;   // tiles in shared memory; kStages - 1 in flight
constexpr int kWin = 256;    // positions per window of page ids
constexpr int kMaxD = 256;   // Dk and Dv
constexpr int kWideD = 128;  // above: two vectors a lane (kR = 2)
constexpr int kMaxG = 8;     // query heads a cluster serves: one G-tile
constexpr int kMaxGWide = 4;  // the same above kWideD

// vectors of a key row a lane holds at head widths up to D
__host__ __device__ __forceinline__ int vecs_per_lane(int D) {
  return D > kWideD ? 2 : 1;
}

// the query heads of one G-tile (the instantiation's GT) for G heads a kv
// head at head widths up to D
__host__ __device__ __forceinline__ int tile_heads(int G, int D) {
  if (D <= kWideD) return G < kMaxG ? G : kMaxG;
  return G == 1 ? 1 : kMaxGWide;
}

// clusters per (row, kv head): the G-tiles of G query heads
__host__ __device__ __forceinline__ int g_tiles(int G, int D) {
  const int gt = tile_heads(G, D);
  return (G + gt - 1) / gt;
}

// The query heads of this cluster, from blockIdx.y = kv * tiles + tile
// (tiles of GT heads, GT = G when G <= kMaxG): its kv head, the first of
// its heads within that kv head's G, and how many it has (GT but in a
// ragged last tile).
struct HeadTile {
  int kv, g0, n;
};
template <int GT>
__device__ __forceinline__ HeadTile head_tile(int G) {
  const int tiles = (G + GT - 1) / GT;
  const int tile = (int)blockIdx.y % tiles;
  return HeadTile{(int)blockIdx.y / tiles, tile * GT, min(GT, G - tile * GT)};
}

// the length of every non-final range of a row of len positions
__host__ __device__ __forceinline__ int chunk_len(int len) {
  return ((len + kSplit - 1) / kSplit + kGran - 1) / kGran * kGran;
}

// the first position of rank r's range (r = kSplit gives len): rank r
// takes [range_start(len, r), range_start(len, r + 1)); len >= 0
__host__ __device__ __forceinline__ int range_start(int len, int r) {
  const int s = r * chunk_len(len);
  return s < len ? s : len;
}

// What one lane reads of a row in shared memory: kVec elements in one Raw
// load, widened to f32 by unpack.
template <typename T>
struct Lane;
template <>
struct Lane<float> {
  using Raw = uint4;
  static constexpr int kVec = 4;
  static __device__ __forceinline__ void unpack(const Raw& raw, float* f) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
};
template <>
struct Lane<__nv_bfloat16> {
  using Raw = uint4;
  static constexpr int kVec = 8;
  static __device__ __forceinline__ void unpack(const Raw& raw, float* f) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <>
struct Lane<int8_t> {
  using Raw = uint2;
  static constexpr int kVec = 8;
  // exact: byte c ^ 0x80 = c + 128 goes under the exponent of 2^23, and
  // 2^23 + 128 comes off (a byte permute and an add, no conversion unit)
  static __device__ __forceinline__ void unpack(const Raw& raw, float* f) {
    const uint32_t w[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i)
      f[i] = __uint_as_float(__byte_perm(w[i / 4], 0x4b000000u,
                                         0x7440u | (i % 4))) -
             8388736.f;
  }
};

// lanes per key row: kR vectors of kVec elements a lane, rounded up to a
// power of two
template <typename TKV>
__host__ __device__ __forceinline__ int lanes_per_key(int D, int kR) {
  const int per_lane = Lane<TKV>::kVec * kR;
  const int chunks = (D + per_lane - 1) / per_lane;
  int lpk = 1;
  while (lpk < chunks) lpk *= 2;
  return lpk;
}

// Where a (row, kv head)'s keys live. k, v: this kv head's row of slot
// index 0, kstride / vstride elements from one index to the next; int8
// codes
// (kQuant): ks, vs its scale of index 0, sstride floats from one index to
// the next; kPaged: bt the row's block table, index = page * page_size +
// slot.
template <typename T, bool Paged>
struct Rows {
  using TKV = T;
  static constexpr bool kPaged = Paged;
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  const T* k;
  const T* v;
  long long kstride;
  long long vstride;
  const float* ks = nullptr;
  const float* vs = nullptr;
  long long sstride = 0;
  const int* bt = nullptr;
  int page_size = 0;
};

// Dynamic shared memory of one CTA, in bytes from its start:
//   [0, kv)         K and V tiles, kStages each, rows padded to
//                   dp = lpk * kVec * kR elements (after the key loop: the
//                   warps' partials)
//   [kv, sc)        q, G * Dk elements
//   [sc, inbox)     int8: the tiles' k- and v-scales, kStages * kTile each
//   [inbox, pid)    rank 0's inbox: kSplit partials of G * Dv + 2 * G floats
//   [pid, total)    paged: two windows of page ids
template <typename TQ, typename TKV>
struct Layout {
  int dp, kv, sc, inbox, pid, total;
  __host__ __device__ Layout(int G, int Dk, int Dv, bool paged, int kR) {
    constexpr bool quant = std::is_same<TKV, int8_t>::value;
    dp = lanes_per_key<TKV>(Dk > Dv ? Dk : Dv, kR) * Lane<TKV>::kVec * kR;
    const int tiles = 2 * kStages * kTile * dp * (int)sizeof(TKV);
    const int parts = kWarps * (G * Dv + 2 * G) * 4;
    kv = ((tiles > parts ? tiles : parts) + 15) / 16 * 16;
    sc = kv + (G * Dk * (int)sizeof(TQ) + 15) / 16 * 16;
    inbox = sc + (quant ? 2 * kStages * kTile * 4 : 0);
    pid = inbox + kSplit * (G * Dv + 2 * G) * 4;
    total = pid + (paged ? 2 * (kWin + 1) * 4 : 0);
  }
};

__device__ __forceinline__ float merge_scale(float m, float m_new) {
  return m == -INFINITY ? 0.f : exp2f(m - m_new);
}

// q and out point at the first query head of this (row, kv head,
// G-tile), head g of the tile Dk (q) or Dv (out) values after head g - 1;
// only the first n_heads of the tile's G exist (fewer in a ragged last
// tile): the others read q as zeros and are never written. scale is
// log2(e) / sqrt(Dk), so that scores are in base 2 and every exponential
// is one exp2f. vec16: K/V rows and q rows are whole 16-byte chunks at
// 16-byte aligned bases (Dk * sizeof(TKV) and Dv * sizeof(TKV) multiples
// of 16), so they load by cp.async; otherwise element by element. kR: the
// vectors of a key row a lane holds (vecs_per_lane of the wider width).
template <typename TQ, int G, int kR, typename Loader>
__device__ __forceinline__ void attend(const TQ* __restrict__ q,
                                       TQ* __restrict__ out, int Dk, int Dv,
                                       int len, float scale, bool vec16,
                                       const Loader& ld, int n_heads) {
  namespace cg = cooperative_groups;
  using TKV = typename Loader::TKV;
  constexpr int kVec = Lane<TKV>::kVec;          // K/V elements a vector
  constexpr int kLane = kVec * kR;               // K/V elements a lane
  constexpr int kCopy = 16 / (int)sizeof(TKV);   // K/V elements a cp.async
  constexpr int kQVec = Lane<TQ>::kVec;          // q elements a 16-byte load
  constexpr bool kPaged = Loader::kPaged;
  constexpr bool kQuant = Loader::kQuant;
  using Raw = typename Lane<TKV>::Raw;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t inbox_full;  // rank 0's: every thread has delivered
  __shared__ long long ridx[kStages][kTile];  // tile u's slots: ridx[u % S]

  const int rank = (int)cg::this_cluster().block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Layout<TQ, TKV> lay(G, Dk, Dv, kPaged, kR);
  const int lpk = lanes_per_key<TKV>(Dk > Dv ? Dk : Dv, kR), dp = lay.dp;
  const int kpw = 32 / lpk;
  const int kg = lane / lpk, j = lane % lpk;
  TKV* kbuf = reinterpret_cast<TKV*>(smem);  // [kStages][kTile][dp]
  TKV* vbuf = kbuf + kStages * kTile * dp;
  TQ* qs = reinterpret_cast<TQ*>(smem + lay.kv);
  float* ksc = reinterpret_cast<float*>(smem + lay.sc);  // [kStages][kTile]
  float* vsc = ksc + kStages * kTile;
  float* inbox = reinterpret_cast<float*>(smem + lay.inbox);
  int* pid = reinterpret_cast<int*>(smem + lay.pid);  // [2][kWin + 1]

  if (rank == 0 && tid == 0) {
    hopper::mbar_init(&inbox_full, kSplit * kThreads);
    hopper::mbar_init_fence();
  }
  hopper::cluster_arrive_relaxed();

  len = max(len, 0);
  const int lo = range_start(len, rank);
  const int n = range_start(len, rank + 1) - lo;
  const int ntiles = (n + kTile - 1) / kTile;

  // a lane's element e of vector r is element (r * lpk + j) * kVec + e of
  // a row: each vector's loads are contiguous across the lanes
  float qr[G][kLane], acc[G][kLane], m[G], l[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int e = 0; e < kLane; ++e) acc[g][e] = 0.f;
    m[g] = -INFINITY;
    l[g] = 0.f;
  }

  // the page ids of window w: pages [first, last] of positions
  // [lo + w * kWin, lo + (w + 1) * kWin) below lo + n
  auto issue_pids = [&](int w) {
    if constexpr (kPaged) {
      const int p0 = lo + w * kWin;
      const int first = p0 / ld.page_size;
      const int last = (min(p0 + kWin, lo + n) - 1) / ld.page_size;
      int* dst = pid + (w & 1) * (kWin + 1);
      for (int i = tid; i <= last - first; i += kThreads)
        hopper::cp_async4(dst + i, ld.bt + first + i);
    }
  };
  // the slot index of position pos, pos in tile t
  auto slot_index = [&](int pos, int t) -> long long {
    if constexpr (kPaged) {
      const int w = t * kTile / kWin;
      const int first = (lo + w * kWin) / ld.page_size;
      const int pg = pos / ld.page_size;
      const int page = pid[(w & 1) * (kWin + 1) + pg - first];
      return (long long)page * ld.page_size + (pos - pg * ld.page_size);
    } else {
      return pos;
    }
  };
  // one lane per key computes the slots of tile u
  auto tile_rows = [&](int u) {
    const int pos = lo + u * kTile + tid;
    if (u < ntiles && tid < kTile)
      ridx[u % kStages][tid] = pos < lo + n ? slot_index(pos, u) : 0;
  };
  // nk rows of D elements at slot * stride of src into dst's rows of dp
  auto copy_rows = [&](TKV* dst, const TKV* src, long long stride, int D,
                       int st, int nk) {
    if (vec16) {
      const int cpr = D / kCopy;  // 16-byte chunks a row
      for (int c = tid; c < nk * cpr; c += kThreads) {
        const int key = c / cpr, col = (c - key * cpr) * kCopy;
        hopper::cp_async16(dst + key * dp + col,
                           src + ridx[st][key] * stride + col, 16);
      }
    } else {
      for (int c = tid; c < nk * D; c += kThreads) {
        const int key = c / D, d = c - key * D;
        dst[key * dp + d] = src[ridx[st][key] * stride + d];
      }
    }
  };
  auto issue_tile = [&](int t) {
    if (t >= ntiles) return;
    if constexpr (kPaged) {
      constexpr int kTilesPerWin = kWin / kTile;
      if (t % kTilesPerWin == 0 && (t / kTilesPerWin + 1) * kWin < n)
        issue_pids(t / kTilesPerWin + 1);
    }
    const int st = t % kStages;
    const int nk = min(kTile, n - t * kTile);
    copy_rows(kbuf + st * kTile * dp, ld.k, ld.kstride, Dk, st, nk);
    copy_rows(vbuf + st * kTile * dp, ld.v, ld.vstride, Dv, st, nk);
    if constexpr (kQuant) {
      if (tid < nk) {
        const long long off = ridx[st][tid] * ld.sstride;
        hopper::cp_async4(ksc + st * kTile + tid, ld.ks + off);
        hopper::cp_async4(vsc + st * kTile + tid, ld.vs + off);
      }
    }
  };
  // columns [D, dp) of buf's kStages * kTile rows are never loaded: zero
  // them so that q's zero pad meets finite values
  auto zero_pad = [&](TKV* buf, int D) {
    const int pad = dp - D;
    for (int i = tid; i < kStages * kTile * pad; i += kThreads) {
      if constexpr (kQuant)
        buf[(i / pad) * dp + D + i % pad] = 0;
      else
        buf[(i / pad) * dp + D + i % pad] = from_f32<TKV>(0.f);
    }
  };

  if (ntiles > 0) {
    zero_pad(kbuf, Dk);
    zero_pad(vbuf, Dv);
    if (vec16) {
      for (int c = tid; c < n_heads * Dk / kQVec; c += kThreads)
        hopper::cp_async16(qs + c * kQVec, q + c * kQVec, 16);
    } else {
      for (int i = tid; i < n_heads * Dk; i += kThreads) qs[i] = q[i];
    }
    for (int i = n_heads * Dk + tid; i < G * Dk; i += kThreads)
      qs[i] = from_f32<TQ>(0.f);  // a ragged tile's missing heads
    if constexpr (kPaged) {
      issue_pids(0);
      hopper::cp_async_commit();
      hopper::cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < kStages; ++u) tile_rows(u);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      issue_tile(s);
      hopper::cp_async_commit();
    }

    for (int t = 0; t < ntiles; ++t) {
      hopper::cp_async_wait<kStages - 2>();
      __syncthreads();  // tile t is in; tile t - 1's stage is free
      issue_tile(t + kStages - 1);
      hopper::cp_async_commit();
      tile_rows(t + kStages);  // into tile t's slot, issued long ago
      if (t == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int r = 0; r < kR; ++r) {
            const int base = (r * lpk + j) * kVec;
            float f[kVec];
            if (base < Dk) {
              if (vec16) {
#pragma unroll
                for (int c = 0; c < kVec / kQVec; ++c)
                  Lane<TQ>::unpack(*reinterpret_cast<const uint4*>(
                                       qs + g * Dk + base + c * kQVec),
                                   f + c * kQVec);
              } else {
#pragma unroll
                for (int e = 0; e < kVec; ++e)
                  f[e] = base + e < Dk ? to_f32(qs[g * Dk + base + e])
                                       : 0.f;
              }
            } else {
#pragma unroll
              for (int e = 0; e < kVec; ++e) f[e] = 0.f;
            }
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              qr[g][r * kVec + e] = f[e] * scale;
          }
        }
      }

      const int st = t % kStages;
      const TKV* ks = kbuf + st * kTile * dp;
      const TKV* vs = vbuf + st * kTile * dp;
      const int nk = min(kTile, n - t * kTile);
      for (int k0 = warp * kpw; k0 < nk; k0 += kWarps * kpw) {
        const int key = k0 + kg;
        const bool valid = key < nk;
        float kf[kLane], s[G], mx[G];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          Raw raw{};
          if (valid)
            raw = *reinterpret_cast<const Raw*>(ks + key * dp +
                                                (r * lpk + j) * kVec);
          Lane<TKV>::unpack(raw, kf + r * kVec);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float a = 0.f;
#pragma unroll
          for (int e = 0; e < kLane; ++e) a = fmaf(qr[g][e], kf[e], a);
          s[g] = a;
        }
        for (int off = lpk / 2; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
        }
        if constexpr (kQuant) {  // fold the k scale into the key's score
          const float ksk = valid ? ksc[st * kTile + key] : 0.f;
#pragma unroll
          for (int g = 0; g < G; ++g) s[g] *= ksk;
        }
        // the warp's max over this step's keys
#pragma unroll
        for (int g = 0; g < G; ++g) mx[g] = valid ? s[g] : -INFINITY;
        for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
          for (int g = 0; g < G; ++g)
            mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], off));
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (mx[g] > m[g]) {  // warp-uniform: rescale when the max moves
            const float a = merge_scale(m[g], mx[g]);
            l[g] *= a;
#pragma unroll
            for (int e = 0; e < kLane; ++e) acc[g][e] *= a;
            m[g] = mx[g];
          }
        }
        if (valid) {
          float vf[kLane];
#pragma unroll
          for (int r = 0; r < kR; ++r)
            Lane<TKV>::unpack(*reinterpret_cast<const Raw*>(
                                  vs + key * dp + (r * lpk + j) * kVec),
                              vf + r * kVec);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float p = exp2f(s[g] - m[g]);
            l[g] += p;
            // int8: the v scale folds into the probability
            float pv = p;
            if constexpr (kQuant) pv = p * vsc[st * kTile + key];
#pragma unroll
            for (int e = 0; e < kLane; ++e)
              acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
          }
        }
      }
    }
    hopper::cp_async_wait<0>();
  }

  // the warp's key groups add up into lanes 0..lpk-1 in a fixed order (one
  // max for the warp: no rescaling)
  for (int off = 16; off >= lpk; off >>= 1) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      l[g] += __shfl_down_sync(0xffffffffu, l[g], off);
#pragma unroll
      for (int e = 0; e < kLane; ++e)
        acc[g][e] += __shfl_down_sync(0xffffffffu, acc[g][e], off);
    }
  }
  // the warps' partials, over the free K/V tiles: [kWarps][G * Dv + 2 * G]
  __syncthreads();
  float* wpart = reinterpret_cast<float*>(smem);
  const int psize = G * Dv + 2 * G;
  if (lane < lpk) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const int d = (r * lpk + lane) * kVec + e;
          if (d < Dv) wpart[warp * psize + g * Dv + d] = acc[g][r * kVec + e];
        }
      }
      if (lane == 0) {
        wpart[warp * psize + G * Dv + g] = m[g];
        wpart[warp * psize + G * Dv + G + g] = l[g];
      }
    }
  }
  __syncthreads();

  // this CTA's partial, merged over its warps in warp order, into rank
  // 0's inbox
  hopper::cluster_wait();
  const uint32_t dst = hopper::cluster_map(inbox + rank * psize, 0);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float mw[kWarps], c[kWarps], mx = -INFINITY, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = wpart[w * psize + G * Dv + g];
      mx = fmaxf(mx, mw[w]);
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      c[w] = merge_scale(mw[w], mx);
      lsum = fmaf(wpart[w * psize + G * Dv + G + g], c[w], lsum);
    }
    for (int d = tid; d < Dv; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        a = fmaf(wpart[w * psize + g * Dv + d], c[w], a);
      hopper::st_cluster(dst + 4 * (g * Dv + d), a);
    }
    if (tid == 0) {
      hopper::st_cluster(dst + 4 * (G * Dv + g), mx);
      hopper::st_cluster(dst + 4 * (G * Dv + G + g), lsum);
    }
  }
  hopper::mbar_arrive_cluster(hopper::cluster_map(&inbox_full, 0));
  if (rank != 0) return;

  // rank 0: every rank's partial, merged in rank order
  hopper::mbar_wait_cluster(&inbox_full, 0);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= n_heads) break;
    float mr[kSplit], c[kSplit], mx = -INFINITY, lsum = 0.f;
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      mr[r] = inbox[r * psize + G * Dv + g];
      mx = fmaxf(mx, mr[r]);
    }
#pragma unroll
    for (int r = 0; r < kSplit; ++r) {
      c[r] = merge_scale(mr[r], mx);
      lsum = fmaf(inbox[r * psize + G * Dv + G + g], c[r], lsum);
    }
    for (int d = tid; d < Dv; d += kThreads) {
      float a = 0.f;
#pragma unroll
      for (int r = 0; r < kSplit; ++r)
        a = fmaf(inbox[r * psize + g * Dv + d], c[r], a);
      out[g * Dv + d] = from_f32<TQ>(a / fmaxf(lsum, 1e-30f));
    }
  }
}

// The kernels' host side: the instantiation for G query heads at head
// widths up to D = max(Dk, Dv), its G-tile GT = tile_heads(G, D) and its
// kR = vecs_per_lane(D). Launch<T, GT, kR>::run takes G first and
// launches KV * g_tiles(G, D) clusters a row.
template <template <typename, int, int> class Launch, typename T,
          typename... A>
cudaError_t dispatch_g(int G, int D, A... args) {
  if (vecs_per_lane(D) == 2) {
    if (G == 1) return Launch<T, 1, 2>::run(G, args...);
    return Launch<T, kMaxGWide, 2>::run(G, args...);
  }
  switch (tile_heads(G, D)) {
    case 1: return Launch<T, 1, 1>::run(G, args...);
    case 2: return Launch<T, 2, 1>::run(G, args...);
    case 3: return Launch<T, 3, 1>::run(G, args...);
    case 4: return Launch<T, 4, 1>::run(G, args...);
    case 5: return Launch<T, 5, 1>::run(G, args...);
    case 6: return Launch<T, 6, 1>::run(G, args...);
    case 7: return Launch<T, 7, 1>::run(G, args...);
    default: return Launch<T, kMaxG, 1>::run(G, args...);
  }
}

// the C entry points' check of a head geometry: H = KV * G, head widths
// Dk and Dv in 1..kMaxD, and the grid's y (KV * g_tiles) and z (B) within
// 65535
inline bool heads_ok(int B, int H, int KV, int Dk, int Dv) {
  const int D = Dk > Dv ? Dk : Dv;
  return KV > 0 && H > 0 && H % KV == 0 && Dk > 0 && Dv > 0 &&
         D <= kMaxD && B <= 65535 &&
         (long long)KV * g_tiles(H / KV, D) <= 65535;
}

// allow more than 48 KB of dynamic shared memory where a shape needs it
template <typename K>
cudaError_t reserve_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// vec16 of a call: K and V rows whole 16-byte chunks (Dk * kv_item and
// Dv * kv_item multiples of 16; q's rows follow, its items being at least
// kv_item) and every base 16-byte aligned
inline bool vec16(int Dk, int Dv, size_t kv_item, const void* q,
                  const void* k, const void* v) {
  return (Dk * kv_item) % 16 == 0 && (Dv * kv_item) % 16 == 0 &&
         ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
           reinterpret_cast<uintptr_t>(v)) % 16) == 0;
}

}  // namespace split
}  // namespace acar
