// RG-LRU linear recurrence for Hopper (sm_90a), forward and backward.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan (the Pallas TPU
// kernel: grid (B, W / BLOCK_W, S / CHUNK), the (BLOCK_W,) state in VMEM
// scratch carried across the sequential chunk axis). The backward has no
// TPU counterpart: jax cannot reverse-differentiate a pallas_call, so the
// reference trains through its associative scan.
//
//   h_t = a_t * h_{t-1} + u_t,  h_{-1} = 0;  a, u (B, S, W) -> hs (B, S, W)
//   f32 and h_final (B, W) f32, whatever a's and u's types.
//
// What bounds it on the H100: the bytes set the least time (forward, a and
// u read once and hs written once, 12 bytes a step in f32; backward, a,
// the saved hs and the incoming gradient read once, da and du written
// once, 20 bytes a step), but the walk along S is serial: its dependent
// multiply and add (about 8 clocks a step) fit inside a step's bytes only
// if nothing else waits on the chain, and a thread that loads each step
// from device memory waits a round trip a step. So the walk needs bytes in
// flight ahead of it, and as little as possible around it.
//
// Design: staged channel-block walks. A CTA owns one batch row and a block
// of kDc channels (128-byte f32 rows), one walking lane each in warp 0. It
// walks S in tiles of kT steps through a ring of tiles in shared memory,
// filled by 3-D TMA boxes (completion counted on an mbarrier) kFwdStages - 1
// (kBwdStages - 1) tiles ahead of the walk, so the walk reads shared
// memory only. A thread of warp 1 issues the copies and the output stores,
// so the walking warp never waits on the issuing. A lane loads its column
// of the tile into registers kSub steps ahead of the steps it walks,
// widening bf16 to f32 as it loads (the kernels are compiled for each pair
// of input types, so the walk carries no type test). Where TMA cannot take
// a tensor (rows not a multiple of 16 bytes, or a base not 16-byte
// aligned), every thread copies the same tiles element by element into the
// same ring. The walk writes its outputs into shared tiles (two buffers)
// that leave by TMA stores, or by element copies on the other route;
// h_final is written directly. What bounds it now is the walk: a tile's
// dependent chain of kT multiply-adds and the barrier, fence and wait
// around each tile take longer than the tile's bytes.
//
// Rounding. Every operation is rounded on its own, in the plain version's
// order (kernels/rglru_scan.py), so every output equals it bit for bit:
// forward h = a * h, then + u; backward g = dhs + carry, du = g,
// da = g * h_{t-1} (0 at t = 0), carry = a * g.
//
// Edges. Past S (and past W) the copies bring zeros, but unlike the
// selective scan's, a step of zeros is not a step that changes nothing:
// a = 0 sets h to 0 and zeroes the backward's carried gradient. So a walk
// takes only the steps of its tile inside S: h after step S - 1 is
// h_final, and the backward starts at step S - 1 with h_final's gradient
// as its carry. The backward's hs box is kT + 1 rows from t0 - 1, so
// h_{t-1} of a tile's first step is in its own stage (row -1 is TMA's zero
// fill). The tile constants are fixed, so a row's bits depend neither on
// its batch neighbours nor on S; nothing is summed across threads, so
// there is no reduction and no atomic.
#include "common.cuh"
#include "hopper.cuh"

#include <stdint.h>

namespace {

namespace hp = acar::hopper;

constexpr int kT = 64;        // steps a tile
constexpr int kThreads = 128;
// the thread that issues the TMA copies and owns their bulk groups: in
// warp 1, so that warp 0, whose lanes walk, never waits on the issuing
constexpr int kIssuer = 32;
constexpr int kAlign = 128;   // every shared region (TMA destinations)

__host__ __device__ constexpr int align_up(int v) {
  return (v + kAlign - 1) / kAlign * kAlign;
}

constexpr int kDc = 32;       // channels a CTA: 128-byte f32 rows
// ring depths: the forward loads tiles c+1..c+kFwdStages-1 while c walks
constexpr int kFwdStages = 6, kBwdStages = 5;
constexpr int kTile = align_up(kT * kDc * 4);         // [kT][kDc], f32 or less
constexpr int kHsBox = align_up((kT + 1) * kDc * 4);  // rows t0-1..t0+kT-1
constexpr int kFwdStage = 2 * kTile;                  // a, u
constexpr int kBwdStage = 2 * kTile + kHsBox;         // a, dhs, hs
// barriers, ring, output tiles (two buffers), alignment slack
constexpr int kFwdSmem = kAlign + kFwdStages * kFwdStage + 2 * kTile + kAlign;
constexpr int kBwdSmem = kAlign + kBwdStages * kBwdStage + 4 * kTile + kAlign;

struct Maps {
  CUtensorMap a, u, hs, dhs, o0, o1;   // o0: hs (forward) or da; o1: du
};

struct Args {
  const void *a, *u;
  const float *hs, *dhs, *dh_final;
  void *o0, *o1;
  float* h_final;
  int S, W, tma;
};

// a staged input: its tensor and map, element size, region offset in a
// stage, and its box: `rows` rows from the tile's first step + row0
struct In {
  const void* p;
  const CUtensorMap* map;
  int elem, off, row0, rows;
};

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((kAlign - (hp::smem_u32(raw) & (kAlign - 1))) & (kAlign - 1));
}

// Start tile t0's copies of N inputs into `stage`. With TMA the issuer
// announces the bytes on `bar` and issues a box per input (zero-filled
// outside the tensor). Without, every thread copies elements (zeros
// outside); the caller's next __syncthreads publishes them.
template <int N>
__device__ __forceinline__ void stage_tile(const In* in, uint8_t* stage,
                                           uint64_t* bar, bool tma, int b,
                                           int t0, int w0, int S, int W) {
  if (tma) {
    if (threadIdx.x == kIssuer) {
      uint32_t bytes = 0;
#pragma unroll
      for (int i = 0; i < N; ++i) bytes += in[i].rows * kDc * in[i].elem;
      hp::mbar_arrive_expect_tx(bar, bytes);
#pragma unroll
      for (int i = 0; i < N; ++i)
        hp::tma_load_3d(stage + in[i].off, in[i].map, bar, w0,
                        t0 + in[i].row0, b);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    for (int e = threadIdx.x; e < in[i].rows * kDc; e += kThreads) {
      const int t = t0 + in[i].row0 + e / kDc, w = w0 + e % kDc;
      const bool ok = t >= 0 && t < S && w < W;
      const size_t src = ((size_t)b * S + (ok ? t : 0)) * W + w;
      if (in[i].elem == 2) {
        reinterpret_cast<uint16_t*>(stage + in[i].off)[e] =
            ok ? static_cast<const uint16_t*>(in[i].p)[src] : 0;
      } else {
        reinterpret_cast<uint32_t*>(stage + in[i].off)[e] =
            ok ? static_cast<const uint32_t*>(in[i].p)[src] : 0;
      }
    }
  }
}

// Write tile t0 of a (B, S, W) output of type T from its [kT][kDc] shared
// tile: with TMA the issuer stores the box (clipped at S and W) in a bulk
// group; without, every thread copies the elements inside S and W.
template <typename T>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, void* out,
                                           const uint8_t* tile, bool tma,
                                           int b, int t0, int w0, int S,
                                           int W) {
  if (tma) {
    if (threadIdx.x == kIssuer) hp::tma_store_3d(map, tile, w0, t0, b);
    return;
  }
  for (int e = threadIdx.x; e < kT * kDc; e += kThreads) {
    const int t = t0 + e / kDc, w = w0 + e % kDc;
    if (t >= S || w >= W) continue;
    static_cast<T*>(out)[((size_t)b * S + t) * W + w] =
        reinterpret_cast<const T*>(tile)[e];
  }
}

// kSub rows of a lane's column (rows kDc apart) from shared memory into
// registers, widened to f32. The walks load a chunk of kSub steps before
// they walk the chunk before it, so that a step does not wait on its own
// shared-memory loads.
constexpr int kSub = 16;

template <typename T>
__device__ __forceinline__ void load_sub(const T* p, float* v) {
#pragma unroll
  for (int j = 0; j < kSub; ++j) v[j] = acar::to_f32(p[j * kDc]);
}

// One lane's forward walk over the first `steps` steps of a tile (all kT
// when kFull): a, u, hs point at the lane's column. A tile's rows past
// `steps` hold zeros and are loaded but not walked.
template <bool kFull, typename TA, typename TU>
__device__ __forceinline__ float fwd_walk(const TA* a, const TU* u,
                                          float* hs, float h, int steps) {
  float av[2][kSub], uv[2][kSub];
  load_sub(a, av[0]);
  load_sub(u, uv[0]);
#pragma unroll
  for (int k = 0; k < kT / kSub; ++k) {
    if (k + 1 < kT / kSub) {
      load_sub(a + (k + 1) * kSub * kDc, av[(k + 1) & 1]);
      load_sub(u + (k + 1) * kSub * kDc, uv[(k + 1) & 1]);
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int tt = k * kSub + j;
      if (kFull || tt < steps) {
        h = __fadd_rn(__fmul_rn(av[k & 1][j], h), uv[k & 1][j]);
        hs[tt * kDc] = h;
      }
    }
  }
  return h;
}

// One lane's backward walk over the first `steps` steps of a tile, last
// step first, carrying g from the step after: hprev's row tt is h_{t-1}.
// `first`: the tile starts at t = 0, where da is 0 as the plain version
// writes it (not g * 0, whose sign follows g's).
template <bool kFull, typename TA, typename TU>
__device__ __forceinline__ float bwd_walk(const TA* a, const float* dhs,
                                          const float* hprev, TA* da, TU* du,
                                          float carry, int steps,
                                          bool first) {
  constexpr int kLast = kT / kSub - 1;
  float av[2][kSub], gv[2][kSub], hv[2][kSub];
  load_sub(a + kLast * kSub * kDc, av[kLast & 1]);
  load_sub(dhs + kLast * kSub * kDc, gv[kLast & 1]);
  load_sub(hprev + kLast * kSub * kDc, hv[kLast & 1]);
#pragma unroll
  for (int k = kLast; k >= 0; --k) {
    if (k > 0) {
      load_sub(a + (k - 1) * kSub * kDc, av[(k - 1) & 1]);
      load_sub(dhs + (k - 1) * kSub * kDc, gv[(k - 1) & 1]);
      load_sub(hprev + (k - 1) * kSub * kDc, hv[(k - 1) & 1]);
    }
#pragma unroll
    for (int j = kSub - 1; j >= 0; --j) {
      const int tt = k * kSub + j;
      if (kFull || tt < steps) {
        const float g = __fadd_rn(gv[k & 1][j], carry);
        du[tt * kDc] = acar::from_f32<TU>(g);
        da[tt * kDc] = acar::from_f32<TA>(
            tt == 0 && first ? 0.f : __fmul_rn(g, hv[k & 1][j]));
        carry = __fmul_rn(av[k & 1][j], g);
      }
    }
  }
  return carry;
}

template <typename TA, typename TU>
__global__ void __launch_bounds__(kThreads)
    rglru_fwd_kernel(const __grid_constant__ Maps maps, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + kAlign;
  uint8_t* htiles = ring + kFwdStages * kFwdStage;
  const int tid = threadIdx.x, b = blockIdx.y, w0 = blockIdx.x * kDc;
  const int S = p.S, W = p.W, nc = (S + kT - 1) / kT;
  const bool tma = p.tma;
  const In in[2] = {{p.a, &maps.a, (int)sizeof(TA), 0, 0, kT},
                    {p.u, &maps.u, (int)sizeof(TU), kTile, 0, kT}};
  if (tma && tid == kIssuer) {
    for (int s = 0; s < kFwdStages; ++s) hp::mbar_init(&bars[s], 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  for (int c = 0; c < kFwdStages - 1 && c < nc; ++c)
    stage_tile<2>(in, ring + c * kFwdStage, &bars[c], tma, b, c * kT, w0,
                  S, W);
  float h = 0.f;
  for (int c = 0; c < nc; ++c) {
    // tile c - 1 is walked: its hs tile is complete and its stage is free;
    // the hs tile this walk writes has been read by its earlier store
    if (tma) {
      if (tid < kDc) hp::fence_proxy_async();
      if (tid == kIssuer) hp::bulk_wait_read<0>();
    }
    __syncthreads();
    if (c > 0) {
      store_tile<float>(&maps.o0, p.o0, htiles + ((c - 1) & 1) * kTile,
                        tma, b, (c - 1) * kT, w0, S, W);
      if (tma && tid == kIssuer) hp::bulk_commit();
    }
    const int next = c + kFwdStages - 1;
    if (next < nc)
      stage_tile<2>(in, ring + (next % kFwdStages) * kFwdStage,
                    &bars[next % kFwdStages], tma, b, next * kT, w0, S, W);
    const uint8_t* st = ring + (c % kFwdStages) * kFwdStage;
    if (tid < kDc) {
      if (tma) hp::mbar_wait(&bars[c % kFwdStages], (c / kFwdStages) & 1);
      const TA* as = reinterpret_cast<const TA*>(st) + tid;
      const TU* us = reinterpret_cast<const TU*>(st + kTile) + tid;
      float* hs = reinterpret_cast<float*>(htiles + (c & 1) * kTile) + tid;
      const int steps = min(kT, S - c * kT);
      h = steps == kT ? fwd_walk<true>(as, us, hs, h, kT)
                      : fwd_walk<false>(as, us, hs, h, steps);
    }
  }
  if (tma && tid < kDc) hp::fence_proxy_async();
  __syncthreads();
  store_tile<float>(&maps.o0, p.o0, htiles + ((nc - 1) & 1) * kTile, tma, b,
                    (nc - 1) * kT, w0, S, W);
  if (tma && tid == kIssuer) {
    hp::bulk_commit();
    hp::bulk_wait_read<0>();
  }
  if (tid < kDc && w0 + tid < W) p.h_final[(size_t)b * W + w0 + tid] = h;
}

template <typename TA, typename TU>
__global__ void __launch_bounds__(kThreads)
    rglru_bwd_kernel(const __grid_constant__ Maps maps, const Args p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + kAlign;
  uint8_t* otiles = ring + kBwdStages * kBwdStage;   // 2 x (da, du)
  const int tid = threadIdx.x, b = blockIdx.y, w0 = blockIdx.x * kDc;
  const int S = p.S, W = p.W, nc = (S + kT - 1) / kT;
  const bool tma = p.tma;
  const In in[3] = {{p.a, &maps.a, (int)sizeof(TA), 0, 0, kT},
                    {p.dhs, &maps.dhs, 4, kTile, 0, kT},
                    {p.hs, &maps.hs, 4, 2 * kTile, -1, kT + 1}};
  // h_final's gradient enters at step S - 1, the first step walked; a lane
  // past W carries 0 (its outputs are not stored)
  float carry = 0.f;
  if (tid < kDc && w0 + tid < W && p.dh_final != nullptr)
    carry = p.dh_final[(size_t)b * W + w0 + tid];
  if (tma && tid == kIssuer) {
    for (int s = 0; s < kBwdStages; ++s) hp::mbar_init(&bars[s], 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  // walk i takes tile c = nc - 1 - i
  for (int i = 0; i < kBwdStages - 1 && i < nc; ++i)
    stage_tile<3>(in, ring + i * kBwdStage, &bars[i], tma, b,
                  (nc - 1 - i) * kT, w0, S, W);
  for (int i = 0; i < nc; ++i) {
    const int c = nc - 1 - i;
    if (tma) {
      if (tid < kDc) hp::fence_proxy_async();
      if (tid == kIssuer) hp::bulk_wait_read<0>();
    }
    __syncthreads();
    if (i > 0) {
      const uint8_t* ot = otiles + ((i - 1) & 1) * 2 * kTile;
      store_tile<TA>(&maps.o0, p.o0, ot, tma, b, (c + 1) * kT, w0, S, W);
      store_tile<TU>(&maps.o1, p.o1, ot + kTile, tma, b, (c + 1) * kT, w0,
                     S, W);
      if (tma && tid == kIssuer) hp::bulk_commit();
    }
    const int next = i + kBwdStages - 1;
    if (next < nc)
      stage_tile<3>(in, ring + (next % kBwdStages) * kBwdStage,
                    &bars[next % kBwdStages], tma, b, (nc - 1 - next) * kT,
                    w0, S, W);
    const uint8_t* st = ring + (i % kBwdStages) * kBwdStage;
    if (tid < kDc) {
      if (tma) hp::mbar_wait(&bars[i % kBwdStages], (i / kBwdStages) & 1);
      uint8_t* ot = otiles + (i & 1) * 2 * kTile;
      const TA* as = reinterpret_cast<const TA*>(st) + tid;
      const float* dhs = reinterpret_cast<const float*>(st + kTile) + tid;
      const float* hprev =
          reinterpret_cast<const float*>(st + 2 * kTile) + tid;
      TA* da = reinterpret_cast<TA*>(ot) + tid;
      TU* du = reinterpret_cast<TU*>(ot + kTile) + tid;
      const int steps = min(kT, S - c * kT);
      carry = steps == kT
                  ? bwd_walk<true>(as, dhs, hprev, da, du, carry, kT, c == 0)
                  : bwd_walk<false>(as, dhs, hprev, da, du, carry, steps,
                                    c == 0);
    }
  }
  if (tma && tid < kDc) hp::fence_proxy_async();
  __syncthreads();
  const uint8_t* ot = otiles + ((nc - 1) & 1) * 2 * kTile;
  store_tile<TA>(&maps.o0, p.o0, ot, tma, b, 0, w0, S, W);
  store_tile<TU>(&maps.o1, p.o1, ot + kTile, tma, b, 0, w0, S, W);
  if (tma && tid == kIssuer) {
    hp::bulk_commit();
    hp::bulk_wait_read<0>();
  }
}

// TMA takes a tensor whose base is 16-byte aligned and whose rows are a
// multiple of 16 bytes
bool tma_ok(const void* p, bool bf16, int W) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (size_t)W * (bf16 ? 2 : 4) % 16 == 0;
}

// The map of a (B, S, W) tensor read or written in boxes of kDc channels
// and `rows` steps; with tma false, none (the kernels copy elements).
cudaError_t make_map(CUtensorMap* m, bool tma, const void* p, bool bf16,
                     int B, int S, int W, int rows) {
  if (!tma) return cudaSuccess;
  return hp::make_tmap_3d(m, p, bf16, W, S, B, kDc, rows);
}

template <typename TA, typename TU>
cudaError_t launch(bool fwd, const Maps& m, const Args& a, int B,
                   cudaStream_t st) {
  const dim3 grid((a.W + kDc - 1) / kDc, B);
  auto kernel = fwd ? rglru_fwd_kernel<TA, TU> : rglru_bwd_kernel<TA, TU>;
  const int smem = fwd ? kFwdSmem : kBwdSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(m, a);
  return cudaGetLastError();
}

cudaError_t dispatch_types(bool fwd, const Maps& m, const Args& a, int B,
                           bool a_bf16, bool u_bf16, cudaStream_t st) {
  using bf = __nv_bfloat16;
  if (a_bf16)
    return u_bf16 ? launch<bf, bf>(fwd, m, a, B, st)
                  : launch<bf, float>(fwd, m, a, B, st);
  return u_bf16 ? launch<float, bf>(fwd, m, a, B, st)
                : launch<float, float>(fwd, m, a, B, st);
}

cudaError_t run(bool fwd, const void* a, const void* u, const void* hs,
                const void* dhs, const void* dh_final, void* o0, void* o1,
                void* h_final, int B, int S, int W, bool a_bf16, bool u_bf16,
                cudaStream_t st) {
  bool tma = tma_ok(a, a_bf16, W) && tma_ok(hs, false, W);
  tma = tma && (fwd ? tma_ok(u, u_bf16, W)
                    : tma_ok(dhs, false, W) && tma_ok(o0, a_bf16, W) &&
                          tma_ok(o1, u_bf16, W));
  Maps m{};
  cudaError_t err = make_map(&m.a, tma, a, a_bf16, B, S, W, kT);
  if (fwd) {
    if (err == cudaSuccess)
      err = make_map(&m.u, tma, u, u_bf16, B, S, W, kT);
    if (err == cudaSuccess)
      err = make_map(&m.o0, tma, hs, false, B, S, W, kT);
  } else {
    if (err == cudaSuccess)
      err = make_map(&m.hs, tma, hs, false, B, S, W, kT + 1);
    if (err == cudaSuccess)
      err = make_map(&m.dhs, tma, dhs, false, B, S, W, kT);
    if (err == cudaSuccess)
      err = make_map(&m.o0, tma, o0, a_bf16, B, S, W, kT);
    if (err == cudaSuccess)
      err = make_map(&m.o1, tma, o1, u_bf16, B, S, W, kT);
  }
  if (err != cudaSuccess) return err;
  Args p{};
  p.a = a, p.u = u;
  p.hs = static_cast<const float*>(hs);
  p.dhs = static_cast<const float*>(dhs);
  p.dh_final = static_cast<const float*>(dh_final);
  p.o0 = fwd ? const_cast<void*>(hs) : o0;
  p.o1 = o1;
  p.h_final = static_cast<float*>(h_final);
  p.S = S, p.W = W, p.tma = tma;
  return dispatch_types(fwd, m, p, B, a_bf16, u_bf16, st);
}

}  // namespace

// The tile constants: field 0 channels a CTA, 1 steps a tile, 2 channel
// blocks (CTAs along W) for W channels, 3 / 4 the forward's / backward's
// ring stages, 5 threads a CTA, 6 / 7 the forward's / backward's dynamic
// shared memory in bytes; -1 for an unknown field.
extern "C" int acar_rglru_scan_plan(int W, int field) {
  switch (field) {
    case 0: return kDc;
    case 1: return kT;
    case 2: return (W + kDc - 1) / kDc;
    case 3: return kFwdStages;
    case 4: return kBwdStages;
    case 5: return kThreads;
    case 6: return kFwdSmem;
    case 7: return kBwdSmem;
    default: return -1;
  }
}

// a, u (B, S, W), each float32 or bfloat16 (a_bf16, u_bf16) -> hs
// (B, S, W) f32, h_final (B, W) f32.
extern "C" int acar_rglru_scan_fwd(const void* a, const void* u, void* hs,
                                   void* h_final, int B, int S, int W,
                                   int a_bf16, int u_bf16, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  return (int)run(true, a, u, hs, nullptr, nullptr, nullptr, nullptr,
                  h_final, B, S, W, a_bf16 != 0, u_bf16 != 0, st);
}

// The gradients of the forward above: hs the forward's (B, S, W) f32, dhs
// (B, S, W) f32 and dh_final (B, W) f32 or null -> da, du (B, S, W) in
// a's and u's types.
extern "C" int acar_rglru_scan_bwd(const void* a, const void* hs,
                                   const void* dhs, const void* dh_final,
                                   void* da, void* du, int B, int S, int W,
                                   int a_bf16, int u_bf16, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaSuccess;
  auto st = static_cast<cudaStream_t>(stream);
  return (int)run(false, a, nullptr, hs, dhs, dh_final, da, du, nullptr, B,
                  S, W, a_bf16 != 0, u_bf16 != 0, st);
}
