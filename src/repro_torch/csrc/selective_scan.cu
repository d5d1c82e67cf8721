// Mamba-1 selective scan for Hopper (sm_90a), forward and backward.
//
// Replaces: src/repro/kernels/selective_scan.py::selective_scan (the Pallas
// TPU kernel: grid (B, D / BLOCK_D, S / CHUNK), the (BLOCK_D, N) state in
// VMEM scratch carried across the sequential chunk axis, a fori_loop over
// the chunk's steps). The backward has no TPU counterpart: jax cannot
// reverse-differentiate a pallas_call, so the reference trains through its
// jnp scan.
//
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   y_t = h_t . C_t,
//   A = -exp(a_log);  x, dt (B, S, D); a_log (D, N); B, C (B, S, N).
//
// Inputs come in float32 or bfloat16, each with its own type (a bf16 model
// gives bf16 x, B, C and f32 dt, a_log); each is widened to f32 on load and
// all state and arithmetic is f32. y is written in x's type; h_final is f32.
//
// What bounds it on the H100: the work is B*S*D*N multiply-adds and as many
// exponentials (the special-function units, 16 a clock per SM), over inputs
// read once; the walk along S is serial. A walk that reads each step's
// inputs from device memory waits a memory round trip a step, so what it
// needs is bytes in flight, not more chains (B*D*N of them: 524,288 at
// falcon-mamba-7b's width with B = 4, two for every thread the card holds).
//
// Design: staged channel-block walks. A CTA owns one batch row and a block
// of kDc channels; each thread holds k states of one channel in registers
// (the channel's N states sit in N / k neighbouring lanes). The CTA walks S
// in tiles of kChunk steps through a ring of kStages tiles in shared
// memory: x, dt (and dy) [kChunk][kDc] and B, C [kChunk][N], copied by TMA
// (one thread issues a 3-D box per input, completion counted on an
// mbarrier) two tiles ahead of the walk, so the walk reads shared memory
// only and waits one round trip a tile at most. Where TMA cannot take a
// tensor (rows not a multiple of 16 bytes: bf16 N < 8, or D not a multiple
// of 8), every thread copies the same tiles element by element instead.
// A tile's bf16 inputs are widened to f32 once, in shared memory, so the
// walk's loads carry no type test. Every tile walks all kChunk steps: past
// S (and past D) the copies bring zeros, and a step of zeros leaves the
// state, and the backward's carried gradient, as they are. Outputs leave a
// tile at a time from shared memory by TMA stores.
//
// Rounding. Each state takes the plain version's operations, each rounded
// on its own (scan_step), so every state equals the plain version's bit for
// bit. y_t sums its k products in order in the thread, then a fixed
// __shfl_xor butterfly over the channel's lanes. The forward writes the
// state at the start of every tile (a checkpoint, B * ceil(S / kChunk) * D
// * N floats). The backward walks the tiles in reverse: it recomputes the
// tile's states from its checkpoint into registers with scan_step (so the
// bits are the forward's), then steps back carrying g_t = dy_t C_t +
// exp(dt_{t+1} A) g_{t+1}. dx = dt sum_n g B and ddt = x sum_n g B +
// sum_n g h_{t-1} exp(dt A) A share their sums over n (the same butterfly).
// dB and dC are sums over d: the warp's channels by a fixed halving
// exchange of shuffles, the CTA's warps in order in shared memory, giving
// one partial per channel block, which a second kernel adds in block order.
// d a_log sums over (b, t): each thread keeps its own sum over t, and a
// third kernel adds over b. Tile constants depend on N alone, so a row's
// bits never depend on the batch or the sequence length; no atomics, so a
// rerun reproduces every bit.
#include "common.cuh"
#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

namespace {

namespace hp = acar::hopper;

constexpr int kChunk = 16;   // tile steps = checkpoint interval = window
constexpr int kStages = 3;   // ring depth: tile c + 2 loads while c walks
constexpr int kAlign = 128;  // every shared region (TMA destinations)
constexpr unsigned kFull = 0xffffffffu;

// operand type tags, one bit per input: x, dt, a_log, B, C
enum Operand : int { kX = 0, kDt = 1, kALog = 2, kB = 3, kC = 4 };

__host__ __device__ __forceinline__ bool is_bf16(int codes, int operand) {
  return (codes >> operand) & 1;
}

__host__ __device__ constexpr int align_up(int v) {
  return (v + kAlign - 1) / kAlign * kAlign;
}

// The tile constants: functions of the state size N alone.
template <int N>
struct Plan {
  static constexpr int k = N < 4 ? N : 4;        // states a thread holds
  static constexpr int lanes = N / k;            // lanes of one channel
  static constexpr int dc = N == 32 ? 32 : 64;   // channels a CTA
  static constexpr int threads = dc * lanes;
  static constexpr int warps = threads / 32;
  // one input's region of a stage, sized for f32: [kChunk][dc], [kChunk][N]
  static constexpr int ch_bytes = align_up(kChunk * dc * 4);
  static constexpr int n_bytes = align_up(kChunk * N * 4);
  static constexpr int fwd_stage = 2 * ch_bytes + 2 * n_bytes;  // x dt B C
  static constexpr int bwd_stage = 3 * ch_bytes + 2 * n_bytes;  // +dy
  // one window's dB / dC sums, a row of 2N per warp and step
  static constexpr int red_bytes = warps * kChunk * 2 * N * 4;
  // barriers, ring, the widened tile, output tiles (two buffers),
  // alignment slack
  static constexpr int fwd_smem =
      kAlign + (kStages + 1) * fwd_stage + 2 * ch_bytes + kAlign;
  static constexpr int bwd_smem = kAlign + (kStages + 1) * bwd_stage +
                                  4 * ch_bytes + 2 * red_bytes + kAlign;
};

struct Maps {
  CUtensorMap x, dt, bm, cm, dy, o0, o1;   // o0: y or dx; o1: ddt
};

struct Args {
  const void *x, *dt, *a_log, *bm, *cm, *dy;
  const float *dh_final, *ckpt_in;
  void *o0, *o1;
  float *h_final, *ckpt, *da_part, *db_part, *dc_part;
  int S, D, codes, tma;
};

// a staged input: its tensor, map, type, and region offset in a stage;
// `wide` inputs are [.., D] (a box of dc channels), the others [.., N]
struct In {
  const void* p;
  const CUtensorMap* map;
  bool bf16, wide;
  int off;
};

__device__ __forceinline__ float load(const void* p, bool bf16, size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, bool bf16, size_t i,
                                      float v) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

// The tile's bf16 inputs widened to f32 in `cvt` (at the same offsets as
// in the stage), so the walk reads f32 only; an f32 input stays where it
// was staged. The caller synchronises before the walk.
template <int N>
__device__ __forceinline__ void widen(const In* in, int n,
                                      const uint8_t* stage, uint8_t* cvt) {
  using P = Plan<N>;
  for (int i = 0; i < n; ++i) {
    if (!in[i].bf16) continue;
    const int pairs = kChunk * (in[i].wide ? P::dc : N) / 2;
    const __nv_bfloat162* src =
        reinterpret_cast<const __nv_bfloat162*>(stage + in[i].off);
    float2* dst = reinterpret_cast<float2*>(cvt + in[i].off);
    for (int e = threadIdx.x; e < pairs; e += P::threads)
      dst[e] = __bfloat1622float2(src[e]);
  }
}

// input i's f32 tile: widened in `cvt` or as staged
__device__ __forceinline__ const float* tile_f32(const In& in,
                                                 const uint8_t* stage,
                                                 const uint8_t* cvt) {
  return reinterpret_cast<const float*>((in.bf16 ? cvt : stage) + in.off);
}

// a y / dx / ddt value into its output tile, in the output's type
__device__ __forceinline__ void put(uint8_t* tile, bool bf16, int i,
                                    float v) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(tile)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(tile)[i] = v;
  }
}

// K consecutive f32 states to or from device memory, one vector access
template <int K>
__device__ __forceinline__ void st_states(float* p, const float* v) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}
template <int K>
__device__ __forceinline__ void ld_states(const float* p, float* v) {
  if constexpr (K == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else if constexpr (K == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    v[0] = f.x, v[1] = f.y;
  } else {
    v[0] = p[0];
  }
}

// One step of the recurrence, each operation rounded on its own as the
// plain version rounds it: h = exp(dt a) h + (dt x) b. The forward and the
// backward's recomputation share it, so their states agree bit for bit.
__device__ __forceinline__ float scan_step(float h, float dt, float x,
                                           float a, float b) {
  const float decay = expf(__fmul_rn(dt, a));
  return __fadd_rn(__fmul_rn(decay, h), __fmul_rn(__fmul_rn(dt, x), b));
}

// Sum over the L lanes of a channel (a power of two <= 8), fixed order:
// every lane ends with the same bits.
template <int L>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = L >> 1; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Sum M values over the warp's channels (lane bits O, O/2, .., L) by a
// halving exchange: at each bit a lane keeps half of its values, adds its
// partner's sums of that half and sends the other half. On return the lane
// holds the sums of values [base, base + M'); `writer` is false on lanes
// whose sums a lane with a lower index holds too.
template <int O, int M, int L>
__device__ __forceinline__ void channel_sum(float* v, int lane, int& base,
                                            bool& writer) {
  if constexpr (O >= L) {
    const bool up = lane & O;
    if constexpr (M > 1) {
      constexpr int H = M / 2;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      if (up) base += H;
      channel_sum<O / 2, H, L>(v, lane, base, writer);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      if (up) writer = false;
      channel_sum<O / 2, 1, L>(v, lane, base, writer);
    }
  }
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((kAlign - (hp::smem_u32(raw) & (kAlign - 1))) & (kAlign - 1));
}

// Start tile t0's copies of `n` inputs into `stage`. With TMA one thread
// announces the bytes on `bar` and issues a box per input (zero-filled past
// S and D). Without, every thread copies elements (zeros past S and D);
// the caller's next __syncthreads publishes them.
template <int N>
__device__ __forceinline__ void stage_tile(const In* in, int n, uint8_t* stage,
                                           uint64_t* bar, bool tma, int b,
                                           int t0, int d0, int S, int D) {
  using P = Plan<N>;
  if (tma) {
    if (threadIdx.x == 0) {
      uint32_t bytes = 0;
      for (int i = 0; i < n; ++i)
        bytes += kChunk * (in[i].wide ? P::dc : N) * (in[i].bf16 ? 2 : 4);
      hp::mbar_arrive_expect_tx(bar, bytes);
      for (int i = 0; i < n; ++i)
        hp::tma_load_3d(stage + in[i].off, in[i].map, bar,
                        in[i].wide ? d0 : 0, t0, b);
    }
    return;
  }
  for (int i = 0; i < n; ++i) {
    const int cols = in[i].wide ? P::dc : N, width = in[i].wide ? D : N;
    const int c0 = in[i].wide ? d0 : 0;
    for (int e = threadIdx.x; e < kChunk * cols; e += P::threads) {
      const int t = t0 + e / cols, col = c0 + e % cols;
      const bool ok = t < S && col < width;
      const size_t src = ((size_t)b * S + t) * width + col;
      if (in[i].bf16) {
        reinterpret_cast<uint16_t*>(stage + in[i].off)[e] =
            ok ? static_cast<const uint16_t*>(in[i].p)[src] : 0;
      } else {
        reinterpret_cast<uint32_t*>(stage + in[i].off)[e] =
            ok ? static_cast<const uint32_t*>(in[i].p)[src] : 0;
      }
    }
  }
}

// Write tile t0 of a [.., D] output from its [kChunk][dc] shared tile:
// with TMA one thread stores the box (clipped at S and D) in a bulk group;
// without, every thread copies the elements inside S and D.
template <int N>
__device__ __forceinline__ void store_tile(const CUtensorMap* map, void* out,
                                           bool bf16, const uint8_t* tile,
                                           bool tma, int b, int t0, int d0,
                                           int S, int D) {
  using P = Plan<N>;
  if (tma) {
    if (threadIdx.x == 0) hp::tma_store_3d(map, tile, d0, t0, b);
    return;
  }
  for (int e = threadIdx.x; e < kChunk * P::dc; e += P::threads) {
    const int t = t0 + e / P::dc, d = d0 + e % P::dc;
    if (t >= S || d >= D) continue;
    const size_t dst = ((size_t)b * S + t) * D + d;
    if (bf16) {
      static_cast<uint16_t*>(out)[dst] =
          reinterpret_cast<const uint16_t*>(tile)[e];
    } else {
      static_cast<uint32_t*>(out)[dst] =
          reinterpret_cast<const uint32_t*>(tile)[e];
    }
  }
}

template <int N>
__global__ void __launch_bounds__(Plan<N>::threads, 1024 / Plan<N>::threads)
    scan_fwd_kernel(const __grid_constant__ Maps maps, const Args p) {
  using P = Plan<N>;
  constexpr int K = P::k;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + kAlign;
  uint8_t* cvt = ring + kStages * P::fwd_stage;
  uint8_t* ytiles = cvt + P::fwd_stage;
  const int tid = threadIdx.x, ch = tid / P::lanes, grp = tid % P::lanes;
  const int n0 = grp * K, b = blockIdx.y, d0 = blockIdx.x * P::dc;
  const int S = p.S, D = p.D, d = d0 + ch;
  const bool active = d < D, tma = p.tma;
  const int nc = (S + kChunk - 1) / kChunk;
  const bool bx = is_bf16(p.codes, kX), bdt = is_bf16(p.codes, kDt);
  const bool bb = is_bf16(p.codes, kB), bc = is_bf16(p.codes, kC);
  const In in[4] = {{p.x, &maps.x, bx, true, 0},
                    {p.dt, &maps.dt, bdt, true, P::ch_bytes},
                    {p.bm, &maps.bm, bb, false, 2 * P::ch_bytes},
                    {p.cm, &maps.cm, bc, false, 2 * P::ch_bytes + P::n_bytes}};
  float a[K], h[K];
  const size_t arow = (size_t)(active ? d : D - 1) * N + n0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    a[j] = -expf(load(p.a_log, is_bf16(p.codes, kALog), arow + j));
    h[j] = 0.f;
  }
  if (tma && tid == 0) {
    for (int s = 0; s < kStages; ++s) hp::mbar_init(&bars[s], 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  for (int c = 0; c < 2 && c < nc; ++c)
    stage_tile<N>(in, 4, ring + c * P::fwd_stage, &bars[c], tma, b,
                  c * kChunk, d0, S, D);
  for (int c = 0; c < nc; ++c) {
    // tile c - 1 is walked: its y tile is complete and its stage is free;
    // the y tile this walk writes has been read by its earlier store
    if (tma) {
      hp::fence_proxy_async();
      if (tid == 0) hp::bulk_wait_read<0>();
    }
    __syncthreads();
    if (c > 0) {
      store_tile<N>(&maps.o0, p.o0, bx, ytiles + ((c - 1) & 1) * P::ch_bytes,
                    tma, b, (c - 1) * kChunk, d0, S, D);
      if (tma && tid == 0) hp::bulk_commit();
    }
    if (c + 2 < nc)
      stage_tile<N>(in, 4, ring + ((c + 2) % kStages) * P::fwd_stage,
                    &bars[(c + 2) % kStages], tma, b, (c + 2) * kChunk, d0,
                    S, D);
    if (tma) hp::mbar_wait(&bars[c % kStages], (c / kStages) & 1);
    const uint8_t* st = ring + (c % kStages) * P::fwd_stage;
    widen<N>(in, 4, st, cvt);
    if (active) st_states<K>(p.ckpt + (((size_t)b * nc + c) * D + d) * N + n0,
                             h);
    __syncthreads();
    const float* xs = tile_f32(in[0], st, cvt);
    const float* dts = tile_f32(in[1], st, cvt);
    const float* bs = tile_f32(in[2], st, cvt);
    const float* cs = tile_f32(in[3], st, cvt);
    uint8_t* yt = ytiles + (c & 1) * P::ch_bytes;
    // every tile walks all kChunk steps: past S its inputs are zeros, and
    // a step of zeros leaves the state as it is (its y is not stored)
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const float xv = xs[tt * P::dc + ch], dtv = dts[tt * P::dc + ch];
      float bv[K], cv[K];
      ld_states<K>(bs + tt * N + n0, bv);
      ld_states<K>(cs + tt * N + n0, cv);
#pragma unroll
      for (int j = 0; j < K; ++j) h[j] = scan_step(h[j], dtv, xv, a[j], bv[j]);
      float s = __fmul_rn(h[0], cv[0]);
#pragma unroll
      for (int j = 1; j < K; ++j) s = __fadd_rn(s, __fmul_rn(h[j], cv[j]));
      // every lane of the channel holds the sum; all store the same bits
      put(yt, bx, tt * P::dc + ch, lane_sum<P::lanes>(s));
    }
  }
  if (tma) hp::fence_proxy_async();
  __syncthreads();
  store_tile<N>(&maps.o0, p.o0, bx, ytiles + ((nc - 1) & 1) * P::ch_bytes,
                tma, b, (nc - 1) * kChunk, d0, S, D);
  if (tma && tid == 0) {
    hp::bulk_commit();
    hp::bulk_wait_read<0>();
  }
  if (active) st_states<K>(p.h_final + ((size_t)b * D + d) * N + n0, h);
}

// After window `t0` is walked: out[(b, t, blk), q, n] = the sum over the
// CTA's warps, in order, of their sums of the window's dB (q 0) / dC (q 1).
template <int N>
__device__ __forceinline__ void write_parts(const float* red, float* db_part,
                                            float* dc_part, int S, int b,
                                            int t0) {
  using P = Plan<N>;
  const int n_blk = gridDim.x;
  for (int e = threadIdx.x; e < kChunk * 2 * N; e += P::threads) {
    const int tt = e / (2 * N), r = e % (2 * N), t = t0 + tt;
    if (t >= S) continue;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < P::warps; ++w) s += red[(w * kChunk + tt) * 2 * N + r];
    float* part = r < N ? db_part : dc_part;
    part[(((size_t)b * S + t) * n_blk + blockIdx.x) * N + r % N] = s;
  }
}

template <int N>
__global__ void __launch_bounds__(Plan<N>::threads, 512 / Plan<N>::threads)
    scan_bwd_kernel(const __grid_constant__ Maps maps, const Args p) {
  using P = Plan<N>;
  constexpr int K = P::k;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  uint8_t* ring = smem + kAlign;
  uint8_t* cvt = ring + kStages * P::bwd_stage;
  uint8_t* otiles = cvt + P::bwd_stage;   // 2 x (dx, ddt)
  float* red = reinterpret_cast<float*>(otiles + 4 * P::ch_bytes);
  const int tid = threadIdx.x, ch = tid / P::lanes, grp = tid % P::lanes;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = grp * K, b = blockIdx.y, d0 = blockIdx.x * P::dc;
  const int S = p.S, D = p.D, d = d0 + ch;
  const bool active = d < D, tma = p.tma;
  const int nc = (S + kChunk - 1) / kChunk;
  const bool bx = is_bf16(p.codes, kX), bdt = is_bf16(p.codes, kDt);
  const bool bb = is_bf16(p.codes, kB), bc = is_bf16(p.codes, kC);
  const In in[5] = {
      {p.x, &maps.x, bx, true, 0},
      {p.dt, &maps.dt, bdt, true, P::ch_bytes},
      {p.dy, &maps.dy, bx, true, 2 * P::ch_bytes},
      {p.bm, &maps.bm, bb, false, 3 * P::ch_bytes},
      {p.cm, &maps.cm, bc, false, 3 * P::ch_bytes + P::n_bytes}};
  float a[K], carry[K], da[K];
  const size_t arow = (size_t)(active ? d : D - 1) * N + n0;
  const size_t srow = ((size_t)b * D + d) * N + n0;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    a[j] = -expf(load(p.a_log, is_bf16(p.codes, kALog), arow + j));
    da[j] = 0.f;
  }
  // an inactive lane carries g = 0 (and sees x = dt = dy = 0), so it adds
  // nothing to any sum
  if (active && p.dh_final != nullptr) {
    ld_states<K>(p.dh_final + srow, carry);
  } else {
#pragma unroll
    for (int j = 0; j < K; ++j) carry[j] = 0.f;
  }
  if (tma && tid == 0) {
    for (int s = 0; s < kStages; ++s) hp::mbar_init(&bars[s], 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  // walk i takes tile c = nc - 1 - i
  for (int i = 0; i < 2 && i < nc; ++i)
    stage_tile<N>(in, 5, ring + i * P::bwd_stage, &bars[i], tma, b,
                  (nc - 1 - i) * kChunk, d0, S, D);
  for (int i = 0; i < nc; ++i) {
    const int c = nc - 1 - i;
    if (tma) {
      hp::fence_proxy_async();
      if (tid == 0) hp::bulk_wait_read<0>();
    }
    __syncthreads();
    if (i > 0) {
      const uint8_t* ot = otiles + ((i - 1) & 1) * 2 * P::ch_bytes;
      store_tile<N>(&maps.o0, p.o0, bx, ot, tma, b, (c + 1) * kChunk, d0, S,
                    D);
      store_tile<N>(&maps.o1, p.o1, bdt, ot + P::ch_bytes, tma, b,
                    (c + 1) * kChunk, d0, S, D);
      if (tma && tid == 0) hp::bulk_commit();
      write_parts<N>(red + ((i - 1) & 1) * (P::red_bytes / 4), p.db_part,
                     p.dc_part, S, b, (c + 1) * kChunk);
    }
    if (i + 2 < nc)
      stage_tile<N>(in, 5, ring + ((i + 2) % kStages) * P::bwd_stage,
                    &bars[(i + 2) % kStages], tma, b, (c - 2) * kChunk, d0,
                    S, D);
    if (tma) hp::mbar_wait(&bars[i % kStages], (i / kStages) & 1);
    const uint8_t* st = ring + (i % kStages) * P::bwd_stage;
    widen<N>(in, 5, st, cvt);
    // the window's states, recomputed from its checkpoint: hs[tt] is the
    // state before step tt of the tile, hs[tt + 1] the state after it
    float hs[kChunk + 1][K];
    if (active) {
      ld_states<K>(p.ckpt_in + (((size_t)b * nc + c) * D + d) * N + n0,
                   hs[0]);
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j) hs[0][j] = 0.f;
    }
    __syncthreads();
    const float* xs = tile_f32(in[0], st, cvt);
    const float* dts = tile_f32(in[1], st, cvt);
    const float* dys = tile_f32(in[2], st, cvt);
    const float* bs = tile_f32(in[3], st, cvt);
    const float* cs = tile_f32(in[4], st, cvt);
    uint8_t* ot = otiles + (i & 1) * 2 * P::ch_bytes;
    float* rw = red + (i & 1) * (P::red_bytes / 4) + warp * kChunk * 2 * N;
    // all kChunk steps, as in the forward: past S (and past D) the inputs
    // are zeros, so a step there carries g through unchanged and adds
    // nothing to d a_log (its other sums are not stored)
#pragma unroll
    for (int tt = 0; tt < kChunk; ++tt) {
      const float xv = xs[tt * P::dc + ch], dtv = dts[tt * P::dc + ch];
      float bv[K];
      ld_states<K>(bs + tt * N + n0, bv);
#pragma unroll
      for (int j = 0; j < K; ++j)
        hs[tt + 1][j] = scan_step(hs[tt][j], dtv, xv, a[j], bv[j]);
    }
#pragma unroll
    for (int tt = kChunk - 1; tt >= 0; --tt) {
      const float xv = xs[tt * P::dc + ch], dtv = dts[tt * P::dc + ch];
      const float dyv = dys[tt * P::dc + ch], dtx = dtv * xv;
      float bv[K], cv[K], v[2 * K];
      ld_states<K>(bs + tt * N + n0, bv);
      ld_states<K>(cs + tt * N + n0, cv);
      // dx = dt sum_n g b; ddt = x sum_n g b + sum_n g h_prev decay A
      float sgb = 0.f, sqa = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float decay = expf(__fmul_rn(dtv, a[j]));
        const float g = fmaf(dyv, cv[j], carry[j]);
        const float q = g * hs[tt][j] * decay;
        sgb = fmaf(g, bv[j], sgb);
        sqa = fmaf(q, a[j], sqa);
        da[j] = fmaf(q, dtv, da[j]);
        carry[j] = decay * g;
        v[j] = g * dtx;                   // this channel's share of dB
        v[K + j] = dyv * hs[tt + 1][j];   // and of dC
      }
      sgb = lane_sum<P::lanes>(sgb);
      sqa = lane_sum<P::lanes>(sqa);
      put(ot, bx, tt * P::dc + ch, dtv * sgb);
      put(ot + P::ch_bytes, bdt, tt * P::dc + ch, fmaf(xv, sgb, sqa));
      int base = 0;
      bool writer = true;
      channel_sum<16, 2 * K, P::lanes>(v, lane, base, writer);
      if (writer) {
        constexpr int kept = 2 * K * P::lanes / 32 > 1 ? 2 * K * P::lanes / 32
                                                       : 1;
#pragma unroll
        for (int m = 0; m < kept; ++m) {
          const int idx = base + m, q = idx / K;
          rw[tt * 2 * N + q * N + n0 + idx % K] = v[m];
        }
      }
    }
  }
  if (tma) hp::fence_proxy_async();
  __syncthreads();
  const uint8_t* ot = otiles + ((nc - 1) & 1) * 2 * P::ch_bytes;
  store_tile<N>(&maps.o0, p.o0, bx, ot, tma, b, 0, d0, S, D);
  store_tile<N>(&maps.o1, p.o1, bdt, ot + P::ch_bytes, tma, b, 0, d0, S, D);
  if (tma && tid == 0) {
    hp::bulk_commit();
    hp::bulk_wait_read<0>();
  }
  write_parts<N>(red + ((nc - 1) & 1) * (P::red_bytes / 4), p.db_part,
                 p.dc_part, S, b, 0);
  if (active) st_states<K>(p.da_part + srow, da);
}

// out[r, n] = sum over k < n_part of part[r, k, n], k in order.
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 void* __restrict__ out, bool bf16,
                                 size_t rows, int n_part, int N) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= rows * N) return;
  const size_t r = idx / N;
  const int n = idx % N;
  float s = 0.f;
  for (int k = 0; k < n_part; ++k) s += part[(r * n_part + k) * N + n];
  store(out, bf16, idx, s);
}

// d a_log[d, n] = A[d, n] * sum over b of part[b, d, n], b in order.
__global__ void alog_grad_kernel(const float* __restrict__ part,
                                 const void* __restrict__ a_log,
                                 void* __restrict__ da_log, bool bf16,
                                 int n_batch, size_t dn) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= dn) return;
  float s = 0.f;
  for (int b = 0; b < n_batch; ++b) s += part[(size_t)b * dn + idx];
  store(da_log, bf16, idx, -expf(load(a_log, bf16, idx)) * s);
}

bool valid_state_dim(int N) {
  return N >= 1 && N <= 32 && (N & (N - 1)) == 0;
}

// TMA takes a tensor whose base is 16-byte aligned and whose rows are a
// multiple of 16 bytes
bool tma_ok(const void* p, bool bf16, int width) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (size_t)width * (bf16 ? 2 : 4) % 16 == 0;
}

template <int N>
int plan_field(int D, int field) {
  using P = Plan<N>;
  switch (field) {
    case 0: return P::dc;
    case 1: return kChunk;       // tile steps
    case 2: return kChunk;       // checkpoint interval
    case 3: return P::k;
    case 4: return P::lanes;
    case 5: return P::threads;
    case 6: return kStages;
    case 7: return (D + P::dc - 1) / P::dc;
    case 8: return P::fwd_smem;
    case 9: return P::bwd_smem;
    default: return -1;
  }
}

template <int N>
cudaError_t launch(bool fwd, const Maps& m, const Args& a, int B,
                   cudaStream_t st) {
  using P = Plan<N>;
  const dim3 grid((a.D + P::dc - 1) / P::dc, B);
  auto kernel = fwd ? scan_fwd_kernel<N> : scan_bwd_kernel<N>;
  const int smem = fwd ? P::fwd_smem : P::bwd_smem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, P::threads, smem, st>>>(m, a);
  return cudaGetLastError();
}

cudaError_t launch_n(bool fwd, const Maps& m, const Args& a, int B, int N,
                     cudaStream_t st) {
  switch (N) {
    case 1: return launch<1>(fwd, m, a, B, st);
    case 2: return launch<2>(fwd, m, a, B, st);
    case 4: return launch<4>(fwd, m, a, B, st);
    case 8: return launch<8>(fwd, m, a, B, st);
    case 16: return launch<16>(fwd, m, a, B, st);
    default: return launch<32>(fwd, m, a, B, st);
  }
}

// The tensor maps of a launch: a [.., D] tensor in boxes of dc channels
// and a [.., N] one in boxes of N, kChunk rows each; with tma false, none
// (the kernels copy element by element).
cudaError_t make_map(CUtensorMap* m, bool tma, const void* p, bool bf16,
                     int width, int box, int S, int B) {
  if (!tma) return cudaSuccess;
  return hp::make_tmap_3d(m, p, bf16, width, S, B, box, kChunk);
}

}  // namespace

extern "C" int acar_selective_scan_chunk() { return kChunk; }

// The tile constants for (D, N): field 0 channels a CTA, 1 tile steps, 2
// checkpoint interval, 3 states a thread, 4 lanes a channel, 5 threads a
// CTA, 6 stages, 7 channel blocks (CTAs along D), 8 / 9 the forward's /
// backward's dynamic shared memory in bytes; -1 for an N the kernels do
// not take or an unknown field.
extern "C" int acar_selective_scan_plan(int D, int N, int field) {
  switch (N) {
    case 1: return plan_field<1>(D, field);
    case 2: return plan_field<2>(D, field);
    case 4: return plan_field<4>(D, field);
    case 8: return plan_field<8>(D, field);
    case 16: return plan_field<16>(D, field);
    case 32: return plan_field<32>(D, field);
    default: return -1;
  }
}

// x, dt (B, S, D); a_log (D, N); bm, cm (B, S, N) -> y (B, S, D) in x's
// type, h_final (B, D, N) f32, ckpt (B, ceil(S / kChunk), D, N) f32.
// codes: bit Operand set where that input is bfloat16.
extern "C" int acar_selective_scan_fwd(const void* x, const void* dt,
                                       const void* a_log, const void* bm,
                                       const void* cm, void* y,
                                       void* h_final, void* ckpt, int B,
                                       int S, int D, int N, int codes,
                                       void* stream) {
  if (!valid_state_dim(N)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaSuccess;
  const bool bx = is_bf16(codes, kX), bdt = is_bf16(codes, kDt);
  const bool bb = is_bf16(codes, kB), bc = is_bf16(codes, kC);
  const int dc = acar_selective_scan_plan(D, N, 0);
  const bool tma = tma_ok(x, bx, D) && tma_ok(dt, bdt, D) &&
                   tma_ok(bm, bb, N) && tma_ok(cm, bc, N) &&
                   tma_ok(y, bx, D);
  Maps m{};
  cudaError_t err = make_map(&m.x, tma, x, bx, D, dc, S, B);
  if (err == cudaSuccess) err = make_map(&m.dt, tma, dt, bdt, D, dc, S, B);
  if (err == cudaSuccess) err = make_map(&m.bm, tma, bm, bb, N, N, S, B);
  if (err == cudaSuccess) err = make_map(&m.cm, tma, cm, bc, N, N, S, B);
  if (err == cudaSuccess) err = make_map(&m.o0, tma, y, bx, D, dc, S, B);
  if (err != cudaSuccess) return (int)err;
  Args a{};
  a.x = x, a.dt = dt, a.a_log = a_log, a.bm = bm, a.cm = cm, a.o0 = y;
  a.h_final = static_cast<float*>(h_final);
  a.ckpt = static_cast<float*>(ckpt);
  a.S = S, a.D = D, a.codes = codes, a.tma = tma;
  return (int)launch_n(true, m, a, B, N, static_cast<cudaStream_t>(stream));
}

// The gradients of the forward above. dy (B, S, D) in x's type; dh_final
// (B, D, N) f32 or null (no gradient reaches h_final). Writes dx, ddt,
// dbm, dcm, da_log in their inputs' types. Scratch: da_part (B, D, N),
// db_part and dc_part (B, S, blocks, N), all f32, where blocks is field 7
// of acar_selective_scan_plan(D, N).
extern "C" int acar_selective_scan_bwd(
    const void* x, const void* dt, const void* a_log, const void* bm,
    const void* cm, const void* ckpt, const void* dy, const void* dh_final,
    void* dx, void* ddt, void* da_log, void* dbm, void* dcm, void* da_part,
    void* db_part, void* dc_part, int B, int S, int D, int N, int codes,
    void* stream) {
  if (!valid_state_dim(N)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bx = is_bf16(codes, kX), bdt = is_bf16(codes, kDt);
  const bool bb = is_bf16(codes, kB), bc = is_bf16(codes, kC);
  const int dc = acar_selective_scan_plan(D, N, 0);
  const int n_blk = acar_selective_scan_plan(D, N, 7);
  const bool tma = tma_ok(x, bx, D) && tma_ok(dt, bdt, D) &&
                   tma_ok(bm, bb, N) && tma_ok(cm, bc, N) &&
                   tma_ok(dy, bx, D) && tma_ok(dx, bx, D) &&
                   tma_ok(ddt, bdt, D);
  Maps m{};
  cudaError_t err = make_map(&m.x, tma, x, bx, D, dc, S, B);
  if (err == cudaSuccess) err = make_map(&m.dt, tma, dt, bdt, D, dc, S, B);
  if (err == cudaSuccess) err = make_map(&m.bm, tma, bm, bb, N, N, S, B);
  if (err == cudaSuccess) err = make_map(&m.cm, tma, cm, bc, N, N, S, B);
  if (err == cudaSuccess) err = make_map(&m.dy, tma, dy, bx, D, dc, S, B);
  if (err == cudaSuccess) err = make_map(&m.o0, tma, dx, bx, D, dc, S, B);
  if (err == cudaSuccess) err = make_map(&m.o1, tma, ddt, bdt, D, dc, S, B);
  if (err != cudaSuccess) return (int)err;
  Args a{};
  a.x = x, a.dt = dt, a.a_log = a_log, a.bm = bm, a.cm = cm, a.dy = dy;
  a.dh_final = static_cast<const float*>(dh_final);
  a.ckpt_in = static_cast<const float*>(ckpt);
  a.o0 = dx, a.o1 = ddt;
  a.da_part = static_cast<float*>(da_part);
  a.db_part = static_cast<float*>(db_part);
  a.dc_part = static_cast<float*>(dc_part);
  a.S = S, a.D = D, a.codes = codes, a.tma = tma;
  err = launch_n(false, m, a, B, N, st);
  if (err != cudaSuccess) return (int)err;
  constexpr int kThreads = 256;
  const size_t rows = (size_t)B * S;
  const int blocks = (int)((rows * N + kThreads - 1) / kThreads);
  sum_parts_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(db_part), dbm, bb, rows, n_blk, N);
  sum_parts_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(dc_part), dcm, bc, rows, n_blk, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t dn = (size_t)D * N;
  alog_grad_kernel<<<(int)((dn + kThreads - 1) / kThreads), kThreads, 0,
                     st>>>(static_cast<const float*>(da_part), a_log, da_log,
                           is_bf16(codes, kALog), B, dn);
  return (int)cudaGetLastError();
}
