// Fused SwiGLU MLP for Hopper (sm_90a): out = (silu(x Wg) * (x Wu)) Wd.
//
// Replaces: src/repro/kernels/fused_swiglu.py::fused_swiglu (the Pallas TPU
// kernel: grid (T / BLOCK_T, F / BLOCK_F), F innermost, an f32 VMEM
// accumulator of (BLOCK_T, D), so the (T, F) hidden activation never
// reaches HBM).
//
// Shapes: x (T, D); Wg, Wu (D, F); Wd (F, D) -> out (T, D).
//
// What bounds it on the H100: operations. The call does 6*T*D*F flops
// against 3*D*F weight elements: at the serving chunk (T 256, d 576, F
// 1536) the bytes and the flops are level at about 2 us, and at
// recurrentgemma-2b's training width (T 4096, d 2560, F 7680) the 483
// GFLOP take 0.49 ms at the bf16 tensor-core peak. Only the tensor cores
// reach that: the same work in f32 FMAs has a floor of 7.2 ms.
//
// bf16: two tensor-core GEMM kernels, launched one after the other by the
// wrapper (so a bf16 call is two CUDA launches):
//   stage 1, gate_up: h = bf16(silu(x Wg) * (x Wu)), g and u in f32;
//   stage 2, down:    out = bf16(h Wd).
// Why two kernels when the Pallas kernel keeps h on chip: its f32
// (BLOCK_T, D) accumulator is 1.3 MB at BLOCK_T 128, D 2560, past an SM's
// registers and its 227 KB of shared memory. h's round trip through HBM
// is 2*T*F*2 bytes (126 MB at T 4096, 8% of the bound; at T 256 it stays
// in the 50 MB L2), and h is rounded to x's dtype exactly where the Pallas
// kernel rounds it (h.astype(x.dtype) before the down product), so the
// split adds no rounding.
//
// Both stages are one kernel template. A CTA owns a fixed 128-row tile of
// the output: 128 columns of h in stage 1 (the same columns of Wg and Wu,
// two accumulators g and u that share the x tile); in stage 2, 256 columns
// of out (two 128-column halves of Wd) when d_model is a multiple of 256,
// else 128. One producer warp streams the A tile (128 rows x 64 of K) and
// the B tiles (64 of K x 128 columns)
// by TMA into a 4-stage ring in shared memory (48 KB a stage, 128-byte
// swizzle), tracked by full/empty mbarriers. Two consumer warpgroups, 64
// rows each, run wgmma m64n128k16 (bf16 in, f32 accumulate) over K in
// steps of 64, one step in flight while the next is issued. Wg, Wu and Wd
// stay in their row-major (K, N) layouts: wgmma reads such an N-contiguous
// B operand through its transpose bit, so no weight is repacked. The
// epilogue writes the f32 accumulators straight from registers, rounded
// to bf16 once, rows and columns past the edge masked; a ragged edge is
// read as zeros (TMA's out-of-bounds fill).
//
// Batch invariance: the tile sizes (128 rows, 128 or 256 columns by
// d_model, 64 of K, 4 stages) are never chosen from T; no split-K and no
// atomics.
// Each output element sums its K products in one fixed order in its own
// accumulator, so a token's bits do not depend on how many tokens share
// the call or which rows share its tile. D and F must be multiples of 8
// (TMA's 16-byte row strides) and the tensors 16-byte aligned; the wrapper
// raises otherwise.
//
// float32 (the reduced f32 models only; TF32 is off, so f32 operands never
// go through the tensor cores): two stage kernels, gate_up then down, on
// one register-tiled CUDA-core GEMM (swiglu_f32_gemm_kernel): 64-row
// tiles, an 8 x 8 block of outputs a thread fed by 16-byte shared-memory
// loads, operands staged by cp.async through a 3-stage ring, and K split
// over a thread-block cluster by K alone (1 to 8 CTAs), the ranks'
// partials added in rank order over distributed shared memory. What
// bounds it: operations (67 TFLOP/s of f32 FMA on the CUDA cores); at
// small T the split fills the card. Any d_model and d_ff (see the stage
// kernels below).
#include "common.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>
#include <math.h>

#include <initializer_list>

namespace {

namespace hp = acar::hopper;
using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------
// bf16: the two tensor-core stages
// ---------------------------------------------------------------------
constexpr int kBM = 128;      // output rows per CTA: 2 consumer warpgroups
constexpr int kBN = 128;      // columns per B operand (one wgmma's N)
constexpr int kBK = 64;       // K per stage: one 128-byte swizzled row
constexpr int kStages = 4;
constexpr int kATile = kBM * kBK * 2;          // 16 KB
constexpr int kBBox = kBK * 64 * 2;            // 8 KB: 64 K rows x 64 columns
constexpr int kBTile = 2 * kBBox;              // 16 KB
constexpr int kStageBytes = kATile + 2 * kBTile;  // 48 KB
constexpr int kGemmThreads = 384;  // producer warpgroup + 2 consumers
constexpr int kGemmSmem =
    kStages * kStageBytes + 2 * kStages * 8 + 1024;  // + barriers, alignment

__device__ __forceinline__ float silu(float g) {
  return g / (1.f + expf(-g));
}

// The stages a CTA can run: kGateUp: B0 = Wg, B1 = Wu at the same 128
// columns, out = h (N = F). kDownWide: B0, B1 = Wd at columns n0 and
// n0 + 128, 256 columns of out (N = D). kDownNarrow: B0 = Wd alone, 128
// columns, for a narrow d_model (not a multiple of 256), where 256-wide
// tiles would leave the last one mostly empty and half the SMs idle.
enum Mode : int { kGateUp = 0, kDownWide = 1, kDownNarrow = 2 };

__host__ __device__ constexpr int cols_per_cta(int mode) {
  return mode == kDownWide ? 2 * kBN : kBN;
}

template <int kMode>
__global__ void __launch_bounds__(kGemmThreads, 1)
    swiglu_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b0,
                       const __grid_constant__ CUtensorMap tm_b1,
                       bf16* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle and wgmma's descriptors need 1024-byte tiles
  uint8_t* smem =
      smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int m0 = blockIdx.x * kBM;
  constexpr bool kGated = kMode == kGateUp;
  constexpr bool kTwoB = kMode != kDownNarrow;  // a second B operand
  constexpr uint32_t kTx = kTwoB ? kStageBytes : kATile + kBTile;
  const int n0 = blockIdx.y * cols_per_cta(kMode);
  const int n_k = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], 256);  // every consumer thread
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps the ring full
    hp::setmaxnreg_dec40();
    if (threadIdx.x == 0) {
      const int nb1 = kGated ? n0 : n0 + kBN;
      for (int i = 0; i < n_k; ++i) {
        const int s = i % kStages;
        hp::mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = smem + s * kStageBytes;
        const int k0 = i * kBK;
        hp::mbar_arrive_expect_tx(&full[s], kTx);
        hp::tma_load_2d(st, &tm_a, &full[s], k0, m0);
        hp::tma_load_2d(st + kATile, &tm_b0, &full[s], n0, k0);
        hp::tma_load_2d(st + kATile + kBBox, &tm_b0, &full[s], n0 + 64, k0);
        if (kTwoB) {
          hp::tma_load_2d(st + kATile + kBTile, &tm_b1, &full[s], nb1, k0);
          hp::tma_load_2d(st + kATile + kBTile + kBBox, &tm_b1, &full[s],
                          nb1 + 64, k0);
        }
      }
    }
  } else {
    hp::setmaxnreg_inc232();
    const int cw = wg - 1;  // rows 64*cw .. 64*cw + 63 of the tile
    float acc0[64], acc1[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      acc0[j] = 0.f;
      acc1[j] = 0.f;
    }
    for (int i = 0; i < n_k; ++i) {
      const int s = i % kStages;
      hp::mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* a = smem + s * kStageBytes + cw * (64 * 128);
      const uint8_t* b0 = smem + s * kStageBytes + kATile;
      const uint8_t* b1 = b0 + kBTile;
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        hp::fence_operand(acc0[j]);
        if (kTwoB) hp::fence_operand(acc1[j]);
      }
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        // A: K-major, 16 of K = 32 bytes along the row; B: MN-major,
        // 16 of K = 16 rows of 128 bytes; 64-column boxes 8 KB apart
        const uint64_t da = hp::smem_desc(a + kk * 32, 16, 1024);
        hp::wgmma_m64n128k16_tb(acc0, da,
                                hp::smem_desc(b0 + kk * 2048, kBBox, 1024));
        if (kTwoB)
          hp::wgmma_m64n128k16_tb(acc1, da,
                                  hp::smem_desc(b1 + kk * 2048, kBBox, 1024));
      }
      hp::wgmma_commit();
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        hp::fence_operand(acc0[j]);
        if (kTwoB) hp::fence_operand(acc1[j]);
      }
      // the previous step's products are done: release its stage
      hp::wgmma_wait<1>();
      if (i > 0) hp::mbar_arrive(&empty[(i - 1) % kStages]);
    }
    hp::wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      hp::fence_operand(acc0[j]);
      if (kTwoB) hp::fence_operand(acc1[j]);
    }

    const int t = threadIdx.x % 128;
    const int row = m0 + cw * 64 + (t / 32) * 16 + (t % 32) / 4;
    const int col = n0 + 2 * (t % 4);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row + 8 * half;
        const int e = 4 * j + 2 * half;  // this row's pair in column block j
        const int c = col + 8 * j;
        if (r >= M) continue;
        bf16* o = out + (size_t)r * N + c;
        if (kGated) {
          if (c < N)
            *reinterpret_cast<uint32_t*>(o) = hp::pack_bf16x2(
                silu(acc0[e]) * acc1[e], silu(acc0[e + 1]) * acc1[e + 1]);
        } else {
          if (c < N)
            *reinterpret_cast<uint32_t*>(o) =
                hp::pack_bf16x2(acc0[e], acc0[e + 1]);
          if (kTwoB && c + kBN < N)
            *reinterpret_cast<uint32_t*>(o + kBN) =
                hp::pack_bf16x2(acc1[e], acc1[e + 1]);
        }
      }
    }
  }
}

template <int kMode>
cudaError_t launch_gemm(const CUtensorMap& a, const CUtensorMap& b0,
                        const CUtensorMap& b1, void* out, int M, int N, int K,
                        cudaStream_t st) {
  const cudaError_t err = cudaFuncSetAttribute(
      swiglu_gemm_kernel<kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kGemmSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + kBM - 1) / kBM,
                  (N + cols_per_cta(kMode) - 1) / cols_per_cta(kMode));
  swiglu_gemm_kernel<kMode><<<grid, kGemmThreads, kGemmSmem, st>>>(
      a, b0, b1, static_cast<bf16*>(out), M, N, K);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// float32: two stage kernels on one register-tiled CUDA-core GEMM,
// split over K across a thread-block cluster
// ---------------------------------------------------------------------
// A CTA owns a tile of kF32Rows token rows by kF32Cols columns of the B
// operand: in down, 128 columns of Wd (128 columns of out); in gate_up,
// 64 columns of Wg beside the same 64 of Wu (64 columns of h), so that g
// and u share the x tile and a thread holds both of the columns it
// finishes. Warp w owns rows 2 kF32ThreadRows w .. of the tile; a thread
// of it a kF32ThreadRows x 8 block of outputs: rows 2 kF32ThreadRows w +
// 4 ty + (0..3) (+ 8 for the second four; ty = lane / 16), columns 4 tx +
// (0..3) and 64 + 4 tx + (0..3) (tx = lane % 16),
// every operand read from shared memory by 16-byte loads (A row-major,
// a float4 four k of one row, taken four k at a time). A warp whose rows
// all lie past M skips the arithmetic. The K operand comes in steps of
// kF32K through a ring of kF32Stages stages by cp.async, A and B as they
// lie in memory: 16-byte copies where K and N are multiples of 4 and the
// operands 16-byte aligned, 4-byte copies otherwise; zero-filled past M,
// N and the rank's K range.
//
// Split-K: a cluster of f32_split(K) CTAs shares one output tile; rank r
// sums k over [f32_start(K, r), f32_start(K, r + 1)) in order (one fmaf
// chain per output element), a range that depends on K alone. With more
// than one rank, each stores its partials over distributed shared memory
// into the inbox of the rank that owns those columns (the drained ring's
// space), and the owner adds the ranks' partials in rank order 0..n-1;
// gate_up combines g and u so, then forms silu(g) * u in f32 once. No
// workspace in device memory, no second kernel, no atomics. An element's
// sum runs in an order fixed by K: it depends on neither M, nor N, nor
// the rows or columns beside it, so rows called alone and column slices
// of the weights give the same bits.
constexpr int kF32Warps = 4;
constexpr int kF32ThreadRows = 8;  // output rows a thread (a multiple of 4)
constexpr int kF32Threads = 32 * kF32Warps;
constexpr int kF32Rows = 2 * kF32ThreadRows * kF32Warps;  // rows a tile
constexpr int kF32Cols = 128;      // B columns a tile (gate_up: 64 + 64)
constexpr int kF32HCols = kF32Cols / 2;  // columns of h a gate_up tile
constexpr int kF32K = 16;          // K a ring stage
constexpr int kF32Stages = 3;
constexpr int kF32MinBlocks = 3;   // CTAs an SM, for the register budget
// The split: up to 8 ranks, each at least one ring stage of K, so even
// a small K spreads over several SMs (K 64: 4 ranks of 16). A small T
// runs few tiles and needs that; a large T pays for the exchange (about
// 5% at T 4096), since the split may follow K only.
constexpr int kF32MaxSplit = 8;
constexpr int kF32MinChunk = kF32K;  // K a rank at least, past one rank
// A row-major, its rows of kF32K padded by 4 floats: 16-byte aligned, and
// the 8 rows a warp reads at one k fall in distinct banks
constexpr int kF32AStride = kF32K + 4;
constexpr int kF32StageFloats =
    kF32Rows * kF32AStride + kF32K * kF32Cols;
constexpr int kF32RingFloats = kF32Stages * kF32StageFloats;
constexpr int kF32InboxFloats = kF32Rows * kF32Cols;
constexpr int kF32SmemBytes =
    4 * (kF32RingFloats > kF32InboxFloats ? kF32RingFloats
                                          : kF32InboxFloats);

// CTAs a cluster: 1, 2, 4 or 8 by K alone, each rank >= kF32MinChunk
__host__ __device__ __forceinline__ int f32_split(int K) {
  int n = 1;
  while (n < kF32MaxSplit && K >= 2 * n * kF32MinChunk) n *= 2;
  return n;
}

// K a rank: ceil(K / split) rounded up to a whole ring stage
__host__ __device__ __forceinline__ int f32_chunk(int K) {
  const int n = f32_split(K);
  return ((K + n - 1) / n + kF32K - 1) / kF32K * kF32K;
}

// the first k of rank r's range (r >= the split gives K)
__host__ __device__ __forceinline__ int f32_start(int K, int r) {
  const long long s = (long long)r * f32_chunk(K);
  return s < K ? (int)s : K;
}

// kGateUp: b0 = Wg, b1 = Wu, out = h (N = F, its silu(g) * u); else
// b0 = Wd, out = h Wd (N = D). kVec: A and B by 16-byte copies and out
// by 16-byte stores (K, N multiples of 4, every pointer 16-byte aligned).
// kSplit: f32_split(K), the cluster's CTAs.
template <bool kGateUp, bool kVec, int kSplit>
__global__ void __launch_bounds__(kF32Threads, kF32MinBlocks)
    swiglu_f32_gemm_kernel(const float* __restrict__ a,
                           const float* __restrict__ b0,
                           const float* __restrict__ b1,
                           float* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(16) float f32_smem[];
  float* smem = f32_smem;
  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ty = lane / 16, tx = lane % 16;
  const int m0 = blockIdx.z * kF32Rows;
  // the tile's first column of the output (h or out)
  const int n0 = blockIdx.y * (kGateUp ? kF32HCols : kF32Cols);
  const int lo = f32_start(K, rank), hi = f32_start(K, rank + 1);
  const int n_k = (hi - lo + kF32K - 1) / kF32K;
  // the thread's row r: wrow + r % 4 + 8 (r / 4)
  const int wrow = 2 * kF32ThreadRows * warp + 4 * ty;
  // the warp has a row below M
  const bool live = m0 + 2 * kF32ThreadRows * warp < M;

  // one ring stage: columns k0 .. k0 + kF32K - 1 of A's rows, the same
  // rows of B
  auto load_stage = [&](int i, int buf) {
    float* as = smem + buf * kF32StageFloats;
    float* bs = as + kF32Rows * kF32AStride;
    const int k0 = lo + i * kF32K;
    if (kVec) {
#pragma unroll
      for (int t = 0; t < kF32Rows * kF32K / 4 / kF32Threads; ++t) {
        const int q = tid + t * kF32Threads, m = q / (kF32K / 4),
                  k = (q % (kF32K / 4)) * 4;
        const bool ok = m0 + m < M && k0 + k < hi;
        hp::cp_async16(as + m * kF32AStride + k,
                       ok ? a + (size_t)(m0 + m) * K + k0 + k : a,
                       ok ? 16u : 0u);
      }
    } else {
#pragma unroll 4
      for (int t = 0; t < kF32Rows * kF32K / kF32Threads; ++t) {
        const int e = tid + t * kF32Threads, m = e / kF32K, k = e % kF32K;
        const bool ok = m0 + m < M && k0 + k < hi;
        hp::cp_async4_zfill(as + m * kF32AStride + k,
                            ok ? a + (size_t)(m0 + m) * K + k0 + k : a,
                            ok ? 4u : 0u);
      }
    }
    // B: column c of the tile is column n0 + c of b0 (gate_up: c < 64 of
    // Wg, c >= 64 the same columns of Wu)
    if (kVec) {
#pragma unroll
      for (int t = 0; t < kF32K * kF32Cols / 4 / kF32Threads; ++t) {
        const int q = tid + t * kF32Threads, k = q / 32, c = (q % 32) * 4;
        const float* src = b0;
        int col = n0 + c;
        if (kGateUp && c >= kF32HCols) {
          src = b1;
          col -= kF32HCols;
        }
        const bool ok = col < N && k0 + k < hi;
        hp::cp_async16(bs + k * kF32Cols + c,
                       ok ? src + (size_t)(k0 + k) * N + col : src,
                       ok ? 16u : 0u);
      }
    } else {
#pragma unroll 4
      for (int t = 0; t < kF32K * kF32Cols / kF32Threads; ++t) {
        const int e = tid + t * kF32Threads, k = e / kF32Cols,
                  c = e % kF32Cols;
        const float* src = b0;
        int col = n0 + c;
        if (kGateUp && c >= kF32HCols) {
          src = b1;
          col -= kF32HCols;
        }
        const bool ok = col < N && k0 + k < hi;
        hp::cp_async4_zfill(bs + k * kF32Cols + c,
                            ok ? src + (size_t)(k0 + k) * N + col : src,
                            ok ? 4u : 0u);
      }
    }
  };

  float acc[kF32ThreadRows][8];
#pragma unroll
  for (int i = 0; i < kF32ThreadRows; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    hp::cp_async_commit();
  }
  for (int i = 0; i < n_k; ++i) {
    hp::cp_async_wait<kF32Stages - 2>();
    __syncthreads();  // stage i is in; every thread is done with i - 1
    if (i + kF32Stages - 1 < n_k)
      load_stage(i + kF32Stages - 1, (i + kF32Stages - 1) % kF32Stages);
    hp::cp_async_commit();
    if (!live) continue;
    const float* as = smem + (i % kF32Stages) * kF32StageFloats;
    const float* bs = as + kF32Rows * kF32AStride;
    // four k at a time: a float4 of each of the thread's rows, then the
    // four k in order
#pragma unroll
    for (int k4 = 0; k4 < kF32K; k4 += 4) {
      float4 a4[kF32ThreadRows];
#pragma unroll
      for (int r = 0; r < kF32ThreadRows; ++r)
        a4[r] = *reinterpret_cast<const float4*>(
            as + (wrow + r % 4 + 8 * (r / 4)) * kF32AStride + k4);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float4 c0 = *reinterpret_cast<const float4*>(
            bs + (k4 + kk) * kF32Cols + 4 * tx);
        const float4 c1 = *reinterpret_cast<const float4*>(
            bs + (k4 + kk) * kF32Cols + 64 + 4 * tx);
        const float bv[8] = {c0.x, c0.y, c0.z, c0.w,
                             c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int r = 0; r < kF32ThreadRows; ++r) {
          const float av = kk == 0   ? a4[r].x
                           : kk == 1 ? a4[r].y
                           : kk == 2 ? a4[r].z
                                     : a4[r].w;
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av, bv[c], acc[r][c]);
        }
      }
    }
  }
  hp::cp_async_wait<0>();

  // a row's 4 output columns from col (a multiple of 4): one 16-byte
  // store where the row has them all (kVec: N % 4 == 0, out aligned)
  auto store4 = [&](int row, int col, float4 v) {
    float* o = out + (size_t)row * N + col;
    if (kVec && col + 3 < N) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      if (col < N) o[0] = v.x;
      if (col + 1 < N) o[1] = v.y;
      if (col + 2 < N) o[2] = v.z;
      if (col + 3 < N) o[3] = v.w;
    }
  };
  auto silu4 = [](float4 g, float4 u) {
    return make_float4(silu(g.x) * u.x, silu(g.y) * u.y, silu(g.z) * u.z,
                       silu(g.w) * u.w);
  };

  if (kSplit == 1) {
    // one rank: its sums are the outputs
    if (!live) return;
#pragma unroll
    for (int r = 0; r < kF32ThreadRows; ++r) {
      const int row = m0 + wrow + r % 4 + 8 * (r / 4);
      if (row >= M) continue;
      const float4 lo4 =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      const float4 hi4 =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
      if (kGateUp) {
        store4(row, n0 + 4 * tx, silu4(lo4, hi4));
      } else {
        store4(row, n0 + 4 * tx, lo4);
        store4(row, n0 + 64 + 4 * tx, hi4);
      }
    }
    return;
  }

  // every rank is done with its ring: the inboxes take its place. The
  // owner of a 4-column unit u (0..31) of the tile: down, u / (32 / n);
  // gate_up, (u % 16) / (16 / n), its g columns first, then its u
  // columns. Inbox [source rank][row][kWidth columns].
  constexpr int kWidth = kF32Cols / kSplit;
  constexpr int kOwn = kGateUp ? kF32HCols / kSplit : kWidth;  // out cols
  hp::cluster_arrive();
  hp::cluster_wait();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int owner, col;
    if (kGateUp) {
      constexpr int kPer = 16 / kSplit;  // h units an owner
      owner = tx / kPer;
      col = h * kOwn + (tx % kPer) * 4;
    } else {
      constexpr int kPer = 32 / kSplit;
      const int unit = tx + 16 * h;
      owner = unit / kPer;
      col = (unit % kPer) * 4;
    }
#pragma unroll
    for (int r = 0; r < kF32ThreadRows; ++r) {
      const int row = wrow + r % 4 + 8 * (r / 4);
      if (m0 + row >= M) continue;
      hp::st_cluster_v4(
          hp::cluster_map(smem + (rank * kF32Rows + row) * kWidth + col,
                          owner),
          make_float4(acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2],
                      acc[r][4 * h + 3]));
    }
  }
  hp::cluster_arrive();
  hp::cluster_wait();

  // this rank's columns, 4 at a time, the ranks' partials added in rank
  // order
  auto part = [&](int s, int row, int c) {
    return *reinterpret_cast<const float4*>(
        smem + (s * kF32Rows + row) * kWidth + c);
  };
  auto add4 = [](float4 x, float4 y) {
    return make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
  };
  constexpr int kUnits = kOwn / 4;  // 4-column units a row
#pragma unroll
  for (int t = 0; t < (kF32Rows * kUnits + kF32Threads - 1) / kF32Threads;
       ++t) {
    const int q = tid + t * kF32Threads, row = q / kUnits,
              c = (q % kUnits) * 4;
    if (row >= kF32Rows || m0 + row >= M) continue;
    float4 v = part(0, row, c);
#pragma unroll
    for (int s = 1; s < kSplit; ++s) v = add4(v, part(s, row, c));
    if (kGateUp) {
      float4 u = part(0, row, kOwn + c);
#pragma unroll
      for (int s = 1; s < kSplit; ++s) u = add4(u, part(s, row, kOwn + c));
      v = silu4(v, u);
    }
    store4(m0 + row, n0 + rank * kOwn + c, v);
  }
}

template <bool kGateUp, bool kVec, int kSplit>
cudaError_t launch_f32_split(const float* a, const float* b0,
                             const float* b1, float* out, int M, int K,
                             int N, cudaStream_t st) {
  const auto kernel = swiglu_f32_gemm_kernel<kGateUp, kVec, kSplit>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kF32SmemBytes);
  if (err != cudaSuccess) return err;
  const int cols = kGateUp ? kF32HCols : kF32Cols;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplit, (N + cols - 1) / cols,
                     (M + kF32Rows - 1) / kF32Rows);
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = kF32SmemBytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kSplit > 1;  // one rank: no cluster
  err = cudaLaunchKernelEx(&cfg, kernel, a, b0, b1, out, M, K, N);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kGateUp, bool kVec>
cudaError_t launch_f32_vec(const float* a, const float* b0, const float* b1,
                           float* out, int M, int K, int N,
                           cudaStream_t st) {
  switch (f32_split(K)) {
    case 1:
      return launch_f32_split<kGateUp, kVec, 1>(a, b0, b1, out, M, K, N, st);
    case 2:
      return launch_f32_split<kGateUp, kVec, 2>(a, b0, b1, out, M, K, N, st);
    case 4:
      return launch_f32_split<kGateUp, kVec, 4>(a, b0, b1, out, M, K, N, st);
    default:
      return launch_f32_split<kGateUp, kVec, 8>(a, b0, b1, out, M, K, N, st);
  }
}

template <bool kGateUp>
cudaError_t launch_f32(const void* a, const void* b0, const void* b1,
                       void* out, int M, int K, int N, cudaStream_t st) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0) return cudaErrorInvalidValue;
  const int cols = kGateUp ? kF32HCols : kF32Cols;
  if ((N + cols - 1) / cols > 65535 || (M + kF32Rows - 1) / kF32Rows > 65535)
    return cudaErrorInvalidValue;
  bool vec = K % 4 == 0 && N % 4 == 0;
  for (const void* p : {a, b0, b1, static_cast<const void*>(out)})
    vec = vec && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  const float* pa = static_cast<const float*>(a);
  const float* p0 = static_cast<const float*>(b0);
  const float* p1 = static_cast<const float*>(b1);
  float* po = static_cast<float*>(out);
  return vec ? launch_f32_vec<kGateUp, true>(pa, p0, p1, po, M, K, N, st)
             : launch_f32_vec<kGateUp, false>(pa, p0, p1, po, M, K, N, st);
}

bool bf16_shapes_ok(int D, int F, std::initializer_list<const void*> ptrs) {
  if (D % 8 != 0 || F % 8 != 0) return false;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace

// bf16 stage 1: h (T, F) = bf16(silu(x Wg) * (x Wu))
extern "C" int acar_swiglu_gate_up(const void* x, const void* wg,
                                   const void* wu, void* h, int n_tokens,
                                   int D, int F, void* stream) {
  if (!bf16_shapes_ok(D, F, {x, wg, wu, h})) return (int)cudaErrorInvalidValue;
  if (n_tokens <= 0) return (int)cudaSuccess;
  CUtensorMap ma, mg, mu;
  cudaError_t err = hp::make_tmap_bf16(&ma, x, n_tokens, D, kBM);
  if (err == cudaSuccess) err = hp::make_tmap_bf16(&mg, wg, D, F, kBK);
  if (err == cudaSuccess) err = hp::make_tmap_bf16(&mu, wu, D, F, kBK);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_gemm<kGateUp>(ma, mg, mu, h, n_tokens, F, D,
                                static_cast<cudaStream_t>(stream));
}

// bf16 stage 2: out (T, D) = bf16(h Wd)
extern "C" int acar_swiglu_down(const void* h, const void* wd, void* out,
                                int n_tokens, int D, int F, void* stream) {
  if (!bf16_shapes_ok(D, F, {h, wd, out})) return (int)cudaErrorInvalidValue;
  if (n_tokens <= 0) return (int)cudaSuccess;
  CUtensorMap mh, md;
  cudaError_t err = hp::make_tmap_bf16(&mh, h, n_tokens, F, kBM);
  if (err == cudaSuccess) err = hp::make_tmap_bf16(&md, wd, F, D, kBK);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the tile width follows d_model, never T
  if (D % (2 * kBN) == 0)
    return (int)launch_gemm<kDownWide>(mh, md, md, out, n_tokens, D, F, st);
  return (int)launch_gemm<kDownNarrow>(mh, md, md, out, n_tokens, D, F, st);
}

// float32 stage 1: h (T, F) = silu(x Wg) * (x Wu)
extern "C" int acar_swiglu_gate_up_f32(const void* x, const void* wg,
                                       const void* wu, void* h, int n_tokens,
                                       int D, int F, void* stream) {
  return (int)launch_f32<true>(x, wg, wu, h, n_tokens, D, F,
                               static_cast<cudaStream_t>(stream));
}

// float32 stage 2: out (T, D) = h Wd
extern "C" int acar_swiglu_down_f32(const void* h, const void* wd, void* out,
                                    int n_tokens, int D, int F,
                                    void* stream) {
  return (int)launch_f32<false>(h, wd, wd, out, n_tokens, F, D,
                                static_cast<cudaStream_t>(stream));
}

// The f32 stages' plan as the kernel computes it, for checking
// kernels/fused_swiglu.py::swiglu_f32_plan(): field 0 the CTAs of a
// cluster (the split of K), 1 the K a rank, 2 a tile's token rows, 3 a
// gate_up tile's columns of h, 4 a down tile's columns, 5 the K a ring
// stage, 6 and 7 the gate_up and down column tiles of n; 8 + r the first
// k of rank r's range (r >= the split gives K). -1 for another field.
extern "C" int acar_swiglu_f32_plan(int k, int n, int field) {
  switch (field) {
    case 0: return f32_split(k);
    case 1: return f32_chunk(k);
    case 2: return kF32Rows;
    case 3: return kF32HCols;
    case 4: return kF32Cols;
    case 5: return kF32K;
    case 6: return (n + kF32HCols - 1) / kF32HCols;
    case 7: return (n + kF32Cols - 1) / kF32Cols;
    default:
      if (field >= 8 && field <= 8 + kF32MaxSplit)
        return f32_start(k, field - 8);
      return -1;
  }
}
