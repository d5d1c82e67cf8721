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
// go through the tensor cores): two CUDA-core stage kernels, gate_up then
// down, one CTA per fixed block of kRows = 8 token rows
// (models.blocking.TOKEN_BLOCK), every sum in one fixed order with no
// atomics; x's rows stream through shared memory in chunks, so any d_model
// runs (see the stage kernels below).
#include "common.cuh"
#include "hopper.cuh"

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
// float32: two CUDA-core stage kernels
// ---------------------------------------------------------------------
constexpr int kRows = 8;     // token rows per CTA (models.blocking.TOKEN_BLOCK)
constexpr int kThreads = 256;
constexpr int kFChunk = kThreads;  // one hidden unit per thread per chunk
constexpr int kDChunk = 1024;      // x columns in shared memory at a time

// float32 runs as two stages, h = silu(x Wg) * (x Wu) then h Wd, each a
// kernel of its own (the wrapper launches both, and the serving mesh's
// tensor parallelism calls them apart, gathering h between them):
//   stage 1: one CTA a block of kRows token rows and kFChunk hidden units;
//            each thread sums one unit's g and u over D in order (fmaf),
//            x's rows streamed through shared memory kDChunk columns at a
//            time (any D), then h = silu(g) * u. A unit's value does not
//            depend on F, so a column slice of Wg and Wu gives the same
//            columns of h.
//   stage 2: one CTA a block of kRows rows and kThreads output columns;
//            each thread sums its column over F in order, kFChunk units of
//            h at a time through shared memory.
// Each element's sums run in one fixed order with no atomics, so a row's
// bits depend on neither its neighbours nor the count of rows, and a
// column's on neither the other columns nor their count.
__global__ void __launch_bounds__(kThreads)
    swiglu_gate_up_f32_kernel(const float* __restrict__ x,
                              const float* __restrict__ wg,
                              const float* __restrict__ wu,
                              float* __restrict__ h, int n_tokens, int D,
                              int F) {
  __shared__ float xs[kRows * kDChunk];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, n_tokens - row0);
  const int f = blockIdx.y * kFChunk + tid;
  float g[kRows], u[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    g[r] = 0.f;
    u[r] = 0.f;
  }
  for (int d0 = 0; d0 < D; d0 += kDChunk) {
    const int nd = min(kDChunk, D - d0);
    __syncthreads();  // the previous chunk is read
    for (int i = tid; i < kRows * nd; i += kThreads) {
      const int r = i / nd, d = i % nd;
      xs[r * kDChunk + d] =
          r < nrows ? x[(size_t)(row0 + r) * D + d0 + d] : 0.f;
    }
    __syncthreads();
    if (f < F) {
      for (int d = 0; d < nd; ++d) {
        const float wgv = wg[(size_t)(d0 + d) * F + f];
        const float wuv = wu[(size_t)(d0 + d) * F + f];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xs[r * kDChunk + d];
          g[r] = fmaf(xv, wgv, g[r]);
          u[r] = fmaf(xv, wuv, u[r]);
        }
      }
    }
  }
  if (f >= F) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nrows) {
      const float sg = g[r] / (1.f + expf(-g[r]));  // silu in float32
      h[(size_t)(row0 + r) * F + f] = sg * u[r];
    }
  }
}

// stage 2: out (T, D) = h (T, F) Wd (F, D)
__global__ void __launch_bounds__(kThreads)
    swiglu_down_f32_kernel(const float* __restrict__ h,
                           const float* __restrict__ wd,
                           float* __restrict__ out, int n_tokens, int D,
                           int F) {
  __shared__ float hs[kRows * kFChunk];
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, n_tokens - row0);
  const int c = blockIdx.y * kThreads + tid;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int f0 = 0; f0 < F; f0 += kFChunk) {
    for (int i = tid; i < kRows * kFChunk; i += kThreads) {
      const int r = i / kFChunk, ff = i % kFChunk;
      hs[i] = (r < nrows && f0 + ff < F)
                  ? h[(size_t)(row0 + r) * F + f0 + ff]
                  : 0.f;
    }
    __syncthreads();
    const int nf = min(kFChunk, F - f0);
    if (c < D) {
      for (int ff = 0; ff < nf; ++ff) {
        const float w = wd[(size_t)(f0 + ff) * D + c];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(hs[r * kFChunk + ff], w, acc[r]);
      }
    }
    __syncthreads();
  }
  if (c < D) {
    for (int r = 0; r < nrows; ++r) out[(size_t)(row0 + r) * D + c] = acc[r];
  }
}

cudaError_t launch_down_f32(const void* h, const void* wd, void* out,
                            int n_tokens, int D, int F, cudaStream_t st) {
  const dim3 grid((n_tokens + kRows - 1) / kRows,
                  (D + kThreads - 1) / kThreads);
  swiglu_down_f32_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(h), static_cast<const float*>(wd),
      static_cast<float*>(out), n_tokens, D, F);
  return cudaGetLastError();
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
  if (n_tokens <= 0) return (int)cudaSuccess;
  const dim3 grid((n_tokens + kRows - 1) / kRows,
                  (F + kFChunk - 1) / kFChunk);
  swiglu_gate_up_f32_kernel<<<grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg),
      static_cast<const float*>(wu), static_cast<float*>(h), n_tokens, D, F);
  return (int)cudaGetLastError();
}

// float32 stage 2: out (T, D) = h Wd
extern "C" int acar_swiglu_down_f32(const void* h, const void* wd, void* out,
                                    int n_tokens, int D, int F,
                                    void* stream) {
  if (n_tokens <= 0) return (int)cudaSuccess;
  return (int)launch_down_f32(h, wd, out, n_tokens, D, F,
                              static_cast<cudaStream_t>(stream));
}
