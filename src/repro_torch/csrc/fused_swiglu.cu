// Fused SwiGLU MLP for Hopper (sm_90a): out = (silu(x Wg) * (x Wu)) Wd.
//
// Replaces: src/repro/kernels/fused_swiglu.py::fused_swiglu (the Pallas TPU
// kernel: grid (T / BLOCK_T, F / BLOCK_F), F innermost, f32 VMEM accumulator,
// so the (T, F) hidden activation never reaches HBM).
//
// Shapes: x (T, D); Wg, Wu (D, F); Wd (F, D) -> out (T, D), float32 or
// bfloat16, all arithmetic in float32.
//
// What bounds it on the H100: operations. A prefill chunk of a few hundred
// tokens does 6*T*D*F flops against 3*D*F weight elements, well above the
// ridge for T >= 64 once the weights sit in L2. This first version runs on
// the CUDA cores (no wgmma), so it is far from the tensor-core bound; its
// numbers stand in PERF.md as the baseline for the wgmma version.
//
// Design: one CTA per fixed block of kRows = 8 token rows (the port's
// models.blocking.TOKEN_BLOCK), never a block size derived from T, so a
// token's bits do not depend on how many tokens share the call. The CTA
// keeps its x rows in shared memory and walks F in chunks of kFChunk hidden
// units: each thread computes the gate and up projections of one hidden unit
// for all 8 rows in float32, applies silu to the gate in float32, multiplies
// by up in float32 (as the Pallas kernel does; the plain version rounds
// silu(g) to x's dtype first, so the two agree exactly only in float32),
// rounds that h to x's dtype, and parks it in shared memory. The CTA then
// accumulates h @ Wd[chunk] into float32 registers, one set of output columns
// per thread. Each output element sums over F in one fixed order, with no
// atomics; the hidden activation never leaves the SM.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kRows = 8;     // token rows per CTA (models.blocking.TOKEN_BLOCK)
constexpr int kThreads = 256;
constexpr int kFChunk = kThreads;  // one hidden unit per thread per chunk
// output columns per thread: the kernel is instantiated for 4, 8, 12 and
// 16 columns (D <= 1024, 2048, 3072, 4096) and the launch takes the
// fewest that cover D. Column c's sum is the same loop in every
// instantiation, so its bits do not depend on which one runs.
constexpr int kMaxCols = 16;

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
    fused_swiglu_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                        const T* __restrict__ wu, const T* __restrict__ wd,
                        T* __restrict__ out, int n_tokens, int D, int F) {
  extern __shared__ float smem[];
  float* xs = smem;              // kRows x D
  float* hs = xs + kRows * D;    // kRows x kFChunk

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int nrows = min(kRows, n_tokens - row0);

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    xs[i] = r < nrows ? acar::to_f32(x[(size_t)(row0 + r) * D + d]) : 0.f;
  }

  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.f;
  }
  __syncthreads();

  for (int f0 = 0; f0 < F; f0 += kFChunk) {
    const int f = f0 + tid;
    if (f < F) {
      float g[kRows], u[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        g[r] = 0.f;
        u[r] = 0.f;
      }
      for (int d = 0; d < D; ++d) {
        const float wgv = acar::to_f32(wg[(size_t)d * F + f]);
        const float wuv = acar::to_f32(wu[(size_t)d * F + f]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float xv = xs[r * D + d];
          g[r] = fmaf(xv, wgv, g[r]);
          u[r] = fmaf(xv, wuv, u[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float sg = g[r] / (1.f + expf(-g[r]));  // silu in float32
        hs[r * kFChunk + tid] = acar::to_f32(acar::from_f32<T>(sg * u[r]));
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRows; ++r) hs[r * kFChunk + tid] = 0.f;
    }
    __syncthreads();

    const int nf = min(kFChunk, F - f0);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tid + j * kThreads;
      if (c < D) {
        for (int ff = 0; ff < nf; ++ff) {
          const float w = acar::to_f32(wd[(size_t)(f0 + ff) * D + c]);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r][j] = fmaf(hs[r * kFChunk + ff], w, acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kCols; ++j) {
    const int c = tid + j * kThreads;
    if (c < D) {
      for (int r = 0; r < nrows; ++r)
        out[(size_t)(row0 + r) * D + c] = acar::from_f32<T>(acc[r][j]);
    }
  }
}

template <typename T, int kCols>
cudaError_t launch_cols(const void* x, const void* wg, const void* wu,
                        const void* wd, void* out, int n_tokens, int D,
                        int F, cudaStream_t st) {
  // x rows and one chunk of h in shared memory: 36 KB at D = 1024, 80 KB
  // of x at D = 2560, 128 KB at D = 4096 (the opt-in covers up to 227 KB)
  const size_t smem = sizeof(float) * ((size_t)kRows * D + kRows * kFChunk);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_swiglu_kernel<T, kCols>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const int grid = (n_tokens + kRows - 1) / kRows;
  fused_swiglu_kernel<T, kCols><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<T*>(out), n_tokens, D, F);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* out, int n_tokens, int D, int F,
                   cudaStream_t st) {
  if (D <= 4 * kThreads)
    return launch_cols<T, 4>(x, wg, wu, wd, out, n_tokens, D, F, st);
  if (D <= 8 * kThreads)
    return launch_cols<T, 8>(x, wg, wu, wd, out, n_tokens, D, F, st);
  if (D <= 12 * kThreads)
    return launch_cols<T, 12>(x, wg, wu, wd, out, n_tokens, D, F, st);
  return launch_cols<T, 16>(x, wg, wu, wd, out, n_tokens, D, F, st);
}

}  // namespace

extern "C" int acar_fused_swiglu(const void* x, const void* wg,
                                 const void* wu, const void* wd, void* out,
                                 int n_tokens, int D, int F, int dtype,
                                 void* stream) {
  if (D > kMaxCols * kThreads) return (int)cudaErrorInvalidValue;
  if (n_tokens <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == acar::kBF16) {
    return (int)launch<__nv_bfloat16>(x, wg, wu, wd, out, n_tokens, D, F, st);
  }
  return (int)launch<float>(x, wg, wu, wd, out, n_tokens, D, F, st);
}
