// The column-invariant projection for Hopper (sm_90a): out (M, N) =
// x (M, K) w (K, N), summed in f32 and rounded once to x's dtype
// (kernels/projection.py).
//
// Replaces no TPU kernel: the reference leaves its products against
// column-split weights (wq, wk, wv, the decode MLP's w_gate / w_up, an
// untied lm_head) to XLA. It is here for the serving mesh's bits. cuBLAS
// picks its kernel by shape, so a bf16 product over a column slice of w
// can round apart from the same columns of the unsliced product, and its
// choice by M can make a row's bits depend on its neighbours. Here every
// output element's sum runs in an order fixed by K alone.
//
// What bounds it on the H100: at a decode tick's 8 rows, bytes (w read
// once: 33.6 MB at (8, 4096, 4096) is 10 us at 3.35 TB/s); at a prefill
// chunk's hundreds of rows, the tensor cores and the L2 traffic of x read
// once a column tile.
//
// Design: one launch, split-K over a thread-block cluster, the pattern of
// decode_split.cuh.
// - Tiles. A cluster of kSplit CTAs serves one output tile of kCols
//   columns by kRows token rows (bf16; kF32Rows in f32), constants never
//   chosen from M or N; the ragged last tile is masked. Grid (kSplit,
//   ceil(N / kCols), ceil(M / rows)).
// - K ranges. Rank r sums K over [r * chunk, (r + 1) * chunk) clipped to
//   K, chunk = ceil(K / kSplit) rounded up to kKGran: a function of K
//   alone, so a column slice of w (same K) and a call on fewer rows take
//   the same ranges. An empty range contributes 0. kernels/projection.py
//   mirrors this as projection_plan(); acar_projection_plan reports it.
// - bf16 inside a rank. Thread 0 streams w (kKGran k-rows x kCols
//   columns a tile) and x (16-row boxes, only those of rows the tile has)
//   by TMA into a ring with the 128-byte swizzle, one mbarrier a stage.
//   Eight warps: warp w owns output columns 16 (w % 4) .. + 15 and
//   tokens 64 (w / 4) .. + 63 of the tile: mma.sync.m16n8k16 with the
//   weight on
//   the M side and the tokens on the N side ("swap AB": out^T = w^T x^T),
//   w's fragments by ldmatrix.trans from its row-major (K, N) tile, x's
//   by ldmatrix. A block of 16 tokens the tile does not have is skipped,
//   so a decode's 8 rows cost two mma a k-step and warp, and a token's
//   sums do not depend on which others exist.
// - Staging follows the rows the tile has, never its arithmetic: a stage
//   holds w's tile and the x boxes of the tile's rows, and the ring takes
//   as many stages as fit kRingBytes (2..kMaxStages), so a decode's small
//   stages leave room for many CTAs an SM. Every element's sum is the
//   same sequence of mma steps whatever the ring's depth.
// - f32 inside a rank (TF32 stays off: CUDA cores). 16 column quads x 8
//   k-lanes: a thread sums every 8th k of the rank's range for 4 columns
//   (one 16-byte load of w a k) and all kF32Rows rows, x's rows through
//   shared memory kXChunk values at a time; the k-lanes meet in lane
//   order in shared memory.
// - Combine. Each rank stores its f32 partials over distributed shared
//   memory into the inbox of the rank that owns the columns (rank r owns
//   columns 8r .. 8r + 7 of the tile); each rank adds the kSplit
//   partials of its columns in rank order 0..kSplit-1 and rounds once.
//   bf16: the inbox takes the drained ring's place behind a cluster
//   barrier, the senders arrive on the owner's mbarrier and the owner
//   waits for all of them; f32: two cluster barriers. No workspace in
//   device memory, no second kernel, no atomics.
#include "common.cuh"
#include "hopper.cuh"

#include <cooperative_groups.h>
#include <stdint.h>

#include <initializer_list>

namespace {

namespace hp = acar::hopper;
using bf16 = __nv_bfloat16;

constexpr int kSplit = 8;     // CTAs a cluster: the K ranges of a tile
constexpr int kKGran = 64;    // a range's length is a multiple of this
constexpr int kCols = 64;     // output columns a tile
constexpr int kOwn = kCols / kSplit;  // columns each rank finishes

// bf16
constexpr int kRows = 128;                   // token rows a tile
constexpr int kWarps = 8;                    // 4 column blocks x 2 halves
constexpr int kThreads = 32 * kWarps;
constexpr int kXBox = 16;                    // token rows a TMA box of x
constexpr int kWTile = kKGran * kCols * 2;   // 8 KB
constexpr int kXBoxBytes = kXBox * kKGran * 2;  // 2 KB
constexpr int kTok = kRows / 2;              // tokens a warp
constexpr int kRingBytes = 24 * 1024;        // the ring's budget
constexpr int kMaxStages = 8;

// f32
constexpr int kF32Rows = 8;
constexpr int kQuads = kCols / 4;            // 16 column quads
constexpr int kLanesK = 8;                   // k-lanes
constexpr int kF32Threads = kQuads * kLanesK;
constexpr int kXChunk = 256;

__host__ __device__ __forceinline__ int chunk_len(int K) {
  return ((K + kSplit - 1) / kSplit + kKGran - 1) / kKGran * kKGran;
}

// the first k of rank r's range (r = kSplit gives K)
__host__ __device__ __forceinline__ int range_start(int K, int r) {
  const long long s = (long long)r * chunk_len(K);
  return s < K ? (int)s : K;
}

// A bf16 CTA's staging for a tile of `rows` token rows (rows > 0) and
// ranks of up to n_k steps (rank 0's, the same in every CTA of a
// cluster): the x boxes a stage holds, a stage's bytes (w's tile and the
// boxes), the ring's depth, and the CTA's shared memory: the ring, which
// the inbox ([kSplit][kOwn][box_rows] floats) reuses once it is drained.
struct Staging {
  int nbox, stage_bytes, stages, total;
  __host__ __device__ Staging(int rows, int n_k) {
    nbox = (rows + kXBox - 1) / kXBox;
    stage_bytes = kWTile + nbox * kXBoxBytes;
    int s = kRingBytes / stage_bytes;
    s = s < 2 ? 2 : (s > kMaxStages ? kMaxStages : s);
    stages = n_k < s ? (n_k < 1 ? 1 : n_k) : s;
    const int inbox = kSplit * kOwn * nbox * kXBox * 4;
    total = stages * stage_bytes > inbox ? stages * stage_bytes : inbox;
  }
};

// warp w takes the 16 columns 16 (w % 4) .. + 15 of the tile and its
// kTok tokens from kTok (w / 4); rank r finishes columns kOwn r .. + 7
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
    projection_split_kernel(const __grid_constant__ CUtensorMap tm_x,
                            const __grid_constant__ CUtensorMap tm_w,
                            bf16* __restrict__ out, int M, int K, int N) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on one
  uint8_t* smem =
      smem_raw + ((1024 - (hp::smem_u32(smem_raw) & 1023)) & 1023);
  __shared__ uint64_t full[kMaxStages];
  __shared__ uint64_t inbox_full;  // every sender has delivered

  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int n0 = blockIdx.y * kCols, m0 = blockIdx.z * kRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wc = warp % 4, t0 = (warp / 4) * kTok;  // columns, tokens
  const int lo = range_start(K, rank), hi = range_start(K, rank + 1);
  const int n_k = (hi - lo + kKGran - 1) / kKGran;
  const int rows = min(kRows, M - m0);
  // the same staging in every CTA of the cluster: rank 0's range
  const Staging sg(rows, (range_start(K, 1) + kKGran - 1) / kKGran);
  const int box_rows = sg.nbox * kXBox;

  if (tid == 0) {
    asm volatile("prefetch.tensormap [%0];" ::"l"(&tm_w) : "memory");
    asm volatile("prefetch.tensormap [%0];" ::"l"(&tm_x) : "memory");
    for (int s = 0; s < sg.stages; ++s) hp::mbar_init(&full[s], 1);
    // every rank's threads of the two warps whose columns this rank owns
    hp::mbar_init(&inbox_full, kSplit * 64);
    hp::mbar_init_fence();
  }
  __syncthreads();
  auto issue = [&](int i) {
    const int s = i % sg.stages, k0 = lo + i * kKGran;
    uint8_t* st = smem + s * sg.stage_bytes;
    hp::mbar_arrive_expect_tx(&full[s], sg.stage_bytes);
    hp::tma_load_2d(st, &tm_w, &full[s], n0, k0);
    for (int b = 0; b < sg.nbox; ++b)
      hp::tma_load_2d(st + kWTile + b * kXBoxBytes, &tm_x, &full[s], k0,
                      m0 + b * kXBox);
  };
  if (tid == 0)
    for (int i = 0; i < min(sg.stages, n_k); ++i) issue(i);

  float acc[kTok / 8][4];
#pragma unroll
  for (int j = 0; j < kTok / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // ldmatrix row addresses: lane gives row lane % 8 of matrix lane / 8
  const int mi = lane / 8, ri = lane % 8;
  // blocks of 16 tokens of this warp's share that the tile has
  const int njp = (max(0, min(kTok, rows - t0)) + 15) / 16;
  for (int i = 0; i < n_k; ++i) {
    const int s = i % sg.stages;
    hp::mbar_wait(&full[s], (i / sg.stages) & 1);
    const uint8_t* ws = smem + s * sg.stage_bytes;
    const uint8_t* xs = ws + kWTile;
    if (njp > 0) {
#pragma unroll
      for (int kk = 0; kk < kKGran / 16; ++kk) {
        // A = w^T (16 columns x 16 of k) from w's [k][column] rows
        uint32_t a[4];
        const int kr = 16 * kk + 8 * (mi >> 1) + ri;
        const int cc = 2 * wc + (mi & 1);
        hp::ldmatrix_x4_trans(a, ws + kr * 128 + ((cc ^ (kr & 7)) << 4));
#pragma unroll
        for (int jp = 0; jp < kTok / 16; ++jp) {
          if (jp < njp) {
            // B = x^T (16 of k x 8 tokens), two token blocks
            uint32_t b[4];
            const int xr = t0 + 16 * jp + 8 * (mi >> 1) + ri;
            const int xc = 2 * kk + (mi & 1);
            hp::ldmatrix_x4(b, xs + xr * 128 + ((xc ^ (xr & 7)) << 4));
            hp::mma_bf16_16816(acc[2 * jp], a, b);
            hp::mma_bf16_16816(acc[2 * jp + 1], a, b + 2);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage s
    if (tid == 0 && i + sg.stages < n_k) issue(i + sg.stages);
  }

  // every rank is done with its ring, so the inboxes take its place;
  // acc[j] holds columns 16 wc + gq (+ 8) at tokens t0 + 8 j + 2 tq (+ 1)
  hp::cluster_arrive();
  hp::cluster_wait();
  float* inbox = reinterpret_cast<float*>(smem);
  const int gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int j = 0; j < kTok / 8; ++j) {
    if (t0 + 8 * j < rows) {
      const int t = t0 + 8 * j + 2 * tq;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        hp::st_cluster_v2(
            hp::cluster_map(inbox + (rank * kOwn + gq) * box_rows + t,
                            2 * wc + h),
            acc[j][2 * h], acc[j][2 * h + 1]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    hp::mbar_arrive_cluster(hp::cluster_map(&inbox_full, 2 * wc + h));

  // this rank's columns, one token a thread, the ranks added in order
  hp::mbar_wait_cluster(&inbox_full, 0);
  const int col = n0 + kOwn * rank;
  if (col >= N) return;
  for (int t = tid; t < rows; t += kThreads) {
    uint32_t packed[kOwn / 2];
#pragma unroll
    for (int c = 0; c < kOwn; c += 2) {
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float a = inbox[(c + e) * box_rows + t];
#pragma unroll
        for (int r = 1; r < kSplit; ++r)
          a += inbox[(r * kOwn + c + e) * box_rows + t];
        v[e] = a;
      }
      packed[c / 2] = hp::pack_bf16x2(v[0], v[1]);
    }
    *reinterpret_cast<uint4*>(out + (size_t)(m0 + t) * N + col) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }
}

// kVec4: N % 4 == 0 and w 16-byte aligned, so a quad loads in one go
template <bool kVec4>
__global__ void __cluster_dims__(kSplit, 1, 1)
    __launch_bounds__(kF32Threads)
    projection_split_f32_kernel(const float* __restrict__ x,
                                const float* __restrict__ w,
                                float* __restrict__ out, int M, int K,
                                int N) {
  __shared__ float xs[kF32Rows][kXChunk];
  __shared__ float part[kLanesK][kF32Rows][kCols];  // the k-lanes' sums
  __shared__ float inbox[kSplit * kOwn * kF32Rows];  // [rank][col][row]

  const int rank = (int)cooperative_groups::this_cluster().block_rank();
  const int n0 = blockIdx.y * kCols, m0 = blockIdx.z * kF32Rows;
  const int tid = threadIdx.x, quad = tid % kQuads, kl = tid / kQuads;
  const int lo = range_start(K, rank), hi = range_start(K, rank + 1);
  const int c0 = n0 + 4 * quad;
  const int rows = min(kF32Rows, M - m0);
  hp::cluster_arrive_relaxed();

  float acc[kF32Rows][4];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r)
    acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
  for (int k0 = lo; k0 < hi; k0 += kXChunk) {
    const int nk = min(kXChunk, hi - k0);
    __syncthreads();  // the previous chunk is read
    for (int i = tid; i < kF32Rows * nk; i += kF32Threads) {
      const int r = i / nk, k = i - r * nk;
      xs[r][k] = r < rows ? x[(size_t)(m0 + r) * K + k0 + k] : 0.f;
    }
    __syncthreads();
    // k-lane kl sums k = kl, kl + kLanesK, ... of the chunk, in order
    const float* wk = w + (size_t)k0 * N + c0;
#pragma unroll 4
    for (int k = kl; k < nk; k += kLanesK) {
      float wv[4];
      if (kVec4) {
        const float4 q = c0 < N ? __ldg(reinterpret_cast<const float4*>(
                                      wk + (size_t)k * N))
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        wv[0] = q.x;
        wv[1] = q.y;
        wv[2] = q.z;
        wv[3] = q.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wv[e] = c0 + e < N ? __ldg(wk + (size_t)k * N + e) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const float xv = xs[r][k];
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[r][e] = fmaf(xv, wv[e], acc[r][e]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[kl][r][4 * quad + e] = acc[r][e];
  __syncthreads();

  // this CTA's partial of each (row, column), its k-lanes in order, into
  // the inbox of the rank that owns the column
  hp::cluster_wait();
  for (int i = tid; i < kF32Rows * kCols; i += kF32Threads) {
    const int r = i / kCols, c = i % kCols;
    if (r >= rows) continue;
    float a = part[0][r][c];
#pragma unroll
    for (int l = 1; l < kLanesK; ++l) a += part[l][r][c];
    hp::st_cluster(
        hp::cluster_map(inbox + (rank * kOwn + c % kOwn) * kF32Rows + r,
                        c / kOwn),
        a);
  }
  hp::cluster_arrive();
  hp::cluster_wait();

  // this rank's columns, one element a thread, the ranks added in order
  if (tid < kOwn * kF32Rows) {
    const int r = tid / kOwn, c = tid % kOwn;
    const int col = n0 + kOwn * rank + c;
    if (r < rows && col < N) {
      float a = inbox[c * kF32Rows + r];
#pragma unroll
      for (int s = 1; s < kSplit; ++s)
        a += inbox[(s * kOwn + c) * kF32Rows + r];
      out[(size_t)(m0 + r) * N + col] = a;
    }
  }
}

}  // namespace

// out (M, N) = x (M, K) w (K, N), row-major and contiguous. bf16 needs K
// and N multiples of 8 and 16-byte-aligned tensors (TMA's row strides);
// the wrapper pads and copies to give it those. f32 takes any shape.
extern "C" int acar_projection(const void* x, const void* w, void* out,
                               int M, int K, int N, int dtype,
                               void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int col_tiles = (N + kCols - 1) / kCols;
  if (dtype != acar::kBF16) {
    const int row_tiles = (M + kF32Rows - 1) / kF32Rows;
    if (col_tiles > 65535 || row_tiles > 65535)
      return (int)cudaErrorInvalidValue;
    const dim3 grid(kSplit, col_tiles, row_tiles);
    const bool vec4 =
        N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
    if (vec4)
      projection_split_f32_kernel<true><<<grid, kF32Threads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), M, K, N);
    else
      projection_split_f32_kernel<false><<<grid, kF32Threads, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), M, K, N);
    return (int)cudaGetLastError();
  }
  const int row_tiles = (M + kRows - 1) / kRows;
  if (K % 8 != 0 || N % 8 != 0 || col_tiles > 65535 || row_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {x, w, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  cudaError_t err = hp::make_tmap_bf16(&mx, x, M, K, kXBox);
  if (err == cudaSuccess) err = hp::make_tmap_bf16(&mw, w, K, N, kKGran);
  if (err != cudaSuccess) return (int)err;
  // every CTA gets the most any of them stages: the first row tile's
  const int smem =
      Staging(M < kRows ? M : kRows,
              (range_start(K, 1) + kKGran - 1) / kKGran).total + 1024;
  // The limit is the kernel's, shared by every host thread (the
  // scheduler launches from a worker thread beside the main one), so it
  // is set to the most any call stages, never to this call's: a smaller
  // limit set by another thread between this one's set and launch would
  // refuse the launch.
  int most = 0;
  for (int rows = kXBox; rows <= kRows; rows += kXBox) {
    const int total = Staging(rows, 1 << 20).total;
    most = total > most ? total : most;
  }
  err = cudaFuncSetAttribute(projection_split_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most + 1024);
  if (err != cudaSuccess) return (int)err;
  projection_split_kernel<<<dim3(kSplit, col_tiles, row_tiles), kThreads,
                            smem, st>>>(mx, mw, static_cast<bf16*>(out), M,
                                        K, N);
  return (int)cudaGetLastError();
}

// The plan as the kernels compute it, for checking projection_plan():
// field 0 the CTAs of a cluster, 1 the K chunk, 2 a tile's columns, 3 and
// 4 its token rows in bf16 and f32, 5 the column tiles of N; 6 + r the
// first k of rank r's range (r = kSplit gives K). -1 for another field.
extern "C" int acar_projection_plan(int k, int n, int field) {
  switch (field) {
    case 0: return kSplit;
    case 1: return chunk_len(k);
    case 2: return kCols;
    case 3: return kRows;
    case 4: return kF32Rows;
    case 5: return (n + kCols - 1) / kCols;
    default:
      if (field >= 6 && field <= 6 + kSplit) return range_start(k, field - 6);
      return -1;
  }
}
