// Paged GQA decode attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/paged_decode_attention.py::paged_decode_attention
// (the Pallas TPU kernel: grid (B, KV, NB), one page per grid step, online
// softmax in VMEM scratch).
//
// Computes, for every row b and query head h = kv * G + g:
//   out[b, h] = softmax_s(q[b, h] . k[s] / sqrt(D)) @ v[s]
// over the key positions s < lengths[b] of the row, whose K/V live in pages
// k_pages/v_pages (P, page_size, KV, D) addressed through block_table (B, NB).
//
// What bounds it on the H100: bytes. One decode token reads every cached key
// and value of its row once and does 4*D flops per key and query head, far
// below the card's ~295 flop/byte ridge. At serving shapes (a few dozen rows,
// a hundred-odd positions) the call moves well under a megabyte, so latency
// bounds it: the launch, the block-table and K/V round trips, the combine.
//
// Design: decode_split.cuh's loop, one launch of a grid (kSplit, KV *
// G-tiles, B) in clusters of kSplit CTAs. A cluster serves one (row, kv
// head) with its G query heads (up to 8, 4 above head width 128; a
// larger G in tiles, each reading the kv head's keys), so each K/V byte
// is read once a tile and used by every head of it; its ranks
// split the row's positions by the row's own length and combine their
// partial softmax states over distributed shared memory in rank order. A
// CTA copies the page ids of its positions from the block table once per
// page, a window of 256 positions at a time, and translates positions to
// rows from them: only positions below lengths[b] are loaded, so spare
// block-table slots and stale bytes past the row's length are never read.
// Left for later: TMA page loads, and more rows per CTA where a row's
// range is shorter than a tile.
#include "decode_split.cuh"

namespace {

using acar::split::kSplit;
using acar::split::kThreads;

template <typename T, int GT, int kR>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
    paged_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ block_table,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, int G, int KV, int Dk,
                              int Dv, int page_size, int NB, float scale,
                              bool vec16) {
  const acar::split::HeadTile ht = acar::split::head_tile<GT>(G);
  const int kv = ht.kv, b = blockIdx.z;
  const int len = min(lengths[b], NB * page_size);
  acar::split::Rows<T, true> ld{k_pages + (size_t)kv * Dk,
                                v_pages + (size_t)kv * Dv,
                                (long long)KV * Dk, (long long)KV * Dv};
  ld.bt = block_table + (size_t)b * NB;
  ld.page_size = page_size;
  const size_t head0 = ((size_t)b * KV + kv) * G + ht.g0;
  acar::split::attend<T, GT, kR>(q + head0 * Dk, out + head0 * Dv, Dk, Dv,
                                 len, scale, vec16, ld, ht.n);
}

template <typename T, int GT, int kR>
struct Launch {
  static cudaError_t run(int G, const void* q, const void* k_pages,
                         const void* v_pages, const void* block_table,
                         const void* lengths, void* out, int B, int KV,
                         int Dk, int Dv, int page_size, int NB, float scale,
                         bool vec16, cudaStream_t st) {
    const int bytes = acar::split::Layout<T, T>(GT, Dk, Dv, true, kR).total;
    const cudaError_t err = acar::split::reserve_smem(
        paged_decode_split_kernel<T, GT, kR>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(kSplit, KV * ((G + GT - 1) / GT), B);
    paged_decode_split_kernel<T, GT, kR><<<grid, kThreads, bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), static_cast<const int*>(block_table),
        static_cast<const int*>(lengths), static_cast<T*>(out), G, KV, Dk,
        Dv, page_size, NB, scale, vec16);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int acar_paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* block_table, const void* lengths, void* out, int B, int H,
    int KV, int Dk, int Dv, int page_size, int NB, int dtype, void* stream) {
  if (!acar::split::heads_ok(B, H, KV, Dk, Dv))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV, D = Dk > Dv ? Dk : Dv;
  const float scale = 1.4426950408889634f / sqrtf((float)Dk);  // log2(e)
  const bool vec16 = acar::split::vec16(
      Dk, Dv, dtype == acar::kBF16 ? 2 : 4, q, k_pages, v_pages);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == acar::kBF16)
    return (int)acar::split::dispatch_g<Launch, __nv_bfloat16>(
        G, D, q, k_pages, v_pages, block_table, lengths, out, B, KV, Dk, Dv,
        page_size, NB, scale, vec16, st);
  return (int)acar::split::dispatch_g<Launch, float>(
      G, D, q, k_pages, v_pages, block_table, lengths, out, B, KV, Dk, Dv,
      page_size, NB, scale, vec16, st);
}

// the split's geometry as the kernels compute it, for checking the
// wrappers' split_ranges(): the CTAs of a row's cluster, and where rank
// r's key range starts in a row of len positions
extern "C" int acar_decode_split_ctas() { return kSplit; }

extern "C" int acar_decode_split_start(int len, int rank) {
  return acar::split::range_start(len < 0 ? 0 : len, rank);
}

extern "C" const char* acar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
