// Paged GQA decode attention over int8-quantised KV pages, for Hopper
// (sm_90a).
//
// Replaces:
// src/repro/kernels/paged_decode_attention_quant.py::paged_decode_attention_quant
// (the Pallas TPU kernel: grid (B, KV, NB), one page per grid step through
// the scalar-prefetched block table, int8 pages widened on the VPU, scales
// folded into the scores and the probabilities).
//
// Computes, for every row b and query head h = kv * G + g, over the
// positions s < lengths[b] of the row, whose int8 codes live in pages
// k_pages/v_pages (P, page_size, KV, D) and whose float32 per-vector scales
// live in k_scale_pages/v_scale_pages (P, page_size, KV), all addressed
// through block_table (B, NB):
//   scores_s = (q[b, h] / sqrt(D) . k_s) * k_scale_s
//   out[b, h] = sum_s (softmax(scores)_s * v_scale_s) * v_s
//
// What bounds it on the H100: bytes — D + 4 bytes per cached vector and
// head (the codes and one f32 scale), about half of the bf16 pages' 2 * D
// at D 64 or more, far below the flop ridge. At serving shapes (a few dozen
// rows, a hundred-odd positions) the call moves well under a megabyte, so
// latency bounds it: the launch, the block-table and K/V round trips, the
// combine.
//
// Design: decode_split.cuh's loop, as the bf16/f32 paged decode
// (paged_decode_attention.cu) runs it, with an int8 loader: one launch of
// a grid (kSplit, KV * G-tiles, B) in clusters of kSplit CTAs, a cluster
// one (row, kv head) with its G query heads (a G above 8 in tiles of 8;
// of 4 above head width 128), its ranks splitting the row's positions by
// the row's own length and combining in rank order over distributed
// shared memory. Codes go to shared memory by 16-byte cp.async (element
// by element where D is not a multiple of 16), a tile's scales by 4-byte
// cp.async beside them; a lane widens 8 codes in registers. Only positions
// below lengths[b] are loaded, codes and scales alike: spare block-table
// slots and stale slots past a row's length are never read. Device memory
// sees only codes and scales; no dequantised copy of the cache exists.
// Left for later: TMA page loads, and more rows per CTA where a row's
// range is shorter than a tile.
#include "decode_split.cuh"

namespace {

using acar::split::kSplit;
using acar::split::kThreads;

// (kThreads, 1), as decode_attention_quant.cu has it (there ptxas spilled
// the G 6 instantiation without the second bound)
template <typename TQ, int GT, int kR>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
    paged_decode_quant_split_kernel(const TQ* __restrict__ q,
                                    const int8_t* __restrict__ k_pages,
                                    const float* __restrict__ k_scale,
                                    const int8_t* __restrict__ v_pages,
                                    const float* __restrict__ v_scale,
                                    const int* __restrict__ block_table,
                                    const int* __restrict__ lengths,
                                    TQ* __restrict__ out, int G, int KV,
                                    int Dk, int Dv, int page_size, int NB,
                                    float scale, bool vec16) {
  const acar::split::HeadTile ht = acar::split::head_tile<GT>(G);
  const int kv = ht.kv, b = blockIdx.z;
  const int len = min(lengths[b], NB * page_size);
  acar::split::Rows<int8_t, true> ld{k_pages + (size_t)kv * Dk,
                                     v_pages + (size_t)kv * Dv,
                                     (long long)KV * Dk, (long long)KV * Dv};
  ld.ks = k_scale + kv;
  ld.vs = v_scale + kv;
  ld.sstride = KV;
  ld.bt = block_table + (size_t)b * NB;
  ld.page_size = page_size;
  const size_t head0 = ((size_t)b * KV + kv) * G + ht.g0;
  acar::split::attend<TQ, GT, kR>(q + head0 * Dk, out + head0 * Dv, Dk, Dv,
                                  len, scale, vec16, ld, ht.n);
}

template <typename TQ, int GT, int kR>
struct Launch {
  static cudaError_t run(int G, const void* q, const void* k_pages,
                         const void* k_scale, const void* v_pages,
                         const void* v_scale, const void* block_table,
                         const void* lengths, void* out, int B, int KV,
                         int Dk, int Dv, int page_size, int NB, float scale,
                         bool vec16, cudaStream_t st) {
    const int bytes =
        acar::split::Layout<TQ, int8_t>(GT, Dk, Dv, true, kR).total;
    const cudaError_t err = acar::split::reserve_smem(
        paged_decode_quant_split_kernel<TQ, GT, kR>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(kSplit, KV * ((G + GT - 1) / GT), B);
    paged_decode_quant_split_kernel<TQ, GT, kR>
        <<<grid, kThreads, bytes, st>>>(
        static_cast<const TQ*>(q), static_cast<const int8_t*>(k_pages),
        static_cast<const float*>(k_scale),
        static_cast<const int8_t*>(v_pages),
        static_cast<const float*>(v_scale),
        static_cast<const int*>(block_table),
        static_cast<const int*>(lengths), static_cast<TQ*>(out), G, KV, Dk,
        Dv, page_size, NB, scale, vec16);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int acar_paged_decode_attention_quant(
    const void* q, const void* k_pages, const void* k_scale,
    const void* v_pages, const void* v_scale, const void* block_table,
    const void* lengths, void* out, int B, int H, int KV, int Dk, int Dv,
    int page_size, int NB, int dtype, void* stream) {
  if (!acar::split::heads_ok(B, H, KV, Dk, Dv))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV, D = Dk > Dv ? Dk : Dv;
  const float scale = 1.4426950408889634f / sqrtf((float)Dk);  // log2(e)
  const bool vec16 = acar::split::vec16(Dk, Dv, 1, q, k_pages, v_pages);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == acar::kBF16)
    return (int)acar::split::dispatch_g<Launch, __nv_bfloat16>(
        G, D, q, k_pages, k_scale, v_pages, v_scale, block_table, lengths,
        out, B, KV, Dk, Dv, page_size, NB, scale, vec16, st);
  return (int)acar::split::dispatch_g<Launch, float>(
      G, D, q, k_pages, k_scale, v_pages, v_scale, block_table, lengths, out,
      B, KV, Dk, Dv, page_size, NB, scale, vec16, st);
}
