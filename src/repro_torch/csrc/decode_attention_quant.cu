// GQA decode attention over an int8-quantised contiguous KV cache, for
// Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention_quant.py::decode_attention_quant
// (the Pallas TPU kernel: grid (B, KV, S / block), int8 blocks widened on
// the VPU after the VMEM load, scales folded into the scores and the
// probabilities).
//
// Computes, for every row b and query head h = kv * G + g, over positions
// s < length of the int8 codes k/v (B, S, KV, D) and their float32
// per-vector scales (B, S, KV):
//   scores_s = (q[b, h] / sqrt(D) . k[b, s]) * k_scale[b, s]
//   out[b, h] = sum_s (softmax(scores)_s * v_scale[b, s]) * v[b, s]
// length is one scalar for the whole batch (the lockstep wave's pos + 1)
// and arrives as a launch argument, so a call copies nothing to the card.
//
// What bounds it on the H100: bytes — D + 4 bytes per cached vector and
// head (the codes and one f32 scale), about half of the bf16 cache's 2 * D
// at D 64 or more, far below the flop ridge; at serving shapes (a few dozen
// rows, a hundred-odd positions) the call moves about two megabytes, so
// latency bounds it: the launch, the K/V round trip and the combine.
//
// Design: decode_split.cuh's loop, as the bf16/f32 dense-cache decode
// (decode_attention.cu) runs it, with an int8 loader: one launch of a grid
// (kSplit, KV * G-tiles, B) in clusters of kSplit CTAs, each cluster one
// (row, kv head) with its G query heads (a G above 8 in tiles of 8; of 4
// above head width 128), its ranks splitting [0, length) by the length
// alone and combining over distributed shared memory in rank order.
// Codes go to shared memory by 16-byte cp.async (element by element
// where D is not a multiple of 16), a tile's scales by 4-byte cp.async
// beside them; a lane widens 8 codes in registers, and no dequantised copy
// of the cache exists anywhere. Any S works; positions at or past length
// are never read, codes and scales alike. Left for later: TMA tile loads,
// and more rows per CTA at short lengths.
#include "decode_split.cuh"

namespace {

using acar::split::kSplit;
using acar::split::kThreads;

// (kThreads, 1): without the second bound ptxas capped the dense G 6
// instantiation at 168 registers and spilled 16 bytes
template <typename TQ, int GT, int kR>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads, 1)
    dense_decode_quant_split_kernel(const TQ* __restrict__ q,
                                    const int8_t* __restrict__ k_codes,
                                    const float* __restrict__ k_scale,
                                    const int8_t* __restrict__ v_codes,
                                    const float* __restrict__ v_scale,
                                    TQ* __restrict__ out, int S, int G,
                                    int KV, int Dk, int Dv, int length,
                                    float scale, bool vec16) {
  const acar::split::HeadTile ht = acar::split::head_tile<GT>(G);
  const int kv = ht.kv, b = blockIdx.z;
  const size_t srow = (size_t)b * S * KV + kv;  // (row, kv head) index 0
  acar::split::Rows<int8_t, false> ld{k_codes + srow * Dk,
                                      v_codes + srow * Dv,
                                      (long long)KV * Dk, (long long)KV * Dv};
  ld.ks = k_scale + srow;
  ld.vs = v_scale + srow;
  ld.sstride = KV;
  const size_t head0 = ((size_t)b * KV + kv) * G + ht.g0;
  acar::split::attend<TQ, GT, kR>(q + head0 * Dk, out + head0 * Dv, Dk, Dv,
                                  length, scale, vec16, ld, ht.n);
}

template <typename TQ, int GT, int kR>
struct Launch {
  static cudaError_t run(int G, const void* q, const void* k_codes,
                         const void* k_scale, const void* v_codes,
                         const void* v_scale, void* out, int B, int S,
                         int KV, int Dk, int Dv, int length, float scale,
                         bool vec16, cudaStream_t st) {
    const int bytes =
        acar::split::Layout<TQ, int8_t>(GT, Dk, Dv, false, kR).total;
    const cudaError_t err = acar::split::reserve_smem(
        dense_decode_quant_split_kernel<TQ, GT, kR>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(kSplit, KV * ((G + GT - 1) / GT), B);
    dense_decode_quant_split_kernel<TQ, GT, kR>
        <<<grid, kThreads, bytes, st>>>(
        static_cast<const TQ*>(q), static_cast<const int8_t*>(k_codes),
        static_cast<const float*>(k_scale),
        static_cast<const int8_t*>(v_codes),
        static_cast<const float*>(v_scale), static_cast<TQ*>(out), S, G, KV,
        Dk, Dv, length, scale, vec16);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int acar_decode_attention_quant(
    const void* q, const void* k_codes, const void* k_scale,
    const void* v_codes, const void* v_scale, void* out, int B, int H, int KV,
    int Dk, int Dv, int S, int length, int dtype, void* stream) {
  if (!acar::split::heads_ok(B, H, KV, Dk, Dv) || length < 0 || length > S)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV, D = Dk > Dv ? Dk : Dv;
  const float scale = 1.4426950408889634f / sqrtf((float)Dk);  // log2(e)
  const bool vec16 = acar::split::vec16(Dk, Dv, 1, q, k_codes, v_codes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == acar::kBF16)
    return (int)acar::split::dispatch_g<Launch, __nv_bfloat16>(
        G, D, q, k_codes, k_scale, v_codes, v_scale, out, B, S, KV, Dk, Dv,
        length, scale, vec16, st);
  return (int)acar::split::dispatch_g<Launch, float>(
      G, D, q, k_codes, k_scale, v_codes, v_scale, out, B, S, KV, Dk, Dv,
      length, scale, vec16, st);
}
