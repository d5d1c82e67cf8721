// GQA decode attention over a contiguous KV cache, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention (the
// Pallas TPU kernel: grid (B, KV, S / BLOCK_S), one 512-key block per grid
// step, online softmax in VMEM scratch, caches off the block grid padded).
//
// Computes, for every row b and query head h = kv * G + g:
//   out[b, h] = softmax_s(q[b, h] . k[b, s] / sqrt(D)) @ v[b, s]
// over the positions s < length of k_cache/v_cache (B, S, KV, D). length is
// one scalar for the whole batch (the lockstep wave's pos + 1) and arrives
// as a launch argument, so a call copies nothing to the card.
//
// What bounds it on the H100: bytes. A decode token reads each cached key
// and value of its row once and does 4*D flops per key and query head, far
// below the card's ~295 flop/byte ridge; at serving shapes (a few dozen
// rows, a hundred-odd positions) the call moves a few megabytes at most, so
// latency bounds it: the launch, the K/V round trip and the combine.
//
// Design: decode_split.cuh's loop, one launch of a grid (kSplit, KV *
// G-tiles, B) in clusters of kSplit CTAs, each cluster one (row, kv head)
// with its G query heads (a G above 8 in tiles of 8; of 4 above head
// width 128), its ranks splitting [0, length) by the length alone and
// combining over distributed shared memory in rank order. Any S works
// (no padding to a block grid); positions at or past length are never
// read. Left for
// later: TMA tile loads, and more rows per CTA at short lengths.
#include "decode_split.cuh"

namespace {

using acar::split::kSplit;
using acar::split::kThreads;

template <typename T, int GT, int kR>
__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__(kThreads)
    dense_decode_split_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_cache,
                              const T* __restrict__ v_cache,
                              T* __restrict__ out, int S, int G, int KV,
                              int Dk, int Dv, int length, float scale,
                              bool vec16) {
  const acar::split::HeadTile ht = acar::split::head_tile<GT>(G);
  const int kv = ht.kv, b = blockIdx.z;
  const size_t row = (size_t)b * S * KV + kv;  // (row, kv head) index 0
  const acar::split::Rows<T, false> ld{k_cache + row * Dk,
                                       v_cache + row * Dv,
                                       (long long)KV * Dk, (long long)KV * Dv};
  const size_t head0 = ((size_t)b * KV + kv) * G + ht.g0;
  acar::split::attend<T, GT, kR>(q + head0 * Dk, out + head0 * Dv, Dk, Dv,
                                 length, scale, vec16, ld, ht.n);
}

template <typename T, int GT, int kR>
struct Launch {
  static cudaError_t run(int G, const void* q, const void* k_cache,
                         const void* v_cache, void* out, int B, int S,
                         int KV, int Dk, int Dv, int length, float scale,
                         bool vec16, cudaStream_t st) {
    const int bytes =
        acar::split::Layout<T, T>(GT, Dk, Dv, false, kR).total;
    const cudaError_t err = acar::split::reserve_smem(
        dense_decode_split_kernel<T, GT, kR>, bytes);
    if (err != cudaSuccess) return err;
    const dim3 grid(kSplit, KV * ((G + GT - 1) / GT), B);
    dense_decode_split_kernel<T, GT, kR><<<grid, kThreads, bytes, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_cache),
        static_cast<const T*>(v_cache), static_cast<T*>(out), S, G, KV, Dk,
        Dv, length, scale, vec16);
    return cudaGetLastError();
  }
};

}  // namespace

extern "C" int acar_decode_attention(const void* q, const void* k_cache,
                                     const void* v_cache, void* out, int B,
                                     int H, int KV, int Dk, int Dv, int S,
                                     int length, int dtype, void* stream) {
  if (!acar::split::heads_ok(B, H, KV, Dk, Dv) || length < 0 || length > S)
    return (int)cudaErrorInvalidValue;
  const int G = H / KV, D = Dk > Dv ? Dk : Dv;
  const float scale = 1.4426950408889634f / sqrtf((float)Dk);  // log2(e)
  const bool vec16 = acar::split::vec16(
      Dk, Dv, dtype == acar::kBF16 ? 2 : 4, q, k_cache, v_cache);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == acar::kBF16)
    return (int)acar::split::dispatch_g<Launch, __nv_bfloat16>(
        G, D, q, k_cache, v_cache, out, B, S, KV, Dk, Dv, length, scale,
        vec16, st);
  return (int)acar::split::dispatch_g<Launch, float>(
      G, D, q, k_cache, v_cache, out, B, S, KV, Dk, Dv, length, scale, vec16,
      st);
}
