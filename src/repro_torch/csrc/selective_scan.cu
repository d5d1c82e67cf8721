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
// What bounds it on the H100: neither bytes nor flops, but the serial
// dependence along S. The work is B*S*D*N multiply-adds plus one exp each;
// the inputs are read once. Each thread owns one (b, d, n) state and walks
// S, so the card holds B*D*N independent chains (524,288 at falcon-mamba-7b's
// width with B = 4) and each step's latency (an exp, a dependent multiply
// and add, a shuffle reduction) is hidden only by other chains.
//
// Design. A CTA of 256 threads holds 256 / N channels; the N states of a
// channel sit in N neighbouring lanes of one warp, and y_t's sum over n is a
// butterfly of __shfl_xor in a fixed order (every lane ends with the same
// bits). The forward writes the state at every kChunk-th step (a checkpoint,
// B * ceil(S / kChunk) * D * N floats) and nothing else of the walk. The
// backward walks the chunks in reverse: it recomputes the chunk's states
// from its checkpoint into shared memory with the same rounded operations as
// the forward (so the bits equal the forward's), then steps back through the
// chunk carrying g_t = dy_t C_t + exp(dt_{t+1} A) g_{t+1}. dx and ddt are
// sums over n (the same butterfly). dB and dC are sums over d: each CTA sums
// its own channels in a fixed order into a per-CTA partial, and a second
// kernel adds the partials in CTA order. d a_log sums over (b, t): each
// thread keeps its own sum over t, and a third kernel adds over b. No
// atomics anywhere, so a rerun reproduces every bit.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;   // checkpoint interval; the backward's window

// operand type tags, one bit per input: x, dt, a_log, B, C
enum Operand : int { kX = 0, kDt = 1, kALog = 2, kB = 3, kC = 4 };

__host__ __device__ __forceinline__ bool is_bf16(int codes, int operand) {
  return (codes >> operand) & 1;
}

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

// One step of the recurrence, each operation rounded on its own as the
// plain version rounds it: h = exp(dt a) h + (dt x) b. The forward and the
// backward's recomputation share it, so their states agree bit for bit.
__device__ __forceinline__ float scan_step(float h, float dt, float x,
                                           float a, float b) {
  const float decay = expf(__fmul_rn(dt, a));
  return __fadd_rn(__fmul_rn(decay, h), __fmul_rn(__fmul_rn(dt, x), b));
}

// Sum over the n lanes of a channel (a power of two <= 32), fixed order.
__device__ __forceinline__ float group_sum(float v, int n_state) {
  for (int off = n_state >> 1; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Lane {
  int d, n, dd;     // channel, state, channel clamped into range for loads
  bool active;      // d < D
};

__device__ __forceinline__ Lane lane_of(int D, int N) {
  const int per_cta = kThreads / N;
  Lane l;
  l.d = blockIdx.x * per_cta + threadIdx.x / N;
  l.n = threadIdx.x % N;
  l.active = l.d < D;
  l.dd = l.active ? l.d : D - 1;
  return l;
}

__global__ void __launch_bounds__(kThreads)
    scan_fwd_kernel(const void* __restrict__ x, const void* __restrict__ dt,
                    const void* __restrict__ a_log,
                    const void* __restrict__ bm, const void* __restrict__ cm,
                    void* __restrict__ y, float* __restrict__ h_final,
                    float* __restrict__ ckpt, int S, int D, int N,
                    int codes) {
  const Lane l = lane_of(D, N);
  const int b = blockIdx.y;
  const int nc = (S + kChunk - 1) / kChunk;
  const float a =
      -expf(load(a_log, is_bf16(codes, kALog), (size_t)l.dd * N + l.n));
  const size_t row0 = (size_t)b * S;
  float h = 0.f;
  for (int t = 0; t < S; ++t) {
    if (t % kChunk == 0 && l.active)
      ckpt[(((size_t)b * nc + t / kChunk) * D + l.d) * N + l.n] = h;
    const size_t i = (row0 + t) * D + l.dd;
    const size_t j = (row0 + t) * N + l.n;
    h = scan_step(h, load(dt, is_bf16(codes, kDt), i),
                  load(x, is_bf16(codes, kX), i), a,
                  load(bm, is_bf16(codes, kB), j));
    const float yv =
        group_sum(__fmul_rn(h, load(cm, is_bf16(codes, kC), j)), N);
    if (l.active && l.n == 0) store(y, is_bf16(codes, kX), i, yv);
  }
  if (l.active) h_final[((size_t)b * D + l.d) * N + l.n] = h;
}

__global__ void __launch_bounds__(kThreads)
    scan_bwd_kernel(const void* __restrict__ x, const void* __restrict__ dt,
                    const void* __restrict__ a_log,
                    const void* __restrict__ bm, const void* __restrict__ cm,
                    const float* __restrict__ ckpt,
                    const void* __restrict__ dy,
                    const float* __restrict__ dh_final,
                    void* __restrict__ dx, void* __restrict__ ddt,
                    float* __restrict__ da_part, float* __restrict__ db_part,
                    float* __restrict__ dc_part, int S, int D, int N,
                    int codes) {
  __shared__ float hs[kChunk * kThreads];   // states, then dy_t h_t
  __shared__ float vb[kChunk * kThreads];   // g_t dt_t x_t
  const Lane l = lane_of(D, N);
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int nc = (S + kChunk - 1) / kChunk;
  const int per_cta = kThreads / N;
  const int n_cta = gridDim.x;
  const bool bx = is_bf16(codes, kX), bdt = is_bf16(codes, kDt);
  const bool bb = is_bf16(codes, kB), bc = is_bf16(codes, kC);
  const float a =
      -expf(load(a_log, is_bf16(codes, kALog), (size_t)l.dd * N + l.n));
  const size_t row0 = (size_t)b * S;
  // an inactive lane carries g = 0, so it adds nothing to any sum
  float carry = (l.active && dh_final != nullptr)
                    ? dh_final[((size_t)b * D + l.d) * N + l.n]
                    : 0.f;
  float da_acc = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, t1 = min(S, t0 + kChunk);
    const float h0 =
        l.active ? ckpt[(((size_t)b * nc + c) * D + l.d) * N + l.n] : 0.f;
    float h = h0;
    for (int t = t0; t < t1; ++t) {
      const size_t i = (row0 + t) * D + l.dd;
      h = scan_step(h, load(dt, bdt, i), load(x, bx, i), a,
                    load(bm, bb, (row0 + t) * N + l.n));
      hs[(t - t0) * kThreads + tid] = h;
    }
    for (int t = t1 - 1; t >= t0; --t) {
      const size_t i = (row0 + t) * D + l.dd;
      const size_t j = (row0 + t) * N + l.n;
      const float xv = load(x, bx, i), dtv = load(dt, bdt, i);
      const float bv = load(bm, bb, j), cv = load(cm, bc, j);
      const float dyv = l.active ? load(dy, bx, i) : 0.f;
      const float h_t = hs[(t - t0) * kThreads + tid];
      const float h_prev = t > t0 ? hs[(t - 1 - t0) * kThreads + tid] : h0;
      const float decay = expf(__fmul_rn(dtv, a));
      const float g = fmaf(dyv, cv, carry);
      const float dx_v = group_sum(g * dtv * bv, N);
      const float ddt_v =
          group_sum(g * (xv * bv + h_prev * decay * a), N);
      da_acc = fmaf(g * h_prev, decay * dtv, da_acc);
      carry = decay * g;
      hs[(t - t0) * kThreads + tid] = dyv * h_t;   // h_t is spent
      vb[(t - t0) * kThreads + tid] = g * dtv * xv;
      if (l.active && l.n == 0) {
        store(dx, bx, i, dx_v);
        store(ddt, bdt, i, ddt_v);
      }
    }
    __syncthreads();
    // this CTA's share of dB and dC: its channels summed in order
    const int steps = t1 - t0;
    for (int k = tid; k < steps * N; k += kThreads) {
      const int tt = k / N, nn = k % N;
      float sb = 0.f, sc = 0.f;
      for (int ch = 0; ch < per_cta; ++ch) {
        sc += hs[tt * kThreads + ch * N + nn];
        sb += vb[tt * kThreads + ch * N + nn];
      }
      const size_t o = ((row0 + t0 + tt) * n_cta + blockIdx.x) * N + nn;
      dc_part[o] = sc;
      db_part[o] = sb;
    }
    __syncthreads();
  }
  if (l.active) da_part[((size_t)b * D + l.d) * N + l.n] = da_acc;
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

}  // namespace

extern "C" int acar_selective_scan_chunk() { return kChunk; }

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
  const dim3 grid((D + kThreads / N - 1) / (kThreads / N), B);
  scan_fwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dt, a_log, bm, cm, y, static_cast<float*>(h_final),
      static_cast<float*>(ckpt), S, D, N, codes);
  return (int)cudaGetLastError();
}

// The gradients of the forward above. dy (B, S, D) in x's type; dh_final
// (B, D, N) f32 or null (no gradient reaches h_final). Writes dx, ddt,
// dbm, dcm, da_log in their inputs' types. Scratch: da_part (B, D, N),
// db_part and dc_part (B, S, n_cta, N), all f32, where n_cta is
// acar_selective_scan_ctas(D, N).
extern "C" int acar_selective_scan_ctas(int D, int N) {
  if (!valid_state_dim(N)) return -1;
  return (D + kThreads / N - 1) / (kThreads / N);
}

extern "C" int acar_selective_scan_bwd(
    const void* x, const void* dt, const void* a_log, const void* bm,
    const void* cm, const void* ckpt, const void* dy, const void* dh_final,
    void* dx, void* ddt, void* da_log, void* dbm, void* dcm, void* da_part,
    void* db_part, void* dc_part, int B, int S, int D, int N, int codes,
    void* stream) {
  if (!valid_state_dim(N)) return (int)cudaErrorInvalidValue;
  if (B <= 0 || S <= 0 || D <= 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_cta = acar_selective_scan_ctas(D, N);
  scan_bwd_kernel<<<dim3(n_cta, B), kThreads, 0, st>>>(
      x, dt, a_log, bm, cm, static_cast<const float*>(ckpt), dy,
      static_cast<const float*>(dh_final), dx, ddt,
      static_cast<float*>(da_part), static_cast<float*>(db_part),
      static_cast<float*>(dc_part), S, D, N, codes);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)B * S;
  const int blocks = (int)((rows * N + kThreads - 1) / kThreads);
  sum_parts_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(db_part), dbm, is_bf16(codes, kB), rows,
      n_cta, N);
  sum_parts_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(dc_part), dcm, is_bf16(codes, kC), rows,
      n_cta, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t dn = (size_t)D * N;
  alog_grad_kernel<<<(int)((dn + kThreads - 1) / kThreads), kThreads, 0,
                     st>>>(static_cast<const float*>(da_part), a_log, da_log,
                           is_bf16(codes, kALog), B, dn);
  return (int)cudaGetLastError();
}
