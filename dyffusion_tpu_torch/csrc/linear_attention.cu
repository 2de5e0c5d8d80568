// 'qkv'-rescale linear attention for Hopper, sm_90a: kernel B3.
//
// Replaces dyffusion_tpu/ops/pallas_attention.py::_pallas_core_impl /
// _kernel (B3, on separate q, k, v of (BH, D, N), as heads = 1). q, k and v
// are three base pointers that share one set of element strides for the
// (batch, token, channel) axes; the output has its own. (B1 runs its own
// two-launch kernel, linear_attention_qkv.cu; ptxas holds this one at 61
// registers with no spill.)
// Per batch element b and head h:
//
//   q' = softmax_D(q[n, :]) * scale        (per token, over the head's D channels)
//   k' = softmax_N(k[:, d])                (per channel, over the N tokens)
//   v' = v / N
//   context[d, e] = sum_n k'[n, d] v'[n, e]             (D x D)
//   out[n, e]     = sum_d q'[n, d] context[d, e]
//
// Design. One thread block per (b, h). The TPU kernel computes all heads in
// one (h*D x h*D) block-diagonal product padded to 128 lanes; here a head is
// a block, nothing is padded in memory and the ragged last tile is masked.
//   Pass 1 walks the tokens in tiles of TILE_N. It keeps a running max and a
//   sum of exponentials per k-channel (online softmax, rescaled when the max
//   grows) and accumulates the D x D context in f32 registers, four entries
//   per thread.
//   The context is then scaled by scale / (sum * N) into shared memory.
//   Pass 2 walks the tokens again. One warp takes one token: lane d holds
//   q[n, d], the softmax over D is two shuffle reductions, and lane e sums
//   q'[n, d] * context[d, e] over d by shuffles. Outputs go through a shared
//   tile so that the store is coalesced for both layouts.
// Every tile is read and written through shared memory with the fastest
// varying thread index on the axis of stride 1 (tokens for the NCHW view of
// a 1x1-conv output, channels for the token-major layout), so both layouts
// move whole cache lines and no copy is needed on either side.
//
// What bounds it: bytes. At (BH, D, N) it reads q, k and v once and writes
// out once, 4 * BH * D * N elements, for 4 * BH * N * D * D f32 operations:
// at (480, 32, 3600) bf16 0.44 GB against 7.1 GFLOP, where the H100 would
// need ~295 FLOP per byte to be bound by its tensor cores. The arithmetic
// runs in f32 on the CUDA cores.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int D = 32;          // dim_head (one warp lane per channel)
constexpr int TILE_N = 64;     // tokens per shared-memory tile
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int LD = D + 1;      // padded row: no bank conflicts on column walks

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Copy a (nt x D) tile of channels [ch0, ch0 + D) starting at token n0 into
// tile[n][c] (f32). Tokens past nt are not touched.
template <typename T>
__device__ __forceinline__ void load_tile(float (*tile)[LD], const T* base, int n0, int nt,
                                          int64_t sn, int64_t sc, int ch0, bool tokens_fast) {
  for (int idx = threadIdx.x; idx < TILE_N * D; idx += THREADS) {
    int n, c;
    if (tokens_fast) { c = idx / TILE_N; n = idx % TILE_N; }
    else             { n = idx / D;      c = idx % D; }
    if (n < nt) tile[n][c] = to_f32(base[(int64_t)(n0 + n) * sn + (int64_t)(ch0 + c) * sc]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                        T* __restrict__ out, int N, int heads, int64_t sb, int64_t sn, int64_t sc,
                        int64_t ob, int64_t on, int64_t oc, float scale) {
  __shared__ float ks[TILE_N][LD];   // k tile, then exp(k - max); q tile in pass 2
  __shared__ float vs[TILE_N][LD];   // v tile; output tile in pass 2
  __shared__ float ctx[D][LD];       // context * scale / (sum * N)
  __shared__ float s_max[D], s_alpha[D], s_sum[D];

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x % heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const T* base = q + (int64_t)b * sb;
  T* obase = out + (int64_t)b * ob;
  const bool in_tokens_fast = sn == 1;
  const bool out_tokens_fast = on == 1;

  // ---- pass 1: online k-softmax statistics and the context ----
  // thread (lane = d, warp = e-block) owns context[d][4*warp .. 4*warp+3]
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  float run_max = -CUDART_INF_F, run_sum = 0.f;  // meaningful in warp 0 (lane = d)
  for (int n0 = 0; n0 < N; n0 += TILE_N) {
    const int nt = min(TILE_N, N - n0);
    load_tile(ks, k + (int64_t)b * sb, n0, nt, sn, sc, h * D, in_tokens_fast);
    load_tile(vs, v + (int64_t)b * sb, n0, nt, sn, sc, h * D, in_tokens_fast);
    __syncthreads();
    if (warp == 0) {
      float m = run_max;
      for (int n = 0; n < nt; ++n) m = fmaxf(m, ks[n][lane]);
      s_alpha[lane] = expf(run_max - m);  // 0 on the first tile (run_max = -inf)
      s_max[lane] = m;
      run_max = m;
    }
    __syncthreads();
    for (int idx = tid; idx < nt * D; idx += THREADS) {
      const int n = idx / D, c = idx % D;
      ks[n][c] = expf(ks[n][c] - s_max[c]);
    }
    __syncthreads();
    const float alpha = s_alpha[lane];
    const int e0 = warp * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] *= alpha;
    for (int n = 0; n < nt; ++n) {
      const float p = ks[n][lane];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] = fmaf(p, vs[n][e0 + j], acc[j]);
    }
    if (warp == 0) {
      float s = 0.f;
      for (int n = 0; n < nt; ++n) s += ks[n][lane];
      run_sum = run_sum * alpha + s;
    }
    __syncthreads();  // tiles are overwritten by the next iteration
  }
  if (warp == 0) s_sum[lane] = run_sum;
  __syncthreads();
  {
    const float f = scale / (s_sum[lane] * (float)N);
#pragma unroll
    for (int j = 0; j < 4; ++j) ctx[lane][warp * 4 + j] = acc[j] * f;
  }
  __syncthreads();

  // ---- pass 2: q-softmax per token times the context ----
  for (int n0 = 0; n0 < N; n0 += TILE_N) {
    const int nt = min(TILE_N, N - n0);
    load_tile(ks, base, n0, nt, sn, sc, h * D, in_tokens_fast);
    __syncthreads();
    for (int n = warp; n < nt; n += WARPS) {
      const float x = ks[n][lane];
      float m = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
      const float ex = expf(x - m);
      float s = ex;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float qp = ex / s;
      float y = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) y = fmaf(__shfl_sync(0xffffffffu, qp, d), ctx[d][lane], y);
      vs[n][lane] = y;
    }
    __syncthreads();
    for (int idx = tid; idx < TILE_N * D; idx += THREADS) {
      int n, c;
      if (out_tokens_fast) { c = idx / TILE_N; n = idx % TILE_N; }
      else                 { n = idx / D;      c = idx % D; }
      if (n < nt) from_f32(obase + (int64_t)(n0 + n) * on + (int64_t)(h * D + c) * oc, vs[n][c]);
    }
    __syncthreads();
  }
}

template <typename T>
void launch(const void* q, const void* k, const void* v, void* out, int B, int N, int heads, int64_t sb,
            int64_t sn, int64_t sc, int64_t ob, int64_t on, int64_t oc, float scale, cudaStream_t s) {
  dim3 grid((unsigned)(B * heads));
  linear_attention_kernel<T><<<grid, THREADS, 0, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, N, heads, sb, sn, sc, ob, on, oc, scale);
}

}  // namespace

// q, k, v (one layout) and out with their (batch, token, channel) element
// strides; head h reads channels [h*D, (h+1)*D) of each input and writes the
// same channels of out.
extern "C" int linear_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       int is_bf16, int B, int N, int heads, int dim_head, int64_t sb,
                                       int64_t sn, int64_t sc, int64_t ob, int64_t on, int64_t oc,
                                       float scale, void* stream) {
  if (dim_head != D || B <= 0 || N <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  if (q == nullptr || k == nullptr || v == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    launch<__nv_bfloat16>(q, k, v, out, B, N, heads, sb, sn, sc, ob, on, oc, scale, s);
  } else {
    launch<float>(q, k, v, out, B, N, heads, sb, sn, sc, ob, on, oc, scale, s);
  }
  return (int)cudaGetLastError();
}
