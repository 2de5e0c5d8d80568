// Fused bias + LeakyReLU with gain (B2) for Hopper, sm_90a.
//
// Replaces dyffusion_tpu/ops/fused_act.py::_pallas_fused_leaky_relu (its
// inner `kernel`):
//
//   out = leaky_relu(x + bias[channel], slope) * scale
//
// with the bias broadcast over the channel axis, dim 1 (NCHW), as the
// original reference's fused_bias_act op does. x is any dense tensor (every
// axis order, e.g. NCHW or channels-last); out has x's strides, so element j
// of memory in x and in out is the same logical element, and its channel is
// (j / cstride) % C, cstride being x's dim-1 stride.
//
// What bounds it: bytes. It reads x once and writes out once (2 * numel *
// itemsize; the bias is C floats) and does a few operations per element.
//
// Design. Each block of 256 threads takes UNROLL * 256 consecutive vectors
// (one per thread at a time, UNROLL loads in flight per thread) and exits:
// the hardware hands the next block to whichever SM frees first, so no
// grid size has to match the occupancy that the registers allow.
// - Loads and stores are VEC * sizeof(T) bytes: 16 whenever x and out are
//   both 16-byte aligned, whatever the shape and layout. A vector may span
//   channels; numel need not be a multiple of VEC (block 0 takes the last
//   numel % VEC elements one by one). Only a base pointer off alignment
//   narrows the width.
// - No divide. The channel of a vector's first element comes from two
//   multiply-shift divides (by cstride, then by C; constants from the
//   caller), once per vector. Where cstride >= VEC (NCHW at the path
//   shapes) a vector meets at most one channel boundary: the elements
//   before the split point take the first channel's bias, the rest the
//   next one's. A shorter run walks the vector element by element.
//   Channels-last with C % VEC == 0 (cstride == 1) needs only the divide
//   by C: a vector's VEC channels are consecutive, and their bias entries
//   are read as float4s.
// - Reads f32 or bf16, computes in f32, writes the input's type.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // vectors per thread, all loaded before the first store

// how the bias is found: none; walk the runs of cstride elements; or
// channels-last with C % VEC == 0 (consecutive channels per vector)
enum Mode { NO_BIAS = 0, RUNS = 1, CHANNELS_LAST = 2 };

// n / d for 0 <= n < 2^63 as (umulhi(n, m) + n) >> s, with s = ceil(log2 d)
// and m = ceil(2^(64 + s) / d) - 2^64 (which fits in 64 bits); d = 1 is
// m = 0, s = 0. The caller computes m and s.
struct Divisor {
  uint64_t m;
  int s;
};
__device__ __forceinline__ uint64_t divide(uint64_t n, Divisor d) { return (__umul64hi(n, d.m) + n) >> d.s; }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

struct Params {
  const float* bias;
  int64_t numel, cstride;
  int C;
  Divisor by_cstride, by_c;
  float slope, scale;
};

__device__ __forceinline__ float act(float v, const Params& p) { return (v >= 0.f ? v : v * p.slope) * p.scale; }

// b[t] = the bias of element j + t, t < VEC
template <int MODE, int VEC>
__device__ __forceinline__ void bias_of(uint64_t j, const Params& p, float (&b)[VEC]) {
  if constexpr (MODE == NO_BIAS) {
#pragma unroll
    for (int t = 0; t < VEC; ++t) b[t] = 0.f;
  } else if constexpr (MODE == CHANNELS_LAST) {
    const int c = (int)(j - divide(j, p.by_c) * p.C);  // a multiple of VEC: j is, and so is C
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int t = 0; t < VEC; t += 4) {
        const float4 f = *reinterpret_cast<const float4*>(p.bias + c + t);  // the caller aligns the bias to 16 bytes
        b[t] = f.x; b[t + 1] = f.y; b[t + 2] = f.z; b[t + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) b[t] = p.bias[c + t];
    }
  } else {
    const uint64_t run = divide(j, p.by_cstride);
    int64_t r = (int64_t)(j - run * (uint64_t)p.cstride);  // position in the run of cstride elements
    int c = (int)(run - divide(run, p.by_c) * p.C);
    float bc = p.bias[c];
    if (p.cstride >= VEC) {  // at most one boundary: elements from `left` on are the next channel's
      const int64_t left = p.cstride - r;
      const float next = left < VEC ? p.bias[c + 1 == p.C ? 0 : c + 1] : bc;
#pragma unroll
      for (int t = 0; t < VEC; ++t) b[t] = t < left ? bc : next;
    } else {
#pragma unroll
      for (int t = 0; t < VEC; ++t) {
        b[t] = bc;
        if (t + 1 < VEC && ++r == p.cstride) {  // the next element starts the next channel's run
          r = 0;
          c = c + 1 == p.C ? 0 : c + 1;
          bc = p.bias[c];
        }
      }
    }
  }
}

// VEC elements per load and store; x and out are aligned to VEC *
// sizeof(T) bytes (the caller guarantees it)
template <typename T, int VEC, int MODE>
__global__ void __launch_bounds__(THREADS)
fused_leaky_relu_kernel(const T* __restrict__ x, T* __restrict__ out, Params p) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  const R* xv = reinterpret_cast<const R*>(x);
  R* ov = reinterpret_cast<R*>(out);
  const int64_t n_vec = p.numel / VEC;
  const int64_t i0 = (int64_t)blockIdx.x * (THREADS * UNROLL) + threadIdx.x;  // this thread's first vector
  R raw[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u)
    if (i0 + u * THREADS < n_vec) raw[u] = xv[i0 + u * THREADS];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const int64_t i = i0 + u * THREADS;
    if (i < n_vec) {
      float b[VEC];
      bias_of<MODE, VEC>((uint64_t)i * VEC, p, b);
      T* e = reinterpret_cast<T*>(&raw[u]);
#pragma unroll
      for (int t = 0; t < VEC; ++t) from_f32(&e[t], act(to_f32(e[t]) + b[t], p));
      ov[i] = raw[u];
    }
  }
  // the last numel % VEC elements, one per thread of block 0
  const int64_t j = n_vec * VEC + threadIdx.x;
  if (blockIdx.x == 0 && j < p.numel) {
    float b[1];
    bias_of<MODE == NO_BIAS ? NO_BIAS : RUNS, 1>((uint64_t)j, p, b);
    from_f32(&out[j], act(to_f32(x[j]) + b[0], p));
  }
}

template <typename T, int VEC, int MODE>
cudaError_t launch(const void* x, void* out, const Params& p, cudaStream_t s) {
  const int64_t blocks = (p.numel / VEC + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (blocks > 0x7fffffff) return cudaErrorInvalidValue;  // the grid's x limit
  fused_leaky_relu_kernel<T, VEC, MODE><<<(unsigned)(blocks < 1 ? 1 : blocks), THREADS, 0, s>>>((const T*)x, (T*)out, p);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t by_mode(int mode, const void* x, void* out, const Params& p, cudaStream_t s) {
  switch (mode) {
    case NO_BIAS: return launch<T, VEC, NO_BIAS>(x, out, p, s);
    case RUNS: return launch<T, VEC, RUNS>(x, out, p, s);
    case CHANNELS_LAST: return launch<T, VEC, CHANNELS_LAST>(x, out, p, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t by_width(int vec, int mode, const void* x, void* out, const Params& p, cudaStream_t s) {
  switch (vec) {
    case 1: return by_mode<T, 1>(mode, x, out, p, s);
    case 2: return by_mode<T, 2>(mode, x, out, p, s);
    case 4: return by_mode<T, 4>(mode, x, out, p, s);
    case 8:  // 16 bytes of bf16; f32 stops at 4
      if constexpr (sizeof(T) == 2) return by_mode<T, 8>(mode, x, out, p, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x and out: numel elements of one dense layout, aligned to vec elements;
// bias: C floats (16-byte aligned for mode 2) or null (mode 0); cstride:
// x's dim-1 stride; (cstride_m, cstride_s) and (c_m, c_s): the divisors of
// cstride and C (see Divisor); mode: 0 no bias, 1 any layout, 2 cstride == 1
// and C % vec == 0.
extern "C" int fused_leaky_relu_launch(const void* x, const void* bias, void* out, int is_bf16, int vec, int mode,
                                       int64_t numel, int64_t cstride, int C, uint64_t cstride_m, int cstride_s,
                                       uint64_t c_m, int c_s, float slope, float scale, void* stream) {
  if (numel <= 0 || cstride <= 0 || C <= 0 || (mode != NO_BIAS) != (bias != nullptr) ||
      (mode == CHANNELS_LAST && (cstride != 1 || C % vec != 0)))
    return (int)cudaErrorInvalidValue;
  const Params p{(const float*)bias, numel, cstride, C, {cstride_m, cstride_s}, {c_m, c_s}, slope, scale};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? by_width<__nv_bfloat16>(vec, mode, x, out, p, s) : by_width<float>(vec, mode, x, out, p, s));
}
