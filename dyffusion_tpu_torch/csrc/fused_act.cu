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
// Design. A grid-stride loop over memory. Each thread moves VEC elements
// with one load and one store of VEC * sizeof(T) bytes: 16 where alignment,
// the element count and the channel stride allow (one channel per vector),
// narrower otherwise. Reads f32 or bf16, computes in f32, writes the input's
// type.
//
// What bounds it: bytes. It reads x once and writes out once (2 * numel *
// itemsize; the bias is C floats) and does a few operations per element.
//
// Plain C interface, loaded with ctypes; returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// VEC elements per thread and step; the caller guarantees that numel and
// (when there is a bias) cstride are multiples of VEC and that x and out are
// aligned to VEC * sizeof(T) bytes.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
fused_leaky_relu_kernel(const T* __restrict__ x, const float* __restrict__ bias, T* __restrict__ out,
                        int64_t n_vec, int64_t cstride, int C, float slope, float scale) {
  using R = typename Raw<VEC * sizeof(T)>::type;
  const R* xv = reinterpret_cast<const R*>(x);
  R* ov = reinterpret_cast<R*>(out);
  for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < n_vec;
       i += (int64_t)gridDim.x * THREADS) {
    const float b = bias ? bias[(i * VEC / cstride) % C] : 0.f;
    R raw = xv[i];
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float v = to_f32(e[j]) + b;
      v = v >= 0.f ? v : v * slope;
      from_f32(&e[j], v * scale);
    }
    ov[i] = raw;
  }
}

template <typename T, int VEC>
cudaError_t launch(const void* x, const float* bias, void* out, int64_t numel, int64_t cstride, int C,
                   float slope, float scale, cudaStream_t s) {
  const int64_t n_vec = numel / VEC;
  // enough blocks to fill the card several times over; the loop takes the rest
  const int64_t blocks = (n_vec + THREADS - 1) / THREADS;
  const unsigned grid = (unsigned)(blocks < 132 * 16 ? blocks : 132 * 16);
  fused_leaky_relu_kernel<T, VEC><<<grid, THREADS, 0, s>>>((const T*)x, bias, (T*)out, n_vec, cstride,
                                                           C, slope, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int vec, const void* x, const float* bias, void* out, int64_t numel,
                     int64_t cstride, int C, float slope, float scale, cudaStream_t s) {
  switch (vec) {
    case 1: return launch<T, 1>(x, bias, out, numel, cstride, C, slope, scale, s);
    case 2: return launch<T, 2>(x, bias, out, numel, cstride, C, slope, scale, s);
    case 4: return launch<T, 4>(x, bias, out, numel, cstride, C, slope, scale, s);
    case 8:  // 16 bytes of bf16; f32 stops at 4
      if constexpr (sizeof(T) == 2) return launch<T, 8>(x, bias, out, numel, cstride, C, slope, scale, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x and out: numel elements of one dense layout; bias: C floats or null;
// cstride: x's dim-1 stride; vec: elements per load, chosen by the caller.
extern "C" int fused_leaky_relu_launch(const void* x, const void* bias, void* out, int is_bf16,
                                       int64_t numel, int64_t cstride, int C, int vec, float slope,
                                       float scale, void* stream) {
  if (numel <= 0 || cstride <= 0 || C <= 0 || numel % vec != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* b = (const float*)bias;
  cudaError_t err = is_bf16
      ? dispatch<__nv_bfloat16>(vec, x, b, out, numel, cstride, C, slope, scale, s)
      : dispatch<float>(vec, x, b, out, numel, cstride, C, slope, scale, s);
  return (int)err;
}
