// 'qkv'-rescale linear attention for Hopper, sm_90a: kernels B1 and B3.
//
// Replaces dyffusion_tpu/ops/pallas_attention.py::_pallas_qkv / _qkv_kernel
// (the pl.pallas_call at :181) on the to_qkv projection (B, N, 3*heads*D):
// q, k and v are the channel ranges [0, hD), [hD, 2hD) and [2hD, 3hD) of
// one tensor. Also kernel B3, _pallas_core_impl / _kernel (the
// pl.pallas_call at :293), on separate q, k, v of (BH, D, N): the same
// function with B = BH, heads = 1, tokens at the (BH, D, N) tensors' dim-2
// stride and channels at their dim-1 stride. The kernels read q, k and v
// from three base pointers of one layout (one tensor's strides): B1 passes
// qkv, qkv + hD*sc and qkv + 2hD*sc, B3 its three tensors. Per batch
// element b and head h:
//
//   q' = softmax_D(q[n, :]) * scale        (per token, over the head's D channels)
//   k' = softmax_N(k[:, d])                (per channel, over the N tokens)
//   v' = v / N
//   context[d, e] = sum_n k'[n, d] v'[n, e]             (D x D)
//   out[n, e]     = sum_d q'[n, d] context[d, e]
//
// What bounds it: bytes. It reads q, k and v once and writes out once; at
// (B, N, 3hD) = (120, 3600, 384) bf16 that is 0.44 GB, 0.132 ms at 3.35 TB/s,
// against 7.1 GFLOP of f32 work, 0.106 ms on the CUDA cores at 67 TFLOP/s.
// The arithmetic runs in f32 on the CUDA cores in both dtypes.
//
// Two launches per call:
//
// 1. Partial pass, grid (B*heads, S), 256 threads. Block (bh, s) walks one
//    contiguous chunk of whole 64-token tiles and writes, in f32, the
//    chunk's per-channel max m[d], its sum of exponentials l[d] and the
//    unnormalised context C[d][e] = sum_n exp(k[n,d] - m[d]) v[n,e] to a
//    workspace the caller allocates. S splits N so that the grid fills the
//    card; one block no longer walks all N tokens of its (b, h) alone.
//    - Loads: the widest vector (2-16 bytes) that the base pointers, the
//      strides and N allow, chosen once per call by the caller, copied
//      with cp.async (4-16 bytes) into a double-buffered staging tile in
//      the input's layout and dtype, so the next tile's copy overlaps this
//      tile's work. No divide in the address arithmetic but by constants.
//    - Statistics: warp w takes tokens [8w, 8w+8) of the tile, lane d
//      channel d; the eight warps' maxima meet in shared memory, each
//      exponential is computed once, and each warp keeps its own running
//      sum (one rescale factor per tile serves all warps).
//    - Context: each thread owns a 4x4 block of C for one quarter of the
//      tile's tokens and reads p and v as float4 from padded f32 tiles:
//      8 shared loads per 64 FMAs.
//    - Two barriers per tile.
// 2. Merge-and-output pass, grid (B*heads, S'), 128 threads. Each block
//    merges the S partials of its (b, h) in shared memory (M = max_s m_s,
//    L = sum_s l_s e^{m_s - M}, ctx = sum_s C_s e^{m_s - M} * scale /
//    (L N)), then takes its token range with one thread per token: the
//    token's 32 q channels go to registers (in the NCHW view neighbouring
//    threads read neighbouring tokens), the softmax runs in registers, and
//    the 32 outputs come from ctx read as float4 broadcasts; no shuffles.
//    Stores are direct and coalesced when tokens are the output's stride-1
//    axis (the NCHW view, and B3's (BH, D, N) output whatever its inputs'
//    layout), else through a shared tile, one token's channels per warp
//    store.
//
// Split across ranks (spatial sharding: each rank of a model group holds
// some of the N tokens). The entry points run the passes one at a time:
// the partial pass over the rank's tokens (linear_attention_qkv_partials),
// then a merge of its S chunks (linear_attention_qkv_merge: first each
// (b, h, d)'s maximum m over the chunks; the caller takes the global
// maximum M over the ranks; then, in a second call, one partial per (b, h)
// with l and C rescaled by e^{m_s - M} and summed over the chunks, its
// m set to 0: the sum over ranks of such partials is the global one), and,
// once the caller has summed that partial over the ranks, the output pass
// over the rank's tokens with S = 1 and the global N in its v / N
// (linear_attention_qkv_output).
//
// Plain C interface, loaded with ctypes; returns the first CUDA error of
// the launches (cudaGetLastError() after each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int D = 32;                   // dim_head
constexpr int TILE_N = 64;              // tokens per tile of the partial pass
constexpr int THREADS = 256;            // partial pass: 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int SLICE = TILE_N / WARPS;   // tokens per warp in the statistics: 8
constexpr int LDP = TILE_N + 4;         // f32 p / v tile row: 16-byte rows, float4 columns spread over banks
constexpr int PART = D * D + 2 * D;     // floats per partial: C[D][D], m[D], l[D]
constexpr int OUT_THREADS = 128;        // output pass: one thread per token
constexpr int LDO = D + 1;              // output tile row: no bank conflicts

static_assert(SLICE == 8 && THREADS == 4 * 64, "the statistics and the 4x4 context blocks assume 8 warps of 8 tokens");
static_assert(4 * D * D <= 2 * D * LDP, "the four token groups' contexts must fit in the p and v tiles");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int BYTES> struct Raw;
template <> struct Raw<16> { using type = uint4; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<2> { using type = unsigned short; };

// staging tile of one of k, v in the input dtype: [channel][token] rows of
// LD elements when tokens are the fast axis (16-byte rows, padded by 16
// bytes so that lanes reading one channel row each hit other banks), else
// [token][channel] rows of D elements
template <typename T> struct Stage {
  static constexpr int LD = TILE_N + 16 / (int)sizeof(T);
  static constexpr int ELEMS = D * LD;
  static constexpr int BYTES = ELEMS * (int)sizeof(T);
};

template <typename T>
constexpr int partial_smem() {
  return 4 * Stage<T>::BYTES + (2 * D * LDP + WARPS * D + D) * (int)sizeof(float);
}

// v, opaque to the compiler at each use: a stride multiplied into several
// addresses inside a loop is then not hoisted out of it as one 64-bit
// register per address
__device__ __forceinline__ int64_t opaque(int64_t v) {
  asm volatile("mov.b64 %0, %0;" : "+l"(v));
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src));
  } else {
    static_assert(BYTES == 4, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory"); }

// One thread's share of copying a 64-token tile of one head's D channels
// into a staging tile: copy i reads head + n0 * sn + off + i * step and
// writes the staging tile at dst + i * ROW_STEP * ROW_LEN, VEC elements
// along the fast axis (stride 1 there when VEC > 1; the caller guarantees
// alignment and, when tokens are fast, N % VEC == 0). Tokens past N are not
// copied; the statistics mask them. One offset and one step per thread keep
// the copies' addresses out of the registers the context needs.
template <typename T, int VEC, bool TOKENS_FAST>
struct TileCopy {
  static constexpr int BYTES = VEC * (int)sizeof(T);
  static constexpr int PER_ROW = (TOKENS_FAST ? TILE_N : D) / VEC;  // copies per staging row
  static constexpr int ROW_STEP = THREADS / PER_ROW;                // rows between one thread's copies
  static constexpr int ITEMS = TILE_N * D / VEC / THREADS;          // copies per thread
  static constexpr int ROW_LEN = TOKENS_FAST ? Stage<T>::LD : D;
  using R = typename Raw<BYTES>::type;

  int64_t off, step;
  int dst, n;  // staging offset and tile token of this thread's first copy

  __device__ __forceinline__ TileCopy(int64_t sn, int64_t sc) {
    const int row = threadIdx.x / PER_ROW, col = threadIdx.x % PER_ROW * VEC;
    n = TOKENS_FAST ? col : row;
    off = (int64_t)n * sn + (int64_t)(TOKENS_FAST ? row : col) * sc;
    step = (int64_t)ROW_STEP * (TOKENS_FAST ? sc : sn);
    dst = row * ROW_LEN + col;
  }

  __device__ __forceinline__ void operator()(T* tile, const T* head, int n0, int N, int64_t sn) const {
    const T* g = head + (int64_t)n0 * sn + off;
    T* d = tile + dst;
    R held[BYTES < 4 ? ITEMS : 1];  // 2-byte copies: plain loads, all issued before the stores
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      if (n0 + n + (TOKENS_FAST ? 0 : i * ROW_STEP) < N) {
        if constexpr (BYTES >= 4) {
          cp_async<BYTES>(d + i * ROW_STEP * ROW_LEN, g + i * step);
        } else {
          held[i] = *reinterpret_cast<const R*>(g + i * step);
        }
      }
    }
    if constexpr (BYTES < 4) {
#pragma unroll
      for (int i = 0; i < ITEMS; ++i)
        if (n0 + n + (TOKENS_FAST ? 0 : i * ROW_STEP) < N) *reinterpret_cast<R*>(d + i * ROW_STEP * ROW_LEN) = held[i];
    }
  }
};

// x[j] = staged element (token 8 * warp + j, channel lane), as f32
template <typename T, bool TOKENS_FAST>
__device__ __forceinline__ void read_slice(const T* st, int lane, int warp, float (&x)[SLICE]) {
  if constexpr (TOKENS_FAST) {
    const T* p = st + lane * Stage<T>::LD + warp * SLICE;
    if constexpr (sizeof(T) == 4) {
      const float4 a = ld4(reinterpret_cast<const float*>(p)), b = ld4(reinterpret_cast<const float*>(p) + 4);
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w; x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
    } else {
      const uint4 r = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        x[2 * i] = f.x;
        x[2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < SLICE; ++j) x[j] = to_f32(st[(warp * SLICE + j) * D + lane]);
  }
}

// resident blocks per SM that the partial kernel's registers are held to:
// 3 (80 registers) with vector copies; one-element copies keep more
// addresses and values in flight, spill there and get 2 (128 registers)
template <int VEC>
constexpr int partial_min_blocks() { return VEC == 1 ? 2 : 3; }

template <typename T, int VEC, bool TOKENS_FAST>
__global__ void __launch_bounds__(THREADS, partial_min_blocks<VEC>())
linear_attention_qkv_partial_kernel(const T* __restrict__ k_all, const T* __restrict__ v_all, float* __restrict__ ws,
                                    int N, int heads, int64_t sb, int64_t sn, int64_t sc) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* stage = reinterpret_cast<T*>(smem);  // [buffer 0, 1][k, v][Stage<T>::ELEMS]
  float* ps = reinterpret_cast<float*>(smem + 4 * Stage<T>::BYTES);  // p = exp(k - max), [d][token]
  float* vs = ps + D * LDP;                                           // v, [e][token]
  float* s_max = vs + D * LDP;                                        // [warp][d]
  float* s_alpha = s_max + WARPS * D;                                 // [d]

  const int bh = blockIdx.x, b = bh / heads, h = bh % heads;
  const int tiles = (N + TILE_N - 1) / TILE_N;
  const int per = (tiles + gridDim.y - 1) / gridDim.y;
  const int t_begin = blockIdx.y * per, t_end = min(tiles, t_begin + per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = tid >> 6, dblk = (tid >> 3) & 7, eblk = tid & 7;  // context: tokens [16 grp, 16 grp + 16)
  const int64_t head = (int64_t)b * sb + (int64_t)h * D * sc;  // (b, h)'s first channel
  const T* kbase = k_all + head;
  const T* vbase = v_all + head;
  const TileCopy<T, VEC, TOKENS_FAST> load_tile(sn, sc);

  float run_max = -CUDART_INF_F;  // of channel lane; the same in every warp
  float run_sum = 0.f;            // of channel lane, over this warp's tokens
  float acc[4][4];                // C[dblk + 8i][eblk + 8j], over this group's tokens
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  if (t_begin < t_end) {
    load_tile(stage, kbase, t_begin * TILE_N, N, sn);
    load_tile(stage + Stage<T>::ELEMS, vbase, t_begin * TILE_N, N, sn);
    cp_async_commit();
    if (t_begin + 1 < t_end) {
      load_tile(stage + 2 * Stage<T>::ELEMS, kbase, (t_begin + 1) * TILE_N, N, sn);
      load_tile(stage + 3 * Stage<T>::ELEMS, vbase, (t_begin + 1) * TILE_N, N, sn);
    }
    cp_async_commit();
    cp_async_wait<1>();  // the first tile
    __syncthreads();
  }
  for (int t = t_begin; t < t_end; ++t) {
    T* kst = stage + 2 * ((t - t_begin) & 1) * Stage<T>::ELEMS;
    T* vst = kst + Stage<T>::ELEMS;
    const int nt = min(TILE_N, N - t * TILE_N);  // tokens of this tile
    // statistics: this warp's 8 tokens of channel lane, then all warps'
    float x[SLICE];
    read_slice<T, TOKENS_FAST>(kst, lane, warp, x);
    float m = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < SLICE; ++j)
      if (warp * SLICE + j < nt) m = fmaxf(m, x[j]);
    s_max[warp * D + lane] = m;
    __syncthreads();  // barrier 1: every warp's maximum
#pragma unroll
    for (int w = 0; w < WARPS; ++w) m = fmaxf(m, s_max[w * D + lane]);
    const float new_max = fmaxf(run_max, m);
    const float alpha = expf(run_max - new_max);  // 0 on the first tile (run_max = -inf)
    run_max = new_max;
    float v[SLICE];
    read_slice<T, TOKENS_FAST>(vst, lane, warp, v);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < SLICE; ++j) {
      const bool ok = warp * SLICE + j < nt;
      x[j] = ok ? expf(x[j] - new_max) : 0.f;
      v[j] = ok ? v[j] : 0.f;
      sum += x[j];
    }
    run_sum = fmaf(run_sum, alpha, sum);
    float* pr = ps + lane * LDP + warp * SLICE;
    float* vr = vs + lane * LDP + warp * SLICE;
    st4(pr, x[0], x[1], x[2], x[3]);
    st4(pr + 4, x[4], x[5], x[6], x[7]);
    st4(vr, v[0], v[1], v[2], v[3]);
    st4(vr + 4, v[4], v[5], v[6], v[7]);
    if (warp == 0) s_alpha[lane] = alpha;
    cp_async_wait<0>();  // the next tile
    __syncthreads();     // barrier 2: p, v, alpha and the next tile are in; this staging buffer is free
    if (t + 2 < t_end) {
      load_tile(kst, kbase, (t + 2) * TILE_N, N, sn);
      load_tile(vst, vbase, (t + 2) * TILE_N, N, sn);
    }
    cp_async_commit();
    // context: rescale by alpha, then this group's 16 tokens
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = s_alpha[dblk + 8 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= a;
    }
#pragma unroll
    for (int k4 = 0; k4 < 16; k4 += 4) {
      const int n = grp * 16 + k4;
      float4 vv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = ld4(vs + (eblk + 8 * j) * LDP + n);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 p = ld4(ps + (dblk + 8 * i) * LDP + n);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(p.w, vv[j].w, fmaf(p.z, vv[j].z, fmaf(p.y, vv[j].y, fmaf(p.x, vv[j].x, acc[i][j]))));
      }
    }
  }

  // the chunk's partial: the four groups' contexts, the eight warps' sums
  __syncthreads();  // the last tile's p and v are read
  float* red = ps;  // [group][d][e]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[grp * D * D + (dblk + 8 * i) * D + eblk + 8 * j] = acc[i][j];
  s_max[warp * D + lane] = run_sum;
  __syncthreads();
  float* part = ws + ((int64_t)bh * gridDim.y + blockIdx.y) * PART;
  {
    const int idx = tid * 4;  // THREADS * 4 = D * D
    float4 c = ld4(red + idx);
#pragma unroll
    for (int g = 1; g < 4; ++g) {
      const float4 r = ld4(red + g * D * D + idx);
      c.x += r.x; c.y += r.y; c.z += r.z; c.w += r.w;
    }
    *reinterpret_cast<float4*>(part + idx) = c;
  }
  if (warp == 0) {
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) l += s_max[w * D + lane];
    part[D * D + lane] = run_max;  // -inf for an empty chunk
    part[D * D + D + lane] = l;
  }
}

// x[c] = q[c] of one token, c < D; VEC > 1: channels at stride 1, read
// VEC at a time
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* row, int64_t sc, float (&x)[D]) {
  if constexpr (VEC == 1) {
    const int64_t step = opaque(sc);
#pragma unroll
    for (int c = 0; c < D; ++c) x[c] = to_f32(row[c * step]);
  } else {
    using R = typename Raw<VEC * sizeof(T)>::type;
#pragma unroll
    for (int c = 0; c < D; c += VEC) {
      R raw = *reinterpret_cast<const R*>(row + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[c + j] = to_f32(e[j]);
    }
  }
}

// VEC: elements per q load along the channels (1 when tokens are the fast
// axis: neighbouring threads then read neighbouring tokens)
// resident blocks per SM that the output kernel's registers are held to:
// 5 (96 registers) in bf16; f32 spills there and gets 4 (128 registers)
template <typename T>
constexpr int output_min_blocks() { return sizeof(T) == 2 ? 5 : 4; }

template <typename T, int VEC>
__global__ void __launch_bounds__(OUT_THREADS, output_min_blocks<T>())
linear_attention_qkv_output_kernel(const T* __restrict__ q, const float* __restrict__ ws, T* __restrict__ out,
                                   int N, int heads, int S, int64_t sb, int64_t sn, int64_t sc, int64_t ob,
                                   int64_t on, int64_t oc, int n_norm, float scale) {
  __shared__ __align__(16) float ctx[D * D];
  __shared__ float tile[OUT_THREADS * LDO];
  const int bh = blockIdx.x, b = bh / heads, h = bh % heads, tid = threadIdx.x;

  // merge the S partials of (b, h): thread owns ctx[d][e0 .. e0 + 7]
  {
    const float* part = ws + (int64_t)bh * S * PART;
    const int d = tid >> 2, e0 = (tid & 3) * 8;
    float M = -CUDART_INF_F;
    for (int s = 0; s < S; ++s) M = fmaxf(M, part[s * PART + D * D + d]);
    float c[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    float L = 0.f;
    for (int s = 0; s < S; ++s) {
      const float* p = part + s * PART;
      const float m = p[D * D + d];
      const float w = m == -CUDART_INF_F ? 0.f : expf(m - M);  // an empty chunk has no tokens
      L = fmaf(p[D * D + D + d], w, L);
      const float4 a = ld4(p + d * D + e0), r = ld4(p + d * D + e0 + 4);
      c[0] = fmaf(w, a.x, c[0]); c[1] = fmaf(w, a.y, c[1]); c[2] = fmaf(w, a.z, c[2]); c[3] = fmaf(w, a.w, c[3]);
      c[4] = fmaf(w, r.x, c[4]); c[5] = fmaf(w, r.y, c[5]); c[6] = fmaf(w, r.z, c[6]); c[7] = fmaf(w, r.w, c[7]);
    }
    const float f = scale / (L * (float)n_norm);  // v / N with the N of every rank's tokens
    st4(ctx + d * D + e0, c[0] * f, c[1] * f, c[2] * f, c[3] * f);
    st4(ctx + d * D + e0 + 4, c[4] * f, c[5] * f, c[6] * f, c[7] * f);
  }
  __syncthreads();

  const int units = (N + OUT_THREADS - 1) / OUT_THREADS;
  const int per = (units + gridDim.y - 1) / gridDim.y * OUT_THREADS;
  const int n_begin = blockIdx.y * per, n_end = min(N, n_begin + per);
  const T* qbase = q + (int64_t)b * sb + (int64_t)h * D * sc;
  T* obase = out + (int64_t)b * ob + (int64_t)h * D * oc;
  for (int n0 = n_begin; n0 < n_end; n0 += OUT_THREADS) {
    const int n = n0 + tid;
    if (n < n_end) {
      float x[D];  // q, then softmax_D(q)
      load_row<T, VEC>(qbase + (int64_t)n * sn, sc, x);
      float m = x[0];
#pragma unroll
      for (int c = 1; c < D; ++c) m = fmaxf(m, x[c]);
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        x[c] = expf(x[c] - m);
        s += x[c];
      }
      const float inv = 1.f / s;
#pragma unroll
      for (int c = 0; c < D; ++c) x[c] *= inv;
      // the outputs in two halves of D / 2, each stored before the next:
      // fewer values live at once
#pragma unroll
      for (int e0 = 0; e0 < D; e0 += D / 2) {
        float y[D / 2];
#pragma unroll
        for (int e = 0; e < D / 2; ++e) y[e] = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) {
#pragma unroll
          for (int e = 0; e < D / 2; e += 4) {
            const float4 cc = ld4(ctx + d * D + e0 + e);  // the same address in every lane: a broadcast
            y[e] = fmaf(x[d], cc.x, y[e]);
            y[e + 1] = fmaf(x[d], cc.y, y[e + 1]);
            y[e + 2] = fmaf(x[d], cc.z, y[e + 2]);
            y[e + 3] = fmaf(x[d], cc.w, y[e + 3]);
          }
        }
        if (on == 1) {  // tokens fast in out: each store instruction covers 32 neighbouring tokens
#pragma unroll
          for (int e = 0; e < D / 2; ++e) from_f32(obase + (int64_t)(e0 + e) * oc + n, y[e]);
        } else {
#pragma unroll
          for (int e = 0; e < D / 2; ++e) tile[tid * LDO + e0 + e] = y[e];
        }
      }
    }
    if (on != 1) {  // through shared memory: each warp store covers one token's D channels
      __syncthreads();
      for (int i = tid; i < OUT_THREADS * D; i += OUT_THREADS) {
        const int t = i / D, e = i % D;
        if (n0 + t < n_end) from_f32(obase + (int64_t)(n0 + t) * on + (int64_t)e * oc, tile[t * LDO + e]);
      }
      __syncthreads();
    }
  }
}

struct Args {
  const void *q, *k, *v;
  void* out;
  float* ws;
  int B, N, heads;
  int64_t sb, sn, sc, ob, on, oc;
  int S, S2;
  int n_norm;  // the N of v / N: N, or all ranks' tokens when split
  int passes;  // 1: partial pass, 2: output pass, 3: both
  float scale;
  cudaStream_t stream;
};

// occupancy == nullptr: launch both kernels; else write their blocks per SM
template <typename T, int VEC, bool TOKENS_FAST>
cudaError_t run(const Args& a, int* occupancy) {
  constexpr int OUT_VEC = TOKENS_FAST ? 1 : VEC;
  constexpr int smem = partial_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(linear_attention_qkv_partial_kernel<T, VEC, TOKENS_FAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (occupancy != nullptr) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occupancy[0], linear_attention_qkv_partial_kernel<T, VEC, TOKENS_FAST>, THREADS, smem);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occupancy[1], linear_attention_qkv_output_kernel<T, OUT_VEC>, OUT_THREADS, 0);
  }
  if (a.passes & 1) {
    linear_attention_qkv_partial_kernel<T, VEC, TOKENS_FAST><<<dim3(a.B * a.heads, a.S), THREADS, smem, a.stream>>>(
        (const T*)a.k, (const T*)a.v, a.ws, a.N, a.heads, a.sb, a.sn, a.sc);
    err = cudaGetLastError();
    if (err != cudaSuccess || !(a.passes & 2)) return err;
  }
  linear_attention_qkv_output_kernel<T, OUT_VEC><<<dim3(a.B * a.heads, a.S2), OUT_THREADS, 0, a.stream>>>(
      (const T*)a.q, a.ws, (T*)a.out, a.N, a.heads, a.S, a.sb, a.sn, a.sc, a.ob, a.on, a.oc, a.n_norm, a.scale);
  return cudaGetLastError();
}

template <typename T, bool TOKENS_FAST>
cudaError_t by_width(int vec, const Args& a, int* occupancy) {
  switch (vec) {
    case 1: return run<T, 1, TOKENS_FAST>(a, occupancy);
    case 2: return run<T, 2, TOKENS_FAST>(a, occupancy);
    case 4: return run<T, 4, TOKENS_FAST>(a, occupancy);
    case 8:  // 16 bytes of bf16; f32 stops at 4
      if constexpr (sizeof(T) == 2) return run<T, 8, TOKENS_FAST>(a, occupancy);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(int is_bf16, int vec, int tokens_fast, const Args& a, int* occupancy) {
  if (is_bf16) {
    return tokens_fast ? by_width<__nv_bfloat16, true>(vec, a, occupancy)
                       : by_width<__nv_bfloat16, false>(vec, a, occupancy);
  }
  return tokens_fast ? by_width<float, true>(vec, a, occupancy) : by_width<float, false>(vec, a, occupancy);
}

}  // namespace

// q, k, v: the base pointers of the three (B, N, heads*D) inputs, of one
// layout with (batch, token, channel) element strides sb, sn, sc; out (B,
// N, heads*D) with its own strides; ws: B*heads*S*(D*D + 2*D) floats of
// scratch. vec: elements per load along the fast axis (tokens when
// tokens_fast, else channels), chosen by the caller so that every vector of
// all three inputs is aligned and lies in one row. S: chunks per (b, h) of
// the partial pass; S2: blocks per (b, h) of the output pass.
extern "C" int linear_attention_qkv_launch(const void* q, const void* k, const void* v, void* out, void* ws,
                                           int is_bf16, int vec, int tokens_fast, int B, int N, int heads,
                                           int dim_head, int64_t sb, int64_t sn, int64_t sc, int64_t ob, int64_t on,
                                           int64_t oc, int S, int S2, float scale, void* stream) {
  if (dim_head != D || B <= 0 || N <= 0 || heads <= 0 || S <= 0 || S2 <= 0 || S > 65535 || S2 > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, (float*)ws, B, N, heads, sb, sn, sc, ob, on, oc, S, S2, N, 3, scale, (cudaStream_t)stream};
  return (int)dispatch(is_bf16, vec, tokens_fast, a, nullptr);
}

// blocks_per_sm[0], [1]: resident blocks per SM of the partial and the
// output kernel of the instantiation a launch with these arguments runs
extern "C" int linear_attention_qkv_occupancy(int is_bf16, int vec, int tokens_fast, int* blocks_per_sm) {
  const Args a{};
  return (int)dispatch(is_bf16, vec, tokens_fast, a, blocks_per_sm);
}

// The partial pass alone over (B, N, heads*D) k and v (the base pointers of
// linear_attention_qkv_launch): ws receives B*heads*S partials.
extern "C" int linear_attention_qkv_partials(const void* k, const void* v, void* ws, int is_bf16, int vec,
                                             int tokens_fast, int B, int N, int heads, int dim_head, int64_t sb,
                                             int64_t sn, int64_t sc, int S, void* stream) {
  if (dim_head != D || B <= 0 || N <= 0 || heads <= 0 || S <= 0 || S > 65535) return (int)cudaErrorInvalidValue;
  const Args a{nullptr, k, v, nullptr, (float*)ws, B, N, heads, sb, sn, sc, 0, 0, 0, S, 1, N, 1, 0.f,
               (cudaStream_t)stream};
  return (int)dispatch(is_bf16, vec, tokens_fast, a, nullptr);
}

// The output pass alone: ws holds one partial per (b, h) (S = 1 after a
// merge), n_norm the N of v / N.
extern "C" int linear_attention_qkv_output(const void* q, void* out, const void* ws, int is_bf16, int vec,
                                           int tokens_fast, int B, int N, int heads, int dim_head, int64_t sb,
                                           int64_t sn, int64_t sc, int64_t ob, int64_t on, int64_t oc, int S,
                                           int S2, int n_norm, float scale, void* stream) {
  if (dim_head != D || B <= 0 || N <= 0 || heads <= 0 || S <= 0 || S2 <= 0 || S2 > 65535 || n_norm <= 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, nullptr, nullptr, out, (float*)ws, B, N, heads, sb, sn, sc, ob, on, oc, S, S2, n_norm, 2, scale,
               (cudaStream_t)stream};
  return (int)dispatch(is_bf16, vec, tokens_fast, a, nullptr);
}

namespace {

constexpr int MERGE_THREADS = D * D / 4;  // 4 context elements per thread

// Block bh of the merge over the S chunk partials of one (b, h) in ws.
// M == nullptr: maxima[bh][d] = max_s m_s[d]. Else, with M the maxima over
// every rank: merged[bh] = the partial of the rank's tokens at M, C[d][e]
// and l[d] times e^{m_s[d] - M[d]} summed over the chunks (an empty chunk,
// m = -inf, adds nothing), its m 0.
__global__ void __launch_bounds__(MERGE_THREADS)
linear_attention_qkv_merge_kernel(const float* __restrict__ ws, int S, const float* __restrict__ M,
                                  float* __restrict__ maxima, float* __restrict__ merged) {
  const int bh = blockIdx.x, tid = threadIdx.x;
  const float* part = ws + (int64_t)bh * S * PART;
  if (M == nullptr) {
    if (tid < D) {
      float m = -CUDART_INF_F;
      for (int s = 0; s < S; ++s) m = fmaxf(m, part[s * PART + D * D + tid]);
      maxima[bh * D + tid] = m;
    }
    return;
  }
  float* dst = merged + (int64_t)bh * PART;
  const int idx = tid * 4, d = idx / D;  // four elements of row d of C
  const float Md = M[bh * D + d];
  float4 c = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < S; ++s) {
    const float m = part[s * PART + D * D + d];
    const float w = m == -CUDART_INF_F ? 0.f : expf(m - Md);
    const float4 r = ld4(part + s * PART + idx);
    c.x = fmaf(w, r.x, c.x); c.y = fmaf(w, r.y, c.y); c.z = fmaf(w, r.z, c.z); c.w = fmaf(w, r.w, c.w);
  }
  *reinterpret_cast<float4*>(dst + idx) = c;
  if (tid < D) {
    const float Mt = M[bh * D + tid];
    float l = 0.f;
    for (int s = 0; s < S; ++s) {
      const float m = part[s * PART + D * D + tid];
      l = fmaf(part[s * PART + D * D + D + tid], m == -CUDART_INF_F ? 0.f : expf(m - Mt), l);
    }
    dst[D * D + tid] = 0.f;
    dst[D * D + D + tid] = l;
  }
}

}  // namespace

// ws: BH*S partials of the partial pass. M == nullptr: write each (b, h,
// d)'s maximum over the chunks to maxima (BH*D floats). Else: write to
// merged (BH*(D*D + 2*D) floats) one partial per (b, h) at the maxima M.
// S = 0 (a rank of no tokens, ws unread): maxima of -inf, a partial of zeros.
extern "C" int linear_attention_qkv_merge(const void* ws, int BH, int S, const void* M, void* maxima, void* merged,
                                          void* stream) {
  if (BH <= 0 || S < 0 || (M == nullptr ? maxima == nullptr : merged == nullptr)) return (int)cudaErrorInvalidValue;
  linear_attention_qkv_merge_kernel<<<BH, MERGE_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)ws, S, (const float*)M, (float*)maxima, (float*)merged);
  return (int)cudaGetLastError();
}
