// Symmetric abs-max quantize and dequantize, for Hopper (sm_90a): the
// port's wire codec.
//
// Replaces the JAX package's TPU kernels
// src/repro/kernels/quantize.py::quantize_pallas (def :37, body
// _quant_kernel) and ::dequantize_pallas (def :61, body
// _dequant_kernel), and computes what they compute, for each group of
// elements that shares one scale:
//   scale = max(amax, 1e-12) * f32(1 / qmax)        (f32)
//   q     = clip(round_half_even(x / scale), -qmax, qmax)  (int8)
//   x'    = f32(q) * scale, cast to the output type
// with qmax = 2^(bits-1) - 1 (127 at 8 bits, 7 at 4 bits, still stored
// in int8). The scale is a multiply by the f32 reciprocal of qmax, not
// a divide: XLA rewrites the TPU kernel's `amax / qmax`, and the wire
// codec's under `jax.jit`, into that multiply, so a divide here would
// differ in the last bit of some scales. The payload is a true IEEE
// divide (__fdiv_rn), as the reference's is; rintf rounds half to even.
//
// Two groupings, one source:
//  * tile form (quantize_pallas / dequantize_pallas): x [n, d], one
//    scale per block x block tile, scales [n/block, d/block];
//  * grouped form (control/schedule.py wire_encode / wire_decode): x
//    [G, L] contiguous, one scale per row. G = 1 is the segment-scalar
//    codec (axes=None), G = P the per-pod-slice codec.
// Inputs are f32 or bf16; the dequantized output f32 or bf16
// (__float2bfloat16_rn, round to nearest even). Offsets are 64-bit.
//
// What bounds it on this card: bytes. Quantizing reads 4 B (f32) and
// writes 1 B per element; dequantizing reads 1 B and writes 4 B; a
// handful of operations per element is far below the 295 operations a
// byte at which the H100 stops being memory-bound. A 21 M-element f32
// part (kv_migrate's at the full mamba2-2.7b cache) is 105 MB, 31 us at
// 3.35 TB/s.
//
// What the design does about it. Every thread moves 16-byte (f32) or
// 8-byte (bf16) vectors of 4 elements, 4 vectors in flight, with
// neighbouring threads on neighbouring addresses, where the group's
// length and the pointers allow it (else one element at a time). The
// abs-max is an unsigned max over the bit patterns of |x| (for
// non-negative floats their order is the float order, and a NaN sorts
// above inf, so it propagates as jnp.max does); it is exact and the same
// in any order.
//  * Tile form: one block per tile. Pass 1 takes the tile's abs-max
//    (warp __reduce_max_sync, then shared memory); pass 2 reads the tile
//    again (256 KB at 256x256 f32, still in L2) and writes the payload.
//  * Grouped form: a group is spread over many blocks, so its abs-max
//    is a reduction across blocks: pass 1 reduces within each block and
//    atomicMax-es the result into a zeroed word per group; pass 2, a
//    second launch, computes the scale and writes the payload. A group
//    larger than L2 is read twice from device memory (9 B per f32
//    element instead of 5); a grid-wide barrier with the group held on
//    chip is later work.
//  * Dequantize: elementwise, one scale per block (tile form) or per
//    grid row (grouped form).
//  * Dequantize-accumulate (grouped form): acc = fmaf(f32(q), scale,
//    acc) in place, the decode's multiply fused into the add with one
//    rounding, as XLA fuses the reference's `acc + q * scale` in the
//    gradient sync. acc is an f32 [G, L] view whose rows may lie apart
//    (row stride ldacc), as a part along axis 1 of a gradient leaf does.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;          // vectors in flight per thread
constexpr int kMaxBlocksPerGroup = 2048;

// ---- element access: VEC consecutive elements as floats ---------------
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[VEC]) {
  if constexpr (VEC == 4 && sizeof(T) == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (VEC == 4) {
    const uint2 t = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
  } else if constexpr (sizeof(T) == 4) {
    v[0] = __ldg(reinterpret_cast<const float*>(p));
  } else {
    v[0] = __bfloat162float(p[0]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[VEC]) {
  if constexpr (VEC == 4 && sizeof(T) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (VEC == 4) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 t;
    t.x = *reinterpret_cast<const unsigned*>(&a);
    t.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = t;
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float*>(p) = v[0];
  } else {
    p[0] = __float2bfloat16_rn(v[0]);
  }
}

template <int VEC>
__device__ __forceinline__ void load_q(const int8_t* p, float (&v)[VEC]) {
  if constexpr (VEC == 4) {
    const char4 t = *reinterpret_cast<const char4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = p[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store_q(int8_t* p, const float (&v)[VEC],
                                        float scale, float qmax) {
  signed char r[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float t = rintf(__fdiv_rn(v[k], scale));
    t = fminf(fmaxf(t, -qmax), qmax);
    r[k] = static_cast<signed char>(static_cast<int>(t));
  }
  if constexpr (VEC == 4) {
    *reinterpret_cast<char4*>(p) = make_char4(r[0], r[1], r[2], r[3]);
  } else {
    p[0] = r[0];
  }
}

template <int VEC>
__device__ __forceinline__ unsigned abs_bits_max(unsigned m,
                                                 const float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) m = max(m, __float_as_uint(fabsf(v[k])));
  return m;
}

// The block's max of m, returned to every thread.
__device__ __forceinline__ unsigned block_max(unsigned m) {
  __shared__ unsigned warp_max[kWarps];
  m = __reduce_max_sync(0xffffffffu, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kWarps ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) warp_max[0] = m;
  }
  __syncthreads();
  return warp_max[0];
}

// max(amax, 1e-12) * f32(1/qmax); a NaN abs-max stays NaN
__device__ __forceinline__ float scale_of(unsigned amax_bits,
                                          float inv_qmax) {
  const float a = __uint_as_float(amax_bits);
  return __fmul_rn(isnan(a) ? a : fmaxf(a, 1e-12f), inv_qmax);
}

// ---- tile form -----------------------------------------------------------
// grid (d/block, n/block); vector v of a tile is row v / (block/VEC),
// column (v % (block/VEC)) * VEC
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
quantize_tile_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, long long d, int block,
                     float qmax, float inv_qmax) {
  const long long base = static_cast<long long>(blockIdx.y) * block * d +
                         static_cast<long long>(blockIdx.x) * block;
  const int per_row = block / VEC;
  const int n_vec = block * per_row;
  unsigned m = 0u;
  for (int v0 = threadIdx.x; v0 < n_vec; v0 += kThreads * kUnroll) {
    float f[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < n_vec) {
        const int r = v / per_row;
        load_vec<T, VEC>(x + base + r * d + (v - r * per_row) * VEC, f[u]);
        m = abs_bits_max<VEC>(m, f[u]);
      }
    }
  }
  const float s = scale_of(block_max(m), inv_qmax);
  if (threadIdx.x == 0)
    scale[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = s;
  for (int v0 = threadIdx.x; v0 < n_vec; v0 += kThreads * kUnroll) {
    float f[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < n_vec) {
        const int r = v / per_row;
        load_vec<T, VEC>(x + base + r * d + (v - r * per_row) * VEC, f[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int v = v0 + u * kThreads;
      if (v < n_vec) {
        const int r = v / per_row;
        store_q<VEC>(q + base + r * d + (v - r * per_row) * VEC, f[u], s,
                     qmax);
      }
    }
  }
}

template <typename TO, int VEC>
__global__ void __launch_bounds__(kThreads)
dequantize_tile_kernel(const int8_t* __restrict__ q,
                       const float* __restrict__ scale, TO* __restrict__ out,
                       long long d, int block) {
  const long long base = static_cast<long long>(blockIdx.y) * block * d +
                         static_cast<long long>(blockIdx.x) * block;
  const float s =
      scale[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x];
  const int per_row = block / VEC;
  const int n_vec = block * per_row;
  for (int v = threadIdx.x; v < n_vec; v += kThreads) {
    const int r = v / per_row;
    const long long off = base + r * d + (v - r * per_row) * VEC;
    float f[VEC];
    load_q<VEC>(q + off, f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = __fmul_rn(f[k], s);
    store_vec<TO, VEC>(out + off, f);
  }
}

// ---- grouped form ------------------------------------------------------
// grid (blocks per group, G); the blocks of row g stride over its
// L / VEC vectors
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
group_amax_kernel(const T* __restrict__ x, unsigned* __restrict__ amax,
                  long long L) {
  const T* xg = x + static_cast<long long>(blockIdx.y) * L;
  const long long n_vec = L / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  unsigned m = 0u;
  for (long long v0 = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
       v0 < n_vec; v0 += stride * kUnroll) {
    float f[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < n_vec) {
        load_vec<T, VEC>(xg + v * VEC, f[u]);
        m = abs_bits_max<VEC>(m, f[u]);
      }
    }
  }
  m = block_max(m);
  if (threadIdx.x == 0) atomicMax(amax + blockIdx.y, m);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
group_quantize_kernel(const T* __restrict__ x,
                      const unsigned* __restrict__ amax,
                      int8_t* __restrict__ q, float* __restrict__ scale,
                      long long L, float qmax, float inv_qmax) {
  const long long g0 = static_cast<long long>(blockIdx.y) * L;
  const float s = scale_of(amax[blockIdx.y], inv_qmax);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[blockIdx.y] = s;
  const long long n_vec = L / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v0 = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
       v0 < n_vec; v0 += stride * kUnroll) {
    float f[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < n_vec) load_vec<T, VEC>(x + g0 + v * VEC, f[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + u * stride;
      if (v < n_vec) store_q<VEC>(q + g0 + v * VEC, f[u], s, qmax);
    }
  }
}

template <typename TO, int VEC>
__global__ void __launch_bounds__(kThreads)
group_dequantize_kernel(const int8_t* __restrict__ q,
                        const float* __restrict__ scale,
                        TO* __restrict__ out, long long L) {
  const long long g0 = static_cast<long long>(blockIdx.y) * L;
  const float s = scale[blockIdx.y];
  const long long n_vec = L / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       v < n_vec; v += stride) {
    float f[VEC];
    load_q<VEC>(q + g0 + v * VEC, f);
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = __fmul_rn(f[k], s);
    store_vec<TO, VEC>(out + g0 + v * VEC, f);
  }
}

// acc[g, :] = fmaf(f32(q[g, :]), scale[g], acc[g, :]); row g of acc at
// acc + g * ldacc
template <int VEC>
__global__ void __launch_bounds__(kThreads)
group_dequantize_add_kernel(const int8_t* __restrict__ q,
                            const float* __restrict__ scale,
                            float* __restrict__ acc, long long L,
                            long long ldacc) {
  const int8_t* qg = q + static_cast<long long>(blockIdx.y) * L;
  float* ag = acc + static_cast<long long>(blockIdx.y) * ldacc;
  const float s = scale[blockIdx.y];
  const long long n_vec = L / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long v = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       v < n_vec; v += stride) {
    float f[VEC], a[VEC];
    load_q<VEC>(qg + v * VEC, f);
    load_vec<float, VEC>(ag + v * VEC, a);
#pragma unroll
    for (int k = 0; k < VEC; ++k) a[k] = fmaf(f[k], s, a[k]);
    store_vec<float, VEC>(ag + v * VEC, a);
  }
}

// ---- host side -----------------------------------------------------------
bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// 4-element vectors when every group (or tile row) starts on a vector
// boundary and every pointer is aligned to its vector's size
bool use_vec4(long long unit, const void* in, int in_bytes, const void* out,
              int out_bytes) {
  return unit % 4 == 0 && aligned(in, 4 * in_bytes) &&
         aligned(out, 4 * out_bytes);
}

int blocks_per_group(long long L, int vec, long long G) {
  const long long need = (L / vec + kThreads - 1) / kThreads;
  const long long cap = kMaxBlocksPerGroup / G > 0 ? kMaxBlocksPerGroup / G
                                                   : 1;
  const long long b = need < cap ? need : cap;
  return static_cast<int>(b > 0 ? b : 1);
}

template <typename T>
void quantize_tile(const void* x, void* q, void* scale, long long n,
                   long long d, int block, float qmax, float inv_qmax,
                   cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(d / block),
                  static_cast<unsigned>(n / block));
  if (use_vec4(block, x, sizeof(T), q, 1))
    quantize_tile_kernel<T, 4><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), d, block, qmax, inv_qmax);
  else
    quantize_tile_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), d, block, qmax, inv_qmax);
}

template <typename TO>
void dequantize_tile(const void* q, const void* scale, void* out,
                     long long n, long long d, int block, cudaStream_t st) {
  const dim3 grid(static_cast<unsigned>(d / block),
                  static_cast<unsigned>(n / block));
  if (use_vec4(block, q, 1, out, sizeof(TO)))
    dequantize_tile_kernel<TO, 4><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<TO*>(out), d, block);
  else
    dequantize_tile_kernel<TO, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<TO*>(out), d, block);
}

template <typename T, int VEC>
int quantize_groups_vec(const void* x, void* q, void* scale, void* amax,
                        long long G, long long L, float qmax,
                        float inv_qmax, cudaStream_t st) {
  const cudaError_t e = cudaMemsetAsync(amax, 0, G * sizeof(unsigned), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(blocks_per_group(L, VEC, G), static_cast<unsigned>(G));
  group_amax_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<unsigned*>(amax), L);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  group_quantize_kernel<T, VEC><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const unsigned*>(amax),
      static_cast<int8_t*>(q), static_cast<float*>(scale), L, qmax,
      inv_qmax);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int quantize_groups(const void* x, void* q, void* scale, void* amax,
                    long long G, long long L, float qmax, float inv_qmax,
                    cudaStream_t st) {
  if (use_vec4(L, x, sizeof(T), q, 1))
    return quantize_groups_vec<T, 4>(x, q, scale, amax, G, L, qmax,
                                     inv_qmax, st);
  return quantize_groups_vec<T, 1>(x, q, scale, amax, G, L, qmax, inv_qmax,
                                   st);
}

template <typename TO>
void dequantize_groups(const void* q, const void* scale, void* out,
                       long long G, long long L, cudaStream_t st) {
  if (use_vec4(L, q, 1, out, sizeof(TO))) {
    const dim3 grid(blocks_per_group(L, 4, G), static_cast<unsigned>(G));
    group_dequantize_kernel<TO, 4><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<TO*>(out), L);
  } else {
    const dim3 grid(blocks_per_group(L, 1, G), static_cast<unsigned>(G));
    group_dequantize_kernel<TO, 1><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<TO*>(out), L);
  }
}

void dequantize_groups_add(const void* q, const void* scale, void* acc,
                           long long G, long long L, long long ldacc,
                           cudaStream_t st) {
  if (use_vec4(L, q, 1, acc, 4) && ldacc % 4 == 0) {
    const dim3 grid(blocks_per_group(L, 4, G), static_cast<unsigned>(G));
    group_dequantize_add_kernel<4><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<float*>(acc), L, ldacc);
  } else {
    const dim3 grid(blocks_per_group(L, 1, G), static_cast<unsigned>(G));
    group_dequantize_add_kernel<1><<<grid, kThreads, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<float*>(acc), L, ldacc);
  }
}

}  // namespace

// Each launcher runs on `stream` and returns cudaGetLastError() (0 =
// launched). The caller checks devices, types, contiguity and shapes:
// tile form n and d multiples of block, n/block <= 65535; grouped form
// 1 <= G <= 65535, L >= 1. `amax` is scratch of G 32-bit words. The
// accumulating dequantize takes acc f32 with rows ldacc >= L apart.
extern "C" int quantize_tile_launch(const void* x, void* q, void* scale,
                                    int is_bf16, long long n, long long d,
                                    int block, float qmax, float inv_qmax,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    quantize_tile<__nv_bfloat16>(x, q, scale, n, d, block, qmax, inv_qmax,
                                 st);
  else
    quantize_tile<float>(x, q, scale, n, d, block, qmax, inv_qmax, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_tile_launch(const void* q, const void* scale,
                                      void* out, int out_bf16, long long n,
                                      long long d, int block, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    dequantize_tile<__nv_bfloat16>(q, scale, out, n, d, block, st);
  else
    dequantize_tile<float>(q, scale, out, n, d, block, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quantize_groups_launch(const void* x, void* q, void* scale,
                                      void* amax, int is_bf16, long long G,
                                      long long L, float qmax,
                                      float inv_qmax, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return quantize_groups<__nv_bfloat16>(x, q, scale, amax, G, L, qmax,
                                          inv_qmax, st);
  return quantize_groups<float>(x, q, scale, amax, G, L, qmax, inv_qmax,
                                st);
}

extern "C" int dequantize_groups_launch(const void* q, const void* scale,
                                        void* out, int out_bf16, long long G,
                                        long long L, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    dequantize_groups<__nv_bfloat16>(q, scale, out, G, L, st);
  else
    dequantize_groups<float>(q, scale, out, G, L, st);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dequantize_groups_add_launch(const void* q, const void* scale,
                                            void* acc, long long G,
                                            long long L, long long ldacc,
                                            void* stream) {
  dequantize_groups_add(q, scale, acc, G, L, ldacc,
                        static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* quantize_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int quantize_max_groups() { return 65535; }
