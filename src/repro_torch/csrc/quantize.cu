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
// The abs-max is an unsigned max over the bit patterns of |x| (for
// non-negative floats their order is the float order, and a NaN sorts
// above inf, so it propagates as jnp.max does); it is exact and the same
// in any order.
//
// Two groupings, one source:
//  * tile form (quantize_pallas / dequantize_pallas): x [n, d], one
//    scale per block x block tile, scales [n/block, d/block];
//  * grouped form (control/schedule.py wire_encode / wire_decode): x
//    [G, L] with unit column stride, rows ldx >= L elements apart (a
//    part along axis 1 of a gradient leaf is read in place), one scale
//    per row. G = 1 is the segment-scalar codec (axes=None), G = P the
//    per-pod-slice codec. The payload is a contiguous [G, L].
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
// What the design does about it.
//  * Grouped quantize: one persistent, cooperative launch, and the part
//    held on chip as far as it fits. The grid is the blocks that can be
//    co-resident (one 512-thread block per SM: a 224 KB ring of seven
//    32 KB slots). The part's rows are cut into chunks of at most one
//    slot, none crossing a row; each block owns a contiguous stripe of
//    chunks, which may span many rows. Pass 1 streams the stripe through
//    the ring with bulk asynchronous copies (cp.async.bulk, completed on
//    an mbarrier per slot) and takes each row's bit-max. A row wholly
//    inside the stripe is this block's alone and its max goes to the
//    row's word of the scratch; the stripe's first and last rows may be
//    shared, so their partial maxes go to the block's own two slots.
//    Every word is written by one block, so nothing is zeroed. One grid
//    barrier (cooperative_groups grid sync); then each block reduces
//    the slots of the blocks that share its first and last rows (a max
//    is exact in any order). Pass 2 walks the stripe backwards: the last
//    seven chunks are still in the ring, and the others are copied
//    again, the most recent first (what L2 still holds). A part up to
//    ~29 MB is read from device memory once, the 84 MB migrate part
//    about 1.65 times at most. The payload's rounding runs in full-rate
//    float operations (q_bytes), with the IEEE divide only where they
//    could differ from it. A chunk's ends that are not 16-byte aligned
//    (odd L, bf16 rows, an offset pointer) are read by scalar code in the
//    same kernel. One kernel per call, no memset.
//  * Tile form, block 256 on a 16-byte aligned x: a cluster of 4 blocks
//    per tile (__cluster_dims__). Each block copies its 64 rows into
//    shared memory once (64 KB f32, 32 KB bf16; 64 bulk copies on four
//    mbarriers, so the max starts on the first rows while the rest
//    arrive), takes their bit-max, and the four exchange them through
//    distributed shared memory (map_shared_rank) at a cluster barrier;
//    each block then writes its rows' payload from shared memory. One
//    read per element from device memory, 1,024 blocks at 4096^2. Other
//    block sizes and unaligned inputs take a one-block-per-tile kernel
//    (the tile read twice, the second time from L2) inside the same
//    launcher.
//  * Dequantize: elementwise, one scale per block (tile form) or per
//    grid row (grouped form); 16-byte (f32) or 8-byte (bf16) vectors of
//    4 elements where the length and pointers allow it.
//  * Dequantize-accumulate (grouped form): acc = fmaf(f32(q), scale,
//    acc) in place, the decode's multiply fused into the add with one
//    rounding, as XLA fuses the reference's `acc + q * scale` in the
//    gradient sync. acc is an f32 [G, L] view whose rows may lie apart
//    (row stride ldacc), as a part along axis 1 of a gradient leaf does.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;          // vectors in flight per thread
constexpr int kMaxBlocksPerGroup = 2048;

// grouped quantize: one block per SM, a ring of slots in shared memory
constexpr int kGroupThreads = 512;
constexpr int kSlotBytes = 32768;
constexpr int kSlots = 7;
constexpr int kGroupSmem = kSlots * kSlotBytes;      // 229,376 B
// 16-byte vectors of a chunk per thread
constexpr int kVecsPerThread = kSlotBytes / 16 / kGroupThreads;
constexpr int kMaxDevices = 64;

// tile quantize: a cluster of kCluster blocks per kTile x kTile tile
constexpr int kTile = 256;
constexpr int kCluster = 4;
constexpr int kBandRows = kTile / kCluster;          // rows per block
constexpr int kBandStages = 4;                       // mbarriers per band
constexpr int kStageRows = kBandRows / kBandStages;

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

// 16 bytes as floats: 4 f32 or 8 bf16
template <typename T>
__device__ __forceinline__ void unpack16(const uint4 t,
                                         float (&v)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(t.x); v[1] = __uint_as_float(t.y);
    v[2] = __uint_as_float(t.z); v[3] = __uint_as_float(t.w);
  } else {
    const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      v[2 * k] = f.x; v[2 * k + 1] = f.y;
    }
  }
}

template <typename T>
__device__ __forceinline__ void load16(const unsigned char* s,
                                       float (&v)[16 / sizeof(T)]) {
  unpack16<T>(*reinterpret_cast<const uint4*>(s), v);
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

// A group's scale, its reciprocal (rounded to nearest) and qmax
struct QScale {
  float s, rcp, qmax;
};

__device__ __forceinline__ QScale qscale(float s, float qmax) {
  return {s, __frcp_rn(s), qmax};
}

// clip(rintf(__fdiv_rn(v, s)), +-qmax) as int8: the arithmetic of the
// reference, one element
__device__ __forceinline__ signed char q_exact(float v, const QScale& q) {
  float r = rintf(__fdiv_rn(v, q.s));
  r = fminf(fmaxf(r, -q.qmax), q.qmax);
  return static_cast<signed char>(static_cast<int>(r));
}

// y = t + 1.5 * 2^23 rounds t to an integer r (half to even) for |t| <
// 2^22, and y's low byte is then r as int8
constexpr float kRound = 12582912.0f;
// |t - r| below this leaves t at least 2^-13 from every half-integer
constexpr float kHalfMargin = 0.5f - 0x1p-13f;

// The payload bytes of VEC elements of a group whose abs-max gave the
// scale (each byte in the low byte of b[k]), bit for bit q_exact's, in
// full-rate float operations. Every |v| <= amax, so t = v * rcp is at
// most qmax * (1 + 2^-21) in magnitude and its integer within +-qmax;
// t is within |t| * 2^-23 of v / s (two roundings of 2^-24) and the
// divide's own result within |t| * 2^-24, under 2^-13 in all, so where t
// is at least 2^-13 from every half-integer both round to the same
// integer and the clamp leaves it. Only otherwise (a few elements in
// 10^4 of uniform inputs; a NaN or inf, whose t - r is NaN) does the
// vector take q_exact, the IEEE divide.
template <int VEC>
__device__ __forceinline__ void q_bytes(const float (&v)[VEC],
                                        const QScale& q,
                                        unsigned (&b)[VEC]) {
  bool ok = true;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float t = __fmul_rn(v[k], q.rcp);
    const float y = __fadd_rn(t, kRound);
    const float r = __fsub_rn(y, kRound);
    ok &= fabsf(__fsub_rn(t, r)) < kHalfMargin;
    b[k] = __float_as_uint(y);
  }
  if (!ok) {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      b[k] = static_cast<unsigned char>(q_exact(v[k], q));
  }
}

// the low bytes of b[0..3] as one word
__device__ __forceinline__ unsigned pack4(const unsigned* b) {
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040),
                     __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// VEC payload bytes at p: one streaming 4- or 8-byte store when `vec`
// (p aligned to VEC), else byte by byte. The payload is not read again
// by the kernel, so its lines are marked to leave L2 first.
template <int VEC>
__device__ __forceinline__ void store_q(int8_t* p, const float (&v)[VEC],
                                        const QScale& q, bool vec = true) {
  unsigned b[VEC];
  q_bytes<VEC>(v, q, b);
  if constexpr (VEC == 4) {
    if (vec) {
      __stcs(reinterpret_cast<int*>(p), static_cast<int>(pack4(b)));
      return;
    }
  } else if constexpr (VEC == 8) {
    if (vec) {
      __stcs(reinterpret_cast<int2*>(p),
             make_int2(static_cast<int>(pack4(b)),
                       static_cast<int>(pack4(b + 4))));
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) p[k] = static_cast<int8_t>(b[k] & 0xffu);
}

template <int VEC>
__device__ __forceinline__ unsigned abs_bits_max(unsigned m,
                                                 const float (&v)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) m = max(m, __float_as_uint(fabsf(v[k])));
  return m;
}

// The block's max of m, returned to every thread; safe to call again
// right after it returns.
template <int THREADS>
__device__ __forceinline__ unsigned block_max(unsigned m) {
  constexpr int kW = THREADS / 32;
  __shared__ unsigned warp_max[kW];
  m = __reduce_max_sync(0xffffffffu, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < kW ? warp_max[lane] : 0u;
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) warp_max[0] = m;
  }
  __syncthreads();
  m = warp_max[0];
  __syncthreads();
  return m;
}

// max(amax, 1e-12) * f32(1/qmax); a NaN abs-max stays NaN
__device__ __forceinline__ float scale_of(unsigned amax_bits,
                                          float inv_qmax) {
  const float a = __uint_as_float(amax_bits);
  return __fmul_rn(isnan(a) ? a : fmaxf(a, 1e-12f), inv_qmax);
}

// ---- mbarriers and bulk copies (PTX) -----------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

// after the inits, before any use: visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- tile form -----------------------------------------------------------
// One block per tile, for block sizes other than 256 and unaligned x.
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
  const float s = scale_of(block_max<kThreads>(m), inv_qmax);
  if (threadIdx.x == 0)
    scale[static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x] = s;
  const QScale qs = qscale(s, qmax);
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
        store_q<VEC>(q + base + r * d + (v - r * per_row) * VEC, f[u], qs);
      }
    }
  }
}

// block 256: grid (4 * d/256, n/256), clusters of 4 along x; cluster
// block r holds rows [64r, 64r + 64) of tile (blockIdx.y, blockIdx.x / 4)
template <typename T>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
quantize_tile_cluster_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                             float* __restrict__ scale, long long d,
                             float qmax, float inv_qmax) {
  constexpr int kRowBytes = kTile * sizeof(T);
  constexpr int kVecsPerRow = kRowBytes / 16;
  constexpr int kStageVecs = kStageRows * kVecsPerRow;
  constexpr int VE = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char band[];
  __shared__ __align__(8) unsigned long long bar[kBandStages];
  __shared__ unsigned band_max;
  __shared__ float tile_scale;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const long long tcol = blockIdx.x / kCluster;
  const long long row0 =
      static_cast<long long>(blockIdx.y) * kTile + rank * kBandRows;
  const T* src = x + row0 * d + tcol * kTile;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kBandStages; ++s) mbar_init(&bar[s]);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    for (int s = 0; s < kBandStages; ++s) {
      mbar_expect_tx(&bar[s], kStageRows * kRowBytes);
      for (int r = s * kStageRows; r < (s + 1) * kStageRows; ++r)
        bulk_load(band + r * kRowBytes, src + r * d, kRowBytes, &bar[s]);
    }
  }
  unsigned m = 0u;
  for (int s = 0; s < kBandStages; ++s) {
    mbar_wait(&bar[s], 0u);
    for (int v = tid; v < kStageVecs; v += kThreads) {
      float f[VE];
      load16<T>(band + (s * kStageVecs + v) * 16, f);
      m = abs_bits_max<VE>(m, f);
    }
  }
  m = block_max<kThreads>(m);
  if (tid == 0) band_max = m;
  cluster.sync();
  if (tid < 32) {
    unsigned t = tid < kCluster ? *cluster.map_shared_rank(&band_max, tid)
                                : 0u;
    t = __reduce_max_sync(0xffffffffu, t);
    if (tid == 0) tile_scale = scale_of(t, inv_qmax);
  }
  __syncthreads();
  // no block reads another's band_max after this; wait before leaving
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  const float s = tile_scale;
  const QScale qs = qscale(s, qmax);
  if (rank == 0 && tid == 0)
    scale[static_cast<long long>(blockIdx.y) * (gridDim.x / kCluster) +
          tcol] = s;
  int8_t* qb = q + row0 * d + tcol * kTile;
  for (int v = tid; v < kBandRows * kVecsPerRow; v += kThreads) {
    float f[VE];
    load16<T>(band + v * 16, f);
    const int r = v / kVecsPerRow;
    store_q<VE>(qb + r * d + (v - r * kVecsPerRow) * VE, f, qs);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
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
// Chunk j of row g is columns [j * ce, min((j + 1) * ce, L)); the chunks
// run row by row, nj to a row. A chunk is `head` elements read one by
// one until the source is 16-byte aligned, a `body` that is bulk-copied
// (a multiple of 16 bytes), and a `tail` read one by one.
struct Chunk {
  long long g, j, col;
  int head, body, tail;
};

template <typename T>
__device__ __forceinline__ void chunk_at(Chunk& c, const T* x, long long ldx,
                                         long long L, long long ce) {
  c.col = c.j * ce;
  const int n = static_cast<int>(min(ce, L - c.col));
  const int mis =
      static_cast<int>(reinterpret_cast<uintptr_t>(x + c.g * ldx + c.col) &
                       15u);
  c.head = min(mis ? (16 - mis) / static_cast<int>(sizeof(T)) : 0, n);
  c.body = ((n - c.head) * static_cast<int>(sizeof(T)) & ~15) /
           static_cast<int>(sizeof(T));
  c.tail = n - c.head - c.body;
}

// the next and the previous chunk, without a division
__device__ __forceinline__ void step_on(Chunk& c, long long nj) {
  if (++c.j == nj) { c.j = 0; ++c.g; }
}

__device__ __forceinline__ void step_back(Chunk& c, long long nj) {
  if (c.j-- == 0) { c.j = nj - 1; --c.g; }
}

// the block that owns chunk t: blocks [0, rem) own base + 1 chunks each,
// the rest base
__device__ __forceinline__ long long block_of(long long t, long long base,
                                              long long rem) {
  const long long cut = rem * (base + 1);
  return t < cut ? t / (base + 1) : rem + (t - cut) / base;
}

__device__ __forceinline__ long long first_chunk(long long b, long long base,
                                                 long long rem) {
  return b * base + min(b, rem);
}

// one persistent cooperative launch; grid <= co-resident blocks and <=
// n_chunks. amax: G words (rows inside one stripe), then 2 per block
// (the partial maxes of the stripe's first and last rows).
template <typename T>
__global__ void __launch_bounds__(kGroupThreads, 1)
quantize_groups_kernel(const T* __restrict__ x, long long ldx,
                       int8_t* __restrict__ q, float* __restrict__ scale,
                       unsigned* __restrict__ amax, long long G, long long L,
                       long long ce, long long nj, long long n_chunks,
                       float qmax, float inv_qmax) {
  constexpr int VE = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long bar[kSlots];
  __shared__ float edge_scale[2];
  const int tid = threadIdx.x;
  const long long b = blockIdx.x;
  const long long base = n_chunks / gridDim.x, rem = n_chunks % gridDim.x;
  const long long t0 = first_chunk(b, base, rem);
  const int K = static_cast<int>(base + (b < rem ? 1 : 0));
  const long long g_first = t0 / nj, g_last = (t0 + K - 1) / nj;
  unsigned* part = amax + G;

  if (tid == 0) {
    for (int s = 0; s < kSlots; ++s) mbar_init(&bar[s]);
    mbar_init_fence();
  }
  __syncthreads();
  // thread 0's cursor: the next chunk it copies; in pass 1 chunk k of
  // the stripe goes into slot k % kSlots (the last kSlots stay there)
  Chunk pc;
  pc.g = g_first;
  pc.j = t0 - g_first * nj;
  auto issue = [&](int s) {               // chunk pc into slot s
    chunk_at<T>(pc, x, ldx, L, ce);
    if (pc.body == 0) return;
    mbar_expect_tx(&bar[s], pc.body * sizeof(T));
    bulk_load(ring + s * kSlotBytes, x + pc.g * ldx + pc.col + pc.head,
              pc.body * sizeof(T), &bar[s]);
  };
  if (tid == 0)
    for (int k = 0; k < min(K, kSlots); ++k) {
      issue(k);
      step_on(pc, nj);
    }
  unsigned phase = 0u;        // bit s: parity of slot s's next completion

  // pass 1: the bit-max of each row of the stripe
  Chunk c;
  c.g = g_first;
  c.j = t0 - g_first * nj;
  unsigned m = 0u;
  for (int k = 0; k < K; ++k, step_on(c, nj)) {
    chunk_at<T>(c, x, ldx, L, ce);
    const int s = k % kSlots;
    if (c.body) {
      mbar_wait(&bar[s], (phase >> s) & 1u);
      phase ^= 1u << s;
    }
    const T* src = x + c.g * ldx + c.col;
    float f1[1];
    if (tid < c.head) {
      load_vec<T, 1>(src + tid, f1);
      m = abs_bits_max<1>(m, f1);
    }
    if (tid < c.tail) {
      load_vec<T, 1>(src + c.head + c.body + tid, f1);
      m = abs_bits_max<1>(m, f1);
    }
    const unsigned char* slot = ring + s * kSlotBytes;
    const int nv = c.body / VE;
#pragma unroll
    for (int i = 0; i < kVecsPerThread; ++i) {
      const int v = tid + i * kGroupThreads;
      if (v < nv) {
        float f[VE];
        load16<T>(slot + v * 16, f);
        m = abs_bits_max<VE>(m, f);
      }
    }
    if (k == K - 1 || c.j == nj - 1) {                // the row ends here
      m = block_max<kGroupThreads>(m);
      if (tid == 0) {
        if (c.g == g_first || c.g == g_last) {
          if (c.g == g_first) part[2 * b] = m;
          if (c.g == g_last) part[2 * b + 1] = m;
        } else {
          amax[c.g] = m;
        }
      }
      m = 0u;
    }
    __syncthreads();                                  // slot s is free
    if (tid == 0 && k + kSlots < K) {
      issue(s);
      step_on(pc, nj);
    }
  }

  cg::this_grid().sync();

  // the whole max of the first and last rows: each block whose stripe
  // meets the row left a partial in its slot 0 (the row is its first)
  // or 1 (its last)
  for (int e = 0; e < 2; ++e) {
    const long long g = e ? g_last : g_first;
    const long long blo = block_of(g * nj, base, rem);
    const long long bhi = block_of(min((g + 1) * nj, n_chunks) - 1, base, rem);
    unsigned mm = 0u;
    for (long long bb = blo + tid; bb <= bhi; bb += kGroupThreads) {
      const bool first = first_chunk(bb, base, rem) / nj == g;
      mm = max(mm, __ldcg(part + 2 * bb + (first ? 0 : 1)));
    }
    mm = block_max<kGroupThreads>(mm);
    if (tid == 0) edge_scale[e] = scale_of(mm, inv_qmax);
  }
  __syncthreads();

  // pass 2: the payload, the stripe walked backwards: the last kSlots
  // chunks from their slots, the rest copied again, kSlots ahead
  step_back(c, nj);                                   // chunk K - 1
  if (K > kSlots) {
    pc = c;
    for (int i = 0; i < kSlots; ++i) step_back(pc, nj);
  }
  for (int k = K - 1; k >= 0; --k, step_back(c, nj)) {
    chunk_at<T>(c, x, ldx, L, ce);
    const int s = k % kSlots;
    if (c.body && k < K - kSlots) {
      mbar_wait(&bar[s], (phase >> s) & 1u);
      phase ^= 1u << s;
    }
    const float sc = c.g == g_first  ? edge_scale[0]
                     : c.g == g_last ? edge_scale[1]
                                     : scale_of(__ldcg(amax + c.g), inv_qmax);
    const QScale qs = qscale(sc, qmax);
    if (tid == 0 && c.j == 0) scale[c.g] = sc;        // the row starts here
    const T* src = x + c.g * ldx + c.col;
    int8_t* qc = q + c.g * L + c.col;
    float f1[1];
    if (tid < c.head) {
      load_vec<T, 1>(src + tid, f1);
      store_q<1>(qc + tid, f1, qs);
    }
    if (tid < c.tail) {
      const int e = c.head + c.body + tid;
      load_vec<T, 1>(src + e, f1);
      store_q<1>(qc + e, f1, qs);
    }
    int8_t* qb = qc + c.head;
    const bool vec = (reinterpret_cast<uintptr_t>(qb) % VE) == 0;
    const int nv = c.body / VE;
    const unsigned char* slot = ring + s * kSlotBytes;
    uint4 u[kVecsPerThread];
#pragma unroll
    for (int i = 0; i < kVecsPerThread; ++i) {
      const int v = tid + i * kGroupThreads;
      if (v < nv) u[i] = *reinterpret_cast<const uint4*>(slot + v * 16);
    }
#pragma unroll
    for (int i = 0; i < kVecsPerThread; ++i) {
      const int v = tid + i * kGroupThreads;
      if (v < nv) {
        float f[VE];
        unpack16<T>(u[i], f);
        store_q<VE>(qb + v * VE, f, qs, vec);
      }
    }
    __syncthreads();                                  // slot s is free
    if (tid == 0 && k >= kSlots) {
      issue(s);                                       // chunk k - kSlots
      step_back(pc, nj);
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
cudaError_t quantize_tile(const void* x, void* q, void* scale, long long n,
                          long long d, int block, float qmax, float inv_qmax,
                          cudaStream_t st) {
  if (block == kTile && aligned(x, 16)) {
    constexpr int smem = kBandRows * kTile * sizeof(T);
    const cudaError_t e = cudaFuncSetAttribute(
        quantize_tile_cluster_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    const dim3 grid(static_cast<unsigned>(d / kTile * kCluster),
                    static_cast<unsigned>(n / kTile));
    quantize_tile_cluster_kernel<T><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), d, qmax, inv_qmax);
    return cudaGetLastError();
  }
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
  return cudaGetLastError();
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

// co-resident blocks of quantize_groups_kernel<T> on the current device
// (SMs x blocks an SM), found once per device; negative: a CUDA error
template <typename T>
int coresident_blocks() {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  e = cudaFuncSetAttribute(quantize_groups_kernel<T>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kGroupSmem);
  int per_sm = 0, sms = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, quantize_groups_kernel<T>, kGroupThreads, kGroupSmem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (per_sm * sms <= 0) return -static_cast<int>(cudaErrorInvalidConfiguration);
  if (dev < kMaxDevices) cache[dev] = per_sm * sms;
  return per_sm * sms;
}

template <typename T>
int quantize_groups(const void* x, long long ldx, void* q, void* scale,
                    void* scratch, long long scratch_words, long long G,
                    long long L, float qmax, float inv_qmax,
                    cudaStream_t st) {
  const int cores = coresident_blocks<T>();
  if (cores < 0) return -cores;
  // chunks of at most one slot, never across a row, a multiple of 16
  // bytes, about as many to each block
  constexpr long long slot_elems = kSlotBytes / sizeof(T);
  constexpr long long ve = 16 / sizeof(T);
  const long long per_block =
      (G * L + static_cast<long long>(cores) * slot_elems - 1) /
      (static_cast<long long>(cores) * slot_elems);
  long long ce = (G * L + cores * per_block - 1) / (cores * per_block);
  ce = (ce + ve - 1) / ve * ve;
  ce = ce < slot_elems ? ce : slot_elems;
  long long nj = (L + ce - 1) / ce;
  long long n_chunks = G * nj;
  const int blocks = static_cast<int>(n_chunks < cores ? n_chunks : cores);
  if (G + 2LL * blocks > scratch_words)
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* st_ = static_cast<float*>(scale);
  unsigned* am = static_cast<unsigned*>(scratch);
  void* args[] = {&xt, &ldx, &qt, &st_, &am, &G, &L, &ce, &nj, &n_chunks,
                  &qmax, &inv_qmax};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(quantize_groups_kernel<T>), dim3(blocks),
      dim3(kGroupThreads), args, kGroupSmem, st));
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

// Each launcher runs on `stream` and returns a CUDA error code (0 =
// launched). The caller checks devices, types, strides and shapes:
// tile form x contiguous, n and d multiples of block, n/block <= 65535;
// grouped form 1 <= G <= 65535, L >= 1, x with unit column stride and
// rows ldx >= L apart, q contiguous [G, L], `scratch` at least
// G + 2 * quantize_groups_blocks(is_bf16) 32-bit words (nothing needs
// zeroing). The accumulating dequantize takes acc f32 with rows
// ldacc >= L apart.
extern "C" int quantize_tile_launch(const void* x, void* q, void* scale,
                                    int is_bf16, long long n, long long d,
                                    int block, float qmax, float inv_qmax,
                                    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return static_cast<int>(quantize_tile<__nv_bfloat16>(
        x, q, scale, n, d, block, qmax, inv_qmax, st));
  return static_cast<int>(
      quantize_tile<float>(x, q, scale, n, d, block, qmax, inv_qmax, st));
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

// The grouped quantize's grid on the current device at most (its
// co-resident blocks); negative: minus a CUDA error code.
extern "C" int quantize_groups_blocks(int is_bf16) {
  return is_bf16 ? coresident_blocks<__nv_bfloat16>()
                 : coresident_blocks<float>();
}

extern "C" int quantize_groups_launch(const void* x, long long ldx, void* q,
                                      void* scale, void* scratch,
                                      long long scratch_words, int is_bf16,
                                      long long G, long long L, float qmax,
                                      float inv_qmax, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return quantize_groups<__nv_bfloat16>(x, ldx, q, scale, scratch,
                                          scratch_words, G, L, qmax,
                                          inv_qmax, st);
  return quantize_groups<float>(x, ldx, q, scale, scratch, scratch_words, G,
                                L, qmax, inv_qmax, st);
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
