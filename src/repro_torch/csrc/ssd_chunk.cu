// Mamba-2 SSD (state-space duality) within one chunk, for Hopper
// (sm_90a).
//
// Replaces the JAX package's TPU kernel
// src/repro/kernels/ssd_scan.py::ssd_chunk_pallas (body _ssd_kernel),
// and computes what it computes, for each (batch b, chunk c, head h):
//   cum[q]      = sum_{i<=q} da[h, i]                   (log-decay)
//   y[q, h, p]  = sum_{k<=q} (C[q] . B[k]) * exp(cum[q] - cum[k]) * x[k, h, p]
//   st[h, p, n] = sum_k exp(cum[Q-1] - cum[k]) * x[k, h, p] * B[k, n]
// Inputs: x [B,nC,Q,H,P], B/C [B,nC,Q,N] (bf16 or f32), da [B,nC,H,Q]
// (f32); y and st are f32, and so is every decay factor and sum. The
// causal mask is applied by zeroing k > q (the TPU kernel masks the
// exponent with -1e30 before exp: the upper triangle is positive and
// would overflow). cum is summed in one fixed order (`chunk_cumsum`
// here, by one warp), which the plain version repeats: with the served
// model's log-decays (sums near -1e3 over a chunk) another order moves
// decay factors by ~1e-4 relative.
//
// What bounds it on this card: bytes. At the serve shape of
// mamba2-2.7b (B=4, nC=3, Q=256, H=80, P=64, N=128, bf16 x, B and C)
// one call must read x (31.5 MB), B and C (1.6 MB) and da (1.0 MB) and
// write y (62.9 MB f32) and the states (31.5 MB f32): 128.4 MB, 38.3 us
// at 3.35 TB/s. Its two contractions are 8.2 GFLOP (16.4 with the
// hi/lo split below), 8-17 us at the 989 TFLOP/s bf16 tensor-core rate,
// and its 31.6 M exps a few us more.
//
// bf16 inputs (the serve path): ssd_chunk_bf16_kernel, on the tensor
// cores with wgmma. Every product of the reference's f32 arithmetic is
// kept at f32 accuracy:
//  * C B^T: C and B are bf16, so bf16 wgmma with f32 accumulation forms
//    each product exactly, as f32 does.
//  * The decayed scores S = (C B^T) o L and the decayed x of the states
//    are f32. Each value v is split into hi = bf16(v) and lo = bf16(v -
//    hi) (v - hi is exact in f32), and the product runs as two bf16
//    wgmmas, hi . x + lo . x, into one f32 accumulator. What the split
//    drops is under 2^-18 |v| (3.8e-6 relative); TF32 (2^-11) would not
//    keep the 1e-4 the kernel is held to.
// Design:
//  * One block (one warpgroup, 128 threads) per work item. A y item is
//    (b*c, 64-row q-tile, group of 8 heads): it computes the 64x64 C B^T
//    tiles of k-tiles <= its q-tile once (m64n64k16, C and B K-major in
//    shared memory) and keeps them in f32 in shared memory, 4 k-tiles
//    (64 KB) at a time. Then, per head: the decay exp(cum[q] - cum[k])
//    and the causal mask in registers (branch-free, as the TPU kernel
//    masks: the exponent of a pair k > q is -1e30), the hi/lo split,
//    and the y product as m64n64k16 wgmmas with the scores as the
//    register A operand (the f32 accumulator layout of the first
//    product is the A fragment layout of the second) against the x tile
//    [64 k x 64 p], MN-major in shared memory. A states item is (b*c,
//    group of 8 heads): it keeps the B tiles of 4 k-tiles in shared
//    memory and, per head, multiplies (x o dec)^T, split hi/lo in
//    registers, by them (MN-major) as m64n128k16 wgmmas.
//  * The grid is one flat list, heaviest items first: the last q-tile
//    (most k-tiles), the states, then the other q-tiles in falling
//    order.
//  * Tiles come in by cp.async (16 bytes a thread, 8 rows x 4 chunks a
//    warp: full 32-byte sectors and no shared-memory bank conflicts)
//    into a three-stage ring in the no-swizzle core-matrix layout wgmma
//    reads; a head's first x tile brings its row of da with it, and the
//    copies of the tiles two ahead are in flight during a tile's work.
//    N is zero-padded to 128 and P to 64 in shared memory, and ragged
//    q, k and head groups are masked. Q above 256 runs in windows of 4
//    k-tiles, adding into y and the states in device memory.
//  * y leaves through shared memory as 16-byte stores, each warp writing
//    whole rows; the states straight from the accumulators as 8-byte
//    stores, each quad of lanes filling one 32-byte sector.
// What is left for later: a persistent grid, warp specialisation (a
// producer warp issuing TMA loads, two consumer warpgroups), clusters
// that share C B^T between head groups through distributed shared
// memory, and the 128-byte swizzle.
//
// f32 inputs (the f32 engine; not the serve path) take the CUDA-core
// kernels: ssd_diag_kernel, one block per (b, c, h, q-tile), C B^T and
// the decay per 64x64 tile in 104 KB of shared memory, and
// ssd_state_kernel, one block per (b, c, h).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
// ======================================================================
// f32 inputs: the CUDA-core kernels
// ======================================================================


constexpr int kThreads = 256;   // 16 x 16
constexpr int kTile = 64;       // rows of a q-tile and of a k-tile
constexpr int kSS = kTile + 16; // row stride of the score tile
constexpr int kMaxP = 64;       // 4 columns of 16 threads
constexpr int kMaxN = 128;      // 8 columns of 16 threads (states)
constexpr int kMaxQ = 4096;

__device__ __forceinline__ float to_f32(float v) { return v; }

// Inclusive prefix sum of da[0, n) into cum[0, n), by warp 0, one
// 32-element segment after the other; ends with __syncthreads().
__device__ void chunk_cumsum(const float* __restrict__ da, float* cum,
                             int n) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float carry = 0.0f;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      float v = i < n ? da[i] : 0.0f;
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v += t;
      }
      v += carry;
      if (i < n) cum[i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
  __syncthreads();
}

size_t diag_smem_bytes(int Q, int P, int N) {
  return sizeof(float) *
         (static_cast<size_t>(2) * kTile * (N + 1) + kTile * P +
          kTile * kSS + Q);
}

size_t state_smem_bytes(int Q, int P, int N) {
  return sizeof(float) * (static_cast<size_t>(kTile) * (P + N) + Q);
}

// y for one (b, c, h, q-tile): blockIdx = (b * nC + c, h, q-tile).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_diag_kernel(const T* __restrict__ x,        // [BC, Q, H, P]
                const T* __restrict__ Bm,       // [BC, Q, N]
                const T* __restrict__ Cm,       // [BC, Q, N]
                const float* __restrict__ da,   // [BC, H, Q]
                float* __restrict__ y,          // [BC, Q, H, P]
                int Q, int H, int P, int N) {
  extern __shared__ float smem[];
  const int NS = N + 1;                 // padded: B rows hit distinct banks
  float* Cs = smem;                     // [kTile][NS]
  float* Bs = Cs + kTile * NS;          // [kTile][NS]
  float* xs = Bs + kTile * NS;          // [kTile][P]
  float* Ss = xs + kTile * P;           // [kTile][kSS]
  float* cum = Ss + kTile * kSS;        // [Q]
  const size_t bc = blockIdx.x;
  const int h = blockIdx.y, qt = blockIdx.z;
  const int q0 = qt * kTile;
  const int nq = min(kTile, Q - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i - r * N;
    Cs[r * NS + n] =
        r < nq ? to_f32(Cm[(bc * Q + q0 + r) * N + n]) : 0.0f;
  }
  chunk_cumsum(da + (bc * H + h) * Q, cum, q0 + nq);

  float acc[4][4] = {};
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * kTile;
    const int nk = min(kTile, Q - k0);
    __syncthreads();                    // the previous tile is consumed
    for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      Bs[r * NS + n] =
          r < nk ? to_f32(Bm[(bc * Q + k0 + r) * N + n]) : 0.0f;
    }
    for (int i = threadIdx.x; i < kTile * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      xs[i] = r < nk ? to_f32(x[((bc * Q + k0 + r) * H + h) * P + p])
                     : 0.0f;
    }
    __syncthreads();

    // scores: (C . B) * exp(cum[q] - cum[k]) for k <= q, else 0
    float s[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float c[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) c[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * NS + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(c[i], b[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + ty + 16 * i, k = k0 + tx + 16 * j;
        float v = 0.0f;
        if (q < Q && k <= q) v = s[i][j] * expf(cum[q] - cum[k]);
        Ss[(ty + 16 * i) * kSS + tx + 16 * j] = v;
      }
    __syncthreads();

    // y += scores @ x over this k-tile
    for (int k = 0; k < nk; ++k) {
      float sv[4], xv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty + 16 * i) * kSS + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        xv[j] = p < P ? xs[k * P + p] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = tx + 16 * j;
      if (p < P) y[((bc * Q + q0 + r) * H + h) * P + p] = acc[i][j];
    }
  }
}

// Chunk-end states for one (b, c, h): blockIdx = (b * nC + c, h).
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ x,       // [BC, Q, H, P]
                 const T* __restrict__ Bm,      // [BC, Q, N]
                 const float* __restrict__ da,  // [BC, H, Q]
                 float* __restrict__ st,        // [BC, H, P, N]
                 int Q, int H, int P, int N) {
  extern __shared__ float smem[];
  float* xs = smem;                     // [kTile][P], x * decay
  float* Bs = xs + kTile * P;           // [kTile][N]
  float* dec = Bs + kTile * N;          // [Q]: cum, then the decay
  const size_t bc = blockIdx.x;
  const int h = blockIdx.y;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  chunk_cumsum(da + (bc * H + h) * Q, dec, Q);
  const float last = dec[Q - 1];
  __syncthreads();                      // every thread has read cum[Q-1]
  for (int i = threadIdx.x; i < Q; i += kThreads)
    dec[i] = expf(last - dec[i]);

  float acc[4][8] = {};
  for (int k0 = 0; k0 < Q; k0 += kTile) {
    const int nk = min(kTile, Q - k0);
    __syncthreads();                    // decay written / tile consumed
    for (int i = threadIdx.x; i < kTile * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      xs[i] = r < nk ? to_f32(x[((bc * Q + k0 + r) * H + h) * P + p]) *
                           dec[k0 + r]
                     : 0.0f;
    }
    for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      Bs[i] = r < nk ? to_f32(Bm[(bc * Q + k0 + r) * N + n]) : 0.0f;
    }
    __syncthreads();
    for (int k = 0; k < nk; ++k) {
      float xv[4], bv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int p = ty + 16 * i;
        xv[i] = p < P ? xs[k * P + p] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        bv[j] = n < N ? Bs[k * N + n] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(xv[i], bv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int p = ty + 16 * i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (n < N) st[((bc * H + h) * P + p) * N + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch_cuda_cores(const void* x, const void* Bm, const void* Cm,
                      const void* da, void* y, void* st, int BC, int Q,
                      int H, int P, int N, cudaStream_t stream) {
  const size_t smem_y = diag_smem_bytes(Q, P, N);
  const size_t smem_s = state_smem_bytes(Q, P, N);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_diag_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_y));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      ssd_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_s));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_y(BC, H, (Q + kTile - 1) / kTile);
  ssd_diag_kernel<T><<<grid_y, kThreads, smem_y, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(da),
      static_cast<float*>(y), Q, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid_s(BC, H);
  ssd_state_kernel<T><<<grid_s, kThreads, smem_s, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const float*>(da), static_cast<float*>(st), Q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

// ======================================================================
// bf16 inputs: the wgmma kernel
// ======================================================================
using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 128;        // one warpgroup
constexpr int kHeadsY = 8;             // heads of a y item
constexpr int kHeadsS = 8;             // heads of a states item
constexpr int kWin = 4;                // C B^T k-tiles kept at once
constexpr int kStages = 3;             // x-tile (and states) ring depth
constexpr int kTileN = 64 * 128 * 2;   // B or C tile, N padded to 128
constexpr int kTileP = 64 * 64 * 2;    // x tile, P padded to 64
constexpr int kScoreTile = 64 * 64 * 4;
constexpr int kYStride = 72;           // y staging row (floats)
constexpr int kYStage = 64 * kYStride * 4;

// Shared memory, by item. A row of da or cum is Q floats padded to
// whole 32-float segments; a ring of kStages da rows rides with the x
// tiles.
//  y item:      kWin score tiles | region U: while the scores are made,
//               the C tile and a two-stage B ring; while the heads run,
//               the x ring, the y staging, cum and the da ring.
//  states item: kWin B tiles (a window of k-tiles) | the x ring |
//               cum, then the decay | the da ring.
__host__ __device__ int row_floats(int Q) { return ((Q + 31) / 32) * 32; }
size_t rows_bytes(int Q) {
  return static_cast<size_t>(row_floats(Q)) * (1 + kStages) * 4;
}
size_t y_smem_bytes(int Q) {
  const size_t heads = kStages * kTileP + kYStage + rows_bytes(Q);
  const size_t scores = 3 * static_cast<size_t>(kTileN);
  return kWin * kScoreTile + (heads > scores ? heads : scores);
}
size_t states_smem_bytes(int Q) {
  return kWin * kTileN + kStages * kTileP + rows_bytes(Q);
}
size_t bf16_smem_bytes(int Q) {
  return y_smem_bytes(Q) > states_smem_bytes(Q) ? y_smem_bytes(Q)
                                                : states_smem_bytes(Q);
}

// ---- PTX wrappers ------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every copy but the newest N groups has landed; then made visible to
// the async proxy (wgmma) and to the whole block, which has also
// finished with everything before
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
template <int NR>
__device__ __forceinline__ void fence_regs(float (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int NR>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[NR]) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// distance between core matrices (8 rows x 16 bytes, 128 bytes each)
// adjacent along K (lbo) and along M or N (sbo).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d += A . B^T over one k16 step, A and B both from shared memory
// (K-major, no swizzle); m64n64k16, bf16 in, f32 accumulate.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

// d += A . B over one k16 step, A (m64 x k16 bf16) from registers in
// the accumulator-shaped fragment layout, B from shared memory
// (MN-major, no swizzle); m64n64k16, f32 accumulate.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A . B over one k16 step, A (m64 x k16 bf16) from registers in
// the accumulator-shaped fragment layout, B from shared memory
// (MN-major, no swizzle); m64n128k16, f32 accumulate.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// ---- tiles -------------------------------------------------------------
// A tile of 64 rows and C8 chunks of 8 bf16 columns, stored as core
// matrices: chunk c8 of rows 8*r8..8*r8+7 is the 128 bytes at
// (c8 * 8 + r8) * 128, row r at (r % 8) * 16 within it. K-major use
// (columns = K): lbo 1024, sbo 128, a k16 step is +2048 bytes.
// MN-major use (rows = K): lbo 128, sbo 1024, a k16 step is +256.
__device__ __forceinline__ int tile_off(int r, int c) {
  return (((c >> 3) * 8 + (r >> 3)) << 7) + ((r & 7) << 4) + ((c & 7) << 1);
}

// Rows [0, 64) of a row-major bf16 matrix (row stride ld elements, rows
// < nvalid and columns < cols real, the rest zero) into a tile. Each
// warp takes 8 rows x 4 chunks at a time (full 32-byte sectors; the 8
// rows of a quarter-warp hit 8 distinct bank groups); cp.async where a
// whole chunk is real and `vec` (16-byte aligned rows), else plain
// loads and one 16-byte store.
template <int C8>
__device__ __forceinline__ void load_tile(unsigned char* tile,
                                          const bf16* __restrict__ src,
                                          long long ld, int nvalid, int cols,
                                          bool vec) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int job = warp; job < 2 * C8; job += 4) {
    const int r = (job & 7) * 8 + (lane & 7);
    const int c = ((job >> 3) * 4 + (lane >> 3)) * 8;
    unsigned char* dst = tile + tile_off(r, c);
    const bf16* s = src + r * ld + c;
    if (vec && r < nvalid && c + 8 <= cols) {
      cp_async16(dst, s);
    } else {
      __align__(16) bf16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = (r < nvalid && c + e < cols) ? s[e] : __float2bfloat16(0.0f);
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// n floats of a row into shared memory by cp.async: 16 bytes a thread
// where `vec` (n a multiple of 4, the row 16-byte aligned), else 4.
__device__ __forceinline__ void load_row(float* dst,
                                         const float* __restrict__ src, int n,
                                         bool vec) {
  if (vec) {
    for (int i = threadIdx.x * 4; i < n; i += kWgThreads * 4)
      cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += kWgThreads)
      cp_async4(dst + i, src + i);
  }
}

__device__ __forceinline__ float tile_at(const unsigned char* tile, int r,
                                         int c) {
  return __bfloat162float(
      *reinterpret_cast<const bf16*>(tile + tile_off(r, c)));
}

// hi = bf16(a, b), lo = bf16(a - hi, b - hi), packed low element first
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

struct Args {
  const bf16* x;      // [BC, Q, H, P]
  const bf16* Bm;     // [BC, Q, N]
  const bf16* Cm;     // [BC, Q, N]
  const float* da;    // [BC, H, Q]
  float* y;           // [BC, Q, H, P]
  float* st;          // [BC, H, P, N]
  long long BC;
  int Q, H, P, N, nG, nS, nQT;
  int vec_x, vec_bc;  // 16-byte rows (P, N multiples of 8, aligned)
  int vec_da;         // da rows in 16-byte pieces (Q a multiple of 4)
};

// y for (bc, q-tile qt, heads g*8 ..): see the head comment.
__device__ void y_item(const Args& a, long long bc, int qt, int g,
                       unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8, cp = 2 * (lane & 3);
  const int Q = a.Q, H = a.H, P = a.P, N = a.N, rowf = row_floats(Q);
  float4* score = reinterpret_cast<float4*>(smem);    // [kWin][8][128]
  unsigned char* U = smem + kWin * kScoreTile;
  unsigned char* ctile = U;
  float* ys = reinterpret_cast<float*>(U + kStages * kTileP);
  float* cum = reinterpret_cast<float*>(U + kStages * kTileP + kYStage);
  float* dar = cum + rowf;                             // [kStages][rowf]
  const int q0 = qt * 64, nq = min(64, Q - q0);
  const int h0 = g * kHeadsY, nh = min(kHeadsY, H - h0);
  const int nks = (N + 15) / 16;
  const long long row0 = bc * Q;

  for (int w0 = 0; w0 <= qt; w0 += kWin) {
    const int nw = min(kWin, qt + 1 - w0);
    // -- C B^T of k-tiles w0 .. w0+nw-1, raw, into the score tiles ----
    __syncthreads();                    // the region U is free
    load_tile<16>(ctile, a.Cm + (row0 + q0) * N, N, nq, N, a.vec_bc);
    auto issue_b = [&](int j) {
      const int k0 = (w0 + j) * 64;
      load_tile<16>(U + kTileN * (1 + (j & 1)), a.Bm + (row0 + k0) * N, N,
                    min(64, Q - k0), N, a.vec_bc);
    };
    issue_b(0);
    cp_commit();
    for (int j = 0; j < nw; ++j) {
      cp_wait<0>();                     // tile j is in; tile j-1 consumed
      if (j + 1 < nw) issue_b(j + 1);   // into tile j-1's stage
      cp_commit();
      const unsigned char* btile = U + kTileN * (1 + (j & 1));
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      fence_regs(s);
      wgmma_fence();
      for (int kk = 0; kk < nks; ++kk)
        wgmma_ss_n64(s, desc(ctile + kk * 2048, 1024, 128),
                     desc(btile + kk * 2048, 1024, 128));
      wgmma_commit_wait();
      fence_regs(s);
#pragma unroll
      for (int f = 0; f < 8; ++f)
        score[(j * 8 + f) * kWgThreads + tid] =
            make_float4(s[4 * f], s[4 * f + 1], s[4 * f + 2], s[4 * f + 3]);
    }
    __syncthreads();                    // scores written; U free again

    // -- per head: decay, split, y += S . x over the window ----------
    // a ring over (head, k-tile); a head's first tile brings its da row
    const int T = nh * nw;
    auto issue_x = [&](int i) {
      const int k0 = (w0 + i % nw) * 64, h = h0 + i / nw, slot = i % kStages;
      load_tile<8>(U + kTileP * slot, a.x + ((row0 + k0) * H + h) * P,
                   static_cast<long long>(H) * P, min(64, Q - k0), P,
                   a.vec_x);
      if (i % nw == 0)
        load_row(dar + slot * rowf, a.da + (bc * H + h) * Q, q0 + nq,
                 a.vec_da);
    };
    for (int i = 0; i < kStages - 1; ++i) {   // the ring's first tiles
      if (i < T) issue_x(i);
      cp_commit();
    }
    float acc[32];
    const int qa = q0 + r0, qb = q0 + r1;
    for (int i = 0; i < T; ++i) {
      const int j = i % nw, h = h0 + i / nw;
      cp_wait<kStages - 2>();           // tile i is in; tile i-1 consumed
      if (i + kStages - 1 < T) issue_x(i + kStages - 1);   // its stage
      cp_commit();
      if (j == 0) {                     // a new head: its cum, y so far
        chunk_cumsum(dar + (i % kStages) * rowf, cum, q0 + nq);
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = 8 * jj + cp;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = e < 2 ? qa : qb, p = c + (e & 1);
            acc[4 * jj + e] =
                (w0 > 0 && q < Q && p < P)
                    ? a.y[((row0 + q) * H + h) * P + p] : 0.0f;
          }
        }
      }
      // decay (branch-free: a non-causal pair's exponent is -1e30)
      // and split; element (jj, e) of row a is causal iff 8 jj + e <= la
      const int k0 = (w0 + j) * 64;
      const float ca = qa < Q ? cum[qa] : 0.0f;
      const float cb = qb < Q ? cum[qb] : 0.0f;
      const int la = qa < Q ? qa - k0 - cp : -1;
      const int lb = qb < Q ? qb - k0 - cp : -1;
      uint32_t hi[16], lo[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 sv = score[(j * 8 + jj) * kWgThreads + tid];
        const float2 ck =
            *reinterpret_cast<const float2*>(cum + k0 + 8 * jj + cp);
        const float e0 = sv.x * expf(8 * jj <= la ? ca - ck.x : -1e30f);
        const float e1 =
            sv.y * expf(8 * jj + 1 <= la ? ca - ck.y : -1e30f);
        const float e2 = sv.z * expf(8 * jj <= lb ? cb - ck.x : -1e30f);
        const float e3 =
            sv.w * expf(8 * jj + 1 <= lb ? cb - ck.y : -1e30f);
        const int f = 4 * (jj >> 1) + 2 * (jj & 1);
        split2(e0, e1, hi[f], lo[f]);
        split2(e2, e3, hi[f + 1], lo[f + 1]);
      }
      const unsigned char* xt = U + kTileP * (i % kStages);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = desc(xt + kk * 256, 128, 1024);
        wgmma_rs_n64(acc, hi + 4 * kk, d);
        wgmma_rs_n64(acc, lo + 4 * kk, d);
      }
      wgmma_commit_wait();
      fence_regs(acc);
      if (j == nw - 1) {                // the head's window is done
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int c = 8 * jj + cp;
          *reinterpret_cast<float2*>(ys + r0 * kYStride + c) =
              make_float2(acc[4 * jj], acc[4 * jj + 1]);
          *reinterpret_cast<float2*>(ys + r1 * kYStride + c) =
              make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
        }
        __syncthreads();
        for (int v = tid; v < 64 * 16; v += kWgThreads) {
          const int r = v >> 4, c = (v & 15) * 4;
          if (r >= nq || c >= P) continue;
          float* dst = a.y + ((row0 + q0 + r) * H + h) * P + c;
          const float* src = ys + r * kYStride + c;
          if ((P & 3) == 0) {
            *reinterpret_cast<float4*>(dst) =
                *reinterpret_cast<const float4*>(src);
          } else {
            for (int e = 0; e < 4 && c + e < P; ++e) dst[e] = src[e];
          }
        }
      }
    }
  }
}

// chunk-end states for (bc, heads sg*8 ..): see the head comment.
__device__ void state_item(const Args& a, long long bc, int sg,
                           unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8, cp = 2 * (lane & 3);
  const int Q = a.Q, H = a.H, P = a.P, N = a.N, rowf = row_floats(Q);
  unsigned char* bwin = smem;                          // [kWin] B tiles
  unsigned char* xring = smem + kWin * kTileN;         // [kStages] x tiles
  float* dec = reinterpret_cast<float*>(xring + kStages * kTileP);
  float* dar = dec + rowf;                             // [kStages][rowf]
  const int h0 = sg * kHeadsS, nh = min(kHeadsS, H - h0);
  const int nkt = (Q + 63) / 64;
  const long long row0 = bc * Q;

  for (int w0 = 0; w0 < nkt; w0 += kWin) {
    const int nw = min(kWin, nkt - w0);
    __syncthreads();                    // the last window is consumed
    for (int j = 0; j < nw; ++j) {      // the window's B tiles, kept
      const int k0 = (w0 + j) * 64;
      load_tile<16>(bwin + kTileN * j, a.Bm + (row0 + k0) * N, N,
                    min(64, Q - k0), N, a.vec_bc);
    }
    // a ring over (head, k-tile); a head's first tile brings its da row
    const int T = nh * nw;
    auto issue = [&](int i) {
      const int k0 = (w0 + i % nw) * 64, h = h0 + i / nw, slot = i % kStages;
      load_tile<8>(xring + kTileP * slot, a.x + ((row0 + k0) * H + h) * P,
                   static_cast<long long>(H) * P, min(64, Q - k0), P,
                   a.vec_x);
      if (i % nw == 0)
        load_row(dar + slot * rowf, a.da + (bc * H + h) * Q, Q, a.vec_da);
    };
    for (int i = 0; i < kStages - 1; ++i) {   // with the B tiles
      if (i < T) issue(i);
      cp_commit();
    }
    float acc[64];
    for (int i = 0; i < T; ++i) {
      const int j = i % nw, h = h0 + i / nw;
      cp_wait<kStages - 2>();           // tile i is in; tile i-1 consumed
      if (i + kStages - 1 < T) issue(i + kStages - 1);     // its stage
      cp_commit();
      if (j == 0) {                     // a new head: its decay, st so far
        chunk_cumsum(dar + (i % kStages) * rowf, dec, Q);
        const float last = dec[Q - 1];
        __syncthreads();                // every thread has read cum[Q-1]
        for (int v = tid; v < Q; v += kWgThreads)
          dec[v] = expf(last - dec[v]);
        __syncthreads();
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = e < 2 ? r0 : r1, n = 8 * jj + cp + (e & 1);
            acc[4 * jj + e] =
                (w0 > 0 && p < P && n < N)
                    ? a.st[((bc * H + h) * P + p) * N + n] : 0.0f;
          }
        }
      }
      const unsigned char* xt = xring + kTileP * (i % kStages);
      const int k0 = (w0 + j) * 64;
      uint32_t hi[16], lo[16];
#pragma unroll
      for (int f = 0; f < 8; ++f) {     // k16 step f/2, k half f%2
        const int kb = 16 * (f >> 1) + 8 * (f & 1) + cp;
        const float d0 = k0 + kb < Q ? dec[k0 + kb] : 0.0f;
        const float d1 = k0 + kb + 1 < Q ? dec[k0 + kb + 1] : 0.0f;
        split2(tile_at(xt, kb, r0) * d0, tile_at(xt, kb + 1, r0) * d1,
               hi[2 * f], lo[2 * f]);
        split2(tile_at(xt, kb, r1) * d0, tile_at(xt, kb + 1, r1) * d1,
               hi[2 * f + 1], lo[2 * f + 1]);
      }
      const unsigned char* bt = bwin + kTileN * j;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t d = desc(bt + kk * 256, 128, 1024);
        wgmma_rs_n128(acc, hi + 4 * kk, d);
        wgmma_rs_n128(acc, lo + 4 * kk, d);
      }
      wgmma_commit_wait();
      fence_regs(acc);
      if (j == nw - 1) {                // the head's window is done:
#pragma unroll                          // each quad of lanes writes 32 B
        for (int jj = 0; jj < 16; ++jj) {
          const int n = 8 * jj + cp;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int p = e ? r1 : r0;
            if (p >= P || n >= N) continue;
            float* dst = a.st + ((bc * H + h) * P + p) * N + n;
            const float v0 = acc[4 * jj + 2 * e], v1 = acc[4 * jj + 2 * e + 1];
            if ((N & 1) == 0) {
              *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
            } else {
              dst[0] = v0;
              if (n + 1 < N) dst[1] = v1;
            }
          }
        }
      }
    }
  }
}

// One flat grid, heaviest items first: the last q-tile's y items, the
// states items, then the other q-tiles' y items in falling order.
__global__ void __launch_bounds__(kWgThreads)
ssd_chunk_bf16_kernel(const Args a) {
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  unsigned char* smem = wg_smem;
  const long long per_level = a.BC * a.nG, n_states = a.BC * a.nS;
  long long i = blockIdx.x;
  if (i < per_level) {
    y_item(a, i / a.nG, a.nQT - 1, static_cast<int>(i % a.nG), smem);
  } else if (i < per_level + n_states) {
    i -= per_level;
    state_item(a, i / a.nS, static_cast<int>(i % a.nS), smem);
  } else {
    i -= per_level + n_states;
    const int qt = a.nQT - 2 - static_cast<int>(i / per_level);
    const long long rest = i % per_level;
    y_item(a, rest / a.nG, qt, static_cast<int>(rest % a.nG), smem);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

int launch_wgmma(const void* x, const void* Bm, const void* Cm,
                 const void* da, void* y, void* st, int BC, int Q, int H,
                 int P, int N, cudaStream_t stream) {
  Args a;
  a.x = static_cast<const bf16*>(x);
  a.Bm = static_cast<const bf16*>(Bm);
  a.Cm = static_cast<const bf16*>(Cm);
  a.da = static_cast<const float*>(da);
  a.y = static_cast<float*>(y);
  a.st = static_cast<float*>(st);
  a.BC = BC;
  a.Q = Q; a.H = H; a.P = P; a.N = N;
  a.nG = (H + kHeadsY - 1) / kHeadsY;
  a.nS = (H + kHeadsS - 1) / kHeadsS;
  a.nQT = (Q + 63) / 64;
  a.vec_x = P % 8 == 0 && aligned16(x);
  a.vec_bc = N % 8 == 0 && aligned16(Bm) && aligned16(Cm);
  a.vec_da = Q % 4 == 0 && aligned16(da);
  const long long blocks =
      static_cast<long long>(BC) * (a.nG * a.nQT + a.nS);
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = bf16_smem_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_bf16_kernel<<<static_cast<unsigned>(blocks), kWgThreads, smem,
                          stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ======================================================================
// The backward (ssd_chunk_bwd)
// ======================================================================
// For each (b, c, h), with cum, L (zero above the diagonal), G = C B^T,
// S = G o L and r[k] = exp(cum[Q-1] - cum[k]) as the forward takes
// them, and the cotangents dy [Q,P] of y and dst [P,N] of the states:
//   dS = (dy x^T) masked causal        dx = S^T dy + r o (B dst^T)
//   dG = sum_h dS o L                  dC = dG B
//   dB = dG^T C + sum_h r o (x dst)
//   E = dS o S; rho[k] = r[k] sum_p x[k,p] (B dst^T)[k,p]
//   dcum[q] = sum_k E[q,k] - sum_q' E[q',q] - rho[q]
//             + [q = Q-1] sum_k rho[k];  dda = reverse cumsum of dcum.
// dx, dB and dC are rounded once from f32 to the input dtype; every
// decay factor and sum is f32. Nothing is summed by atomics: every sum
// runs in a fixed order, so two calls give the same bits.
//
// What bounds it on this card: bytes, barely. At the train shape of
// mamba2-2.7b (B=4, nC=4, Q=256, H=80, P=64, N=128, bf16 x, B and C)
// one call must read x, B, C, da, dy (f32) and dst (f32) and write dx,
// dB, dC and dda: 216.5 MB, 64.6 us at 3.35 TB/s. Its contractions are
// 22.4 GFLOP, 23 us at the 989 TFLOP/s bf16 tensor-core rate (two to
// three times that with the hi/lo splits below), and it takes 52 M
// exps. So the products have to run on the tensor cores and
// the per-head intermediates (dS o L, r o (x dst): 503 MB of f32 at
// that shape if each head wrote its own) have to stay on chip.
//
// bf16 inputs (the train path) take three kernels, on the tensor cores
// with wgmma, every product kept at f32 accuracy as the forward keeps
// it: x, B and C are bf16 (exact products, f32 sums); each f32 operand
// (dy, dst, S, r o x, dG) is split into hi = bf16(v) and lo = bf16(v -
// hi), and a product of a bf16 and an f32 operand runs as two wgmmas,
// of two f32 operands (dx = S^T dy) as three: hi.hi + hi.lo + lo.hi.
//  1. ssd_bwd_wgmma_kernel: one block per item (b*c, 64-row k-tile,
//     group of kHeadsB heads), k-tile 0 first (it meets every q-tile).
//     The item's C B^T tiles (transposed: k rows, q columns; m64n64k16
//     from B and C in shared memory) are made once and kept in f32 in
//     shared memory (Q <= 256; beyond, each pair makes its own). Then
//     per head, in order, and per q-tile >= its k-tile, two warpgroups
//     work side by side, meeting at a block barrier a pair:
//     - the dS side: dS^T = x dy^T (k rows; x as register A), the decay
//       and causal mask in registers (branch-free: the exponent of a
//       pair k > q is -1e30), dS^T o L added into the item's dG tiles
//       in shared memory (each element by one thread, in head order), E
//       = dS o S and its row sums over the k-tile and column sums
//       (final); per head also cum (its 4 warps, chunk_cumsum's order),
//       B dst^T (B as register A), rho (final) and r o B dst^T for dx;
//     - the dx side: S^T = (C B^T)^T o L again, split hi / lo in
//       registers as the register-A fragment of dx += S^T dy (as the
//       forward's scores are of y); dx (final); per head r o (x dst)
//       added into an m64n128 accumulator over the item's heads;
//     - both: per pair half the rows of the next pair's dy, copied by
//       cp.async into an f32 staging tile one pair ahead and split hi /
//       lo there by the thread that copied it (no barrier), while the
//       pair's products run; per head half of dst, loaded into
//       registers a head ahead.
//     The dx side also brings B, x and da (one head ahead) and the C
//     tiles. Register-A wgmma loops are unrolled with static indices
//     and the fragments fenced until the wait: the wgmma reads them
//     after it is issued. One warpgroup alone was latency-bound (one
//     warp an SM quarter) and spilled; the two split the per-pair work
//     about evenly and hide each other's waits (PERF.md has the times).
//  2. ssd_bwd_gsum_kernel: the sums over head groups of the items' dG
//     and r o (x dst) tiles, each element's groups added in order into
//     group 0's slot; and per (b*c, h) one warp: dcum from E's row sums
//     (k-tiles in order), its column sums and rho, and dda by the
//     reverse scan in chunk_cumsum's order.
//  3. ssd_bwd_dbc_kernel: dC = dG B and dB = dG^T C + the summed r o
//     (x dst), one block per (b*c, 64-row tile, which), m64n128k16.
// Scratch, f32 (`bwd_scratch_floats`; kernels/ssd_scan.py's
// `bwd_scratch` allocates the same): dG tiles [BC, nG, nT(nT+1)/2,
// 64*64], r o (x dst) [BC, nG, nT, 64*128], E's row sums [BC, H, nT, Q],
// its column sums and rho [BC, H, Q] each. At the train shape 26.2 +
// 21.0 + 5.2 + 1.3 + 1.3 = 55.1 MB (the CUDA-core design took 507 MB).
// What is left for later: a second item an SM (the item's 211 KB of
// shared memory allow one), TMA and the 128-byte swizzle, and a
// persistent grid.
//
// f32 inputs (the f32 parity step; not the train path) take four
// CUDA-core kernels, f32 arithmetic:
//  1. ssd_bwd_cb_kernel: G = C B^T per (b*c), the causal 64x64 tiles,
//     into scratch (f32), computed once for all heads;
//  2. ssd_bwd_head_kernel: one block per (b*c, h), k-tiles outer,
//     q-tiles >= k inner: dS, S, dx (final), the head's dS o L tiles
//     and r o (x dst) into scratch, dcum from E's row and column sums
//     and rho, and dda (final) by the reverse scan;
//  3. ssd_bwd_sum_kernel: the head sums of dG and of r o (x dst), each
//     element's heads added in order 0..H-1 by one thread (dG into the
//     C B^T buffer, the other into head 0's slab);
//  4. ssd_bwd_bc_kernel: dC = dG B and dB = dG^T C + that sum, one
//     block per (b*c, 64-row tile, which).
// A 256x256 f32 score tile does not fit a block's shared memory, so Q
// runs in 64-row tiles (as the f32 forward kernels).
constexpr int kXS = kMaxP + 1;   // row stride of x / dy tiles (floats)
constexpr int kNS = kMaxN + 1;   // row stride of B / dst tiles
constexpr int kTS = kTile + 1;   // row stride of 64x64 tiles

size_t bwd_head_smem_bytes(int Q) {
  return sizeof(float) *
         (static_cast<size_t>(3) * Q + 2 * kTile * kXS + 2 * kTile * kTS +
          kTile * kNS + kMaxP * kNS + kTile);
}

size_t bwd_cb_smem_bytes() {
  return sizeof(float) * 2 * kTile * kNS;
}

size_t bwd_bc_smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(kTile) * kTS + kTile * kMaxN);
}

// G[bc][q][k] = sum_n C[q,n] B[k,n] for the causal tiles:
// blockIdx = (b*c, q-tile, k-tile), upper tiles return at once.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  float* __restrict__ G, int Q, int N) {
  const int qt = blockIdx.y, kt = blockIdx.z;
  if (kt > qt) return;
  extern __shared__ float smem[];
  float* Cs = smem;                     // [kTile][kNS]
  float* Bs = Cs + kTile * kNS;         // [kTile][kNS]
  const size_t bc = blockIdx.x;
  const int q0 = qt * kTile, k0 = kt * kTile;
  const int nq = min(kTile, Q - q0), nk = min(kTile, Q - k0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  for (int i = threadIdx.x; i < kTile * N; i += kThreads) {
    const int r = i / N, n = i - r * N;
    Cs[r * kNS + n] = r < nq ? Cm[(bc * Q + q0 + r) * N + n] : 0.0f;
    Bs[r * kNS + n] = r < nk ? Bm[(bc * Q + k0 + r) * N + n] : 0.0f;
  }
  __syncthreads();
  float s[4][4] = {};
  for (int n = 0; n < N; ++n) {
    float c[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = Cs[(ty + 16 * i) * kNS + n];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Bs[(tx + 16 * j) * kNS + n];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(c[i], b[j], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty + 16 * i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < Q) G[(bc * Q + q) * Q + k] = s[i][j];
    }
  }
}

// sum over the 16 lanes of a half-warp (a thread row), xor order
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One (b*c, h): blockIdx = (b*c, h). See the section's head comment.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_head_kernel(const float* __restrict__ x,        // [BC, Q, H, P]
                    const float* __restrict__ Bm,       // [BC, Q, N]
                    const float* __restrict__ da,   // [BC, H, Q]
                    const float* __restrict__ dy,   // [BC, Q, H, P]
                    const float* __restrict__ dst,  // [BC, H, P, N]
                    const float* __restrict__ G,    // [BC, Q, Q]
                    float* __restrict__ dx,             // [BC, Q, H, P]
                    float* __restrict__ dGh,        // [BC, H, Q, Q]
                    float* __restrict__ dB2h,       // [BC, H, Q, N]
                    float* __restrict__ dda,        // [BC, H, Q]
                    int Q, int H, int P, int N) {
  extern __shared__ float smem[];
  float* cum = smem;                    // [Q]
  float* rr = cum + Q;                  // [Q]: r
  float* dcum = rr + Q;                 // [Q]
  float* xs = dcum + Q;                 // [kTile][kXS]
  float* dys = xs + kTile * kXS;        // [kTile][kXS]
  float* Ss = dys + kTile * kXS;        // [kTile][kTS]: S, then E's sums
  float* Es = Ss + kTile * kTS;         // [kTile][kTS]: E
  float* Bs = Es + kTile * kTS;         // [kTile][kNS]
  float* ds = Bs + kTile * kNS;         // [kMaxP][kNS]: dst
  float* rho = ds + kMaxP * kNS;        // [kTile]
  const size_t bc = blockIdx.x;
  const int h = blockIdx.y;
  const size_t bch = bc * H + h;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int nT = (Q + kTile - 1) / kTile;

  chunk_cumsum(da + bch * Q, cum, Q);
  const float last = cum[Q - 1];
  for (int i = tid; i < Q; i += kThreads) {
    rr[i] = expf(last - cum[i]);
    dcum[i] = 0.0f;
  }
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i - p * N;
    ds[p * kNS + n] = dst[bch * P * N + i];
  }
  float rho_sum = 0.0f;                 // thread 0's, in k order

  for (int kt = 0; kt < nT; ++kt) {
    const int k0 = kt * kTile, nk = min(kTile, Q - k0);
    __syncthreads();                    // the last tile is consumed
    for (int i = tid; i < kTile * P; i += kThreads) {
      const int r = i / P, p = i - r * P;
      xs[r * kXS + p] =
          r < nk ? x[((bc * Q + k0 + r) * H + h) * P + p] : 0.0f;
    }
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      Bs[r * kNS + n] = r < nk ? Bm[(bc * Q + k0 + r) * N + n] : 0.0f;
    }
    float adx[4][4] = {};               // dx[k0 + ty + 16i][tx + 16j]
    for (int qt = kt; qt < nT; ++qt) {
      const int q0 = qt * kTile, nq = min(kTile, Q - q0);
      __syncthreads();                  // dys, Ss, Es free
      for (int i = tid; i < kTile * P; i += kThreads) {
        const int r = i / P, p = i - r * P;
        dys[r * kXS + p] =
            r < nq ? dy[((bc * Q + q0 + r) * H + h) * P + p] : 0.0f;
      }
      __syncthreads();
      // dS[q,k] = sum_p dy[q,p] x[k,p]: q = ty + 16i, k = tx + 16j
      float dsv[4][4] = {};
      for (int p = 0; p < P; ++p) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = dys[(ty + 16 * i) * kXS + p];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[(tx + 16 * j) * kXS + p];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dsv[i][j] = fmaf(a[i], b[j], dsv[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + tx + 16 * j;
          // zero every k > q term before it is multiplied
          const bool ok = q < Q && k <= q;
          const float l = ok ? expf(cum[q] - cum[k]) : 0.0f;
          const float s = ok ? G[(bc * Q + q) * Q + k] * l : 0.0f;
          const float d = ok ? dsv[i][j] : 0.0f;
          Ss[(ty + 16 * i) * kTS + tx + 16 * j] = s;
          Es[(ty + 16 * i) * kTS + tx + 16 * j] = d * s;
          if (q < Q && k < Q) dGh[(bch * Q + q) * Q + k] = d * l;
        }
      }
      __syncthreads();
      // dx[k,p] += sum_q S[q,k] dy[q,p]: k = ty + 16i, p = tx + 16j
      for (int q = 0; q < nq; ++q) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = Ss[q * kTS + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = dys[q * kXS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) adx[i][j] = fmaf(a[i], b[j], adx[i][j]);
      }
      // E's row sums (threads 0-63) and column sums (64-127), in order
      float e = 0.0f;
      if (tid < kTile) {
        for (int c = 0; c < kTile; ++c) e += Es[tid * kTS + c];
      } else if (tid < 2 * kTile) {
        for (int r = 0; r < kTile; ++r) e += Es[r * kTS + tid - kTile];
      }
      __syncthreads();                  // Ss and Es read
      if (tid < 2 * kTile) Ss[tid] = e;
      __syncthreads();
      if (tid < kTile && q0 + tid < Q) dcum[q0 + tid] += Ss[tid];
      __syncthreads();                  // a diagonal tile's rows first
      if (tid < kTile && k0 + tid < Q) dcum[k0 + tid] -= Ss[kTile + tid];
    }
    // the states' terms: BdT[k,p] = sum_n B[k,n] dst[p,n]
    float bd[4][4] = {};
    for (int n = 0; n < N; ++n) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Bs[(ty + 16 * i) * kNS + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ds[(tx + 16 * j) * kNS + n];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) bd[i][j] = fmaf(a[i], b[j], bd[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ty + 16 * i;
      const float rk = k < Q ? rr[k] : 0.0f;
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (p < P) {
          adx[i][j] = fmaf(rk, bd[i][j], adx[i][j]);
          part = fmaf(xs[(ty + 16 * i) * kXS + p], bd[i][j], part);
        }
      }
      part = half_warp_sum(part);
      if (tx == 0) rho[ty + 16 * i] = rk * part;
      if (k < Q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = tx + 16 * j;
          if (p < P) dx[((bc * Q + k) * H + h) * P + p] = adx[i][j];
        }
      }
    }
    // r o (x dst)[k,n] = r[k] sum_p x[k,p] dst[p,n]: k = ty + 16i,
    // n = tx + 16j
    float xd[4][8] = {};
    for (int p = 0; p < P; ++p) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[(ty + 16 * i) * kXS + p];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = ds[p * kNS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) xd[i][j] = fmaf(a[i], b[j], xd[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ty + 16 * i;
      if (k >= Q) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        if (n < N) dB2h[(bch * Q + k) * N + n] = rr[k] * xd[i][j];
      }
    }
    __syncthreads();                    // rho written
    if (tid < nk) dcum[k0 + tid] -= rho[tid];
    if (tid == 0)
      for (int i = 0; i < nk; ++i) rho_sum += rho[i];
  }
  __syncthreads();
  if (tid == 0) dcum[Q - 1] += rho_sum;
  __syncthreads();
  // dda = the reverse cumulative sum of dcum, in chunk_cumsum's order
  // over the reversed axis (warp 0)
  if (tid < 32) {
    float carry = 0.0f;
    for (int base = 0; base < Q; base += 32) {
      const int i = base + tid;
      float v = i < Q ? dcum[Q - 1 - i] : 0.0f;
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, v, o);
        if (tid >= o) v += t;
      }
      v += carry;
      if (i < Q) dda[bch * Q + Q - 1 - i] = v;
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }
}

// The sums over heads, each element's heads in order by one thread:
// dG (causal tiles) into G, r o (x dst) into head 0's slab of dB2h.
// blockIdx = (element block, b*c).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sum_kernel(const float* __restrict__ dGh, float* __restrict__ dB2h,
                   float* __restrict__ G, int Q, int H, int N) {
  const size_t bc = blockIdx.y;
  const long long e = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const long long qq = static_cast<long long>(Q) * Q;
  const long long qn = static_cast<long long>(Q) * N;
  if (e < qq) {
    const int q = static_cast<int>(e / Q), k = static_cast<int>(e % Q);
    if (k / kTile > q / kTile) return;  // not a causal tile
    const float* src = dGh + bc * H * qq + e;
    float s = 0.0f;
    for (int h = 0; h < H; ++h) s += src[h * qq];
    G[bc * qq + e] = s;
  } else if (e < qq + qn) {
    float* src = dB2h + bc * H * qn + (e - qq);
    float s = 0.0f;
    for (int h = 0; h < H; ++h) s += src[h * qn];
    src[0] = s;
  }
}

// dC for one q-tile (blockIdx.z = 0) or dB for one k-tile (1):
// blockIdx = (b*c, tile, which). Outputs rounded once to T.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_bc_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
                  const float* __restrict__ dG,    // [BC, Q, Q] causal
                  const float* __restrict__ dB2,   // [BC, H, Q, N]: h = 0
                  float* __restrict__ dB, float* __restrict__ dC, int Q, int H,
                  int N) {
  extern __shared__ float smem[];
  float* gs = smem;                     // [kTile][kTS]: a dG tile
  float* vs = gs + kTile * kTS;         // [kTile][kMaxN]: B or C tile
  const size_t bc = blockIdx.x;
  const int t = blockIdx.y, nT = (Q + kTile - 1) / kTile;
  const bool want_dC = blockIdx.z == 0;
  const int r0 = t * kTile, nr = min(kTile, Q - r0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* V = want_dC ? Bm : Cm;
  float acc[4][8] = {};
  // dC[q] = sum_{k <= q} dG[q,k] B[k]; dB[k] = sum_{q >= k} dG[q,k] C[q]
  const int first = want_dC ? 0 : t, stop = want_dC ? t + 1 : nT;
  for (int o = first; o < stop; ++o) {
    const int o0 = o * kTile, no = min(kTile, Q - o0);
    __syncthreads();
    // gs[a][b]: dC: dG[r0 + a][o0 + b]; dB: dG[o0 + a][r0 + b]
    const int qa = want_dC ? r0 : o0, ka = want_dC ? o0 : r0;
    const int na = want_dC ? nr : no, nb = want_dC ? no : nr;
    for (int i = tid; i < kTile * kTile; i += kThreads) {
      const int a = i / kTile, b = i - a * kTile;
      gs[a * kTS + b] =
          a < na && b < nb ? dG[(bc * Q + qa + a) * Q + ka + b] : 0.0f;
    }
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int a = i / N, n = i - a * N;
      vs[a * kMaxN + n] =
          a < no ? V[(bc * Q + o0 + a) * N + n] : 0.0f;
    }
    __syncthreads();
    for (int m = 0; m < no; ++m) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = want_dC ? gs[(ty + 16 * i) * kTS + m]
                       : gs[m * kTS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = tx + 16 * j;
        b[j] = n < N ? vs[m * kMaxN + n] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float* out = want_dC ? dC : dB;
  const long long qn = static_cast<long long>(Q) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nr) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = tx + 16 * j;
      if (n >= N) continue;
      const size_t at = (bc * Q + r0 + r) * N + n;
      float v = acc[i][j];
      if (!want_dC) v += dB2[bc * H * qn + (r0 + r) * N + n];
      out[at] = v;
    }
  }
}

// ---- bf16 inputs: the wgmma kernels -------------------------------------
constexpr int kHeadsB = 8;              // heads of a backward item
constexpr int kFrag4 = kWgThreads * 8;  // float4s of a 64x64 f32 tile

// Shared memory of an item (bytes), in this order: the C B^T tiles
// (kWin, fragment order; without the cache three C tiles) | the dG
// tiles (kWin, fragment order; without the cache the rows) | the B tile
// | two x tiles | D: two C tiles while C B^T is made; dst hi / lo at a
// head's start, then r o B dst^T in its second pair's half; dy hi / lo
// of two pairs | dy's
// f32 staging tile [64][64] (swizzled; each warpgroup stages and splits
// half its rows) | E's row sums by warp [4][64] | with the cache two
// rows of nT*64 floats (da, then cum in place), by head parity.
constexpr int kOffDga = kWin * kScoreTile;
constexpr int kOffB = kOffDga + kWin * kScoreTile;
constexpr int kOffX = kOffB + kTileN;
constexpr int kOffD = kOffX + 2 * kTileP;
constexpr int kOffStage = kOffD + 2 * kTileN;
constexpr int kOffRed = kOffStage + 64 * 64 * 4;
constexpr int kOffRows = kOffRed + 4 * 64 * 4;

__host__ __device__ int n_tiles(int Q) { return (Q + 63) / 64; }
__host__ __device__ bool bwd_cache(int Q) { return n_tiles(Q) <= kWin; }
size_t bwd_item_smem_bytes(int Q) {
  return kOffRows + (bwd_cache(Q) ? static_cast<size_t>(2) * n_tiles(Q) *
                                        64 * 4 : 0);
}
size_t bwd_dbc_smem_bytes() {
  return 2 * static_cast<size_t>(kTileN) + 64 * 65 * 4;
}

// the causal (q-tile, k-tile) pairs, kt <= qt, in one list
__host__ __device__ __forceinline__ int pair_index(int qt, int kt) {
  return qt * (qt + 1) / 2 + kt;
}

// floats of each scratch array (see the section's head comment)
void bwd_scratch_floats(long long BC, int Q, int H, long long out[5]) {
  const long long nT = n_tiles(Q), nG = (H + kHeadsB - 1) / kHeadsB;
  out[0] = BC * nG * (nT * (nT + 1) / 2) * 64 * 64;   // dG tiles
  out[1] = BC * nG * nT * 64 * 128;                   // r o (x dst)
  out[2] = BC * H * nT * Q;                           // E's row sums
  out[3] = BC * H * Q;                                // E's column sums
  out[4] = BC * H * Q;                                // rho
}

struct BwdArgs {
  const bf16* x;      // [BC, Q, H, P]
  const bf16* Bm;     // [BC, Q, N]
  const bf16* Cm;     // [BC, Q, N]
  const float* da;    // [BC, H, Q]
  const float* dy;    // [BC, Q, H, P]
  const float* dst;   // [BC, H, P, N]
  bf16* dx;           // [BC, Q, H, P]
  bf16* dB;           // [BC, Q, N]
  bf16* dC;           // [BC, Q, N]
  float* dda;         // [BC, H, Q]
  float* dgp;         // scratch: see the head comment
  float* dbp;
  float* rowp;
  float* colE;
  float* rho;
  long long BC;
  int Q, H, P, N, nG, nT, nPairs;
  int vec_x, vec_bc, vec_da, vec_dy, vec_dst;   // 16-byte rows
};

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wg_bar(int wg) {   // one warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void fence_async() {    // generic -> wgmma
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d += A . B over one k16 step, A (m64 x k16 bf16) from registers in
// the accumulator-shaped fragment layout, B from shared memory K-major
// (no swizzle); m64n64k16, f32 accumulate.
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32],
                                               const uint32_t* a,
                                               uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The register-A fragments of K columns [0, 16 nk) of a bf16 tile's
// rows r0, r1 (the accumulator layout's pairs at columns 8 jj + cp).
template <int NK>
__device__ __forceinline__ void tile_frags(uint32_t (&f)[4 * NK],
                                           const unsigned char* tile, int r0,
                                           int r1, int cp) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * kk + 8 * h + cp;
      f[4 * kk + 2 * h] =
          *reinterpret_cast<const uint32_t*>(tile + tile_off(r0, c));
      f[4 * kk + 2 * h + 1] =
          *reinterpret_cast<const uint32_t*>(tile + tile_off(r1, c));
    }
  }
}
__device__ __forceinline__ float2 bf2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// 8 floats into hi / lo bf16 chunks
__device__ __forceinline__ void split8(const float* v, uint4& hi, uint4& lo) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) split2(v[2 * e], v[2 * e + 1], h[e], l[e]);
  hi = make_uint4(h[0], h[1], h[2], h[3]);
  lo = make_uint4(l[0], l[1], l[2], l[3]);
}

// An f32 staging tile of `pitch4` float4s a row, float4 c4 of row r at
// c4 ^ (r & 7): the 8 rows a quarter-warp reads at once fall on distinct
// banks.
__device__ __forceinline__ float* swz(float* t, int pitch4, int r, int c) {
  return t + (r * pitch4 + ((c >> 2) ^ (r & 7))) * 4 + (c & 3);
}

// This thread's two chunks (8 columns each, jb = 0, 1) of rows [rb, rb
// + 32) of a 64-column tile, the same for the copy into the staging
// tile and for the split out of it, so that neither needs a barrier:
// each warp takes 8 rows x 4 chunks at a time.
__device__ __forceinline__ void dy_chunk(int rb, int jb, int& r, int& c) {
  const int lane = threadIdx.x & 31, job = ((threadIdx.x >> 5) & 3) + 4 * jb;
  r = rb + (job & 3) * 8 + (lane & 7);
  c = ((job >> 2) * 4 + (lane >> 3)) * 8;
}

// This thread's chunks of rows [rb, rb + 32) of an f32 tile (row stride
// ld, nr rows and P columns real) into the staging tile by cp.async, 16
// bytes a copy where `vec`, else 4; what is not real is left as it is
// (split_dy masks it).
__device__ __forceinline__ void stage_dy(float* t, const float* __restrict__ src,
                                         long long ld, int rb, int nr, int P,
                                         bool vec) {
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    int r, c;
    dy_chunk(rb, jb, r, c);
    if (r >= nr) continue;
    const float* s = src + r * ld + c;
    if (vec) {
      if (c < P) cp_async16(swz(t, 16, r, c), s);
      if (c + 4 < P) cp_async16(swz(t, 16, r, c + 4), s + 4);
    } else {
      for (int e = 0; e < 8 && c + e < P; ++e)
        cp_async4(swz(t, 16, r, c + e), s + e);
    }
  }
}

// This thread's chunks of the staged tile (nr rows, P columns real, the
// rest zero) into bf16 hi and lo tiles [64 x 64].
__device__ __forceinline__ void split_dy(unsigned char* hi, unsigned char* lo,
                                         float* t, int rb, int nr, int P) {
#pragma unroll
  for (int jb = 0; jb < 2; ++jb) {
    int r, c;
    dy_chunk(rb, jb, r, c);
    float v[8];
    if (r < nr && c + 8 <= P) {
      const float4 u = *reinterpret_cast<const float4*>(swz(t, 16, r, c));
      const float4 w = *reinterpret_cast<const float4*>(swz(t, 16, r, c + 4));
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
      v[4] = w.x; v[5] = w.y; v[6] = w.z; v[7] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = r < nr && c + e < P ? *swz(t, 16, r, c + e) : 0.0f;
    }
    uint4 h, l;
    split8(v, h, l);
    *reinterpret_cast<uint4*>(hi + tile_off(r, c)) = h;
    *reinterpret_cast<uint4*>(lo + tile_off(r, c)) = l;
  }
}

// What an item's two warpgroups share (see the head comment): the
// item, its shared memory, and this thread's fragment rows r0, r1 and
// column offset cp (in its warpgroup).
struct Item {
  long long bc, row0, bh0;       // b*c, its first row, (b*c)*H + h0
  int kt, k0, nk, g, h0, nh, nqt, T, nks, nkp, rowf;
  int wg, wt, lane, r0, r1, cp, ka, kb, rb;   // rb: this warpgroup's rows
  float4* gt;                    // C B^T tiles (kCache)
  float4* dga;                   // dG tiles (kCache)
  unsigned char* ctiles;         // three C tiles (!kCache)
  float* rows;                   // two da / cum rows, by head parity
  unsigned char* btile;
  unsigned char* xtiles;         // two x tiles, by head parity
  unsigned char* D;
  float* stage;
  float* red;
  float4* gp;                    // the item's dG slots in the scratch
};

__device__ __forceinline__ unsigned char* dy_tiles(const Item& it, int t) {
  return it.D + 2 * kTileP * (t & 1);          // hi, then lo
}

// This warpgroup's half of pair t's dy tile into the staging tile
// (warpgroup 0 also takes its C tile without the cache), one group.
template <bool kCache>
__device__ __forceinline__ void issue_pair(const BwdArgs& a, const Item& it,
                                           int t) {
  const int h = it.h0 + t / it.nqt, q0 = (it.kt + t % it.nqt) * 64;
  stage_dy(it.stage, a.dy + ((it.row0 + q0) * a.H + h) * a.P,
           static_cast<long long>(a.H) * a.P, it.rb, min(64, a.Q - q0), a.P,
           a.vec_dy);
  if (!kCache && it.wg == 0)
    load_tile<16>(it.ctiles + kTileN * (t % 3), a.Cm + (it.row0 + q0) * a.N,
                  a.N, min(64, a.Q - q0), a.N, a.vec_bc);
  cp_commit();
}
// This warpgroup's half of pair t's staged dy into its hi / lo tiles.
__device__ __forceinline__ void split_pair(const BwdArgs& a, const Item& it,
                                           int t) {
  const int q0 = (it.kt + t % it.nqt) * 64;
  unsigned char* y = dy_tiles(it, t);
  split_dy(y, y + kTileP, it.stage, it.rb, min(64, a.Q - q0), a.P);
}
// Head i's x tile and da row (warpgroup 0), one group.
__device__ __forceinline__ void issue_head(const BwdArgs& a, const Item& it,
                                           int i) {
  const int h = it.h0 + i;
  load_tile<8>(it.xtiles + kTileP * (i & 1),
               a.x + ((it.row0 + it.k0) * a.H + h) * a.P,
               static_cast<long long>(a.H) * a.P, it.nk, a.P, a.vec_x);
  load_row(it.rows + (i & 1) * it.rowf, a.da + (it.bc * a.H + h) * a.Q, a.Q,
           a.vec_da);
  cp_commit();
}

// This warpgroup's half of head i's dst [P, N] (f32) into registers,
// and its split into bf16 hi and lo tiles [64 p x 128 n], zero-padded:
// each thread takes 4 of the 1,024 8-column chunks (warpgroup 0 rows
// 0-31, warpgroup 1 rows 32-63).
__device__ __forceinline__ void dst_chunk(int j, int& r, int& c) {
  const int job = (threadIdx.x >> 5) + 8 * j, lane = threadIdx.x & 31;
  r = (job & 7) * 8 + (lane & 7);
  c = ((job >> 3) * 4 + (lane >> 3)) * 8;
}
__device__ __forceinline__ void dst_load(float (&v)[4][8], const BwdArgs& a,
                                         const Item& it, int i) {
  const float* src = a.dst + (it.bh0 + i) * a.P * a.N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int r, c;
    dst_chunk(j, r, c);
    const float* s = src + static_cast<long long>(r) * a.N + c;
    if (a.vec_dst && r < a.P && c + 8 <= a.N) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(s));
      const float4 w = __ldg(reinterpret_cast<const float4*>(s + 4));
      v[j][0] = u.x; v[j][1] = u.y; v[j][2] = u.z; v[j][3] = u.w;
      v[j][4] = w.x; v[j][5] = w.y; v[j][6] = w.z; v[j][7] = w.w;
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[j][e] = r < a.P && c + e < a.N ? __ldg(s + e) : 0.0f;
    }
  }
}
__device__ __forceinline__ void dst_split(const float (&v)[4][8],
                                          const Item& it) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int r, c;
    dst_chunk(j, r, c);
    uint4 h, l;
    split8(v[j], h, l);
    *reinterpret_cast<uint4*>(it.D + tile_off(r, c)) = h;
    *reinterpret_cast<uint4*>(it.D + kTileN + tile_off(r, c)) = l;
  }
}

// (C B^T)^T of C tile `ct` (k rows, q columns) into s
__device__ __forceinline__ void cbt_tile(float (&s)[32], const Item& it,
                                         const unsigned char* ct) {
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.0f;
  fence_regs(s);
  wgmma_fence();
  for (int kk = 0; kk < it.nks; ++kk)
    wgmma_ss_n64(s, desc(it.btile + kk * 2048, 1024, 128),
                 desc(ct + kk * 2048, 1024, 128));
  wgmma_commit_wait();
  fence_regs(s);
}

// The decay of element (jj, e) of this thread's fragment at q-tile q0:
// exp(cum[q] - cum[k]) for k <= q < Q, else 0 (branch-free: the
// exponent of a masked pair is -1e30). L[4]: (r0, q), (r0, q+1), (r1,
// q), (r1, q+1).
__device__ __forceinline__ void decay4(float (&L)[4], const Item& it,
                                       const float* cum, float cka,
                                       float ckb, int q0, int jj, int Q) {
  const int qc = q0 + 8 * jj + it.cp;
  const float2 cq = *reinterpret_cast<const float2*>(cum + qc);
  const int la = it.ka - q0 - it.cp, lb = it.kb - q0 - it.cp;
  const bool v0 = qc < Q, v1 = qc + 1 < Q;
  L[0] = expf(v0 && 8 * jj >= la ? cq.x - cka : -1e30f);
  L[1] = expf(v1 && 8 * jj + 1 >= la ? cq.y - cka : -1e30f);
  L[2] = expf(v0 && 8 * jj >= lb ? cq.x - ckb : -1e30f);
  L[3] = expf(v1 && 8 * jj + 1 >= lb ? cq.y - ckb : -1e30f);
}

// chunk_cumsum's order over n values, in place, by warpgroup 1: each
// warp scans segments of 32 (warp w: w, w + 4, ..); then each segment
// adds its carry, the segments' totals folded in order (as the one-warp
// scan carries them), in `tot`.
__device__ void cumsum_wg(float* v, int n, float* tot) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int nseg = (n + 31) / 32;
  for (int s = warp; s < nseg; s += 4) {
    const int i = 32 * s + lane;
    float x = i < n ? v[i] : 0.0f;
    for (int o = 1; o < 32; o <<= 1) {
      const float u = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += u;
    }
    if (i < n) v[i] = x;
    if (lane == 31) tot[s] = x;
  }
  wg_bar(1);
  for (int s = warp; s < nseg; s += 4) {
    float carry = 0.0f;
    for (int u = 0; u < s; ++u) carry = tot[u] + carry;
    const int i = 32 * s + lane;
    if (i < n) v[i] = v[i] + carry;
  }
}

// The item's r o (x dst) over its heads (k rows, n columns), on the dx
// side: xd += (r o x) dst, r o x split hi / lo in registers, dst's hi /
// lo tiles MN-major in D.
__device__ __forceinline__ void xd_add(float (&xd)[64], const Item& it,
                                       const unsigned char* xt, float ra,
                                       float rb) {
  uint32_t xf[16], ah[16], al[16];
  tile_frags<4>(xf, xt, it.r0, it.r1, it.cp);
#pragma unroll
  for (int f = 0; f < 16; ++f) {
    const float2 u = bf2(xf[f]);
    const float r = f & 1 ? rb : ra;
    split2(r * u.x, r * u.y, ah[f], al[f]);
  }
  fence_regs(xd);
  fence_regs(ah);
  fence_regs(al);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk >= it.nkp) break;
    const uint64_t bh = desc(it.D + kk * 256, 128, 1024);
    const uint64_t bl = desc(it.D + kTileN + kk * 256, 128, 1024);
    wgmma_rs_n128(xd, ah + 4 * kk, bh);
    wgmma_rs_n128(xd, ah + 4 * kk, bl);
    wgmma_rs_n128(xd, al + 4 * kk, bh);
  }
  wgmma_commit_wait();
  fence_regs(xd);
  fence_regs(ah);
  fence_regs(al);
}
// The item's r o (x dst) into its scratch slot (fragment order).
__device__ __forceinline__ void xd_out(const float (&xd)[64],
                                       const BwdArgs& a, const Item& it) {
  float4* bp = reinterpret_cast<float4*>(a.dbp) +
               ((it.bc * a.nG + it.g) * a.nT + it.kt) * 2 *
                   static_cast<long long>(kFrag4);
#pragma unroll
  for (int f = 0; f < 16; ++f)
    bp[f * kWgThreads + it.wt] =
        make_float4(xd[4 * f], xd[4 * f + 1], xd[4 * f + 2], xd[4 * f + 3]);
}

// Warpgroup 0, the dx side and the loader (the B tile, x, da and the C
// tiles): per head r o (x dst); per pair S^T = (C B^T)^T o L,
// split, and dx += S^T dy (dx starting as r o B dst^T), its half of the
// next pair's dy split while that runs; dx out.
template <bool kCache>
__device__ __forceinline__ void bwd_dx_side(const BwdArgs& a,
                                            const Item& it) {
  const int Q = a.Q, H = a.H, P = a.P, wt = it.wt;
  float xd[64];                         // sum_h r o (x dst)
#pragma unroll
  for (int e = 0; e < 64; ++e) xd[e] = 0.0f;
  float v[4][8];                        // this half of dst, a head ahead
  dst_load(v, a, it, 0);
  int t = 0;
  for (int i = 0; i < it.nh; ++i) {
    cp_wait_all();                      // x(i), da(i), pair t: this half
    __syncthreads();                    // HS0: the last pair's D read
    dst_split(v, it);
    fence_async();
    __syncthreads();                    // HS1: dst tiles, x(i), da(i)
    if (i + 1 < it.nh) issue_head(a, it, i + 1);
    __syncthreads();                    // HS2: cum(i)
    const float* cum = it.rows + (i & 1) * it.rowf;
    const unsigned char* xt = it.xtiles + kTileP * (i & 1);
    const float last = cum[Q - 1];
    const float cka = it.ka < Q ? cum[it.ka] : 0.0f;
    const float ckb = it.kb < Q ? cum[it.kb] : 0.0f;
    const float ra = it.ka < Q ? expf(last - cka) : 0.0f;
    const float rb = it.kb < Q ? expf(last - ckb) : 0.0f;
    xd_add(xd, it, xt, ra, rb);
    __syncthreads();                    // HS3: the dst tiles consumed
    split_pair(a, it, t);
    fence_async();
    if (t + 1 < it.T) issue_pair<kCache>(a, it, t + 1);
    __syncthreads();                    // HS4: r o B dst^T in D
    float dx[32];                       // dx starts as r o B dst^T
    {
      const float4* rbd =
          reinterpret_cast<const float4*>(dy_tiles(it, t + 1));
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float4 w = rbd[jj * kWgThreads + wt];
        dx[4 * jj] = w.x; dx[4 * jj + 1] = w.y;
        dx[4 * jj + 2] = w.z; dx[4 * jj + 3] = w.w;
      }
    }
    for (int j = 0; j < it.nqt; ++j, ++t) {
      const int q0 = (it.kt + j) * 64;
      const unsigned char* yh = dy_tiles(it, t);
      __syncthreads();                  // B1: pair t's dy tiles
      float gs[32];
      if (!kCache) cbt_tile(gs, it, it.ctiles + kTileN * (t % 3));
      const float4* gtt = it.gt + j * kFrag4;
      uint32_t sh[16], sl[16];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float L[4];
        decay4(L, it, cum, cka, ckb, q0, jj, Q);
        float4 gv;
        if (kCache) gv = gtt[jj * kWgThreads + wt];
        else gv = make_float4(gs[4 * jj], gs[4 * jj + 1], gs[4 * jj + 2],
                              gs[4 * jj + 3]);
        const int f = 4 * (jj >> 1) + 2 * (jj & 1);
        split2(gv.x * L[0], gv.y * L[1], sh[f], sl[f]);
        split2(gv.z * L[2], gv.w * L[3], sh[f + 1], sl[f + 1]);
      }
      fence_regs(dx);
      fence_regs(sh);
      fence_regs(sl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // hi.hi + hi.lo + lo.hi
        const uint64_t dh = desc(yh + kk * 256, 128, 1024);
        const uint64_t dl = desc(yh + kTileP + kk * 256, 128, 1024);
        wgmma_rs_n64(dx, sh + 4 * kk, dh);
        wgmma_rs_n64(dx, sh + 4 * kk, dl);
        wgmma_rs_n64(dx, sl + 4 * kk, dh);
      }
      wgmma_commit();
      if (j + 1 < it.nqt) {             // this thread's share of the next
        cp_wait_all();                  // pair's dy (the copies are its own)
        split_pair(a, it, t + 1);
        fence_async();
        if (t + 2 < it.T) issue_pair<kCache>(a, it, t + 2);
      }
      wgmma_wait();
      fence_regs(dx);
      fence_regs(sh);                   // read by the wgmmas until here
      fence_regs(sl);
    }
    if (i + 1 < it.nh) dst_load(v, a, it, i + 1);
    const int h = it.h0 + i;            // dx = r o B dst^T + S^T dy
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float* vv = dx + 4 * jj;
      const int p = 8 * jj + it.cp;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = e ? it.kb : it.ka;
        if (k >= Q || p >= P) continue;
        bf16* out = a.dx + ((it.row0 + k) * H + h) * P + p;
        if ((P & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(out) =
              __floats2bfloat162_rn(vv[2 * e], vv[2 * e + 1]);
        } else {
          out[0] = __float2bfloat16_rn(vv[2 * e]);
          if (p + 1 < P) out[1] = __float2bfloat16_rn(vv[2 * e + 1]);
        }
      }
    }
  }
  xd_out(xd, a, it);
}

// Warpgroup 1, the dS side: per head cum, B dst^T (r o B dst^T handed to
// warpgroup 0 through D at the head's start) and rho; per pair dS^T = x
// dy^T, dS^T o L added into the dG tiles (shared memory with the cache,
// else the item's scratch slots; first head writes), E's row sums over
// the k-tile and its column sums; its half of the next pair's dy split.
template <bool kCache>
__device__ __forceinline__ void bwd_ds_side(const BwdArgs& a,
                                            const Item& it) {
  const int Q = a.Q, wt = it.wt, lane = it.lane, wwarp = wt >> 5;
  float v[4][8];                        // this half of dst, a head ahead
  dst_load(v, a, it, 0);
  int t = 0;
  for (int i = 0; i < it.nh; ++i) {
    const long long bch = it.bh0 + i;
    cp_wait_all();                      // pair t: this half
    __syncthreads();                    // HS0: the last pair's D read
    dst_split(v, it);
    fence_async();
    __syncthreads();                    // HS1: dst tiles, x(i), da(i)
    float* cum = it.rows + (i & 1) * it.rowf;
    cumsum_wg(cum, Q, it.red);
    __syncthreads();                    // HS2: cum(i)
    const unsigned char* xt = it.xtiles + kTileP * (i & 1);
    const float last = cum[Q - 1];
    const float cka = it.ka < Q ? cum[it.ka] : 0.0f;
    const float ckb = it.kb < Q ? cum[it.kb] : 0.0f;
    const float ra = it.ka < Q ? expf(last - cka) : 0.0f;
    const float rb = it.kb < Q ? expf(last - ckb) : 0.0f;
    uint32_t xa[16];                    // x: k rows, p (K) columns
    tile_frags<4>(xa, xt, it.r0, it.r1, it.cp);
    float bd[32];                       // B dst^T: k rows, p columns
    {
      uint32_t bf[32];
      tile_frags<8>(bf, it.btile, it.r0, it.r1, it.cp);
#pragma unroll
      for (int e = 0; e < 32; ++e) bd[e] = 0.0f;
      fence_regs(bd);
      fence_regs(bf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {  // A in registers: static indices
        if (kk >= it.nks) break;
        wgmma_rs_n64_k(bd, bf + 4 * kk, desc(it.D + kk * 2048, 1024, 128));
        wgmma_rs_n64_k(bd, bf + 4 * kk,
                       desc(it.D + kTileN + kk * 2048, 1024, 128));
      }
      wgmma_commit_wait();
      fence_regs(bd);
      fence_regs(bf);                   // read by the wgmmas until here
    }
    __syncthreads();                    // HS3: the dst tiles consumed
    split_pair(a, it, t);
    fence_async();
    if (t + 1 < it.T) issue_pair<kCache>(a, it, t + 1);
    {                                   // rho[k] = r[k] sum_p x[k,p] bd[k,p]
      float pa = 0.0f, pb = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 u = bf2(xa[4 * (jj >> 1) + 2 * (jj & 1)]);
        const float2 w = bf2(xa[4 * (jj >> 1) + 2 * (jj & 1) + 1]);
        pa = fmaf(u.x, bd[4 * jj], pa);
        pa = fmaf(u.y, bd[4 * jj + 1], pa);
        pb = fmaf(w.x, bd[4 * jj + 2], pb);
        pb = fmaf(w.y, bd[4 * jj + 3], pb);
      }
      pa += __shfl_xor_sync(0xffffffffu, pa, 1);
      pa += __shfl_xor_sync(0xffffffffu, pa, 2);
      pb += __shfl_xor_sync(0xffffffffu, pb, 1);
      pb += __shfl_xor_sync(0xffffffffu, pb, 2);
      if ((lane & 3) == 0) {
        if (it.ka < Q) a.rho[bch * Q + it.ka] = ra * pa;
        if (it.kb < Q) a.rho[bch * Q + it.kb] = rb * pb;
      }
      // r o B dst^T for dx, in the dy buffer of the head's second pair
      // (free until that pair is split, after B1 of the first)
      float4* rbd = reinterpret_cast<float4*>(dy_tiles(it, t + 1));
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        rbd[jj * kWgThreads + wt] =
            make_float4(ra * bd[4 * jj], ra * bd[4 * jj + 1],
                        rb * bd[4 * jj + 2], rb * bd[4 * jj + 3]);
    }
    __syncthreads();                    // HS4: r o B dst^T in D
    float ea = 0.0f, eb = 0.0f;         // E's column sums, this thread's
    for (int j = 0; j < it.nqt; ++j, ++t) {
      const int q0 = (it.kt + j) * 64;
      const unsigned char* yh = dy_tiles(it, t);
      __syncthreads();                  // B1: pair t's dy tiles
      float gs[32];
      if (!kCache) cbt_tile(gs, it, it.ctiles + kTileN * (t % 3));
      float ds[32];                     // dS^T = x dy^T: k rows, q columns
#pragma unroll
      for (int e = 0; e < 32; ++e) ds[e] = 0.0f;
      fence_regs(ds);
      fence_regs(xa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {  // A in registers: static indices
        if (kk >= it.nkp) break;
        wgmma_rs_n64_k(ds, xa + 4 * kk, desc(yh + kk * 2048, 1024, 128));
        wgmma_rs_n64_k(ds, xa + 4 * kk,
                       desc(yh + kTileP + kk * 2048, 1024, 128));
      }
      wgmma_commit_wait();
      fence_regs(ds);
      fence_regs(xa);                   // read by the wgmmas until here
      float4* dgt = kCache ? it.dga + j * kFrag4
                           : it.gp + pair_index(it.kt + j, it.kt) *
                                         static_cast<long long>(kFrag4);
      const float4* gtt = it.gt + j * kFrag4;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        float L[4];
        decay4(L, it, cum, cka, ckb, q0, jj, Q);
        float4 gv;
        if (kCache) gv = gtt[jj * kWgThreads + wt];
        else gv = make_float4(gs[4 * jj], gs[4 * jj + 1], gs[4 * jj + 2],
                              gs[4 * jj + 3]);
        const float d0 = ds[4 * jj], d1 = ds[4 * jj + 1];
        const float d2 = ds[4 * jj + 2], d3 = ds[4 * jj + 3];
        const float e0 = d0 * (gv.x * L[0]), e1 = d1 * (gv.y * L[1]);
        const float e2 = d2 * (gv.z * L[2]), e3 = d3 * (gv.w * L[3]);
        float4 acc = i == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                            : dgt[jj * kWgThreads + wt];
        acc.x = fmaf(d0, L[0], acc.x);
        acc.y = fmaf(d1, L[1], acc.y);
        acc.z = fmaf(d2, L[2], acc.z);
        acc.w = fmaf(d3, L[3], acc.w);
        dgt[jj * kWgThreads + wt] = acc;
        ea += e0 + e1;
        eb += e2 + e3;
        // E's row sums over this warp's 16 k rows, columns qc, qc + 1
        float c0 = e0 + e2, c1 = e1 + e3;
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          c0 += __shfl_xor_sync(0xffffffffu, c0, o);
          c1 += __shfl_xor_sync(0xffffffffu, c1, o);
        }
        if (lane < 4) {
          it.red[wwarp * 64 + 8 * jj + it.cp] = c0;
          it.red[wwarp * 64 + 8 * jj + it.cp + 1] = c1;
        }
      }
      wg_bar(1);                        // red written
      if (wt < 64 && q0 + wt < Q)
        a.rowp[(bch * a.nT + it.kt) * Q + q0 + wt] =
            it.red[wt] + it.red[64 + wt] + it.red[128 + wt] +
            it.red[192 + wt];
      if (j + 1 < it.nqt) {             // this thread's share of the next
        cp_wait_all();                  // pair's dy (the copies are its own)
        split_pair(a, it, t + 1);
        fence_async();
        if (t + 2 < it.T) issue_pair<kCache>(a, it, t + 2);
      }
    }
    if (i + 1 < it.nh) dst_load(v, a, it, i + 1);
    ea += __shfl_xor_sync(0xffffffffu, ea, 1);
    ea += __shfl_xor_sync(0xffffffffu, ea, 2);
    eb += __shfl_xor_sync(0xffffffffu, eb, 1);
    eb += __shfl_xor_sync(0xffffffffu, eb, 2);
    if ((lane & 3) == 0) {
      if (it.ka < Q) a.colE[bch * Q + it.ka] = ea;
      if (it.kb < Q) a.colE[bch * Q + it.kb] = eb;
    }
  }
  if (kCache) {                         // the item's dG tiles
    for (int j = 0; j < it.nqt; ++j) {
      float4* slot = it.gp + pair_index(it.kt + j, it.kt) *
                                 static_cast<long long>(kFrag4);
#pragma unroll
      for (int f = 0; f < 8; ++f)
        slot[f * kWgThreads + wt] = it.dga[j * kFrag4 + f * kWgThreads + wt];
    }
  }
}

// Items (b*c, k-tile, head group), k-tile 0 first (it meets every
// q-tile); two warpgroups a block, one item each block.
template <bool kCache>
__global__ void __launch_bounds__(2 * kWgThreads, 1)
ssd_bwd_wgmma_kernel(const BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char bwd_smem[];
  const long long per = a.BC * a.nG, rest = blockIdx.x % per;
  unsigned char* smem = bwd_smem;
  Item it;
  it.bc = rest / a.nG;
  it.g = static_cast<int>(rest % a.nG);
  it.kt = static_cast<int>(blockIdx.x / per);
  it.k0 = it.kt * 64;
  it.nk = min(64, a.Q - it.k0);
  it.h0 = it.g * kHeadsB;
  it.nh = min(kHeadsB, a.H - it.h0);
  it.nqt = a.nT - it.kt;
  it.T = it.nh * it.nqt;
  it.nks = (a.N + 15) / 16;
  it.nkp = (a.P + 15) / 16;
  it.rowf = a.nT * 64;
  it.row0 = it.bc * a.Q;
  it.bh0 = it.bc * a.H + it.h0;
  it.wg = threadIdx.x >> 7;
  it.wt = threadIdx.x & (kWgThreads - 1);
  it.lane = threadIdx.x & 31;
  it.r0 = 16 * (it.wt >> 5) + (it.lane >> 2);
  it.r1 = it.r0 + 8;
  it.cp = 2 * (it.lane & 3);
  it.ka = it.k0 + it.r0;
  it.kb = it.k0 + it.r1;
  it.rb = 32 * it.wg;
  it.gt = reinterpret_cast<float4*>(smem);
  it.dga = reinterpret_cast<float4*>(smem + kOffDga);
  it.ctiles = smem;
  it.rows = reinterpret_cast<float*>(smem + (kCache ? kOffRows : kOffDga));
  it.btile = smem + kOffB;
  it.xtiles = smem + kOffX;
  it.D = smem + kOffD;
  it.stage = reinterpret_cast<float*>(smem + kOffStage);
  it.red = reinterpret_cast<float*>(smem + kOffRed);
  it.gp = reinterpret_cast<float4*>(a.dgp) +
          (it.bc * a.nG + it.g) * a.nPairs * static_cast<long long>(kFrag4);

  // prologue: the B tile, head 0's x and da, pair 0; with the cache the
  // C B^T tiles (warpgroup 0 brings the C tiles into D, warpgroup 1
  // multiplies)
  if (it.wg == 0) {
    load_tile<16>(it.btile, a.Bm + (it.row0 + it.k0) * a.N, a.N, it.nk, a.N,
                  a.vec_bc);
    issue_head(a, it, 0);
  }
  issue_pair<kCache>(a, it, 0);
  if (kCache) {
    auto issue_c = [&](int j) {
      const int q0 = (it.kt + j) * 64;
      load_tile<16>(it.D + kTileN * (j & 1), a.Cm + (it.row0 + q0) * a.N,
                    a.N, min(64, a.Q - q0), a.N, a.vec_bc);
      cp_commit();
    };
    if (it.wg == 0) issue_c(0);
    for (int j = 0; j < it.nqt; ++j) {
      if (it.wg == 0) {
        cp_wait_all();
        fence_async();
      }
      __syncthreads();                  // C tile j in; tile j-1 consumed
      if (it.wg == 0) {
        if (j + 1 < it.nqt) issue_c(j + 1);
      } else {
        float s[32];
        cbt_tile(s, it, it.D + kTileN * (j & 1));
#pragma unroll
        for (int f = 0; f < 8; ++f)
          it.gt[j * kFrag4 + f * kWgThreads + it.wt] = make_float4(
              s[4 * f], s[4 * f + 1], s[4 * f + 2], s[4 * f + 3]);
      }
    }
  }
  __syncthreads();                      // the prologue's tiles consumed
  if (it.wg == 0)
    bwd_dx_side<kCache>(a, it);
  else
    bwd_ds_side<kCache>(a, it);
}

// Blocks [0, sum_blocks): one thread per float4 of the items' slots,
// the head groups added in order into group 0's; then blocks of four
// (b*c, h) rows, one a warp: dcum and dda.
__global__ void __launch_bounds__(kWgThreads)
ssd_bwd_gsum_kernel(const BwdArgs a, long long sum_blocks) {
  const int tid = threadIdx.x;
  const long long g_dg = static_cast<long long>(a.nPairs) * kFrag4;
  const long long g_db = static_cast<long long>(a.nT) * 2 * kFrag4;
  if (blockIdx.x < sum_blocks) {
    const long long e = static_cast<long long>(blockIdx.x) * kWgThreads + tid;
    const long long per = g_dg + g_db;
    if (e >= a.BC * per) return;
    const long long bc = e / per;
    long long o = e % per;
    float4* p;
    long long stride;
    if (o < g_dg) {
      p = reinterpret_cast<float4*>(a.dgp) + bc * a.nG * g_dg + o;
      stride = g_dg;
    } else {
      o -= g_dg;
      p = reinterpret_cast<float4*>(a.dbp) + bc * a.nG * g_db + o;
      stride = g_db;
    }
    float4 s = p[0];
#pragma unroll 4
    for (int g = 1; g < a.nG; ++g) {
      const float4 w = p[g * stride];
      s.x += w.x; s.y += w.y; s.z += w.z; s.w += w.w;
    }
    p[0] = s;
    return;
  }
  const int lane = tid & 31, Q = a.Q, nT = a.nT;
  const long long row = (blockIdx.x - sum_blocks) * 4 + (tid >> 5);
  if (row >= a.BC * a.H) return;
  const float* rho = a.rho + row * Q;
  const float* colE = a.colE + row * Q;
  const float* rowp = a.rowp + row * nT * Q;
  float rs = 0.0f;                      // sum_k rho[k]: lanes, then a tree
  for (int k = lane; k < Q; k += 32) rs += rho[k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
  // dda = the reverse cumulative sum of dcum, in chunk_cumsum's order
  // over the reversed axis
  float carry = 0.0f;
  for (int base = 0; base < Q; base += 32) {
    const int i = base + lane, q = Q - 1 - i;
    float v = 0.0f;
    if (i < Q) {
      float e = 0.0f;
      for (int kt = 0; kt <= q / 64; ++kt) e += rowp[kt * Q + q];
      v = e - colE[q] - rho[q];
      if (i == 0) v += rs;
    }
    for (int o = 1; o < 32; o <<= 1) {
      const float t = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += t;
    }
    v += carry;
    if (i < Q) a.dda[row * Q + q] = v;
    carry = __shfl_sync(0xffffffffu, v, 31);
  }
}

// dB for k-tile t (which = 1: sum over q-tiles >= t of dG^T C, plus the
// summed r o (x dst)) or dC for q-tile t (0: sum over k-tiles <= t of dG
// B), from group 0's summed slots; m64n128k16 with the dG tile split
// hi / lo in registers (dC: transposed through shared memory) and the
// C or B tiles MN-major by cp.async, two stages.
__global__ void __launch_bounds__(kWgThreads)
ssd_bwd_dbc_kernel(const BwdArgs a) {
  extern __shared__ __align__(1024) unsigned char dbc_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = 16 * warp + (lane >> 2), r1 = r0 + 8, cp = 2 * (lane & 3);
  const int Q = a.Q, N = a.N, nT = a.nT;
  // heaviest first: level l holds dB of k-tile l and dC of q-tile
  // nT-1-l, each nT-l products
  const int lvl = static_cast<int>(blockIdx.x / (2 * a.BC));
  const long long rest = blockIdx.x % (2 * a.BC), bc = rest >> 1;
  const bool want_dB = rest & 1;
  const int t = want_dB ? lvl : nT - 1 - lvl;
  const int first = want_dB ? t : 0, n_o = nT - lvl;
  const long long row0 = bc * Q;
  unsigned char* ring = dbc_smem;
  float* tt = reinterpret_cast<float*>(dbc_smem + 2 * kTileN);  // [64][65]
  const bf16* V = want_dB ? a.Cm : a.Bm;
  auto issue = [&](int j) {
    const int o0 = (first + j) * 64;
    load_tile<16>(ring + kTileN * (j & 1), V + (row0 + o0) * N, N,
                  min(64, Q - o0), N, a.vec_bc);
  };
  issue(0);
  cp_commit();
  const float4* gp = reinterpret_cast<const float4*>(a.dgp) +
                     bc * a.nG * a.nPairs * static_cast<long long>(kFrag4);
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
  for (int j = 0; j < n_o; ++j) {
    const int o = first + j;
    const float4* src =
        gp + (want_dB ? pair_index(o, t) : pair_index(t, o)) *
                 static_cast<long long>(kFrag4);
    float v[32];                // (dG^T): k rows, q columns
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const float4 w = src[f * kWgThreads + tid];
      v[4 * f] = w.x; v[4 * f + 1] = w.y; v[4 * f + 2] = w.z;
      v[4 * f + 3] = w.w;
    }
    if (!want_dB) {             // dG: q rows, k columns
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * jj + cp;
        tt[r0 * 65 + c] = v[4 * jj];
        tt[r0 * 65 + c + 1] = v[4 * jj + 1];
        tt[r1 * 65 + c] = v[4 * jj + 2];
        tt[r1 * 65 + c + 1] = v[4 * jj + 3];
      }
      __syncthreads();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 8 * jj + cp;
        v[4 * jj] = tt[c * 65 + r0];
        v[4 * jj + 1] = tt[(c + 1) * 65 + r0];
        v[4 * jj + 2] = tt[c * 65 + r1];
        v[4 * jj + 3] = tt[(c + 1) * 65 + r1];
      }
    }
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int f = 4 * (jj >> 1) + 2 * (jj & 1);
      split2(v[4 * jj], v[4 * jj + 1], hi[f], lo[f]);
      split2(v[4 * jj + 2], v[4 * jj + 3], hi[f + 1], lo[f + 1]);
    }
    cp_wait<0>();               // tile j in; tile j-1 and tt consumed
    if (j + 1 < n_o) issue(j + 1);
    cp_commit();
    const unsigned char* vt = ring + kTileN * (j & 1);
    fence_regs(acc);
    fence_regs(hi);
    fence_regs(lo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t d = desc(vt + kk * 256, 128, 1024);
      wgmma_rs_n128(acc, hi + 4 * kk, d);
      wgmma_rs_n128(acc, lo + 4 * kk, d);
    }
    wgmma_commit_wait();
    fence_regs(acc);
    fence_regs(hi);                     // read by the wgmmas until here
    fence_regs(lo);
  }
  if (want_dB) {                // + the summed r o (x dst)
    const float4* bp = reinterpret_cast<const float4*>(a.dbp) +
                       (bc * a.nG * nT + t) * 2 * static_cast<long long>(kFrag4);
#pragma unroll
    for (int f = 0; f < 16; ++f) {
      const float4 w = bp[f * kWgThreads + tid];
      acc[4 * f] += w.x; acc[4 * f + 1] += w.y;
      acc[4 * f + 2] += w.z; acc[4 * f + 3] += w.w;
    }
  }
  bf16* out = want_dB ? a.dB : a.dC;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj) {
    const int n = 8 * jj + cp;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = t * 64 + (e ? r1 : r0);
      if (r >= Q || n >= N) continue;
      bf16* o = out + (row0 + r) * N + n;
      const float v0 = acc[4 * jj + 2 * e], v1 = acc[4 * jj + 2 * e + 1];
      if ((N & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = __float2bfloat16_rn(v0);
        if (n + 1 < N) o[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

int launch_bwd_wgmma(const void* x, const void* Bm, const void* Cm,
                     const void* da, const void* dy, const void* dst,
                     void* dx, void* dB, void* dC, void* dda,
                     void* const* scratch, int BC, int Q, int H, int P,
                     int N, cudaStream_t stream) {
  BwdArgs a;
  a.x = static_cast<const bf16*>(x);
  a.Bm = static_cast<const bf16*>(Bm);
  a.Cm = static_cast<const bf16*>(Cm);
  a.da = static_cast<const float*>(da);
  a.dy = static_cast<const float*>(dy);
  a.dst = static_cast<const float*>(dst);
  a.dx = static_cast<bf16*>(dx);
  a.dB = static_cast<bf16*>(dB);
  a.dC = static_cast<bf16*>(dC);
  a.dda = static_cast<float*>(dda);
  a.dgp = static_cast<float*>(scratch[0]);
  a.dbp = static_cast<float*>(scratch[1]);
  a.rowp = static_cast<float*>(scratch[2]);
  a.colE = static_cast<float*>(scratch[3]);
  a.rho = static_cast<float*>(scratch[4]);
  a.BC = BC;
  a.Q = Q; a.H = H; a.P = P; a.N = N;
  a.nG = (H + kHeadsB - 1) / kHeadsB;
  a.nT = n_tiles(Q);
  a.nPairs = a.nT * (a.nT + 1) / 2;
  a.vec_x = P % 8 == 0 && aligned16(x);
  a.vec_bc = N % 8 == 0 && aligned16(Bm) && aligned16(Cm);
  a.vec_da = Q % 4 == 0 && aligned16(da);
  a.vec_dy = P % 4 == 0 && aligned16(dy);
  a.vec_dst = N % 4 == 0 && aligned16(dst);
  const long long items = static_cast<long long>(BC) * a.nT * a.nG;
  const long long sums =
      (static_cast<long long>(BC) * (a.nPairs + 2LL * a.nT) * kFrag4 +
       kWgThreads - 1) / kWgThreads;
  const long long gsum_blocks = sums + (static_cast<long long>(BC) * H + 3) / 4;
  const long long dbc_blocks = 2LL * BC * a.nT;
  if (items > 2147483647LL || gsum_blocks > 2147483647LL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem_item = bwd_item_smem_bytes(Q);
  const size_t smem_dbc = bwd_dbc_smem_bytes();
  const auto item_kernel = bwd_cache(Q) ? ssd_bwd_wgmma_kernel<true>
                                        : ssd_bwd_wgmma_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      item_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_item));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_dbc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_dbc));
  if (err != cudaSuccess) return static_cast<int>(err);
  item_kernel<<<static_cast<unsigned>(items), 2 * kWgThreads, smem_item,
                stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_gsum_kernel<<<static_cast<unsigned>(gsum_blocks), kWgThreads, 0,
                        stream>>>(a, sums);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_dbc_kernel<<<static_cast<unsigned>(dbc_blocks), kWgThreads,
                       smem_dbc, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

int launch_bwd_f32(const void* x, const void* Bm, const void* Cm,
                   const void* da, const void* dy, const void* dst, void* dx,
                   void* dB, void* dC, void* dda, void* const* scratch,
                   int BC, int Q, int H, int P, int N, cudaStream_t stream) {
  float* G = static_cast<float*>(scratch[0]);
  float* dGh = static_cast<float*>(scratch[1]);
  float* dB2h = static_cast<float*>(scratch[2]);
  const int nT = (Q + kTile - 1) / kTile;
  const size_t smem_cb = bwd_cb_smem_bytes();
  const size_t smem_head = bwd_head_smem_bytes(Q);
  const size_t smem_bc = bwd_bc_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_cb));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_head_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_head));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_bc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bc));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* Bt = static_cast<const float*>(Bm);
  const float* Ct = static_cast<const float*>(Cm);
  ssd_bwd_cb_kernel<<<dim3(BC, nT, nT), kThreads, smem_cb, stream>>>(
      Bt, Ct, G, Q, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_kernel<<<dim3(BC, H), kThreads, smem_head, stream>>>(
      static_cast<const float*>(x), Bt, static_cast<const float*>(da),
      static_cast<const float*>(dy), static_cast<const float*>(dst), G,
      static_cast<float*>(dx), dGh, dB2h, static_cast<float*>(dda), Q, H,
      P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems = static_cast<long long>(Q) * Q +
                          static_cast<long long>(Q) * N;
  ssd_bwd_sum_kernel<<<dim3(static_cast<unsigned>((elems + kThreads - 1) /
                                                  kThreads), BC),
                       kThreads, 0, stream>>>(dGh, dB2h, G, Q, H, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_bc_kernel<<<dim3(BC, nT, 2), kThreads, smem_bc, stream>>>(
      Bt, Ct, G, dB2h, static_cast<float*>(dB), static_cast<float*>(dC), Q,
      H, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the call's kernels on `stream` and returns the first CUDA
// error (0 = launched): bf16 inputs (`bf16` = 1) go to the wgmma kernel,
// f32 inputs (0) to the CUDA-core kernels. The caller checks shapes,
// types and contiguity, and that 1 <= P <= ssd_chunk_max_p(),
// 1 <= N <= ssd_chunk_max_n(), 1 <= Q <= ssd_chunk_max_q(),
// H <= 65535 and BC <= 2^31 - 1.
extern "C" int ssd_chunk_launch(const void* x, const void* Bm,
                                const void* Cm, const void* da, void* y,
                                void* st, int bf16, int BC, int Q, int H,
                                int P, int N, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_wgmma(x, Bm, Cm, da, y, st, BC, Q, H, P, N, s)
              : launch_cuda_cores<float>(x, Bm, Cm, da, y, st, BC, Q, H, P,
                                         N, s);
}

// The backward's kernels on `stream` (see the backward section): dx,
// dB, dC in the inputs' dtype (`bf16` = 1: bf16, the wgmma kernels; 0:
// f32, the CUDA-core kernels), dda f32; dy [BC,Q,H,P] and dst
// [BC,H,P,N] f32, all dense. `scratch` holds five f32 buffers the
// caller allocates, of ssd_chunk_bwd_scratch_floats' sizes (nothing
// need be zeroed). Returns the first CUDA error (0 = launched); the
// caller checks what ssd_chunk_launch's checks.
extern "C" int ssd_chunk_bwd_launch(const void* x, const void* Bm,
                                    const void* Cm, const void* da,
                                    const void* dy, const void* dst,
                                    void* dx, void* dB, void* dC, void* dda,
                                    void* s0, void* s1, void* s2, void* s3,
                                    void* s4, int bf16, int BC, int Q, int H,
                                    int P, int N, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  void* const scratch[5] = {s0, s1, s2, s3, s4};
  return bf16 ? launch_bwd_wgmma(x, Bm, Cm, da, dy, dst, dx, dB, dC, dda,
                                 scratch, BC, Q, H, P, N, s)
              : launch_bwd_f32(x, Bm, Cm, da, dy, dst, dx, dB, dC, dda,
                               scratch, BC, Q, H, P, N, s);
}

// Floats of scratch buffer `which` (0-4) the backward takes at (BC, Q,
// H, N), for bf16 (`bf16` = 1) or f32 inputs (0, three buffers: C B^T
// [BC,Q,Q], the heads' dS o L [BC,H,Q,Q] and r o (x dst) [BC,H,Q,N]).
extern "C" long long ssd_chunk_bwd_scratch_floats(int bf16, long long BC,
                                                  int Q, int H, int N,
                                                  int which) {
  long long f[5] = {0, 0, 0, 0, 0};
  if (bf16) {
    bwd_scratch_floats(BC, Q, H, f);
  } else {
    f[0] = BC * Q * Q;
    f[1] = BC * H * static_cast<long long>(Q) * Q;
    f[2] = BC * H * static_cast<long long>(Q) * N;
  }
  return which >= 0 && which < 5 ? f[which] : 0;
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory (bytes) one block takes at (Q, P, N): of the
// f32 y kernel (kernel = 0), the f32 states kernel (1), the bf16 wgmma
// kernel (2), the f32 backward's C B^T (3), per-head (4), head-sum (5)
// and dB / dC (6) kernels, and the bf16 backward's item (7), group-sum
// (8) and dB / dC (9) kernels. ptxas reports only static shared memory.
extern "C" long long ssd_chunk_smem_bytes(int Q, int P, int N, int kernel) {
  size_t b = 0;
  switch (kernel) {
    case 0: b = diag_smem_bytes(Q, P, N); break;
    case 1: b = state_smem_bytes(Q, P, N); break;
    case 2: b = bf16_smem_bytes(Q); break;
    case 3: b = bwd_cb_smem_bytes(); break;
    case 4: b = bwd_head_smem_bytes(Q); break;
    case 7: b = bwd_item_smem_bytes(Q); break;
    case 6: b = bwd_bc_smem_bytes(); break;
    case 9: b = bwd_dbc_smem_bytes(); break;
    default: break;
  }
  return static_cast<long long>(b);
}

extern "C" int ssd_chunk_max_p() { return kMaxP; }
extern "C" int ssd_chunk_max_n() { return kMaxN; }
extern "C" int ssd_chunk_max_q() { return kMaxQ; }
extern "C" int ssd_chunk_bwd_heads() { return kHeadsB; }
