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
// The backward (ssd_chunk_bwd): CUDA-core kernels, f32 arithmetic
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
// Four kernels, one launch each, nothing summed by atomics (two calls
// give the same bits):
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
// dx, dB and dC are rounded once from f32 to the input dtype; every
// decay factor and sum is f32. A 256x256 f32 score tile does not fit a
// block's shared memory, so Q runs in 64-row tiles (as the f32 forward
// kernels). At the train shape (B=4, nC=4, Q=256, H=80, P=64, N=128)
// the scratch is 4 MB (C B^T), 335 MB (dS o L per head) and 168 MB.
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_cb_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
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
    Cs[r * kNS + n] = r < nq ? to_f32(Cm[(bc * Q + q0 + r) * N + n]) : 0.0f;
    Bs[r * kNS + n] = r < nk ? to_f32(Bm[(bc * Q + k0 + r) * N + n]) : 0.0f;
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_head_kernel(const T* __restrict__ x,        // [BC, Q, H, P]
                    const T* __restrict__ Bm,       // [BC, Q, N]
                    const float* __restrict__ da,   // [BC, H, Q]
                    const float* __restrict__ dy,   // [BC, Q, H, P]
                    const float* __restrict__ dst,  // [BC, H, P, N]
                    const float* __restrict__ G,    // [BC, Q, Q]
                    T* __restrict__ dx,             // [BC, Q, H, P]
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
          r < nk ? to_f32(x[((bc * Q + k0 + r) * H + h) * P + p]) : 0.0f;
    }
    for (int i = tid; i < kTile * N; i += kThreads) {
      const int r = i / N, n = i - r * N;
      Bs[r * kNS + n] = r < nk ? to_f32(Bm[(bc * Q + k0 + r) * N + n]) : 0.0f;
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
          if (p < P) dx[((bc * Q + k) * H + h) * P + p] = from_f32<T>(adx[i][j]);
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
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_bc_kernel(const T* __restrict__ Bm, const T* __restrict__ Cm,
                  const float* __restrict__ dG,    // [BC, Q, Q] causal
                  const float* __restrict__ dB2,   // [BC, H, Q, N]: h = 0
                  T* __restrict__ dB, T* __restrict__ dC, int Q, int H,
                  int N) {
  extern __shared__ float smem[];
  float* gs = smem;                     // [kTile][kTS]: a dG tile
  float* vs = gs + kTile * kTS;         // [kTile][kMaxN]: B or C tile
  const size_t bc = blockIdx.x;
  const int t = blockIdx.y, nT = (Q + kTile - 1) / kTile;
  const bool want_dC = blockIdx.z == 0;
  const int r0 = t * kTile, nr = min(kTile, Q - r0);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* V = want_dC ? Bm : Cm;
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
          a < no ? to_f32(V[(bc * Q + o0 + a) * N + n]) : 0.0f;
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
  T* out = want_dC ? dC : dB;
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
      out[at] = from_f32<T>(v);
    }
  }
}

template <typename T>
int launch_bwd(const void* x, const void* Bm, const void* Cm, const void* da,
               const void* dy, const void* dst, void* dx, void* dB, void* dC,
               void* dda, float* G, float* dGh, float* dB2h, int BC, int Q,
               int H, int P, int N, cudaStream_t stream) {
  const int nT = (Q + kTile - 1) / kTile;
  const size_t smem_cb = bwd_cb_smem_bytes();
  const size_t smem_head = bwd_head_smem_bytes(Q);
  const size_t smem_bc = bwd_bc_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_cb_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_cb));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_head_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_head));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_bwd_bc_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bc));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* Bt = static_cast<const T*>(Bm);
  const T* Ct = static_cast<const T*>(Cm);
  ssd_bwd_cb_kernel<T><<<dim3(BC, nT, nT), kThreads, smem_cb, stream>>>(
      Bt, Ct, G, Q, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_head_kernel<T><<<dim3(BC, H), kThreads, smem_head, stream>>>(
      static_cast<const T*>(x), Bt, static_cast<const float*>(da),
      static_cast<const float*>(dy), static_cast<const float*>(dst), G,
      static_cast<T*>(dx), dGh, dB2h, static_cast<float*>(dda), Q, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long elems = static_cast<long long>(Q) * Q +
                          static_cast<long long>(Q) * N;
  ssd_bwd_sum_kernel<<<dim3(static_cast<unsigned>((elems + kThreads - 1) /
                                                  kThreads), BC),
                       kThreads, 0, stream>>>(dGh, dB2h, G, Q, H, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_bc_kernel<T><<<dim3(BC, nT, 2), kThreads, smem_bc, stream>>>(
      Bt, Ct, G, dB2h, static_cast<T*>(dB), static_cast<T*>(dC), Q, H, N);
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
// dB, dC in the inputs' dtype (`bf16` = 1: bf16, 0: f32), dda f32;
// dy [BC,Q,H,P] and dst [BC,H,P,N] f32, all dense. G [BC,Q,Q], dGh
// [BC,H,Q,Q] and dB2h [BC,H,Q,N] are f32 scratch the caller allocates
// (nothing need be zeroed). Returns the first CUDA error (0 =
// launched); the caller checks what ssd_chunk_launch's checks.
extern "C" int ssd_chunk_bwd_launch(const void* x, const void* Bm,
                                    const void* Cm, const void* da,
                                    const void* dy, const void* dst,
                                    void* dx, void* dB, void* dC, void* dda,
                                    void* G, void* dGh, void* dB2h, int bf16,
                                    int BC, int Q, int H, int P, int N,
                                    void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  float* g = static_cast<float*>(G);
  float* gh = static_cast<float*>(dGh);
  float* bh = static_cast<float*>(dB2h);
  return bf16 ? launch_bwd<__nv_bfloat16>(x, Bm, Cm, da, dy, dst, dx, dB,
                                          dC, dda, g, gh, bh, BC, Q, H, P,
                                          N, s)
              : launch_bwd<float>(x, Bm, Cm, da, dy, dst, dx, dB, dC, dda, g,
                                  gh, bh, BC, Q, H, P, N, s);
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory (bytes) one block takes at (Q, P, N): of the
// f32 y kernel (kernel = 0), the f32 states kernel (1), the bf16 wgmma
// kernel (2), and the backward's C B^T (3), per-head (4), head-sum (5)
// and dB / dC (6) kernels. ptxas reports only static shared memory.
extern "C" long long ssd_chunk_smem_bytes(int Q, int P, int N, int kernel) {
  size_t b = 0;
  switch (kernel) {
    case 0: b = diag_smem_bytes(Q, P, N); break;
    case 1: b = state_smem_bytes(Q, P, N); break;
    case 2: b = bf16_smem_bytes(Q); break;
    case 3: b = bwd_cb_smem_bytes(); break;
    case 4: b = bwd_head_smem_bytes(Q); break;
    case 6: b = bwd_bc_smem_bytes(); break;
    default: break;
  }
  return static_cast<long long>(b);
}

extern "C" int ssd_chunk_max_p() { return kMaxP; }
extern "C" int ssd_chunk_max_n() { return kMaxN; }
extern "C" int ssd_chunk_max_q() { return kMaxQ; }
