// Mamba-2 SSD (state-space duality) within one chunk, for Hopper
// (sm_90a).
//
// Replaces the JAX package's TPU kernel
// src/repro/kernels/ssd_scan.py::ssd_chunk_pallas (body _ssd_kernel),
// and computes what it computes, for each (batch b, chunk c, head h):
//   cum[q]      = sum_{i<=q} da[h, i]                   (log-decay)
//   y[q, h, p]  = sum_{k<=q} (C[q] . B[k]) * exp(cum[q] - cum[k]) * x[k, h, p]
//   st[h, p, n] = sum_k exp(cum[Q-1] - cum[k]) * x[k, h, p] * B[k, n]
// Inputs are bf16 or f32 (x [B,nC,Q,H,P], B/C [B,nC,Q,N]) and f32 (da
// [B,nC,H,Q]); every product and sum is f32; y and st are f32. The
// causal mask is applied by skipping k > q (the TPU kernel masks the
// exponent with -1e30 before exp: the upper triangle is positive and
// would overflow).
//
// What bounds it on this card: operations. At the serve shape of
// mamba2-2.7b (B=4, nC=3, Q=256, H=80, P=64, N=128) one call must do
// about 8.3 GFLOP of f32 work (C B^T once per chunk, the causal y
// product, the states), 124 us at the 67 TFLOP/s the H100 has outside
// the tensor cores, against 128 MB moved, 38 us at 3.35 TB/s. The
// arithmetic is the TPU kernel's f32, so the TF32 rate does not apply.
//
// What the design does about it, and what it leaves for later. The
// TPU cell keeps [8, Q, Q] f32 decay masks and scores (2 MB each) in
// VMEM; a block here has 227 KB of shared memory, so nothing of that
// size is carried over. Instead:
//  * ssd_diag_kernel: one block per (b, c, h, 64-row q-tile). It stages
//    its C tile once and walks the 64-row k-tiles up to the diagonal,
//    staging each B and x tile in shared memory (104 KB at N=128,
//    P=64). The 64x64 C B^T tile is computed on the fly with a 4x4
//    register tile per thread, scaled by the decay factor (k > q is
//    zero), stored to shared memory and multiplied into a 4x4
//    register tile of y. Tiles above the diagonal are never visited.
//  * ssd_state_kernel: one block per (b, c, h); the decay weights are
//    computed once per row into shared memory and each thread keeps a
//    4x8 register tile of the [P, N] state.
//  * Each block computes cum from da itself (one warp, a shuffle scan).
// It runs on the CUDA cores and recomputes C B^T for every head (80x
// the necessary count at the serve shape, so it does about 3x the
// bound's operations). wgmma on the two contractions, TMA staging and
// one C B^T per (b, c) shared by all heads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTile = 64;       // rows of a q-tile and of a k-tile
constexpr int kSS = kTile + 16; // row stride of the score tile
constexpr int kMaxP = 64;       // 4 columns of 16 threads
constexpr int kMaxN = 128;      // 8 columns of 16 threads (states)
constexpr int kMaxQ = 4096;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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
int launch(const void* x, const void* Bm, const void* Cm, const void* da,
           void* y, void* st, int BC, int Q, int H, int P, int N,
           cudaStream_t stream) {
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

}  // namespace

// Launches both kernels on `stream` and returns the first CUDA error (0
// = launched). The caller checks shapes, types and contiguity, and
// that 1 <= P <= ssd_chunk_max_p(), 1 <= N <= ssd_chunk_max_n(),
// 1 <= Q <= ssd_chunk_max_q(), H <= 65535 and BC <= 2^31 - 1.
// `bf16` selects the type of x, B and C (1: bf16, 0: f32).
extern "C" int ssd_chunk_launch(const void* x, const void* Bm,
                                const void* Cm, const void* da, void* y,
                                void* st, int bf16, int BC, int Q, int H,
                                int P, int N, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16>(x, Bm, Cm, da, y, st, BC, Q, H, P,
                                      N, s)
              : launch<float>(x, Bm, Cm, da, y, st, BC, Q, H, P, N, s);
}

extern "C" const char* ssd_chunk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory (bytes) one block takes at (Q, P, N): of the y
// kernel (state = 0) or of the states kernel (state = 1). ptxas reports
// only static shared memory.
extern "C" long long ssd_chunk_smem_bytes(int Q, int P, int N, int state) {
  return static_cast<long long>(state ? state_smem_bytes(Q, P, N)
                                      : diag_smem_bytes(Q, P, N));
}

extern "C" int ssd_chunk_max_p() { return kMaxP; }
extern "C" int ssd_chunk_max_n() { return kMaxN; }
extern "C" int ssd_chunk_max_q() { return kMaxQ; }
