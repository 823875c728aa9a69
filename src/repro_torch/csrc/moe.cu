// The MoE layer's dispatch and combine, for Hopper (sm_90a): one launch
// each where the JAX package's program runs k sequential scatters and k
// sequential gathers.
//
// The JAX package has no kernel here: src/repro/models/moe.py writes the
// dispatch as k scatter-adds of [G,Tg,d] into a zero buffer [G,E,C,d]
// (:98-100) and the combine as k gathers, each masked, scaled by its
// gate and added (:115-118); XLA fuses each into a loop. Done op by op in
// eager PyTorch that is ~50 launches a layer at k = 8 (1,200 a decode
// step of granite-moe-1b-a400m's 24 layers), and every decode the port
// serves is bound by the host's issue. So each is one kernel here, whose
// arithmetic is fixed element by element and equal bit for bit to its
// plain version (kernels/ref.py::moe_dispatch_ref, moe_combine_ref),
// which is the reference's rounding order:
//
//  * moe_dispatch_kernel: buf[e, p, :] = x[t, :] for every kept choice
//    (t, j) routed to expert e at slot p, zeros in every other slot. The
//    reference adds each choice onto zeros in f32 and rounds it to the
//    buffer's type, so a -0.0 of x is stored as +0.0 (+0.0 + -0.0 =
//    +0.0); a dropped choice adds zeros to its expert's slot 0, which
//    changes nothing. Every kept choice owns a slot of its own (the
//    positions are a cumulative count per expert), so the adds are a
//    copy: the kernel copies, clearing the sign of zeros. A block takes
//    kDispatchSlots slots of one expert: its threads first scan the
//    flattened [T*k] choices for those that land in its slots, each
//    with kScanUnroll reads in flight, and note each slot's token in
//    shared memory, then each warp copies a slot's row (or writes
//    zeros). Choices that claim one slot twice are not
//    what the caller builds; the kernel keeps one of them.
//  * moe_combine_kernel: y[t, :] from the k rows ob[e_j, p_j, :] of a
//    token's choices, choice 0 first, as XLA's CPU program rounds the
//    reference's loop in bf16 (r the rounding to bf16):
//      t_j = r(r(keep_j ? ob[e_j, p_j] : 0) * r(g_j))  product in f32
//      y   = t_0;  y = r(y + t_j) for j = 1..k-1      add in f32
//    XLA folds the first add onto zeros, so a -0.0 in t_0 survives. In
//    f32 the same order with no rounding, and no contraction into an
//    FMA (the intrinsics below round each op): XLA's CPU program
//    contracts the f32 form (fma(w_0, g_0, t_1), then fma(w_j, g_j, y)),
//    which the plain version, written in tensor ops, cannot follow, so
//    the f32 form agrees with the reference within an ulp. A block
//    takes a token: its first k threads read the token's (expert, slot,
//    keep, gate) into shared memory, then each thread takes a 16-byte
//    column of the row (d = 1,024 in bf16: one each), issuing the k
//    loads of its column before it adds.
//
// Both are memory kernels. At the serve's prefill of group 1 (T = 2,564
// tokens, k = 8, C = 804 slots, d = 1,024, bf16) the dispatch writes the
// 52.7 MB buffer and need read x only once (5.3 MB): ~17 us at 3.35
// TB/s; the combine reads the kept choices' rows (at most 42.0 MB) and
// writes 5.3 MB: at most ~14 us. A decode step (T = 4, C = 4) is bound
// by the launch. Rows whose byte length is a multiple of 16 on
// 16-byte aligned storage move in 16-byte accesses (8 bf16, 4 f32);
// others element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDispatchSlots = 256;   // slots of one expert a block
constexpr int kDispatchThreads = 512;
constexpr int kScanUnroll = 8;        // choices a thread reads at once
constexpr int kCombineThreads = 128;  // a block a token, a thread a column
constexpr int kMaxK = 32;             // choices a token
constexpr int kUnroll = 8;            // loads issued before the adds

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v with a -0.0 written as +0.0 (every other value, NaNs included, as is)
__device__ __forceinline__ float plus_zero(float v) {
  return (__float_as_uint(v) & 0x7fffffffu) ? v : 0.0f;
}
__device__ __forceinline__ __nv_bfloat16 plus_zero(__nv_bfloat16 v) {
  return (__bfloat16_as_ushort(v) & 0x7fffu) ? v
                                              : __ushort_as_bfloat16(0);
}

// W elements moved as one access (16 bytes where W * sizeof(T) == 16)
template <typename T, int W>
struct alignas(sizeof(T) * W) Pack {
  T v[W];
};

template <typename T, int W>
__global__ void __launch_bounds__(kDispatchThreads)
moe_dispatch_kernel(const T* __restrict__ x,
                    const long long* __restrict__ eidx,
                    const long long* __restrict__ pos,
                    const bool* __restrict__ keep, T* __restrict__ buf,
                    long long n_choices, int k, long long C, long long d) {
  __shared__ int src[kDispatchSlots];
  const long long e = blockIdx.y;
  const long long lo = static_cast<long long>(blockIdx.x) * kDispatchSlots;
  const int n = static_cast<int>(min(static_cast<long long>(kDispatchSlots),
                                     C - lo));
  for (int s = threadIdx.x; s < n; s += blockDim.x) src[s] = -1;
  __syncthreads();
  // the scan: kScanUnroll experts in flight a thread, then the rare
  // match's keep and slot
  for (long long i0 = threadIdx.x; i0 < n_choices;
       i0 += static_cast<long long>(kDispatchThreads) * kScanUnroll) {
    long long ev[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const long long i = i0 + static_cast<long long>(u) * kDispatchThreads;
      ev[u] = i < n_choices ? __ldg(eidx + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const long long i = i0 + static_cast<long long>(u) * kDispatchThreads;
      if (ev[u] != e || !keep[i]) continue;
      const long long p = __ldg(pos + i) - lo;
      if (p >= 0 && p < n) src[p] = static_cast<int>(i / k);
    }
  }
  __syncthreads();
  using P = Pack<T, W>;
  const long long nvec = d / W;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int s = warp; s < n; s += kDispatchThreads / 32) {
    const int t = src[s];
    P* out = reinterpret_cast<P*>(buf + ((e * C) + lo + s) * d);
    if (t < 0) {
      P z;
#pragma unroll
      for (int w = 0; w < W; ++w) z.v[w] = from_f<T>(0.0f);
      for (long long c = lane; c < nvec; c += 32) out[c] = z;
      continue;
    }
    const P* in = reinterpret_cast<const P*>(x + t * d);
    for (long long c = lane; c < nvec; c += 32) {
      P v = in[c];
#pragma unroll
      for (int w = 0; w < W; ++w) v.v[w] = plus_zero(v.v[w]);
      out[c] = v;
    }
  }
}

// acc (f32, holding a value of T) after one more term: the first term
// as it is, then the sum rounded to T
template <typename T>
__device__ __forceinline__ float add_term(float acc, float term, bool first) {
  return first ? term : to_f(from_f<T>(__fadd_rn(acc, term)));
}

template <typename T, int W>
__global__ void __launch_bounds__(kCombineThreads)
moe_combine_kernel(const T* __restrict__ ob,
                   const long long* __restrict__ eidx,
                   const long long* __restrict__ pos,
                   const bool* __restrict__ keep,
                   const float* __restrict__ gates, T* __restrict__ y,
                   int k, long long C, long long d) {
  __shared__ long long s_row[kMaxK];
  __shared__ float s_gate[kMaxK];
  const long long t = blockIdx.x;
  if (threadIdx.x < k) {
    const long long i = t * k + threadIdx.x;
    s_row[threadIdx.x] = keep[i] ? __ldg(eidx + i) * C + __ldg(pos + i) : -1;
    // the gate rounded to T, as the reference's gates.astype(x.dtype)
    s_gate[threadIdx.x] = to_f(from_f<T>(__ldg(gates + i)));
  }
  __syncthreads();
  using P = Pack<T, W>;
  const long long nvec = d / W;
  P* out = reinterpret_cast<P*>(y + t * d);
  for (long long c = threadIdx.x; c < nvec; c += kCombineThreads) {
    float acc[W] = {};
    for (int j0 = 0; j0 < k; j0 += kUnroll) {
      P v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = j0 + u < k ? s_row[j0 + u] : -1;
        if (row >= 0) {
          v[u] = reinterpret_cast<const P*>(ob + row * d)[c];
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) v[u].v[w] = from_f<T>(0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u >= k) break;
        const float g = s_gate[j0 + u];
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const float term = to_f(from_f<T>(__fmul_rn(to_f(v[u].v[w]), g)));
          acc[w] = add_term<T>(acc[w], term, j0 + u == 0);
        }
      }
    }
    P o;
#pragma unroll
    for (int w = 0; w < W; ++w) o.v[w] = from_f<T>(acc[w]);
    out[c] = o;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
void dispatch(const void* x, const long long* eidx, const long long* pos,
              const bool* keep, void* buf, long long T_, int k, long long d,
              long long E, long long C, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  const dim3 grid(static_cast<unsigned>((C + kDispatchSlots - 1) /
                                        kDispatchSlots),
                  static_cast<unsigned>(E));
  if (d % W == 0 && aligned16(x) && aligned16(buf))
    moe_dispatch_kernel<T, W><<<grid, kDispatchThreads, 0, st>>>(
        static_cast<const T*>(x), eidx, pos, keep, static_cast<T*>(buf),
        T_ * k, k, C, d);
  else
    moe_dispatch_kernel<T, 1><<<grid, kDispatchThreads, 0, st>>>(
        static_cast<const T*>(x), eidx, pos, keep, static_cast<T*>(buf),
        T_ * k, k, C, d);
}

template <typename T>
void combine(const void* ob, const long long* eidx, const long long* pos,
             const bool* keep, const float* gates, void* y, long long T_,
             int k, long long d, long long C, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  const unsigned grid = static_cast<unsigned>(T_);
  if (d % W == 0 && aligned16(ob) && aligned16(y))
    moe_combine_kernel<T, W><<<grid, kCombineThreads, 0, st>>>(
        static_cast<const T*>(ob), eidx, pos, keep, gates,
        static_cast<T*>(y), k, C, d);
  else
    moe_combine_kernel<T, 1><<<grid, kCombineThreads, 0, st>>>(
        static_cast<const T*>(ob), eidx, pos, keep, gates,
        static_cast<T*>(y), k, C, d);
}

}  // namespace

// Plain C interface (ctypes). Dense row-major tensors: x [T,d], buf
// [E,C,d], ob [E,C,d], y [T,d]; eidx, pos [T,k] int64; keep [T,k] bool;
// gates [T,k] f32. dtype: 0 = f32, 1 = bf16. Each returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for
// arguments the kernels do not take.
extern "C" int moe_dispatch_launch(const void* x, const void* eidx,
                                   const void* pos, const void* keep,
                                   void* buf, long long T, long long k,
                                   long long d, long long E, long long C,
                                   int dtype, void* stream) {
  if (T < 0 || k < 1 || d < 1 || E < 1 || C < 1 || E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* ei = static_cast<const long long*>(eidx);
  const long long* ps = static_cast<const long long*>(pos);
  const bool* kp = static_cast<const bool*>(keep);
  if (dtype == 0)
    dispatch<float>(x, ei, ps, kp, buf, T, static_cast<int>(k), d, E, C, st);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(x, ei, ps, kp, buf, T, static_cast<int>(k), d, E,
                            C, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int moe_combine_launch(const void* ob, const void* eidx,
                                  const void* pos, const void* keep,
                                  const void* gates, void* y, long long T,
                                  long long k, long long d, long long C,
                                  int dtype, void* stream) {
  if (T < 1 || T > 0x7fffffffLL || k < 1 || k > kMaxK || d < 1 || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* ei = static_cast<const long long*>(eidx);
  const long long* ps = static_cast<const long long*>(pos);
  const bool* kp = static_cast<const bool*>(keep);
  const float* g = static_cast<const float*>(gates);
  if (dtype == 0)
    combine<float>(ob, ei, ps, kp, g, y, T, static_cast<int>(k), d, C, st);
  else if (dtype == 1)
    combine<__nv_bfloat16>(ob, ei, ps, kp, g, y, T, static_cast<int>(k), d,
                           C, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
