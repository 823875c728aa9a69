// Progressive water-fill (RTT-biased weighted max-min rate filling) in
// float64, for Hopper (sm_90a).
//
// Replaces the JAX package's batched device fill
// src/repro/kernels/waterfill.py::fill_rates_loop (:56). That is not a
// Pallas kernel but a jit `lax.while_loop` over [B, N, N] f64 tensors,
// and this kernel computes what its body computes (:88-121), not what
// XLA made of it: per iteration, every unfrozen pair's per-connection
// rate rises along one fill level `inc` (rate += inc * w) until the
// first constraint binds (the single-connection ceiling, the knee path
// cap, a NIC's egress or ingress headroom), and the pairs within
// EPS_SAT of a limit freeze. A fill ends when every pair is frozen, when
// an iteration freezes nothing at a zero increment (a stall), or at the
// 8 N^2 iteration bound, when it reports converged = false.
//
// What bounds it on this card. Not bytes: at N = 8 a fill reads four
// [N, N] f64 matrices and two [N] vectors (2.2 KB) and writes 0.5 KB,
// under a nanosecond at 3.35 TB/s. Not operations: about 20 f64
// operations per pair per iteration, ~9 k for a 7-iteration 8-DC fill,
// also well under a nanosecond at the card's f64 rate. It is bound by
// latency: each iteration is five barrier-separated rounds (a round of
// sums through shared memory, a block minimum, the update, the sums
// again, the freeze), one after another, and the iterations depend on
// each other. On the control loop it is bound by what surrounds it: the
// launch, and the copy in and the copy out with the synchronise that a
// numpy caller pays (kernels/waterfill.py::fill_rates).
//
// The design: one block per fill (a batch of fills is a grid), one
// thread per pair (i, j), N <= 32 (at most 1,024 pairs). A pair thread
// keeps its c, w, c*w, single, path_cap, rate and frozen flag in
// registers. The block has at least 64 threads: warp 0's lane i sums
// row i (egress), warp 1's lane j column j (ingress), each in index
// order, from shared memory at a padded stride. An iteration:
//   1. pair threads write c*w (0 when frozen) and rate*c; barrier;
//   2. the row / column lanes sum both and form the NIC increment
//      bounds; every thread folds its bounds into a warp minimum by
//      shuffles, one value a warp goes through shared memory; barrier;
//   3. every thread reads the block minimum `inc` (0 below EPS_INC or
//      when not finite); active pairs raise their rate and write the
//      new rate*c; barrier;
//   4. the row / column lanes sum it again and flag saturated NICs;
//      barrier;
//   5. active pairs freeze within EPS_SAT of a limit;
//      __syncthreads_or over the hits and __syncthreads_and over the
//      frozen flags make `done` the same in every thread.
// Every product, quotient and sum is a _rn intrinsic, so nvcc cannot
// contract a multiply and an add into an FMA that the reference does not
// do; the sums still run in another order than numpy's, so rates agree
// with the host loop to roundoff (1e-9), with the same iteration count.
// A warp per fill for N <= 8, with several fills a block, would cut the
// barriers to warp syncs: later work.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxN = 32;
constexpr int kLd = kMaxN + 1;       // row stride of the shared matrices
constexpr double kEpsDen = 1e-12;    // weight-denominator clip
constexpr double kEpsInc = 1e-9;     // smallest meaningful increment
constexpr double kEpsSat = 1e-6;     // constraint-saturation slack

// the smaller of a and b, NaN if either is (jnp.minimum's rule; fmin
// would drop the NaN)
__device__ __forceinline__ double nan_min(double a, double b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(1024)
    waterfill_kernel(const double* __restrict__ c,
                     const double* __restrict__ single,
                     const double* __restrict__ egress,
                     const double* __restrict__ ingress,
                     const double* __restrict__ w, long long w_stride,
                     const double* __restrict__ path_cap,
                     double* __restrict__ rate_out,
                     int* __restrict__ iters_out,
                     bool* __restrict__ conv_out, int n, int cap_iters) {
  __shared__ double s_cw[kMaxN * kLd];    // c*w of active pairs, else 0
  __shared__ double s_load[kMaxN * kLd];  // rate*c
  __shared__ double s_min[32];            // each warp's minimum
  __shared__ bool s_sat_e[kMaxN];
  __shared__ bool s_sat_i[kMaxN];

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int n_warps = blockDim.x >> 5;
  const int nn = n * n;
  const bool pair = t < nn;
  const int i = pair ? t / n : 0;
  const int j = pair ? t - i * n : 0;
  const int at = i * kLd + j;
  const long long base = static_cast<long long>(blockIdx.x) * nn;

  // the pair's loop invariants
  double cv = 0.0, wv = 0.0, sv = 0.0, pv = 0.0;
  if (pair) {
    cv = c[base + t];
    wv = w[blockIdx.x * w_stride + t];
    sv = single[base + t];
    pv = path_cap[base + t];
  }
  const double cw = __dmul_rn(cv, wv);
  const bool w_pos = wv > 0.0;
  const bool cw_pos = cw > 0.0;
  const double w_den = fmax(wv, kEpsDen);
  const double cw_den = fmax(cw, kEpsDen);

  // warp 0's lanes own the rows (egress), warp 1's the columns (ingress)
  const bool row = warp == 0 && lane < n;
  const bool col = warp == 1 && lane < n;
  const long long dc = static_cast<long long>(blockIdx.x) * n + lane;
  const double nic = row ? egress[dc] : (col ? ingress[dc] : 0.0);

  double rate = 0.0;
  bool frozen = !pair || cv <= 0.0;
  bool done = __syncthreads_and(frozen);
  int it = 0;
  for (; it < cap_iters && !done; ++it) {
    const bool act = !frozen;
    // 1. this iteration's active weights and loads
    if (pair) {
      s_cw[at] = act ? cw : 0.0;
      s_load[at] = __dmul_rn(rate, cv);
    }
    __syncthreads();
    // 2. the increment bounds, folded into the block minimum
    double m = INFINITY;
    if (act) {
      const double inc_conn =
          w_pos ? __ddiv_rn(__dsub_rn(sv, rate), w_den) : INFINITY;
      const double inc_path =
          cw_pos ? __ddiv_rn(__dsub_rn(pv, __dmul_rn(rate, cv)), cw_den)
                 : INFINITY;
      m = nan_min(inc_conn, inc_path);
    }
    if (row || col) {
      double wsum = 0.0, lsum = 0.0;
      for (int k = 0; k < n; ++k) {
        const int idx = row ? lane * kLd + k : k * kLd + lane;
        wsum = __dadd_rn(wsum, s_cw[idx]);
        lsum = __dadd_rn(lsum, s_load[idx]);
      }
      const double head = __dsub_rn(nic, lsum);
      m = nan_min(m, wsum > 0.0 ? __ddiv_rn(head, fmax(wsum, kEpsDen))
                                : INFINITY);
    }
    for (int o = 16; o > 0; o >>= 1) {
      m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    if (lane == 0) s_min[warp] = m;
    __syncthreads();
    // 3. the step along the fill level
    double inc = s_min[0];
    for (int k = 1; k < n_warps; ++k) inc = nan_min(inc, s_min[k]);
    if (!(isfinite(inc) && inc >= kEpsInc)) inc = 0.0;
    if (act) rate = __dadd_rn(rate, __dmul_rn(inc, wv));
    const double load = __dmul_rn(rate, cv);
    if (pair) s_load[at] = load;
    __syncthreads();
    // 4. saturated NICs
    if (row || col) {
      double lsum = 0.0;
      for (int k = 0; k < n; ++k) {
        lsum = __dadd_rn(lsum, s_load[row ? lane * kLd + k : k * kLd + lane]);
      }
      const bool sat = __dsub_rn(nic, lsum) < kEpsSat;
      if (row) {
        s_sat_e[lane] = sat;
      } else {
        s_sat_i[lane] = sat;
      }
    }
    __syncthreads();
    // 5. freeze the binding pairs
    const bool hit = act && (__dsub_rn(sv, rate) < kEpsSat ||
                             __dsub_rn(pv, load) < kEpsSat || s_sat_e[i] ||
                             s_sat_i[j]);
    frozen = frozen || hit;
    const bool any_hit = __syncthreads_or(hit);
    const bool all_frozen = __syncthreads_and(frozen);
    done = all_frozen || (!any_hit && inc == 0.0);
  }
  if (pair) rate_out[base + t] = rate;
  if (t == 0) {
    iters_out[blockIdx.x] = it;
    conv_out[blockIdx.x] = done;
  }
}

// Threads a block of an n-DC fill: one per pair, a whole number of
// warps, at least two (warp 0 sums rows, warp 1 columns).
int block_threads(int n) {
  const int threads = (n * n + 31) / 32 * 32;
  return threads < 64 ? 64 : threads;
}

}  // namespace

// Launches `batch` fills of n DCs (one block each) on `stream`; returns
// cudaGetLastError(), or cudaErrorInvalidValue for n outside [1, 32]
// or batch < 1. c, single, path_cap, rate: [batch, n, n] f64; w:
// [n, n] (w_stride 0) or [batch, n, n] (w_stride n*n) f64; egress,
// ingress: [batch, n] f64; iters: [batch] int32; converged: [batch]
// bool. All contiguous on one device; the caller checks them.
extern "C" int waterfill_launch(const void* c, const void* single,
                                const void* egress, const void* ingress,
                                const void* w, long long w_stride,
                                const void* path_cap, void* rate,
                                void* iters, void* converged, int batch,
                                int n, int cap_iters, void* stream) {
  if (n < 1 || n > kMaxN || batch < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  waterfill_kernel<<<batch, block_threads(n), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(c), static_cast<const double*>(single),
      static_cast<const double*>(egress),
      static_cast<const double*>(ingress), static_cast<const double*>(w),
      w_stride, static_cast<const double*>(path_cap),
      static_cast<double*>(rate), static_cast<int*>(iters),
      static_cast<bool*>(converged), n, cap_iters);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* waterfill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
