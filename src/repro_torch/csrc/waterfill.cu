// Progressive water-fill (RTT-biased weighted max-min rate filling) in
// float64, for Hopper (sm_90a).
//
// Replaces the JAX package's batched device fill
// src/repro/kernels/waterfill.py::fill_rates_loop (:56). That is not a
// Pallas kernel but a jit `lax.while_loop` over [B, N, N] f64 tensors,
// and these kernels compute what its body computes (:88-121), not what
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
// latency: the iterations depend on each other, and each is one chain
// of dependent f64 operations (the update, an index-order sum, the
// divisions of the bounds, a minimum). Clock stamps in a development
// build (not kept) put about half of an 8-DC iteration in the
// divisions: each __ddiv_rn is a chain of dependent f64 operations
// behind a branch to its slow path, so a thread's divisions run one
// after another. Barriers were not the cost. On the control loop it is
// bound by what surrounds it: the launch, the copies and the
// synchronise that a numpy caller pays.
//
// The design:
// - N <= 8 (the 8-DC mesh every main-path fill runs): a warp a fill,
//   kWarpsPerBlock fills a block. Lane l holds pairs l and l + 32; the
//   warp's own shared region holds the [8][9] matrices. Its rounds are
//   separated by __syncwarp, the minimum is two integer reductions, the
//   saturated NICs one ballot, `hit` and `done` warp votes: no block
//   barrier anywhere in the kernel. A warp past the batch's end returns
//   before the loop, whole, so every shuffle and vote has its 32 lanes.
//   A lane holding two pairs divides four times an iteration (and a NIC
//   lane a fifth), where a thread a pair divides twice; that is what
//   keeps its gain on the one-block design small.
// - 9 <= N <= 32: a block a fill, a thread a pair; warp 0's lane i sums
//   row i (egress), warp 1's lane j column j (ingress). Three barriers
//   an iteration; the votes ride in shared words that every warp folds
//   after the next barrier.
// - One load-sum round an iteration on both: the rate changes only in
//   the update, so the load sums taken after it (for the saturated
//   NICs) are the next iteration's headroom sums; the row and column
//   lanes keep them in registers. Each pair writes c*w if it is still
//   active apart from its NICs (0 otherwise) beside its load, and the
//   active-weight sums after the freeze add 0 in place of every term
//   whose row or column saturated, which is what the freeze makes of
//   it. The warp path takes the weight sums beside the load sums and
//   takes them again after the freeze only when a NIC saturated in this
//   iteration: a NIC saturated earlier froze its pairs then, so its
//   terms are 0 already. (On the block path, with up to 32 terms a sum
//   and a NIC saturating in most iterations, the second sum cost more
//   than it saved.)
// The sums run over a compile-time maximum (8 on the warp path, 32 in
// runs of 8 on the block path), so a run's shared loads issue together.
//
// Arithmetic. Every product, quotient and sum is a _rn intrinsic, so
// nvcc cannot contract a multiply and an add into an FMA that the
// reference does not do; every row and column sum adds its terms to 0.0
// in index order, inactive terms as 0.0; the minimum is NaN-propagating
// (jnp.minimum's rule), and `inc` is 0 below EPS_INC or when not finite,
// so which zero or which NaN a minimum returns cannot reach a rate. The
// rates and iterations are therefore the same bits as the one-block
// design's (one block a fill, five barriers and two votes an
// iteration). They agree with the host loop to roundoff (1e-9), with
// the same iteration count, as numpy sums in another order.
//
// The numpy entry (`waterfill_fill_host`) takes host arrays, stages
// them in a pinned buffer the library keeps, and makes one copy in, the
// launch, one copy out and one synchronise on the caller's stream.
#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

#include <mutex>

namespace {

constexpr int kMaxN = 32;            // the block path: a thread a pair
constexpr int kLd = kMaxN + 1;       // row stride of its shared matrices
constexpr int kWarpN = 8;            // the warp path: two pairs a lane
constexpr int kWarpLd = kWarpN + 1;
// Fills a block on the warp path: one warp on each of the SM's four
// schedulers, so no two fills of a block share an issue slot, and a
// 32-fill batch (the fused sweep) spreads over 8 SMs.
constexpr int kWarpsPerBlock = 4;
constexpr int kColLane = 16;         // warp path: lane 16 + j sums column j
constexpr unsigned kFull = 0xffffffffu;
constexpr double kEpsDen = 1e-12;    // weight-denominator clip
constexpr double kEpsInc = 1e-9;     // smallest meaningful increment
constexpr double kEpsSat = 1e-6;     // constraint-saturation slack
constexpr int kMaxDevices = 64;

// the smaller of a and b, NaN if either is (jnp.minimum's rule; fmin
// would drop the NaN)
__device__ __forceinline__ double nan_min(double a, double b) {
  return (a < b || a != a) ? a : b;
}

// The warp's minimum of m: exact for every value but NaN, and a NaN if
// any lane's m is one (which NaN, and which zero, the clamp of `inc`
// cannot tell apart). Each double maps to a 64-bit key in its order,
// and two integer reductions take the smallest key: the high words,
// then the low words of the lanes holding the smallest high word (in
// place of five rounds of two shuffles and a compare).
__device__ __forceinline__ double warp_min(double m) {
  const bool any_nan = __any_sync(kFull, m != m);
  const unsigned long long bits = __double_as_longlong(m);
  unsigned long long key = bits >> 63 ? ~bits : bits | (1ull << 63);
  const unsigned hi = __reduce_min_sync(kFull, unsigned(key >> 32));
  const unsigned lo = __reduce_min_sync(
      kFull, unsigned(key >> 32) == hi ? unsigned(key) : 0xffffffffu);
  key = (static_cast<unsigned long long>(hi) << 32) | lo;
  const double v =
      __longlong_as_double(key >> 63 ? key & ~(1ull << 63) : ~key);
  return any_nan ? __longlong_as_double(~0ull) : v;
}

// s[0], s[stride], ..., s[(n-1)*stride] added to 0.0 in index order, the
// terms whose bit is set in `zero` as 0.0. Reads up to kMax terms in
// runs of 8 whose loads issue before their adds; the caller's matrix
// holds kMax of them (the unused ones are not added).
template <int kMax>
__device__ __forceinline__ double ordered_sum(const double* s, int stride,
                                              int n, unsigned zero) {
  double sum = 0.0;
#pragma unroll
  for (int k0 = 0; k0 < kMax; k0 += 8) {
    if (k0 >= n) break;
    double v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = s[(k0 + k) * stride];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k0 + k < n) {
        sum = __dadd_rn(sum, (zero >> (k0 + k)) & 1u ? 0.0 : v[k]);
      }
    }
  }
  return sum;
}

// Two index-order sums over the same positions of a and b (no terms
// zeroed), in runs of 8 as ordered_sum, their adds interleaved so that
// the two chains run side by side.
template <int kMax>
__device__ __forceinline__ void ordered_sums(const double* a, const double* b,
                                             int stride, int n, double* sa,
                                             double* sb) {
  double x = 0.0, y = 0.0;
#pragma unroll
  for (int k0 = 0; k0 < kMax; k0 += 8) {
    if (k0 >= n) break;
    double va[8], vb[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      va[k] = a[(k0 + k) * stride];
      vb[k] = b[(k0 + k) * stride];
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k0 + k < n) {
        x = __dadd_rn(x, va[k]);
        y = __dadd_rn(y, vb[k]);
      }
    }
  }
  *sa = x;
  *sb = y;
}

// A pair's loop invariants and state.
struct Pair {
  double c, w, single, cap, cw, rate;
  bool frozen;

  __device__ void load(const double* c_, const double* w_,
                       const double* single_, const double* cap_,
                       long long at, long long w_at, bool live) {
    c = live ? c_[at] : 0.0;
    w = live ? w_[w_at] : 0.0;
    single = live ? single_[at] : 0.0;
    cap = live ? cap_[at] : 0.0;
    cw = __dmul_rn(c, w);
    rate = 0.0;
    frozen = !live || c <= 0.0;
  }

  // the largest fill-level step the pair's own limits allow (INFINITY
  // when frozen)
  __device__ double bound() const {
    if (frozen) return INFINITY;
    const double inc_conn =
        w > 0.0 ? __ddiv_rn(__dsub_rn(single, rate), fmax(w, kEpsDen))
                : INFINITY;
    const double inc_path =
        cw > 0.0
            ? __ddiv_rn(__dsub_rn(cap, __dmul_rn(rate, c)), fmax(cw, kEpsDen))
            : INFINITY;
    return nan_min(inc_conn, inc_path);
  }

  // one step along the fill level; returns whether the pair is active
  // and hit its own limit, and sets its load and its next c*w term
  __device__ bool step(double inc, double* load, double* cw_next) {
    const bool act = !frozen;
    if (act) rate = __dadd_rn(rate, __dmul_rn(inc, w));
    *load = __dmul_rn(rate, c);
    const bool own = act && (__dsub_rn(single, rate) < kEpsSat ||
                             __dsub_rn(cap, *load) < kEpsSat);
    *cw_next = act && !own ? cw : 0.0;
    return own;
  }
};

// a NIC's increment bound: headroom over its active weight
__device__ __forceinline__ double nic_bound(double nic, double lsum,
                                            double wsum) {
  return wsum > 0.0 ? __ddiv_rn(__dsub_rn(nic, lsum), fmax(wsum, kEpsDen))
                    : INFINITY;
}

__device__ __forceinline__ double clamp_inc(double m) {
  return isfinite(m) && m >= kEpsInc ? m : 0.0;
}

// ---------------------------------------------------------------------
// N <= 8: a warp a fill
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
    waterfill_warp_kernel(const double* __restrict__ c,
                          const double* __restrict__ single,
                          const double* __restrict__ egress,
                          const double* __restrict__ ingress,
                          const double* __restrict__ w, long long w_stride,
                          const double* __restrict__ path_cap,
                          double* __restrict__ rate_out,
                          int* __restrict__ iters_out,
                          bool* __restrict__ conv_out, int batch, int n,
                          int cap_iters) {
  __shared__ double s_cw[kWarpsPerBlock][kWarpN * kWarpLd];
  __shared__ double s_load[kWarpsPerBlock][kWarpN * kWarpLd];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int f = blockIdx.x * kWarpsPerBlock + warp;
  if (f >= batch) return;              // the whole warp: no fill
  double* cwm = s_cw[warp];
  double* ldm = s_load[warp];
  const int nn = n * n;
  const long long base = static_cast<long long>(f) * nn;

  // each slot's pair: its matrix entry, its row's and its column's
  // ballot bits, packed in one word (fewer registers live across the
  // divisions' calls)
  Pair p[2];
  int slot[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int t = lane + 32 * q;
    const bool live = t < nn;
    const int i = live ? t / n : 0;
    const int j = live ? t - i * n : 0;
    slot[q] = (i * kWarpLd + j) | (i << 8) | ((kColLane + j) << 16);
    p[q].load(c, w, single, path_cap, base + t, f * w_stride + t, live);
  }
  // lane i < n owns row i (egress), lane 16 + j < 16 + n column j
  const bool row = lane < n;
  const bool col = lane >= kColLane && lane - kColLane < n;
  const int k_own = row ? lane : lane - kColLane;
  const int sum_at = row ? lane * kWarpLd : k_own;
  const int sum_stride = row ? 1 : kWarpLd;
  const double nic = row ? egress[static_cast<long long>(f) * n + lane]
                         : (col ? ingress[static_cast<long long>(f) * n +
                                          k_own]
                                : 0.0);

  // the first iteration's sums: loads of rate 0, every active pair's c*w
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (lane + 32 * q < nn) {
      ldm[slot[q] & 0xff] = __dmul_rn(p[q].rate, p[q].c);
      cwm[slot[q] & 0xff] = p[q].frozen ? 0.0 : p[q].cw;
    }
  }
  __syncwarp();
  double lsum = 0.0, wsum = 0.0;
  if (row || col) {
    ordered_sums<kWarpN>(ldm + sum_at, cwm + sum_at, sum_stride, n,
                                 &lsum, &wsum);
  }
  double m = warp_min(nan_min(nan_min(p[0].bound(), p[1].bound()),
                              nic_bound(nic, lsum, wsum)));
  bool done = __all_sync(kFull, p[0].frozen && p[1].frozen);
  unsigned prev_sats = 0u;
  __syncwarp();

  int it = 0;
  for (; it < cap_iters && !done; ++it) {
    // the update
    const double inc = clamp_inc(m);
    bool act[2], own[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      act[q] = !p[q].frozen;
      double load, cw_next;
      own[q] = p[q].step(inc, &load, &cw_next);
      if (lane + 32 * q < nn) {
        ldm[slot[q] & 0xff] = load;
        cwm[slot[q] & 0xff] = cw_next;
      }
    }
    __syncwarp();
    // the load sums (saturated NICs, the next headroom) and beside them
    // the weight sums of the terms still active apart from their NICs
    bool sat = false;
    if (row || col) {
      ordered_sums<kWarpN>(ldm + sum_at, cwm + sum_at, sum_stride,
                                   n, &lsum, &wsum);
      sat = __dsub_rn(nic, lsum) < kEpsSat;
    }
    const unsigned sats = __ballot_sync(kFull, sat);
    // the freeze
    bool hit = false;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bool h = act[q] && (own[q] ||
                                ((sats >> ((slot[q] >> 8) & 0xff)) & 1u) ||
                                ((sats >> (slot[q] >> 16)) & 1u));
      p[q].frozen = p[q].frozen || h;
      hit = hit || h;
    }
    // the weight sums after it: a NIC saturated in an earlier iteration
    // froze its pairs then, so their terms are 0 already; only one that
    // saturated now zeroes terms, and then the sums are taken again
    if (sats & ~prev_sats) {
      const unsigned other = row ? sats >> kColLane : sats & 0xffffu;
      if (row || col) {
        wsum = ordered_sum<kWarpN>(cwm + sum_at, sum_stride, n,
                                   sat ? kFull : other);
      }
    }
    prev_sats = sats;
    // the next increment
    m = warp_min(nan_min(nan_min(p[0].bound(), p[1].bound()),
                         nic_bound(nic, lsum, wsum)));
    const bool any_hit = __any_sync(kFull, hit);
    const bool all_frozen = __all_sync(kFull, p[0].frozen && p[1].frozen);
    done = all_frozen || (!any_hit && inc == 0.0);
    __syncwarp();
  }
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    if (lane + 32 * q < nn) rate_out[base + lane + 32 * q] = p[q].rate;
  }
  if (lane == 0) {
    iters_out[f] = it;
    conv_out[f] = done;
  }
}

// ---------------------------------------------------------------------
// 9 <= N <= 32: a block a fill
// ---------------------------------------------------------------------
__global__ void __launch_bounds__(1024)
    waterfill_block_kernel(const double* __restrict__ c,
                           const double* __restrict__ single,
                           const double* __restrict__ egress,
                           const double* __restrict__ ingress,
                           const double* __restrict__ w, long long w_stride,
                           const double* __restrict__ path_cap,
                           double* __restrict__ rate_out,
                           int* __restrict__ iters_out,
                           bool* __restrict__ conv_out, int n,
                           int cap_iters) {
  __shared__ double s_cw[kMaxN * kLd];    // the next iteration's c*w terms
  __shared__ double s_load[kMaxN * kLd];  // rate*c
  __shared__ double s_min[32];            // each warp's minimum
  __shared__ unsigned s_vote[32];         // each warp's hit, all-frozen
  __shared__ unsigned s_sat[2];           // saturated egress, ingress NICs

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int n_warps = blockDim.x >> 5;
  const int nn = n * n;
  const bool live = t < nn;
  const int i = live ? t / n : 0;
  const int j = live ? t - i * n : 0;
  const int at = i * kLd + j;
  const long long base = static_cast<long long>(blockIdx.x) * nn;

  Pair p;
  p.load(c, w, single, path_cap, base + t, blockIdx.x * w_stride + t, live);
  // warp 0's lanes own the rows (egress), warp 1's the columns (ingress)
  const bool row = warp == 0 && lane < n;
  const bool col = warp == 1 && lane < n;
  const int sum_at = row ? lane * kLd : lane;
  const int sum_stride = row ? 1 : kLd;
  const long long dc = static_cast<long long>(blockIdx.x) * n + lane;
  const double nic = row ? egress[dc] : (col ? ingress[dc] : 0.0);

  // the first iteration's sums: loads of rate 0, every active pair's c*w
  if (live) {
    s_load[at] = __dmul_rn(p.rate, p.c);
    s_cw[at] = p.frozen ? 0.0 : p.cw;
  }
  __syncthreads();
  double lsum = 0.0;
  double m = p.bound();
  if (row || col) {
    lsum = ordered_sum<kMaxN>(s_load + sum_at, sum_stride, n, 0u);
    m = nan_min(m, nic_bound(nic, lsum, ordered_sum<kMaxN>(
                                            s_cw + sum_at, sum_stride, n,
                                            0u)));
  }
  m = warp_min(m);
  {
    const bool all_frozen = __all_sync(kFull, p.frozen);
    if (lane == 0) {
      s_min[warp] = m;
      s_vote[warp] = all_frozen ? 2u : 0u;
    }
  }
  __syncthreads();

  bool done = false;
  bool zero_inc = false;   // the last update's increment was 0
  int it = 0;
  for (;; ++it) {
    // the last freeze's votes and the next increment: every warp folds
    // the warps' words (one a lane), so `done` and the clamped `inc`
    // agree block-wide
    const unsigned vote = lane < n_warps ? s_vote[lane] : 2u;
    double inc = warp_min(lane < n_warps ? s_min[lane] : INFINITY);
    const bool any_hit = __any_sync(kFull, vote & 1u);
    const bool all_frozen = __all_sync(kFull, vote & 2u);
    done = all_frozen || (!any_hit && zero_inc);
    if (done || it >= cap_iters) break;
    // the update
    inc = clamp_inc(inc);
    zero_inc = inc == 0.0;
    const bool act = !p.frozen;
    double load, cw_next;
    const bool own = p.step(inc, &load, &cw_next);
    if (live) {
      s_load[at] = load;
      s_cw[at] = cw_next;
    }
    __syncthreads();
    // the load sums: saturated NICs, and the next headroom
    bool sat = false;
    if (row || col) {
      lsum = ordered_sum<kMaxN>(s_load + sum_at, sum_stride, n, 0u);
      sat = __dsub_rn(nic, lsum) < kEpsSat;
    }
    if (warp < 2) {
      const unsigned sats = __ballot_sync(kFull, sat);
      if (lane == 0) s_sat[warp] = sats;
    }
    __syncthreads();
    // the freeze, the weight sums, the next increment, the votes
    const unsigned sat_e = s_sat[0], sat_i = s_sat[1];
    const bool hit = act && (own || ((sat_e >> i) & 1u) ||
                             ((sat_i >> j) & 1u));
    p.frozen = p.frozen || hit;
    m = p.bound();
    if (row || col) {
      const double wsum = ordered_sum<kMaxN>(
          s_cw + sum_at, sum_stride, n, sat ? kFull : (row ? sat_i : sat_e));
      m = nan_min(m, nic_bound(nic, lsum, wsum));
    }
    m = warp_min(m);
    const bool any = __any_sync(kFull, hit);
    const bool all = __all_sync(kFull, p.frozen);
    if (lane == 0) {
      s_min[warp] = m;
      s_vote[warp] = (any ? 1u : 0u) | (all ? 2u : 0u);
    }
    __syncthreads();
  }
  if (live) rate_out[base + t] = p.rate;
  if (t == 0) {
    iters_out[blockIdx.x] = it;
    conv_out[blockIdx.x] = done;
  }
}

// Threads a block of an n-DC fill on the block path: one per pair, a
// whole number of warps, at least two (warp 0 sums rows, warp 1
// columns).
int block_threads(int n) {
  const int threads = (n * n + 31) / 32 * 32;
  return threads < 64 ? 64 : threads;
}

cudaError_t launch_fills(const double* c, const double* single,
                         const double* egress, const double* ingress,
                         const double* w, long long w_stride,
                         const double* path_cap, double* rate, int* iters,
                         bool* converged, int batch, int n, int cap_iters,
                         cudaStream_t stream) {
  if (n <= kWarpN) {
    const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
    waterfill_warp_kernel<<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
        c, single, egress, ingress, w, w_stride, path_cap, rate, iters,
        converged, batch, n, cap_iters);
  } else {
    waterfill_block_kernel<<<batch, block_threads(n), 0, stream>>>(
        c, single, egress, ingress, w, w_stride, path_cap, rate, iters,
        converged, n, cap_iters);
  }
  return cudaGetLastError();
}

// The numpy entry's staging: a pinned host buffer and a device buffer
// per device, grown to the largest call and never shrunk.
struct Staging {
  char* host = nullptr;
  char* dev = nullptr;
  size_t bytes = 0;
};
std::mutex g_staging_mu;
Staging g_staging[kMaxDevices];

cudaError_t grow(Staging* s, size_t bytes) {
  if (s->bytes >= bytes) return cudaSuccess;
  size_t want = s->bytes * 2 > bytes ? s->bytes * 2 : bytes;
  if (s->host != nullptr) cudaFreeHost(s->host);
  if (s->dev != nullptr) cudaFree(s->dev);
  s->host = nullptr;
  s->dev = nullptr;
  s->bytes = 0;
  cudaError_t err = cudaMallocHost(reinterpret_cast<void**>(&s->host), want);
  if (err != cudaSuccess) return err;
  err = cudaMalloc(reinterpret_cast<void**>(&s->dev), want);
  if (err != cudaSuccess) {
    cudaFreeHost(s->host);
    s->host = nullptr;
    return err;
  }
  s->bytes = want;
  return cudaSuccess;
}

bool bad_shape(int batch, int n, long long w_stride) {
  return n < 1 || n > kMaxN || batch < 1 ||
         (w_stride != 0 && w_stride != static_cast<long long>(n) * n);
}

}  // namespace

// Launches `batch` fills of n DCs on `stream` (N <= 8: a warp a fill,
// else a block a fill); returns cudaGetLastError(), or
// cudaErrorInvalidValue for n outside [1, 32] or batch < 1. c, single,
// path_cap, rate: [batch, n, n] f64; w: [n, n] (w_stride 0) or
// [batch, n, n] (w_stride n*n) f64; egress, ingress: [batch, n] f64;
// iters: [batch] int32; converged: [batch] bool. All contiguous on one
// device; the caller checks them.
extern "C" int waterfill_launch(const void* c, const void* single,
                                const void* egress, const void* ingress,
                                const void* w, long long w_stride,
                                const void* path_cap, void* rate,
                                void* iters, void* converged, int batch,
                                int n, int cap_iters, void* stream) {
  if (bad_shape(batch, n, w_stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_fills(
      static_cast<const double*>(c), static_cast<const double*>(single),
      static_cast<const double*>(egress),
      static_cast<const double*>(ingress), static_cast<const double*>(w),
      w_stride, static_cast<const double*>(path_cap),
      static_cast<double*>(rate), static_cast<int*>(iters),
      static_cast<bool*>(converged), batch, n, cap_iters,
      static_cast<cudaStream_t>(stream)));
}

// The same fills from and into host memory, in one call on `stream` (a
// stream of the current device): the six inputs (the same shapes,
// contiguous f64 host arrays) are copied into the pinned staging buffer
// and cross in one host-to-device copy; the launch; rate, iters and the
// flag come back in one device-to-host copy into pinned memory; the
// stream is synchronised and the outputs copied into the caller's host
// arrays. Returns the first CUDA error of the staging's allocation, a
// copy, the launch or the synchronise (cudaErrorInvalidValue for a bad
// shape), else 0; the outputs are written only on success.
extern "C" int waterfill_fill_host(const void* c, const void* single,
                                   const void* egress, const void* ingress,
                                   const void* w, long long w_stride,
                                   const void* path_cap, void* rate,
                                   void* iters, void* converged, int batch,
                                   int n, int cap_iters, void* stream) {
  if (bad_shape(batch, n, w_stride)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const size_t nn = static_cast<size_t>(batch) * n * n;   // doubles
  const size_t nv = static_cast<size_t>(batch) * n;
  const size_t nw = w_stride == 0 ? static_cast<size_t>(n) * n : nn;
  // inputs: c, single, path_cap, w, egress, ingress; then the outputs
  const size_t in_bytes = (3 * nn + nw + 2 * nv) * sizeof(double);
  const size_t rate_bytes = nn * sizeof(double);
  const size_t out_bytes = rate_bytes + batch * (sizeof(int) + sizeof(bool));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  std::lock_guard<std::mutex> lock(g_staging_mu);
  Staging* s = &g_staging[device];
  err = grow(s, in_bytes + out_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* srcs[6] = {c, single, path_cap, w, egress, ingress};
  const size_t counts[6] = {nn, nn, nn, nw, nv, nv};
  size_t ofs[6];
  size_t at = 0;
  for (int k = 0; k < 6; ++k) {
    ofs[k] = at;
    memcpy(s->host + at, srcs[k], counts[k] * sizeof(double));
    at += counts[k] * sizeof(double);
  }
  err = cudaMemcpyAsync(s->dev, s->host, in_bytes, cudaMemcpyHostToDevice,
                        st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const double* d = reinterpret_cast<const double*>(s->dev);
  char* out = s->dev + in_bytes;
  err = launch_fills(d + ofs[0] / 8, d + ofs[1] / 8, d + ofs[4] / 8,
                     d + ofs[5] / 8, d + ofs[3] / 8, w_stride, d + ofs[2] / 8,
                     reinterpret_cast<double*>(out),
                     reinterpret_cast<int*>(out + rate_bytes),
                     reinterpret_cast<bool*>(out + rate_bytes +
                                             batch * sizeof(int)),
                     batch, n, cap_iters, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemcpyAsync(s->host + in_bytes, out, out_bytes,
                        cudaMemcpyDeviceToHost, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaStreamSynchronize(st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const char* h = s->host + in_bytes;
  memcpy(rate, h, rate_bytes);
  memcpy(iters, h + rate_bytes, batch * sizeof(int));
  memcpy(converged, h + rate_bytes + batch * sizeof(int),
         batch * sizeof(bool));
  return 0;
}

extern "C" const char* waterfill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
