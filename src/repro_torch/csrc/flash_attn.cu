// Flash attention of the dense family, forward and the custom VJP's
// backward, for Hopper (sm_90a).
//
// Replaces the JAX package's flash_attention (src/repro/models/
// attention.py:39, its jnp oracle of a TPU Pallas kernel) and the
// custom VJP's backward (_vjp_bwd, :99), and computes what they compute
// for q [B,K,G,S,D], k and v [B,K,S,D] (K kv heads, G query heads a kv
// head, Sq == Sk == S), causal, with an optional sliding window:
//   s    = (q . k^T in f32) * D^-0.5, masked to NEG_INF = -1e30 (not -inf)
//          where key j > query i or i - j >= window (window > 0);
//   fwd  : the online softmax (m, l, acc) over key tiles in order;
//          p = exp(s - m_new) rounded to v's dtype before the PV product
//          (f32 sums); out = acc / max(l, 1e-30) in v's dtype and
//          lse = m + log(max(l, 1e-30)) in f32;
//   bwd  : delta = sum(g * out) in f32, p = exp(s - lse) in f32,
//          dv = p^T g, dp = g v^T, ds = p (dp - delta),
//          dq = ds k * sc, dk = ds^T q * sc, in the operands' dtypes.
// The plain versions are kernels/ref.py::flash_fwd_ref / flash_bwd_ref,
// which keep the reference's key blocks of 512; the kernels state their
// own tile of 64 keys. A tile only reorders the sums and moves the
// points where p is rounded against its running max, so the card holds
// the kernels to the plain versions within a tolerance (chip_smoke.py).
//
// Key tiles that lie wholly above the causal diagonal, or wholly before
// a query tile's window, are skipped. That is exact: every row's
// diagonal key is valid, so in the reference such a block adds exp(-1e30
// - m) = 0 (after the diagonal), or is wiped by the next valid block's
// correction exp(-1e30 - m) = 0 (before the window), and in the backward
// its p = exp(-1e30 - lse) is 0. A masked row inside a visited tile keeps
// the reference's arithmetic (its p = 1 until a valid key wipes it).
//
// What bounds it on this card: operations. At llama3-8b's prefill (B=4,
// 32 heads, S=641, D=128, bf16) the forward's two products are 21.5
// GFLOP over the causal half (0.0217 ms at 989 TFLOP/s) against 52 MB of
// q, k, v, out (0.0157 ms at 3.35 TB/s); the backward's five products
// are 2.5x the forward's.
//
// Design. bf16 inputs (the serve and train paths) run on the tensor
// cores with mma.sync m16n8k16 (bf16 in, f32 accumulators), not wgmma:
// a warp owns 16 query rows (16 keys in dk/dv), the f32 score
// accumulator of one product is, re-packed two n-tiles at a time, the A
// fragment of the next one, so scores and probabilities never leave
// registers, and the per-row softmax needs only a quad of lanes. That
// register-level reuse is what wgmma makes awkward (its 64-row
// warpgroup tiles and asynchronous accumulators), and this first design
// keeps to the simpler instruction; moving to wgmma is later work.
// Where the reference's products are exact in f32 the tensor cores are
// too: a product of two bf16 values is exact in f32, so q.k^T, the
// rounded p times v and g.v^T are formed exactly and only summed in
// another order. pT.g, ds.k and ds^T.q have an f32 factor (p and ds stay
// f32 in the reference's backward): it is split into hi = bf16(x) and
// lo = bf16(x - hi) and run as two bf16 products into one accumulator
// (what is dropped is under 2^-17 |x|), as ssd_chunk.cu splits its
// decay. TF32 would keep 2^-11 and is not used.
//  * flash_fwd_bf16_kernel: a block of 4 warps takes 64 query rows of
//    one (b, kv head, g); key and value tiles of 64 rows come in by
//    cp.async (16 bytes a thread, zero-filled past S) into a two-stage
//    ring, the next tile's copy in flight during a tile's products.
//  * flash_bwd_dq_bf16_kernel: the same walk, recomputing s and dp per
//    key tile, dq accumulated in registers; no atomics.
//  * flash_bwd_dkdv_bf16_kernel: a block of 4 warps takes 64 keys of one
//    (b, kv head) and walks every g and every query tile of 32 rows that
//    reaches them, computing s^T and dp^T (keys as rows) so that p^T and
//    ds^T are already A fragments; dk and dv in registers.
//  * flash_delta_kernel: delta = sum(g * out) per row, a warp a row.
//  Shared-memory rows are D + 8 elements apart, so the fragment loads (32
//  bits a lane, or ldmatrix.trans for the operands read transposed) hit
//  distinct banks for every D that is a multiple of 16. D = 128 and 80
//  (the dense family's head widths) are compiled exactly; any other
//  multiple of 16 up to 128 takes the generic instance.
// f32 inputs (the f32 parity runs) run on the CUDA cores (FFMA), a warp
// a query row (a key row in dk/dv), lanes over the 32 keys (queries) of
// a tile in shared memory and over D for the accumulators:
// flash_fwd_f32_kernel, flash_bwd_dq_f32_kernel, flash_bwd_dkdv_f32_kernel.
// Every operand is read through its strides (b, kv head, g, row; unit
// stride along D), so the caller's layouts need no copy; outputs are
// dense.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;   // 4 warps (the bf16 kernels)
constexpr int kBM = 64;         // query rows of a block (fwd, dq)
constexpr int kBN = 64;         // keys of a tile (fwd, dq) / a block (dk/dv)
constexpr int kBQ = 32;         // query rows of a tile (dk/dv)
constexpr int kPad = 8;         // shared-memory row padding, elements

// element strides of one operand: batch, kv head, query group, row
struct View {
  long long b, h, g, s;
};

struct Shape {
  int B, K, G, S, D, window;
  float sc;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo with hi = bf16(x), lo = bf16(x - hi), for a pair
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  hi = pack_bf16(__bfloat162float(h0), __bfloat162float(h1));
  lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1,
                                              uint32_t& r2, uint32_t& r3,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// rows [row0, row0 + R) of an operand (rows `ld` elements apart, D wide)
// into shared memory rows SD apart, 16 bytes a copy; rows at or past S
// are zero-filled
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long ld, int row0, int R,
                                          int S, int D, int SD) {
  const int chunks = D / 8;
  for (int c = threadIdx.x; c < R * chunks; c += blockDim.x) {
    const int r = c / chunks, cc = c - r * chunks;
    const bool ok = row0 + r < S;
    const bf16* p = ok ? src + (long long)(row0 + r) * ld + cc * 8 : src;
    cp_async16(dst + r * SD + cc * 8, p, ok);
  }
}

__device__ __forceinline__ bool valid_key(int qi, int kj, int S,
                                          int window) {
  return kj <= qi && qi < S && (window <= 0 || qi - kj < window);
}

// A fragment (16 rows x 16 cols) of a row-major tile in shared memory
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int SD, int row, int col, int gid,
                                       int tig) {
  const bf16* p = t + (row + gid) * SD + col + 2 * tig;
  a[0] = lds32(p);
  a[1] = lds32(p + 8 * SD);
  a[2] = lds32(p + 8);
  a[3] = lds32(p + 8 * SD + 8);
}

// ----------------------------------------------------------------------
// bf16: forward
// ----------------------------------------------------------------------
template <int DM, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          float* __restrict__ lse, Shape sh, View qv,
                          View kv, View vv) {
  const int D = EXACT ? DM : sh.D;
  const int SD = D + kPad, S = sh.S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + kBM * SD;
  bf16* Vs = Ks + 2 * kBN * SD;

  const int nqt = (S + kBM - 1) / kBM;
  const int qt = nqt - 1 - blockIdx.x;   // the longest rows first
  const int z = blockIdx.y;
  const int gq = z % sh.G, kh = (z / sh.G) % sh.K, b = z / (sh.G * sh.K);
  const bf16* qb = q + b * qv.b + kh * qv.h + gq * qv.g;
  const bf16* kb = k + b * kv.b + kh * kv.h;
  const bf16* vb = v + b * vv.b + kh * vv.h;
  const int q0 = qt * kBM;
  const int klo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int khi = min(S, q0 + kBM);
  const int t_lo = klo / kBN, t_hi = (khi - 1) / kBN;

  load_rows(Qs, qb, qv.s, q0, kBM, S, D, SD);
  load_rows(Ks, kb, kv.s, t_lo * kBN, kBN, S, D, SD);
  load_rows(Vs, vb, vv.s, t_lo * kBN, kBN, S, D, SD);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = q0 + warp * 16 + gid;   // this lane's rows: row0, +8
  float o[DM / 8][4];
#pragma unroll
  for (int i = 0; i < DM / 8; ++i)
    o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t < t_hi) {
      load_rows(Ks + (buf ^ 1) * kBN * SD, kb, kv.s, (t + 1) * kBN, kBN, S,
                D, SD);
      load_rows(Vs + (buf ^ 1) * kBN * SD, vb, vv.s, (t + 1) * kBN, kBN, S,
                D, SD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * kBN * SD;
    const bf16* Vt = Vs + buf * kBN * SD;

    float s[kBN / 8][4];
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      if (EXACT || kk * 16 < D) {
        uint32_t a[4];
        load_a(a, Qs, SD, warp * 16, kk * 16, gid, tig);
#pragma unroll
        for (int nt = 0; nt < kBN / 8; ++nt) {
          const bf16* p = Kt + (nt * 8 + gid) * SD + kk * 16 + 2 * tig;
          mma16816(s[nt], a, lds32(p), lds32(p + 8));
        }
      }
    }
    // scale, mask, the running max and the probabilities
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = row0 + (e >> 1) * 8;
        const int kj = t * kBN + nt * 8 + 2 * tig + (e & 1);
        const float val = valid_key(qi, kj, S, sh.window) && kj < S
                              ? s[nt][e] * sh.sc
                              : kNegInf;
        s[nt][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float corr[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        ls[e >> 1] += p;
      }
    }
    l[0] = l[0] * corr[0] + ls[0];
    l[1] = l[1] * corr[1] + ls[1];
#pragma unroll
    for (int i = 0; i < DM / 8; ++i) {
      o[i][0] *= corr[0];
      o[i][1] *= corr[0];
      o[i][2] *= corr[1];
      o[i][3] *= corr[1];
    }
    // acc += bf16(p) . v
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const bf16* vrow = Vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SD +
                         (lane >> 4) * 8;
#pragma unroll
      for (int d2 = 0; d2 < DM / 16; ++d2) {
        if (EXACT || d2 * 16 < D) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(b0, b1, b2, b3, vrow + d2 * 16);
          mma16816(o[2 * d2], a, b0, b1);
          mma16816(o[2 * d2 + 1], a, b2, b3);
        }
      }
    }
    __syncthreads();
  }
  // the row sums over the quad, then out and lse
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const long long zrow = (long long)z * S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + i * 8;
    if (qi >= S) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    bf16* orow = out + (zrow + qi) * D;
#pragma unroll
    for (int dt = 0; dt < DM / 8; ++dt) {
      if (EXACT || dt * 8 < D)
        *reinterpret_cast<uint32_t*>(orow + dt * 8 + 2 * tig) =
            pack_bf16(o[dt][2 * i] / l_safe, o[dt][2 * i + 1] / l_safe);
    }
    if (tig == 0) lse[zrow + qi] = m[i] + logf(l_safe);
  }
}

// ----------------------------------------------------------------------
// bf16: backward, dq
// ----------------------------------------------------------------------
template <int DM, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ g,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, Shape sh, View qv,
                             View kv, View vv, View gv) {
  const int D = EXACT ? DM : sh.D;
  const int SD = D + kPad, S = sh.S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Gs = Qs + kBM * SD;
  bf16* Ks = Gs + kBM * SD;
  bf16* Vs = Ks + 2 * kBN * SD;

  const int nqt = (S + kBM - 1) / kBM;
  const int qt = nqt - 1 - blockIdx.x;
  const int z = blockIdx.y;
  const int gq = z % sh.G, kh = (z / sh.G) % sh.K, b = z / (sh.G * sh.K);
  const bf16* qb = q + b * qv.b + kh * qv.h + gq * qv.g;
  const bf16* gb = g + b * gv.b + kh * gv.h + gq * gv.g;
  const bf16* kb = k + b * kv.b + kh * kv.h;
  const bf16* vb = v + b * vv.b + kh * vv.h;
  const int q0 = qt * kBM;
  const int klo = sh.window > 0 ? max(0, q0 - sh.window + 1) : 0;
  const int khi = min(S, q0 + kBM);
  const int t_lo = klo / kBN, t_hi = (khi - 1) / kBN;

  load_rows(Qs, qb, qv.s, q0, kBM, S, D, SD);
  load_rows(Gs, gb, gv.s, q0, kBM, S, D, SD);
  load_rows(Ks, kb, kv.s, t_lo * kBN, kBN, S, D, SD);
  load_rows(Vs, vb, vv.s, t_lo * kBN, kBN, S, D, SD);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int row0 = q0 + warp * 16 + gid;
  const long long zrow = (long long)z * S;
  float lse_r[2], del_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + 8 * i;
    lse_r[i] = qi < S ? lse[zrow + qi] : 0.f;
    del_r[i] = qi < S ? delta[zrow + qi] : 0.f;
  }
  float acc[DM / 8][4];
#pragma unroll
  for (int i = 0; i < DM / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int buf = (t - t_lo) & 1;
    if (t < t_hi) {
      load_rows(Ks + (buf ^ 1) * kBN * SD, kb, kv.s, (t + 1) * kBN, kBN, S,
                D, SD);
      load_rows(Vs + (buf ^ 1) * kBN * SD, vb, vv.s, (t + 1) * kBN, kBN, S,
                D, SD);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + buf * kBN * SD;
    const bf16* Vt = Vs + buf * kBN * SD;

    float s[kBN / 8][4], dp[kBN / 8][4];
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      dp[i][0] = dp[i][1] = dp[i][2] = dp[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      if (EXACT || kk * 16 < D) {
        uint32_t aq[4], ag[4];
        load_a(aq, Qs, SD, warp * 16, kk * 16, gid, tig);
        load_a(ag, Gs, SD, warp * 16, kk * 16, gid, tig);
#pragma unroll
        for (int nt = 0; nt < kBN / 8; ++nt) {
          const bf16* pk = Kt + (nt * 8 + gid) * SD + kk * 16 + 2 * tig;
          const bf16* pv = Vt + (nt * 8 + gid) * SD + kk * 16 + 2 * tig;
          mma16816(s[nt], aq, lds32(pk), lds32(pk + 8));
          mma16816(dp[nt], ag, lds32(pv), lds32(pv + 8));
        }
      }
    }
    // ds = p (dp - delta), p = exp(s - lse) (0 where masked)
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1, qi = row0 + 8 * i;
        const int kj = t * kBN + nt * 8 + 2 * tig + (e & 1);
        const float p = valid_key(qi, kj, S, sh.window) && kj < S
                            ? expf(s[nt][e] * sh.sc - lse_r[i])
                            : 0.f;
        s[nt][e] = p * (dp[nt][e] - del_r[i]);
      }
    }
    // dq += ds . k, ds split into bf16 hi + lo
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      uint32_t hi[4], lo[4];
      split_pair(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_pair(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_pair(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_pair(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
      const bf16* krow = Kt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SD +
                         (lane >> 4) * 8;
#pragma unroll
      for (int d2 = 0; d2 < DM / 16; ++d2) {
        if (EXACT || d2 * 16 < D) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(b0, b1, b2, b3, krow + d2 * 16);
          mma16816(acc[2 * d2], hi, b0, b1);
          mma16816(acc[2 * d2 + 1], hi, b2, b3);
          mma16816(acc[2 * d2], lo, b0, b1);
          mma16816(acc[2 * d2 + 1], lo, b2, b3);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qi = row0 + i * 8;
    if (qi >= S) continue;
    bf16* row = dq + (zrow + qi) * D;
#pragma unroll
    for (int dt = 0; dt < DM / 8; ++dt) {
      if (EXACT || dt * 8 < D)
        *reinterpret_cast<uint32_t*>(row + dt * 8 + 2 * tig) = pack_bf16(
            acc[dt][2 * i] * sh.sc, acc[dt][2 * i + 1] * sh.sc);
    }
  }
}

// ----------------------------------------------------------------------
// bf16: backward, dk and dv (keys as the product rows)
// ----------------------------------------------------------------------
template <int DM, bool EXACT>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const bf16* __restrict__ g,
                               const float* __restrict__ lse,
                               const float* __restrict__ delta,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               Shape sh, View qv, View kv, View vv,
                               View gv) {
  const int D = EXACT ? DM : sh.D;
  const int SD = D + kPad, S = sh.S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + kBN * SD;
  bf16* Qs = Vs + kBN * SD;          // [2][kBQ][SD]
  bf16* Gs = Qs + 2 * kBQ * SD;      // [2][kBQ][SD]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * kBQ * SD);   // [2][kBQ]
  float* Ds = Ls + 2 * kBQ;                                  // [2][kBQ]

  const int nkt = (S + kBN - 1) / kBN;
  const int kt = nkt - 1 - blockIdx.x;
  const int z = blockIdx.y;                 // b * K + kv head
  const int kh = z % sh.K, b = z / sh.K;
  const int k0 = kt * kBN;
  const bf16* kb = k + b * kv.b + kh * kv.h;
  const bf16* vb = v + b * vv.b + kh * vv.h;
  // the query rows that reach these keys: [k0, qend)
  const int qend = sh.window > 0 ? min(S, k0 + kBN - 1 + sh.window) : S;
  const int qt_lo = k0 / kBQ, qt_hi = (qend - 1) / kBQ;
  const int nq = qt_hi - qt_lo + 1, total = nq * sh.G;

  auto load_q = [&](int it, int buf) {
    const int gq = it / nq, qt = qt_lo + it % nq;
    const long long zq = (long long)(z * sh.G + gq) * S;
    const bf16* qb = q + b * qv.b + kh * qv.h + gq * qv.g;
    const bf16* gb = g + b * gv.b + kh * gv.h + gq * gv.g;
    load_rows(Qs + buf * kBQ * SD, qb, qv.s, qt * kBQ, kBQ, S, D, SD);
    load_rows(Gs + buf * kBQ * SD, gb, gv.s, qt * kBQ, kBQ, S, D, SD);
    if (threadIdx.x < kBQ) {
      const int qi = qt * kBQ + threadIdx.x;
      Ls[buf * kBQ + threadIdx.x] = qi < S ? lse[zq + qi] : 0.f;
      Ds[buf * kBQ + threadIdx.x] = qi < S ? delta[zq + qi] : 0.f;
    }
  };

  load_rows(Ks, kb, kv.s, k0, kBN, S, D, SD);
  load_rows(Vs, vb, vv.s, k0, kBN, S, D, SD);
  load_q(0, 0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int key0 = k0 + warp * 16 + gid;      // this lane's keys: key0, +8
  float adk[DM / 8][4], adv[DM / 8][4];
#pragma unroll
  for (int i = 0; i < DM / 8; ++i) {
    adk[i][0] = adk[i][1] = adk[i][2] = adk[i][3] = 0.f;
    adv[i][0] = adv[i][1] = adv[i][2] = adv[i][3] = 0.f;
  }

  for (int it = 0; it < total; ++it) {
    const int buf = it & 1;
    if (it + 1 < total) {
      load_q(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int qbase = (qt_lo + it % nq) * kBQ;
    const bf16* Qt = Qs + buf * kBQ * SD;
    const bf16* Gt = Gs + buf * kBQ * SD;
    const float* Lt = Ls + buf * kBQ;
    const float* Dt = Ds + buf * kBQ;

    float st[kBQ / 8][4], dpt[kBQ / 8][4];
#pragma unroll
    for (int i = 0; i < kBQ / 8; ++i) {
      st[i][0] = st[i][1] = st[i][2] = st[i][3] = 0.f;
      dpt[i][0] = dpt[i][1] = dpt[i][2] = dpt[i][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < DM / 16; ++kk) {
      if (EXACT || kk * 16 < D) {
        uint32_t ak[4], av[4];
        load_a(ak, Ks, SD, warp * 16, kk * 16, gid, tig);
        load_a(av, Vs, SD, warp * 16, kk * 16, gid, tig);
#pragma unroll
        for (int nt = 0; nt < kBQ / 8; ++nt) {
          const bf16* pq = Qt + (nt * 8 + gid) * SD + kk * 16 + 2 * tig;
          const bf16* pg = Gt + (nt * 8 + gid) * SD + kk * 16 + 2 * tig;
          mma16816(st[nt], ak, lds32(pq), lds32(pq + 8));
          mma16816(dpt[nt], av, lds32(pg), lds32(pg + 8));
        }
      }
    }
    // p^T and ds^T: rows are keys, columns queries
#pragma unroll
    for (int nt = 0; nt < kBQ / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kj = key0 + (e >> 1) * 8;
        const int c = nt * 8 + 2 * tig + (e & 1), qi = qbase + c;
        const float p = valid_key(qi, kj, S, sh.window) && kj < S
                            ? expf(st[nt][e] * sh.sc - Lt[c])
                            : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - Dt[c]);
      }
    }
    // dv += p^T g, dk += ds^T q, the f32 factor split into hi + lo
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      uint32_t ph[4], pl[4], dh[4], dl[4];
      split_pair(st[2 * kk][0], st[2 * kk][1], ph[0], pl[0]);
      split_pair(st[2 * kk][2], st[2 * kk][3], ph[1], pl[1]);
      split_pair(st[2 * kk + 1][0], st[2 * kk + 1][1], ph[2], pl[2]);
      split_pair(st[2 * kk + 1][2], st[2 * kk + 1][3], ph[3], pl[3]);
      split_pair(dpt[2 * kk][0], dpt[2 * kk][1], dh[0], dl[0]);
      split_pair(dpt[2 * kk][2], dpt[2 * kk][3], dh[1], dl[1]);
      split_pair(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1], dh[2], dl[2]);
      split_pair(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3], dh[3], dl[3]);
      const int roff = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * SD +
                       (lane >> 4) * 8;
#pragma unroll
      for (int d2 = 0; d2 < DM / 16; ++d2) {
        if (EXACT || d2 * 16 < D) {
          uint32_t b0, b1, b2, b3;
          ldsm_x4_trans(b0, b1, b2, b3, Gt + roff + d2 * 16);
          mma16816(adv[2 * d2], ph, b0, b1);
          mma16816(adv[2 * d2 + 1], ph, b2, b3);
          mma16816(adv[2 * d2], pl, b0, b1);
          mma16816(adv[2 * d2 + 1], pl, b2, b3);
          ldsm_x4_trans(b0, b1, b2, b3, Qt + roff + d2 * 16);
          mma16816(adk[2 * d2], dh, b0, b1);
          mma16816(adk[2 * d2 + 1], dh, b2, b3);
          mma16816(adk[2 * d2], dl, b0, b1);
          mma16816(adk[2 * d2 + 1], dl, b2, b3);
        }
      }
    }
    __syncthreads();
  }
  const long long zk = (long long)z * S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kj = key0 + i * 8;
    if (kj >= S) continue;
    bf16* rk = dk + (zk + kj) * D;
    bf16* rv = dv + (zk + kj) * D;
#pragma unroll
    for (int dt = 0; dt < DM / 8; ++dt) {
      if (EXACT || dt * 8 < D) {
        *reinterpret_cast<uint32_t*>(rk + dt * 8 + 2 * tig) = pack_bf16(
            adk[dt][2 * i] * sh.sc, adk[dt][2 * i + 1] * sh.sc);
        *reinterpret_cast<uint32_t*>(rv + dt * 8 + 2 * tig) =
            pack_bf16(adv[dt][2 * i], adv[dt][2 * i + 1]);
      }
    }
  }
}

// ----------------------------------------------------------------------
// delta = sum(g * out) over D, in f32; a warp a row
// ----------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ float to_f(T x) {
  return static_cast<float>(x);
}
template <>
__device__ __forceinline__ float to_f<bf16>(bf16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void flash_delta_kernel(const T* __restrict__ g,
                                   const T* __restrict__ o,
                                   float* __restrict__ delta, Shape sh,
                                   View gv, View ov) {
  const long long rows = (long long)sh.B * sh.K * sh.G * sh.S;
  const long long r = (long long)blockIdx.x * (blockDim.x / 32) +
                      (threadIdx.x >> 5);
  if (r >= rows) return;
  const int lane = threadIdx.x & 31;
  const int qi = r % sh.S;
  const long long zz = r / sh.S;
  const int gq = zz % sh.G, kh = (zz / sh.G) % sh.K;
  const int b = zz / ((long long)sh.G * sh.K);
  const T* gr = g + b * gv.b + kh * gv.h + gq * gv.g + qi * gv.s;
  const T* orow = o + b * ov.b + kh * ov.h + gq * ov.g + qi * ov.s;
  float acc = 0.f;
  for (int d = lane; d < sh.D; d += 32) acc += to_f(gr[d]) * to_f(orow[d]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[r] = acc;
}

// ----------------------------------------------------------------------
// f32 (FFMA): a warp a row, 8 rows a block, tiles of 32
// ----------------------------------------------------------------------
constexpr int kRows = 8;           // rows (warps) of an f32 block
constexpr int kT = 32;             // keys (queries) of an f32 tile
constexpr int kMaxC = 4;           // D / 32, rounded up, at most

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [row0, row0 + R) of an f32 operand into shared rows `SD` apart,
// zero past S
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ld, int row0, int R,
                                              int S, int D, int SD) {
  for (int c = threadIdx.x; c < R * D; c += blockDim.x) {
    const int r = c / D, d = c - r * D;
    dst[r * SD + d] = row0 + r < S ? src[(long long)(row0 + r) * ld + d] : 0.f;
  }
}

__global__ void __launch_bounds__(kRows * 32)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, Shape sh, View qv, View kv,
                         View vv) {
  const int D = sh.D, S = sh.S, SD = D + 1;
  extern __shared__ float fsm[];
  float* Qs = fsm;                   // [kRows][D]
  float* Ks = Qs + kRows * D;        // [kT][SD]
  float* Vs = Ks + kT * SD;          // [kT][SD]
  float* Ps = Vs + kT * SD;          // [kRows][kT]
  const int nblk = (S + kRows - 1) / kRows;
  const int i0 = (nblk - 1 - blockIdx.x) * kRows;
  const int z = blockIdx.y;
  const int gq = z % sh.G, kh = (z / sh.G) % sh.K, b = z / (sh.G * sh.K);
  const float* qb = q + b * qv.b + kh * qv.h + gq * qv.g;
  const float* kb = k + b * kv.b + kh * kv.h;
  const float* vb = v + b * vv.b + kh * vv.h;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = i0 + w;
  const int klo = sh.window > 0 ? max(0, i0 - sh.window + 1) : 0;
  const int khi = min(S, i0 + kRows);
  for (int c = threadIdx.x; c < kRows * D; c += blockDim.x) {
    const int r = c / D, d = c - r * D;
    Qs[c] = i0 + r < S ? qb[(long long)(i0 + r) * qv.s + d] : 0.f;
  }
  float m = kNegInf, l = 0.f, acc[kMaxC] = {0.f, 0.f, 0.f, 0.f};
  for (int kt0 = (klo / kT) * kT; kt0 < khi; kt0 += kT) {
    __syncthreads();
    load_rows_f32(Ks, kb, kv.s, kt0, kT, S, D, SD);
    load_rows_f32(Vs, vb, vv.s, kt0, kT, S, D, SD);
    __syncthreads();
    const int kj = kt0 + lane;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(Qs[w * D + d], Ks[lane * SD + d], s);
    s = valid_key(qi, kj, S, sh.window) && kj < S ? s * sh.sc : kNegInf;
    const float m_new = fmaxf(m, warp_max(s));
    const float p = expf(s - m_new);
    const float corr = expf(m - m_new);
    l = l * corr + warp_sum(p);
    m = m_new;
    Ps[w * kT + lane] = p;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        float pv = 0.f;
        for (int j = 0; j < kT; ++j) pv = fmaf(Ps[w * kT + j], Vs[j * SD + d], pv);
        acc[c] = acc[c] * corr + pv;
      }
    }
  }
  if (qi < S) {
    const long long zr = (long long)z * S + qi;
    const float l_safe = fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) out[zr * D + d] = acc[c] / l_safe;
    }
    if (lane == 0) lse[zr] = m + logf(l_safe);
  }
}

__global__ void __launch_bounds__(kRows * 32)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ g,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, Shape sh, View qv,
                            View kv, View vv, View gv) {
  const int D = sh.D, S = sh.S, SD = D + 1;
  extern __shared__ float fsm[];
  float* Qs = fsm;                   // [kRows][D]
  float* Gs = Qs + kRows * D;        // [kRows][D]
  float* Ks = Gs + kRows * D;        // [kT][SD]
  float* Vs = Ks + kT * SD;          // [kT][SD]
  float* Ps = Vs + kT * SD;          // [kRows][kT]
  const int nblk = (S + kRows - 1) / kRows;
  const int i0 = (nblk - 1 - blockIdx.x) * kRows;
  const int z = blockIdx.y;
  const int gq = z % sh.G, kh = (z / sh.G) % sh.K, b = z / (sh.G * sh.K);
  const float* qb = q + b * qv.b + kh * qv.h + gq * qv.g;
  const float* gb = g + b * gv.b + kh * gv.h + gq * gv.g;
  const float* kb = k + b * kv.b + kh * kv.h;
  const float* vb = v + b * vv.b + kh * vv.h;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = i0 + w;
  const long long zr = (long long)z * S + qi;
  const float lse_i = qi < S ? lse[zr] : 0.f;
  const float del_i = qi < S ? delta[zr] : 0.f;
  const int klo = sh.window > 0 ? max(0, i0 - sh.window + 1) : 0;
  const int khi = min(S, i0 + kRows);
  for (int c = threadIdx.x; c < kRows * D; c += blockDim.x) {
    const int r = c / D, d = c - r * D;
    const bool ok = i0 + r < S;
    Qs[c] = ok ? qb[(long long)(i0 + r) * qv.s + d] : 0.f;
    Gs[c] = ok ? gb[(long long)(i0 + r) * gv.s + d] : 0.f;
  }
  float acc[kMaxC] = {0.f, 0.f, 0.f, 0.f};
  for (int kt0 = (klo / kT) * kT; kt0 < khi; kt0 += kT) {
    __syncthreads();
    load_rows_f32(Ks, kb, kv.s, kt0, kT, S, D, SD);
    load_rows_f32(Vs, vb, vv.s, kt0, kT, S, D, SD);
    __syncthreads();
    const int kj = kt0 + lane;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < D; ++d) {
      s = fmaf(Qs[w * D + d], Ks[lane * SD + d], s);
      dp = fmaf(Gs[w * D + d], Vs[lane * SD + d], dp);
    }
    const float p = valid_key(qi, kj, S, sh.window) && kj < S
                        ? expf(s * sh.sc - lse_i)
                        : 0.f;
    Ps[w * kT + lane] = p * (dp - del_i);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = lane + 32 * c;
      if (d < D)
        for (int j = 0; j < kT; ++j)
          acc[c] = fmaf(Ps[w * kT + j], Ks[j * SD + d], acc[c]);
    }
  }
  if (qi < S) {
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dq[zr * D + d] = acc[c] * sh.sc;
    }
  }
}

__global__ void __launch_bounds__(kRows * 32)
    flash_bwd_dkdv_f32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const float* __restrict__ g,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Shape sh, View qv, View kv, View vv, View gv) {
  const int D = sh.D, S = sh.S, SD = D + 1;
  extern __shared__ float fsm[];
  float* Ks = fsm;                   // [kRows][D]
  float* Vs = Ks + kRows * D;        // [kRows][D]
  float* Qs = Vs + kRows * D;        // [kT][SD]
  float* Gs = Qs + kT * SD;          // [kT][SD]
  float* Ls = Gs + kT * SD;          // [kT]
  float* Dl = Ls + kT;               // [kT]
  float* Ps = Dl + kT;               // [kRows][kT]
  float* Ss = Ps + kRows * kT;       // [kRows][kT]
  const int nblk = (S + kRows - 1) / kRows;
  const int j0 = (nblk - 1 - blockIdx.x) * kRows;
  const int z = blockIdx.y;                 // b * K + kv head
  const int kh = z % sh.K, b = z / sh.K;
  const float* kb = k + b * kv.b + kh * kv.h;
  const float* vb = v + b * vv.b + kh * vv.h;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kj = j0 + w;
  const int qend = sh.window > 0 ? min(S, j0 + kRows - 1 + sh.window) : S;
  for (int c = threadIdx.x; c < kRows * D; c += blockDim.x) {
    const int r = c / D, d = c - r * D;
    const bool ok = j0 + r < S;
    Ks[c] = ok ? kb[(long long)(j0 + r) * kv.s + d] : 0.f;
    Vs[c] = ok ? vb[(long long)(j0 + r) * vv.s + d] : 0.f;
  }
  float ak[kMaxC] = {0.f, 0.f, 0.f, 0.f}, av[kMaxC] = {0.f, 0.f, 0.f, 0.f};
  for (int gq = 0; gq < sh.G; ++gq) {
    const float* qb = q + b * qv.b + kh * qv.h + gq * qv.g;
    const float* gb = g + b * gv.b + kh * gv.h + gq * gv.g;
    const long long zq = (long long)(z * sh.G + gq) * S;
    for (int qt0 = (j0 / kT) * kT; qt0 < qend; qt0 += kT) {
      __syncthreads();
      load_rows_f32(Qs, qb, qv.s, qt0, kT, S, D, SD);
      load_rows_f32(Gs, gb, gv.s, qt0, kT, S, D, SD);
      if (threadIdx.x < kT) {
        const int qi = qt0 + threadIdx.x;
        Ls[threadIdx.x] = qi < S ? lse[zq + qi] : 0.f;
        Dl[threadIdx.x] = qi < S ? delta[zq + qi] : 0.f;
      }
      __syncthreads();
      const int qi = qt0 + lane;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(Qs[lane * SD + d], Ks[w * D + d], s);
        dp = fmaf(Gs[lane * SD + d], Vs[w * D + d], dp);
      }
      const float p = valid_key(qi, kj, S, sh.window) && kj < S
                          ? expf(s * sh.sc - Ls[lane])
                          : 0.f;
      Ps[w * kT + lane] = p;
      Ss[w * kT + lane] = p * (dp - Dl[lane]);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        const int d = lane + 32 * c;
        if (d < D) {
          for (int i = 0; i < kT; ++i) {
            av[c] = fmaf(Ps[w * kT + i], Gs[i * SD + d], av[c]);
            ak[c] = fmaf(Ss[w * kT + i], Qs[i * SD + d], ak[c]);
          }
        }
      }
    }
  }
  if (kj < S) {
    const long long zr = (long long)z * S + kj;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        dk[zr * D + d] = ak[c] * sh.sc;
        dv[zr * D + d] = av[c];
      }
    }
  }
}

// ----------------------------------------------------------------------
// launches
// ----------------------------------------------------------------------
size_t fwd_smem(int D) { return (size_t)(kBM + 4 * kBN) * (D + kPad) * 2; }
size_t dq_smem(int D) { return (size_t)(2 * kBM + 4 * kBN) * (D + kPad) * 2; }
size_t dkdv_smem(int D) {
  return (size_t)(2 * kBN + 4 * kBQ) * (D + kPad) * 2 + 4 * kBQ * 4;
}

template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

View view_of(const long long* st) { return View{st[0], st[1], st[2], st[3]}; }

template <int DM, bool EXACT>
cudaError_t fwd_bf16(const void* q, const void* k, const void* v, void* out,
                     float* lse, const Shape& sh, const long long* st,
                     cudaStream_t stream) {
  auto kern = flash_fwd_bf16_kernel<DM, EXACT>;
  const size_t smem = fwd_smem(sh.D);
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sh.S + kBM - 1) / kBM, sh.B * sh.K * sh.G);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, sh,
      view_of(st), view_of(st + 4), view_of(st + 8));
  return cudaGetLastError();
}

template <int DM, bool EXACT>
cudaError_t bwd_bf16(const void* q, const void* k, const void* v,
                     const void* g, const float* lse, const float* delta,
                     void* dq, void* dk, void* dv, const Shape& sh,
                     const long long* st, cudaStream_t stream) {
  auto kdq = flash_bwd_dq_bf16_kernel<DM, EXACT>;
  auto kkv = flash_bwd_dkdv_bf16_kernel<DM, EXACT>;
  cudaError_t err = allow_smem(kdq, dq_smem(sh.D));
  if (err == cudaSuccess) err = allow_smem(kkv, dkdv_smem(sh.D));
  if (err != cudaSuccess) return err;
  const View qv = view_of(st), kv = view_of(st + 4), vv = view_of(st + 8),
             gv = view_of(st + 12);
  dim3 gq((sh.S + kBM - 1) / kBM, sh.B * sh.K * sh.G);
  kdq<<<gq, kThreads, dq_smem(sh.D), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
      static_cast<bf16*>(dq), sh, qv, kv, vv, gv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 gk((sh.S + kBN - 1) / kBN, sh.B * sh.K);
  kkv<<<gk, kThreads, dkdv_smem(sh.D), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(g), lse, delta,
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sh, qv, kv, vv, gv);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. `strides` holds 4 element strides (batch, kv
// head, query group, row) per operand: q, k, v for the forward; q, k, v,
// g, out for the backward (k's and v's group stride is unused). Rows
// are unit-stride along D; for bf16 every row start is 16-byte aligned
// (the wrapper checks). out [B,K,G,S,D], lse and delta [B,K,G,S], dq
// [B,K,G,S,D], dk and dv [B,K,S,D] are dense. Each returns
// cudaGetLastError() (0 = launched).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int K, int G,
                                int S, int D, int window, float sc,
                                int dtype, const long long* strides,
                                void* stream) {
  const Shape sh{B, K, G, S, D, window, sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1) {
    cudaError_t err;
    if (D == 128)
      err = fwd_bf16<128, true>(q, k, v, out, l, sh, strides, st);
    else if (D == 80)
      err = fwd_bf16<80, true>(q, k, v, out, l, sh, strides, st);
    else
      err = fwd_bf16<128, false>(q, k, v, out, l, sh, strides, st);
    return static_cast<int>(err);
  }
  const size_t smem = (size_t)(kRows * D + 2 * kT * (D + 1) + kRows * kT) * 4;
  cudaError_t err = allow_smem(flash_fwd_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kRows - 1) / kRows, B * K * G);
  flash_fwd_f32_kernel<<<grid, kRows * 32, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), l, sh,
      view_of(strides), view_of(strides + 4), view_of(strides + 8));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_bwd_launch(const void* g, const void* q, const void* k,
                                const void* v, const void* out,
                                const void* lse, void* delta, void* dq,
                                void* dk, void* dv, int B, int K, int G,
                                int S, int D, int window, float sc,
                                int dtype, const long long* strides,
                                void* stream) {
  const Shape sh{B, K, G, S, D, window, sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const View gv = view_of(strides + 12), ov = view_of(strides + 16);
  const long long rows = (long long)B * K * G * S;
  const unsigned dblocks = static_cast<unsigned>((rows + 7) / 8);
  if (dtype == 1) {
    flash_delta_kernel<bf16><<<dblocks, 256, 0, st>>>(
        static_cast<const bf16*>(g), static_cast<const bf16*>(out), dl, sh,
        gv, ov);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    if (D == 128)
      err = bwd_bf16<128, true>(q, k, v, g, l, dl, dq, dk, dv, sh, strides,
                                st);
    else if (D == 80)
      err = bwd_bf16<80, true>(q, k, v, g, l, dl, dq, dk, dv, sh, strides,
                               st);
    else
      err = bwd_bf16<128, false>(q, k, v, g, l, dl, dq, dk, dv, sh, strides,
                                 st);
    return static_cast<int>(err);
  }
  flash_delta_kernel<float><<<dblocks, 256, 0, st>>>(
      static_cast<const float*>(g), static_cast<const float*>(out), dl, sh,
      gv, ov);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const View qv = view_of(strides), kv = view_of(strides + 4),
             vv = view_of(strides + 8);
  const size_t sdq =
      (size_t)(2 * kRows * D + 2 * kT * (D + 1) + kRows * kT) * 4;
  err = allow_smem(flash_bwd_dq_f32_kernel, sdq);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kRows - 1) / kRows, B * K * G);
  flash_bwd_dq_f32_kernel<<<grid, kRows * 32, sdq, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), l, dl,
      static_cast<float*>(dq), sh, qv, kv, vv, gv);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t skv =
      (size_t)(2 * kRows * D + 2 * kT * (D + 1) + 2 * kT + 2 * kRows * kT) * 4;
  err = allow_smem(flash_bwd_dkdv_f32_kernel, skv);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 gk((S + kRows - 1) / kRows, B * K);
  flash_bwd_dkdv_f32_kernel<<<gk, kRows * 32, skv, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(g), l, dl,
      static_cast<float*>(dk), static_cast<float*>(dv), sh, qv, kv, vv, gv);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
