// The MoE layer's routing slots, dispatch and combine, and the two
// latter's backwards, for Hopper (sm_90a): one launch each where the JAX
// package's program runs a one-hot cumulative count, k sequential
// scatters and k sequential gathers, and where its gradient runs their
// transposes.
//
// The JAX package has no kernel here: src/repro/models/moe.py counts
// each choice's capacity slot as a cumulative sum of one-hots over the
// flattened (token, choice) stream (:83-90), writes the dispatch as k
// scatter-adds of [G,Tg,d] into a zero buffer [G,E,C,d] (:98-100) and
// the combine as k gathers, each masked, scaled by its gate and added
// (:115-118); XLA fuses each into a loop. Done op by op in eager
// PyTorch the three take ~92 launches a layer more than these kernels
// (2,208 a decode step of granite-moe-1b-a400m's 24 layers on an H100),
// and every decode the port serves is bound by the host's issue. So
// each is one kernel here, whose result is fixed element by element and
// equal bit for bit to its plain version (kernels/ref.py::moe_slots_ref,
// moe_dispatch_gather_ref, moe_combine_ref), which is the reference's
// count and rounding order:
//
//  * moe_slots_kernel: the capacity slots and their inverse. A choice's
//    slot is its rank among the choices of its expert over its group's
//    stream, token-major; it is kept where the rank is below C (a
//    dropped choice's slot reads 0). src[g, e, c] names the token whose
//    choice holds slot c of expert e, or -1. One cooperative launch: a
//    group's stream is cut into chunks of 512 choices (or a multiple,
//    where the card holds fewer blocks), a block a chunk, and the
//    block's 16 warps cut it into 16 segments. Pass 1: each warp walks
//    its segment 32 choices a step, in order (one step, but where the
//    card holds too few blocks); a lane's rank among the step's lanes
//    of its expert is __popc(peers & lanes below it),
//    the peers found by a ballot a bit of the expert (six at E = 32),
//    on top of the warp's running count of that expert in shared
//    memory, which the peers' first lane then raises. A scan over the 16
//    warps' counts of each expert (a thread an expert) gives each
//    segment's offset in the block and the block's count, which goes
//    to scratch; after one grid barrier each block sums the counts of
//    the blocks before it and of all (a thread a count, added into
//    shared memory). Pass 2: each
//    choice's slot is the sum of the three offsets and its rank; it
//    writes pos_c and keep and, when kept, its token into src; each
//    block then writes -1 to its share of the slots past each expert's
//    total; a group of one chunk (a decode step) takes a plain launch
//    and no grid barrier. Bound by the bytes (the experts read once,
//    pos_c, keep and src written once: 0.45 MB at the serve's prefill of
//    group 1, ~0.1 us at 3.35 TB/s), in practice by latency: one block a
//    group took 0.0315 ms there (10 us loading the experts, 10 us the
//    walk, 14 us the stores, 11 of them one SM's scattered src stores),
//    so the chunks spread all three (41 blocks there: ~0.005 ms; 512
//    threads a block measured best against 256 and 1,024).
//  * moe_dispatch_kernel: buf[s, :] = x[src[s], :] for each slot s =
//    (e, c), zeros where src[s] is -1. The reference adds each choice
//    onto zeros in f32 and rounds it to the buffer's type, so a -0.0 of
//    x is stored as +0.0 (+0.0 + -0.0 = +0.0); a dropped choice adds
//    zeros to its expert's slot 0, which changes nothing. Every kept
//    choice owns a slot of its own, so the adds are a gather: the
//    kernel copies, clearing the sign of zeros. A warp takes a slot's
//    row (a grid of a block for 8 slots); it issues up to kDispatchVecs
//    16-byte loads a lane before any store, and stores an empty slot's
//    zeros without a read, every store a streaming one (0.024 -> 0.020
//    ms at group 1 on an H100; the grid of a warp a slot measured faster
//    than one wave of co-resident blocks looping over the slots).
//    Bound by the bytes: x's kept rows read once (L2-resident) and the
//    buffer written once.
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
//    the f32 form agrees with the reference within an ulp. bf16 takes
//    the card's bf16 ops, a pair of elements an op (bf2_mul, bf2_add:
//    the same bits, see there). A persistent grid of warps: up to four
//    warps take a token, a lane a 16-byte column (d = 1,024 in bf16: one
//    each, 16 KB of a token's 8 rows in flight), and the groups of the
//    grid (as many as the card holds resident) stride over the tokens.
//    Lanes 0..k-1 load a token's keep, eidx, pos_c and gate together
//    (one round trip, where the first design's block staged them in
//    shared memory behind a barrier and took three before its rows),
//    the next token's while this one's rows are in flight, and pass the
//    slot rows and gates to the warp by shuffles; each lane issues the
//    k loads of its column before it adds. ptxas -v: 80 registers (bf16,
//    16-byte), 84 (f32), 72 / 76 (element path), no spill. On an H100
//    80GB HBM3 at 700 W (scripts/moe_combine_ab.py, seeded routing):
//    0.0147 ms at group 1's prefill (the first design 0.0252), 0.0028 a
//    decode step (0.0038), 0.0285 at a train step's layer 0 (0.0410);
//    streaming stores of y measured 5% faster at the prefill and 1%
//    slower in training (that script against this source with __stcs
//    stores), so the stores are plain.
//
//
// The backwards, as XLA's CPU program computes `jax.vjp` of the
// reference's loops (kernels/ref.py::moe_dispatch_bwd_ref,
// moe_combine_bwd_ref, moe_gates_bwd_ref, each equal to it bit for bit):
//
//  * moe_dispatch_bwd_kernel: dx[t, :] = the token's kept choices' rows
//    of the buffer's cotangent g. XLA adds the k gathered rows last
//    choice first (dx = t_{k-1}, then r(dx + t_j) for j = k-2..0, a
//    dropped choice's row +0.0), not in the combine's order, so it is
//    the combine's body (token_sums) without gates, lane j loading the
//    routing of choice k-1-j: the same persistent grid of warps, a
//    token's routing read in one round trip a token ahead, the k loads
//    of a column issued before the adds, bf16 on add.rn.bf16x2. ptxas
//    -v: 72 registers (16-byte, both dtypes), 57 / 62 (element path),
//    no spill. On an H100 80GB HBM3 at 700 W (scripts/moe_combine_ab.py,
//    seeded routing): 0.0287 ms at a train step's layer 0, where the
//    first design (a block a token, its routing staged in shared memory
//    behind a barrier, f32 adds each rounded to bf16) took 0.0401.
//  * moe_combine_bwd_kernel: d_ob[s, :] for slot s = (e, c) is token t =
//    src[s]'s cotangent dy[t, :] times the gate of t's choice holding s,
//    r(dy * r(g)) rounded once, -0.0 written as +0.0 (XLA scatter-adds
//    onto zeros); zeros in an empty slot. Each slot holds at most one
//    kept choice, so it is a gather by moe_slots' src, as the dispatch:
//    a warp a slot, the choice found by a ballot of the token's k
//    choices, every slot written once (no zero fill, no atomic).
//  * moe_gates_bwd_kernel: dg[t, j] = the row product of dy[t] and the
//    kept choice's row of ob, as XLA reduces it: products rounded to
//    the dtype, the row summed in windows of 32 in order (padded to a
//    multiple of 32, half the pad in front), then the windows in order,
//    every add rounded to the dtype; over d <= 32 one sum in order (f32:
//    fused multiply-adds, taken in f64 as the plain version takes
//    them). bf16 takes the card's bf16 ops (the same bits). A
//    persistent grid of warps, a warp a choice: the choice's routing
//    loaded the round before, every 16-byte load of its window of the
//    kept row and of dy's row issued before the first product, lane l
//    summing window l in registers (d = 1,024: one window a lane), the
//    32 window sums then gathered by shuffles and chained in order. dy's
//    row is read by the token's kept choices' warps, neighbours in a
//    block, from L1 or L2 after the first; no shared memory, so d is
//    not capped by it (kMaxGatesD keeps the indices in an int). ptxas
//    -v: 64 registers (bf16), 63 (f32), 127 (element path), no spill.
//    On an H100 80GB HBM3 at 700 W (scripts/moe_combine_ab.py): 0.0291
//    ms at a train step's layer 0, the first design (a block a token,
//    dy staged behind a barrier, window sums passed lane to lane and
//    chained by one lane from shared memory) 0.0569. A second kernel
//    rather than a role of the combine's: the two walk different layouts
//    (slots, tokens) with different blocks.
//
// At the training shape (T = 4,096, k = 8, E = 32, C = 1,284, d =
// 1,024, bf16) d_ob writes the 84.1 MB buffer and reads dy (8.4 MB):
// ~28 us at 3.35 TB/s; dx and dg read the kept rows (at most 67 MB) and
// dy or dx's 8.4 MB: at most ~23 us each.
//
// At the serve's prefill of group 1 (T = 2,564 tokens, k = 8, E = 32,
// C = 804 slots, d = 1,024, bf16) the dispatch writes the 52.7 MB
// buffer and need read x only once (5.3 MB): ~17 us at 3.35 TB/s; the
// combine reads the kept choices' rows (at most 42.0 MB) and writes 5.3
// MB: at most ~14 us. A decode step (T = 4, C = 4) is bound by the
// launch. Rows whose byte length is a multiple of 16 on 16-byte aligned
// storage move in 16-byte accesses (8 bf16, 4 f32); others element by
// element.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSlotsThreads = 512;         // a block a chunk of a group
constexpr int kSlotsWarps = kSlotsThreads / 32;   // the chunk's segments
constexpr int kSlotsChunk = kSlotsThreads;   // choices a block, at least
constexpr int kMaxDevices = 64;
constexpr int kSlotsMaxExperts = 256;      // per-warp counts in shared memory
constexpr int kExpertBits = 9;             // bits of expert + 1 (up to 256)
constexpr int kRankBits = kExpertBits;     // a packed step: rank << 9 | expert + 1
constexpr int kDispatchThreads = 256;
constexpr int kDispatchVecs = 4;           // 16-byte loads a lane before a store
constexpr int kWorkerWarps = 4;            // the token kernels' block: 4 warps
constexpr int kWorkerThreads = 32 * kWorkerWarps;
constexpr int kGatesWarps = 8;             // gates_bwd's block: a warp a choice
constexpr int kGatesThreads = 32 * kGatesWarps;
constexpr int kMaxGatesD = 1 << 20;        // gates_bwd's row (int indices)
constexpr int kMaxK = 32;                  // choices a token
constexpr int kUnroll = 8;                 // loads issued before the adds

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

// a choice's expert, or -1 past the stream's end or outside [0, E) (such
// a choice is dropped)
__device__ __forceinline__ int expert_at(const long long* eidx, int i, int n,
                                         int E) {
  if (i >= n) return -1;
  const long long e = __ldg(eidx + i);
  return (e >= 0 && e < E) ? static_cast<int>(e) : -1;
}

// The warp's lanes whose e equals this lane's: a ballot a bit of e + 1
// (nbits of them, enough for E), each lane keeping the lanes that agree
// with it on every bit. (__match_any_sync gives the same mask; the
// kernel took 10% longer with it on an H100.)
__device__ __forceinline__ unsigned peers_of(int e, int nbits) {
  const unsigned v = static_cast<unsigned>(e + 1);
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int b = 0; b < kExpertBits; ++b) {
    if (b >= nbits) break;
    const bool one = (v >> b) & 1u;
    const unsigned bal = __ballot_sync(0xffffffffu, one);
    peers &= one ? bal : ~bal;
  }
  return peers;
}

// One step of a warp's walk: the lane's rank among the choices of its
// expert e so far in the segment (the warp's running count `cnt` of e
// plus its rank among this step's peers), the count then raised by the
// peers' first lane. e < 0 takes no part and ranks 0.
__device__ __forceinline__ int rank_step(int* cnt, int e, int nbits,
                                         unsigned below) {
  const unsigned peers = peers_of(e, nbits);
  const int r = e >= 0 ? cnt[e] + __popc(peers & below) : 0;
  __syncwarp();
  if (e >= 0 && (peers & below) == 0) cnt[e] = r + __popc(peers);
  __syncwarp();
  return r;
}

// choice i (token i / k) of expert e at slot p: pos_c, keep, src
__device__ __forceinline__ void place(int i, int e, int p, int k, int C,
                                      long long* pos_c, bool* keep,
                                      int* src) {
  const bool kept = e >= 0 && p < C;
  pos_c[i] = kept ? p : 0;
  keep[i] = kept;
  if (kept) src[e * C + p] = i / k;
}

// Grid (blocks a group, G), a cooperative launch where a group has more
// than one block. Block b of group g takes the `chunk` choices from b *
// chunk of the group's stream; part [G, blocks, E] receives each
// block's count of each expert.
__global__ void __launch_bounds__(kSlotsThreads)
moe_slots_kernel(const long long* __restrict__ eidx,
                 long long* __restrict__ pos_c, bool* __restrict__ keep,
                 int* __restrict__ src, int* __restrict__ part, int n,
                 int chunk, int k, int E, int C) {
  __shared__ int cnt[kSlotsWarps][kSlotsMaxExperts];
  __shared__ int before[kSlotsMaxExperts];   // the earlier blocks' counts
  __shared__ int total[kSlotsMaxExperts];    // the group's counts
  const int b = blockIdx.x, nb = gridDim.x;
  const long long g = blockIdx.y;
  eidx += g * n;
  pos_c += g * n;
  keep += g * n;
  src += g * E * C;
  part += g * nb * E;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int* mine = cnt[warp];
  for (int e = lane; e < E; e += 32) mine[e] = 0;
  if (tid < E) before[tid] = total[tid] = 0;
  // a warp's segment of the block's chunk: a multiple of 32 choices
  const int seg = chunk / kSlotsWarps;
  const int lo = b * chunk + warp * seg, nit = seg / 32;
  const unsigned below = (1u << lane) - 1u;
  const int nbits = 32 - __clz(E);           // bits of expert + 1
  // pass 1: the segment's first step in registers; the ranks of later
  // steps (more than 32 choices a warp) parked in pos_c until pass 2
  const int e0 = expert_at(eidx, lo + lane, n, E);
  __syncwarp();
  const int r0 = rank_step(mine, e0, nbits, below);
  for (int it = 1; it < nit; ++it) {
    const int i = lo + it * 32 + lane;
    const int r = rank_step(mine, expert_at(eidx, i, n, E), nbits, below);
    if (i < n) pos_c[i] = r;
  }
  __syncthreads();
  // the scan: each expert's count before each segment, and the block's
  if (tid < E) {
    int run = 0;
#pragma unroll
    for (int w0 = 0; w0 < kSlotsWarps; w0 += 8) {
      int c[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) c[u] = cnt[w0 + u][tid];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        cnt[w0 + u][tid] = run;
        run += c[u];
      }
    }
    if (nb == 1)
      total[tid] = run;
    else
      part[b * E + tid] = run;
  }
  if (nb > 1) {
    // each expert's count before this block and in the whole group
    cg::this_grid().sync();
    for (int t = tid; t < nb * E; t += kSlotsThreads) {
      const int c = __ldcg(part + t), b2 = t / E, j = t - b2 * E;
      if (b2 < b) atomicAdd(before + j, c);
      atomicAdd(total + j, c);
    }
  }
  __syncthreads();
  // pass 2: each choice's slot, then -1 in the block's share of the
  // slots no choice holds
  if (lo + lane < n)
    place(lo + lane, e0, e0 >= 0 ? before[e0] + mine[e0] + r0 : 0, k, C,
          pos_c, keep, src);
  for (int it = 1; it < nit; ++it) {
    const int i = lo + it * 32 + lane;
    if (i >= n) continue;
    const int e = expert_at(eidx, i, n, E);
    place(i, e,
          e >= 0 ? before[e] + mine[e] + static_cast<int>(pos_c[i]) : 0, k,
          C, pos_c, keep, src);
  }
  const int slots = E * C, share = (slots + nb - 1) / nb;
  const int s_end = min(slots, (b + 1) * share);
  for (int s = b * share + tid; s < s_end; s += kSlotsThreads) {
    const int e = s / C;
    if (s - e * C >= min(total[e], C)) src[s] = -1;
  }
}

// *p = v; a 16-byte pack with a streaming store (st.global.cs: the
// buffer is written once and read by the next op, and the hint keeps it
// from crowding x's rows out of L2)
template <typename P>
__device__ __forceinline__ void put_streaming(P* p, const P& v) {
  if constexpr (sizeof(P) == 16)
    __stcs(reinterpret_cast<int4*>(p), *reinterpret_cast<const int4*>(&v));
  else
    *p = v;
}

template <typename T, int W>
__global__ void __launch_bounds__(kDispatchThreads)
moe_dispatch_kernel(const T* __restrict__ x, const int* __restrict__ src,
                    T* __restrict__ buf, long long n_slots, long long T_,
                    long long d) {
  using P = Pack<T, W>;
  const long long s =
      static_cast<long long>(blockIdx.x) * (kDispatchThreads / 32) +
      (threadIdx.x >> 5);
  if (s >= n_slots) return;
  const long long nvec = d / W;
  const int lane = threadIdx.x & 31;
  const long long t = __ldg(src + s);
  P* out = reinterpret_cast<P*>(buf + s * d);
  if (t < 0 || t >= T_) {
    P z;
#pragma unroll
    for (int w = 0; w < W; ++w) z.v[w] = from_f<T>(0.0f);
    for (long long c = lane; c < nvec; c += 32) put_streaming(out + c, z);
    return;
  }
  const P* in = reinterpret_cast<const P*>(x + t * d);
  for (long long c0 = lane; c0 < nvec; c0 += 32 * kDispatchVecs) {
    P v[kDispatchVecs];
#pragma unroll
    for (int u = 0; u < kDispatchVecs; ++u)
      if (c0 + 32 * u < nvec) v[u] = in[c0 + 32 * u];
#pragma unroll
    for (int u = 0; u < kDispatchVecs; ++u) {
      if (c0 + 32 * u >= nvec) break;
#pragma unroll
      for (int w = 0; w < W; ++w) v[u].v[w] = plus_zero(v[u].v[w]);
      put_streaming(out + c0 + 32 * u, v[u]);
    }
  }
}

// bf16 ops on the card's bf16 units (sm_90), one rounding to bf16 each.
// On operands that are bf16 values they give the bits of the f32 op
// rounded to bf16, which is what the reference's bf16 arithmetic is: a
// product of two 8-bit significands is exact in f32, and a sum rounded
// to f32 (24 bits, at least 2 * 8 + 2) and then to bf16 rounds as the
// exact sum rounded once; zeros keep the same signs. Done in f32, each op
// costs a conversion to bf16 (F2F, 16 a clock an SM): at group 1's
// prefill the combine's 42 million take ~11 us of an H100's 132 SMs,
// against a byte bound of ~9-13 us.
__device__ __forceinline__ unsigned bf2_mul(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned bf2_add(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned short bf_mul(unsigned short a,
                                                 unsigned short b) {
  unsigned short d;
  asm("mul.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}
__device__ __forceinline__ unsigned short bf_add(unsigned short a,
                                                 unsigned short b) {
  unsigned short d;
  asm("add.rn.bf16 %0, %1, %2;" : "=h"(d) : "h"(a), "h"(b));
  return d;
}

// One element of T as the sums carry it, and its rounded ops: f32 as is
// (the intrinsics round each op: no contraction into an FMA); bf16 as its
// bits, through the bf16 ops above.
template <typename T>
struct Num;
template <>
struct Num<float> {
  using S = float;
  static __device__ __forceinline__ S of(float v) { return v; }
  static __device__ __forceinline__ S mul(S a, S b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ S add(S a, S b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ float f(S a) { return a; }
  static __device__ __forceinline__ float to(S a) { return a; }
  // a gate as a word (gates.astype(x.dtype)): its f32 bits; and back
  static __device__ __forceinline__ unsigned word(float g) {
    return __float_as_uint(g);
  }
  static __device__ __forceinline__ S gate(unsigned w) {
    return __uint_as_float(w);
  }
};
template <>
struct Num<__nv_bfloat16> {
  using S = unsigned short;
  static __device__ __forceinline__ S of(__nv_bfloat16 v) {
    return __bfloat16_as_ushort(v);
  }
  static __device__ __forceinline__ S mul(S a, S b) { return bf_mul(a, b); }
  static __device__ __forceinline__ S add(S a, S b) { return bf_add(a, b); }
  static __device__ __forceinline__ float f(S a) {
    return __bfloat162float(__ushort_as_bfloat16(a));
  }
  static __device__ __forceinline__ __nv_bfloat16 to(S a) {
    return __ushort_as_bfloat16(a);
  }
  // a gate as a word (gates.astype(x.dtype)): its bf16 in both halves;
  // and back
  static __device__ __forceinline__ unsigned word(float g) {
    const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(g));
    return h | h << 16;
  }
  static __device__ __forceinline__ S gate(unsigned w) {
    return static_cast<S>(w & 0xffffu);
  }
};

// lane q's s (a 16-bit value carried in a 32-bit shuffle)
template <typename S>
__device__ __forceinline__ S shfl(S s, int q) {
  if constexpr (sizeof(S) == 2)
    return static_cast<S>(__shfl_sync(
        0xffffffffu, static_cast<unsigned>(s), q));
  else
    return __shfl_sync(0xffffffffu, s, q);
}

// two bf16 as the word of a bf16x2 (lo the first)
__device__ __forceinline__ unsigned pair_of(__nv_bfloat16 lo,
                                            __nv_bfloat16 hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo)) |
         static_cast<unsigned>(__bfloat16_as_ushort(hi)) << 16;
}

// acc = t (first) or acc + t, element by element, where t is v * g
// (kGated: g is the gate's word, Num<T>::word) or v itself; each op
// rounded to T. bf16 packs go a pair of elements an op.
template <typename T, int W, bool kGated>
__device__ __forceinline__ void term_step(Pack<T, W>& acc,
                                          const Pack<T, W>& v, unsigned g,
                                          bool first) {
  if constexpr (sizeof(T) == 2 && W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const unsigned x = pair_of(v.v[i], v.v[i + 1]);
      const unsigned t = kGated ? bf2_mul(x, g) : x;
      const unsigned a =
          first ? t : bf2_add(pair_of(acc.v[i], acc.v[i + 1]), t);
      acc.v[i] = __ushort_as_bfloat16(static_cast<unsigned short>(a));
      acc.v[i + 1] = __ushort_as_bfloat16(static_cast<unsigned short>(a >> 16));
    }
  } else {
    using N = Num<T>;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const typename N::S t =
          kGated ? N::mul(N::of(v.v[w]), N::gate(g)) : N::of(v.v[w]);
      acc.v[w] = N::to(first ? t : N::add(N::of(acc.v[w]), t));
    }
  }
}

// Lane j < k of a warp: the loads of token t's choice j, keep, eidx,
// pos_c and the gate (kGated: the combine's order), or of its choice
// k-1-j, keep, eidx and pos_c (the dispatch's backward: last choice
// first), issued together, none waiting on another, and nothing here
// waiting on them (a dropped choice's eidx and pos_c are read and not
// used); lanes from k on, and every lane past the last token, read
// nothing and hold a dropped choice.
struct Route {
  unsigned char kp;
  long long e, p;
  float g;
};

template <bool kGated>
__device__ __forceinline__ Route load_route(
    const long long* __restrict__ eidx, const long long* __restrict__ pos,
    const bool* __restrict__ keep, const float* __restrict__ gates,
    long long t, long long T_, int k, int lane) {
  Route r = {0, 0, 0, 0.0f};
  if (t < T_ && lane < k) {
    const long long i = t * k + (kGated ? lane : k - 1 - lane);
    r.kp = __ldg(reinterpret_cast<const unsigned char*>(keep) + i);
    r.e = __ldg(eidx + i);
    r.p = __ldg(pos + i);
    if constexpr (kGated) r.g = __ldg(gates + i);
  }
  return r;
}

// out[t, :] = token t's sum of its k rows of `rows`: the combine's (kGated:
// each row times its choice's gate, choice 0 first) or the dispatch's
// backward's (ungated, last choice first; see the head comment). A
// persistent grid of warps: `wpt` warps (1, 2 or 4) take a token, warp
// `part` of them the W-wide columns part * 32 + lane + m * wpt * 32; the
// grid's gridDim.x * kWorkerWarps / wpt such groups stride over the
// tokens. The routing of a group's next token is loaded while the
// current token's rows are in flight, and passed from lane j to the warp
// by shuffles (lane j holds the j-th term of the sum's order): no shared
// memory, no block barrier. Each kernel is its own __global__ (so a
// profile tells them apart by name) with a minimum of one block an SM:
// without it ptxas held some instances to 40-72 registers and spilled
// the next token's routing across the column loop.
template <typename T, int W, bool kGated>
__device__ __forceinline__ void token_sums(
    const T* __restrict__ rows, const long long* __restrict__ eidx,
    const long long* __restrict__ pos, const bool* __restrict__ keep,
    const float* __restrict__ gates, T* __restrict__ y, long long T_, int k,
    long long C, long long d, int wpt) {
  using P = Pack<T, W>;
  const int lane = threadIdx.x & 31;
  // token and column indices fit an int (T below 2^30 and d below 2^31,
  // checked at launch)
  const int gw = blockIdx.x * kWorkerWarps + (threadIdx.x >> 5);
  const int part = gw % wpt, stride = gridDim.x * kWorkerWarps / wpt;
  const int nvec = static_cast<int>(d / W), ntok = static_cast<int>(T_);
  int t = gw / wpt;
  Route next = load_route<kGated>(eidx, pos, keep, gates, t, T_, k, lane);
  for (; t < ntok; t += stride) {
    // this token's routing (lane j: its choice's slot row, or -1 where
    // dropped, and its gate's word), then the next token's loads
    const long long row_cur = next.kp ? next.e * C + next.p : -1;
    const unsigned gate_cur = kGated ? Num<T>::word(next.g) : 0u;
    next = load_route<kGated>(eidx, pos, keep, gates, t + stride, T_, k,
                               lane);
    P* out = reinterpret_cast<P*>(y + t * d);
    // every lane runs every column step (the shuffles want the whole
    // warp); a lane past the row's end loads and stores nothing
    for (int c0 = part * 32; c0 < nvec; c0 += wpt * 32) {
      const int c = c0 + lane;
      const bool mine = c < nvec;
      P acc = {};
      for (int j0 = 0; j0 < k; j0 += kUnroll) {
        P v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long row = __shfl_sync(0xffffffffu, row_cur,
                                            (j0 + u) & 31);
          if (j0 + u < k && row >= 0 && mine) {
            v[u] = reinterpret_cast<const P*>(rows + row * d)[c];
          } else {
#pragma unroll
            for (int w = 0; w < W; ++w) v[u].v[w] = from_f<T>(0.0f);
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const unsigned g =
              kGated ? __shfl_sync(0xffffffffu, gate_cur, (j0 + u) & 31)
                     : 0u;
          if (j0 + u < k)
            term_step<T, W, kGated>(acc, v[u], g, j0 + u == 0);
        }
      }
      if (mine) out[c] = acc;
    }
  }
}

// y[t, :] = token t's gated sum of its k rows of ob, choice 0 first
template <typename T, int W>
__global__ void __launch_bounds__(kWorkerThreads, 1)
moe_combine_kernel(const T* __restrict__ ob,
                   const long long* __restrict__ eidx,
                   const long long* __restrict__ pos,
                   const bool* __restrict__ keep,
                   const float* __restrict__ gates, T* __restrict__ y,
                   long long T_, int k, long long C, long long d, int wpt) {
  token_sums<T, W, true>(ob, eidx, pos, keep, gates, y, T_, k, C, d, wpt);
}

// dx[t, :] = the sum of token t's kept choices' rows of g, ungated, last
// choice first, as XLA sums the reference's transposed scatter-adds; a
// dropped choice's row reads +0.0
template <typename T, int W>
__global__ void __launch_bounds__(kWorkerThreads, 1)
moe_dispatch_bwd_kernel(const T* __restrict__ g,
                        const long long* __restrict__ eidx,
                        const long long* __restrict__ pos,
                        const bool* __restrict__ keep, T* __restrict__ dx,
                        long long T_, int k, long long C, long long d,
                        int wpt) {
  token_sums<T, W, false>(g, eidx, pos, keep, nullptr, dx, T_, k, C, d, wpt);
}

// d_ob[s, :] for slot s = (e, c) of token t = src[s]: dy[t, :] times the
// gate of t's choice that holds s (found by a ballot of the token's k
// choices, a lane each), rounded to T, -0.0 written as +0.0; zeros where
// the slot is empty. A warp a slot, as the dispatch.
template <typename T, int W>
__global__ void __launch_bounds__(kDispatchThreads)
moe_combine_bwd_kernel(const T* __restrict__ dy,
                       const float* __restrict__ gates,
                       const long long* __restrict__ eidx,
                       const long long* __restrict__ pos,
                       const bool* __restrict__ keep,
                       const int* __restrict__ src, T* __restrict__ d_ob,
                       long long n_slots, long long T_, int k, long long C,
                       long long d) {
  using P = Pack<T, W>;
  const long long s =
      static_cast<long long>(blockIdx.x) * (kDispatchThreads / 32) +
      (threadIdx.x >> 5);
  if (s >= n_slots) return;
  const long long nvec = d / W;
  const int lane = threadIdx.x & 31;
  const long long t = __ldg(src + s);
  P* out = reinterpret_cast<P*>(d_ob + s * d);
  unsigned hit = 0;
  float g = 0.0f;
  if (t >= 0 && t < T_) {
    const long long e = s / C, c = s - e * C, i = t * k + lane;
    const bool mine = lane < k && keep[i] && __ldg(eidx + i) == e &&
                      __ldg(pos + i) == c;
    hit = __ballot_sync(0xffffffffu, mine);
    if (hit) g = to_f(from_f<T>(__ldg(gates + t * k + __ffs(hit) - 1)));
  }
  if (!hit) {
    P z;
#pragma unroll
    for (int w = 0; w < W; ++w) z.v[w] = from_f<T>(0.0f);
    for (long long c = lane; c < nvec; c += 32) put_streaming(out + c, z);
    return;
  }
  const P* in = reinterpret_cast<const P*>(dy + t * d);
  for (long long c0 = lane; c0 < nvec; c0 += 32 * kDispatchVecs) {
    P v[kDispatchVecs];
#pragma unroll
    for (int u = 0; u < kDispatchVecs; ++u)
      if (c0 + 32 * u < nvec) v[u] = in[c0 + 32 * u];
#pragma unroll
    for (int u = 0; u < kDispatchVecs; ++u) {
      if (c0 + 32 * u >= nvec) break;
#pragma unroll
      for (int w = 0; w < W; ++w)
        v[u].v[w] = plus_zero(from_f<T>(__fmul_rn(to_f(v[u].v[w]), g)));
      put_streaming(out + c0 + 32 * u, v[u]);
    }
  }
}

// Window m of the row product of a (dy's row) and b (the kept row of
// ob): the products rounded to T, summed in order from the window's
// first element, every add rounded to T (Num<T>). W > 1: d a multiple of
// 32 on 16-byte storage (no pad), the window's 32 / W loads of each row
// issued before the first product; W = 1: element by element, the pad's
// elements (left of the row and past its end) left out, which changes
// no bit of the result but a zero's sign, which plus_zero clears.
template <typename T, int W>
__device__ __forceinline__ typename Num<T>::S window_sum(
    const T* __restrict__ a, const T* __restrict__ b, int m, int d,
    int left) {
  using N = Num<T>;
  typename N::S s{};
  if constexpr (W > 1) {
    using P = Pack<T, W>;
    constexpr int V = 32 / W;                   // loads a window a row
    const P* av = reinterpret_cast<const P*>(a) + m * V;
    const P* bv = reinterpret_cast<const P*>(b) + m * V;
    P x[V], z[V];
#pragma unroll
    for (int u = 0; u < V; ++u) x[u] = av[u];
#pragma unroll
    for (int u = 0; u < V; ++u) z[u] = bv[u];
#pragma unroll
    for (int u = 0; u < V; ++u)
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const typename N::S pr = N::mul(N::of(x[u].v[w]), N::of(z[u].v[w]));
        s = u == 0 && w == 0 ? pr : N::add(s, pr);
      }
  } else {
    const int e0 = m * 32 - left;
    T x[32], z[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      const bool in = e0 + u >= 0 && e0 + u < d;
      x[u] = in ? a[e0 + u] : from_f<T>(0.0f);
      z[u] = in ? b[e0 + u] : from_f<T>(0.0f);
    }
    bool first = true;
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      if (e0 + u < 0 || e0 + u >= d) continue;
      const typename N::S pr = N::mul(N::of(x[u]), N::of(z[u]));
      s = first ? pr : N::add(s, pr);
      first = false;
    }
  }
  return s;
}

// dg[i] for choice i = t * k + j, as XLA's CPU program reduces the row
// product of dy[t] and the kept choice's row of ob: over d > 32 in
// windows of 32 (the row padded by `left` zeros in front to nwin
// windows), lane l summing window m0 + l of each step of 32 windows in
// registers; the step's window sums then gathered by 32 shuffles and
// chained in order onto the sum of the windows before, every add rounded
// to T. Over d <= 32 (nwin 0) lane 0 sums in order, in f32 as fused
// multiply-adds (taken in f64, as the plain version takes them). A
// persistent grid of warps, a warp a choice, striding over the T * k
// choices; the next choice's keep, eidx and pos_c loaded (every lane the
// same three words) while this one's rows are in flight. dy's row is
// read by each of its kept choices' warps beside the kept row: the
// token's choices are neighbouring warps of a block, so it is read from
// L1 or L2 after the first.
template <typename T, int W>
__global__ void __launch_bounds__(kGatesThreads)
moe_gates_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ ob,
                     const long long* __restrict__ eidx,
                     const long long* __restrict__ pos,
                     const bool* __restrict__ keep, float* __restrict__ dg,
                     long long n, int k, long long C, int d, int nwin,
                     int left) {
  using N = Num<T>;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(gridDim.x) * kGatesWarps;
  long long i = static_cast<long long>(blockIdx.x) * kGatesWarps +
                (threadIdx.x >> 5);
  const unsigned char* kp = reinterpret_cast<const unsigned char*>(keep);
  bool kept_next = false;
  long long e_next = 0, p_next = 0;
  if (i < n) {
    kept_next = __ldg(kp + i);
    e_next = __ldg(eidx + i);
    p_next = __ldg(pos + i);
  }
  for (; i < n; i += stride) {
    const bool kept = kept_next;
    const long long row = e_next * C + p_next;
    if (i + stride < n) {
      kept_next = __ldg(kp + i + stride);
      e_next = __ldg(eidx + i + stride);
      p_next = __ldg(pos + i + stride);
    }
    if (!kept) {                                // the warp alike
      if (lane == 0) dg[i] = 0.0f;
      continue;
    }
    const T* a = dy + (i / k) * d;
    const T* b = ob + row * d;
    typename N::S acc{};
    if (nwin == 0) {
      if (lane == 0) {
        for (int u = 0; u < d; ++u) {
          if constexpr (sizeof(T) == 4) {
            acc = __double2float_rn(__dadd_rn(
                static_cast<double>(acc),
                __dmul_rn(static_cast<double>(a[u]),
                          static_cast<double>(b[u]))));
          } else {
            const typename N::S pr = N::mul(N::of(a[u]), N::of(b[u]));
            acc = u == 0 ? pr : N::add(acc, pr);
          }
        }
      }
    } else {
      for (int m0 = 0; m0 < nwin; m0 += 32) {   // the warp alike
        const typename N::S s =
            m0 + lane < nwin ? window_sum<T, W>(a, b, m0 + lane, d, left)
                             : typename N::S{};
        typename N::S ws[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) ws[q] = shfl(s, q);
#pragma unroll
        for (int q = 0; q < 32; ++q)
          if (m0 + q < nwin) acc = m0 + q == 0 ? ws[q] : N::add(acc, ws[q]);
      }
    }
    if (lane == 0) dg[i] = plus_zero(N::f(acc));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
void dispatch(const void* x, const int* src, void* buf, long long T_,
              long long d, long long n_slots, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  constexpr int rows = kDispatchThreads / 32;   // a warp a slot
  const unsigned grid = static_cast<unsigned>((n_slots + rows - 1) / rows);
  if (d % W == 0 && aligned16(x) && aligned16(buf))
    moe_dispatch_kernel<T, W><<<grid, kDispatchThreads, 0, st>>>(
        static_cast<const T*>(x), src, static_cast<T*>(buf), n_slots, T_, d);
  else
    moe_dispatch_kernel<T, 1><<<grid, kDispatchThreads, 0, st>>>(
        static_cast<const T*>(x), src, static_cast<T*>(buf), n_slots, T_, d);
}

// The co-resident blocks of `kernel` (`threads` a block, no dynamic
// shared memory) on the current device, found once a device (`cache`, a
// slot each); negative: minus a CUDA error code.
template <typename K>
int resident_blocks(K kernel, int threads, int* cache) {
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    0);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (per_sm * sms <= 0)
    return -static_cast<int>(cudaErrorInvalidConfiguration);
  if (dev < kMaxDevices) cache[dev] = per_sm * sms;
  return per_sm * sms;
}

// warps a token of the combine and of the dispatch's backward: a lane a
// W-wide column where the row has up to 128 of them, four warps striding
// over longer rows
int token_wpt(long long nvec) { return nvec > 64 ? 4 : nvec > 32 ? 2 : 1; }

// a token-walking kernel's groups (wpt warps each) on the current
// device: its co-resident warps over wpt (`cache`: a slot a device)
template <typename K>
long long token_groups(K kernel, int* cache, long long nvec) {
  const int blocks = resident_blocks(kernel, kWorkerThreads, cache);
  if (blocks < 0) return blocks;
  return static_cast<long long>(blocks) * kWorkerWarps / token_wpt(nvec);
}

template <typename T, int W>
long long combine_workers(long long d) {
  static int cache[kMaxDevices] = {};
  return token_groups(moe_combine_kernel<T, W>, cache, d / W);
}

template <typename T, int W>
long long dispatch_bwd_workers(long long d) {
  static int cache[kMaxDevices] = {};
  return token_groups(moe_dispatch_bwd_kernel<T, W>, cache, d / W);
}

// the blocks of a grid of `groups` token groups of wpt warps, cut to the
// T tokens where they are fewer
unsigned token_grid(long long groups, long long T_, int wpt) {
  const long long used = T_ < groups ? T_ : groups;
  return static_cast<unsigned>((used * wpt + kWorkerWarps - 1) /
                               kWorkerWarps);
}

template <typename T, int W>
int combine_as(const void* ob, const long long* eidx, const long long* pos,
               const bool* keep, const float* gates, void* y, long long T_,
               int k, long long d, long long C, cudaStream_t st) {
  const int wpt = token_wpt(d / W);
  const long long groups = combine_workers<T, W>(d);
  if (groups < 0) return static_cast<int>(-groups);
  moe_combine_kernel<T, W><<<token_grid(groups, T_, wpt), kWorkerThreads, 0,
                             st>>>(
      static_cast<const T*>(ob), eidx, pos, keep, gates, static_cast<T*>(y),
      T_, k, C, d, wpt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine(const void* ob, const long long* eidx, const long long* pos,
            const bool* keep, const float* gates, void* y, long long T_,
            int k, long long d, long long C, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  if (d % W == 0 && aligned16(ob) && aligned16(y))
    return combine_as<T, W>(ob, eidx, pos, keep, gates, y, T_, k, d, C, st);
  return combine_as<T, 1>(ob, eidx, pos, keep, gates, y, T_, k, d, C, st);
}

template <typename T, int W>
int dispatch_bwd_as(const void* g, const long long* eidx,
                    const long long* pos, const bool* keep, void* dx,
                    long long T_, int k, long long d, long long C,
                    cudaStream_t st) {
  const int wpt = token_wpt(d / W);
  const long long groups = dispatch_bwd_workers<T, W>(d);
  if (groups < 0) return static_cast<int>(-groups);
  moe_dispatch_bwd_kernel<T, W><<<token_grid(groups, T_, wpt),
                                  kWorkerThreads, 0, st>>>(
      static_cast<const T*>(g), eidx, pos, keep, static_cast<T*>(dx), T_, k,
      C, d, wpt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_bwd(const void* g, const long long* eidx, const long long* pos,
                 const bool* keep, void* dx, long long T_, int k, long long d,
                 long long C, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  if (d % W == 0 && aligned16(g) && aligned16(dx))
    return dispatch_bwd_as<T, W>(g, eidx, pos, keep, dx, T_, k, d, C, st);
  return dispatch_bwd_as<T, 1>(g, eidx, pos, keep, dx, T_, k, d, C, st);
}

template <typename T>
void combine_bwd(const void* dy, const float* gates, const long long* eidx,
                 const long long* pos, const bool* keep, const int* src,
                 void* d_ob, long long T_, int k, long long d,
                 long long n_slots, long long C, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  constexpr int rows = kDispatchThreads / 32;   // a warp a slot
  const unsigned grid = static_cast<unsigned>((n_slots + rows - 1) / rows);
  if (d % W == 0 && aligned16(dy) && aligned16(d_ob))
    moe_combine_bwd_kernel<T, W><<<grid, kDispatchThreads, 0, st>>>(
        static_cast<const T*>(dy), gates, eidx, pos, keep, src,
        static_cast<T*>(d_ob), n_slots, T_, k, C, d);
  else
    moe_combine_bwd_kernel<T, 1><<<grid, kDispatchThreads, 0, st>>>(
        static_cast<const T*>(dy), gates, eidx, pos, keep, src,
        static_cast<T*>(d_ob), n_slots, T_, k, C, d);
}

// gates_bwd's warps (a choice each) on the current device
template <typename T, int W>
long long gates_workers() {
  static int cache[kMaxDevices] = {};
  const int blocks =
      resident_blocks(moe_gates_bwd_kernel<T, W>, kGatesThreads, cache);
  if (blocks < 0) return blocks;
  return static_cast<long long>(blocks) * kGatesWarps;
}

template <typename T, int W>
int gates_as(const void* dy, const void* ob, const long long* eidx,
             const long long* pos, const bool* keep, float* dg, long long T_,
             int k, int d, long long C, cudaStream_t st) {
  const int nwin = d <= 32 ? 0 : (d + 31) / 32;
  const int left = nwin > 0 ? (nwin * 32 - d) / 2 : 0;
  const long long warps = gates_workers<T, W>();
  if (warps < 0) return static_cast<int>(-warps);
  const long long n = T_ * k, used = n < warps ? n : warps;
  const unsigned grid =
      static_cast<unsigned>((used + kGatesWarps - 1) / kGatesWarps);
  moe_gates_bwd_kernel<T, W><<<grid, kGatesThreads, 0, st>>>(
      static_cast<const T*>(dy), static_cast<const T*>(ob), eidx, pos, keep,
      dg, n, k, C, d, nwin, left);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int gates_bwd(const void* dy, const void* ob, const long long* eidx,
              const long long* pos, const bool* keep, float* dg, long long T_,
              int k, int d, long long C, cudaStream_t st) {
  constexpr int W = 16 / sizeof(T);
  // the 16-byte form takes whole windows on 16-byte storage
  if (d % 32 == 0 && aligned16(dy) && aligned16(ob))
    return gates_as<T, W>(dy, ob, eidx, pos, keep, dg, T_, k, d, C, st);
  return gates_as<T, 1>(dy, ob, eidx, pos, keep, dg, T_, k, d, C, st);
}

}  // namespace

// Plain C interface (ctypes). Dense row-major tensors: eidx, pos_c [G,Tg,k]
// (or [T,k]) int64; keep [G,Tg,k] bool; src [G,E,C] (or [E,C]) int32; x
// [T,d], buf [E,C,d], ob [E,C,d], y [T,d]; gates [T,k] f32. dtype: 0 =
// f32, 1 = bf16. Each returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for arguments the kernels do not take.
// The slots kernel's grid on the current device at most (its co-resident
// blocks), found once per device; negative: minus a CUDA error code.
static int moe_slots_blocks() {
  static int cache[kMaxDevices] = {};
  return resident_blocks(moe_slots_kernel, kSlotsThreads, cache);
}

// part: scratch of part_words ints (G * ceil(Tg * k / kSlotsChunk) * E
// suffice; no zeroing). Each group's stream goes to as many blocks of
// kSlotsChunk choices (or a multiple) as the co-resident blocks share out.
extern "C" int moe_slots_launch(const void* eidx, void* pos_c, void* keep,
                                void* src, void* part, long long part_words,
                                long long G, long long Tg, long long k,
                                long long E, long long C, void* stream) {
  const long long n = Tg * k;
  if (G < 1 || Tg < 1 || k < 1 || k > kMaxK || E < 1 ||
      E > kSlotsMaxExperts || C < 1 || n > 0x7fffffffLL ||
      E * C > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cores = moe_slots_blocks();
  if (cores < 0) return -cores;
  if (G > cores) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_group = cores / G;
  long long nb = (n + kSlotsChunk - 1) / kSlotsChunk;
  nb = nb < per_group ? nb : per_group;
  long long chunk = (n + nb - 1) / nb;
  chunk = (chunk + kSlotsChunk - 1) / kSlotsChunk * kSlotsChunk;
  nb = (n + chunk - 1) / chunk;
  if (G * nb * E > part_words) return static_cast<int>(cudaErrorInvalidValue);
  const long long* ei = static_cast<const long long*>(eidx);
  long long* pc = static_cast<long long*>(pos_c);
  bool* kp = static_cast<bool*>(keep);
  int* sp = static_cast<int*>(src);
  int* pp = static_cast<int*>(part);
  int n_ = static_cast<int>(n), chunk_ = static_cast<int>(chunk);
  int k_ = static_cast<int>(k), E_ = static_cast<int>(E);
  int C_ = static_cast<int>(C);
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(G));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nb == 1) {  // no grid barrier: a plain launch
    moe_slots_kernel<<<grid, kSlotsThreads, 0, st>>>(ei, pc, kp, sp, pp, n_,
                                                     chunk_, k_, E_, C_);
    return static_cast<int>(cudaGetLastError());
  }
  void* args[] = {&ei, &pc, &kp, &sp, &pp, &n_, &chunk_, &k_, &E_, &C_};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(moe_slots_kernel), grid,
      dim3(kSlotsThreads), args, 0, st));
}

extern "C" int moe_dispatch_launch(const void* x, const void* src, void* buf,
                                   long long T, long long d,
                                   long long n_slots, int dtype,
                                   void* stream) {
  if (T < 1 || d < 1 || n_slots < 1 || n_slots > 0x7fffffffLL * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp = static_cast<const int*>(src);
  if (dtype == 0)
    dispatch<float>(x, sp, buf, T, d, n_slots, st);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(x, sp, buf, T, d, n_slots, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int moe_combine_launch(const void* ob, const void* eidx,
                                  const void* pos, const void* keep,
                                  const void* gates, void* y, long long T,
                                  long long k, long long d, long long C,
                                  int dtype, void* stream) {
  if (T < 1 || T >= (1LL << 30) || k < 1 || k > kMaxK || d < 1 ||
      d > 0x7fffffffLL || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* ei = static_cast<const long long*>(eidx);
  const long long* ps = static_cast<const long long*>(pos);
  const bool* kp = static_cast<const bool*>(keep);
  const float* g = static_cast<const float*>(gates);
  if (dtype == 0)
    return combine<float>(ob, ei, ps, kp, g, y, T, static_cast<int>(k), d, C,
                          st);
  if (dtype == 1)
    return combine<__nv_bfloat16>(ob, ei, ps, kp, g, y, T,
                                  static_cast<int>(k), d, C, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int moe_dispatch_bwd_launch(const void* g, const void* eidx,
                                       const void* pos, const void* keep,
                                       void* dx, long long T, long long k,
                                       long long d, long long C, int dtype,
                                       void* stream) {
  if (T < 1 || T >= (1LL << 30) || k < 1 || k > kMaxK || d < 1 ||
      d > 0x7fffffffLL || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* ei = static_cast<const long long*>(eidx);
  const long long* ps = static_cast<const long long*>(pos);
  const bool* kp = static_cast<const bool*>(keep);
  if (dtype == 0)
    return dispatch_bwd<float>(g, ei, ps, kp, dx, T, static_cast<int>(k), d,
                               C, st);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(g, ei, ps, kp, dx, T,
                                       static_cast<int>(k), d, C, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int moe_combine_bwd_launch(const void* dy, const void* gates,
                                      const void* eidx, const void* pos,
                                      const void* keep, const void* src,
                                      void* d_ob, long long T, long long k,
                                      long long d, long long n_slots,
                                      long long C, int dtype, void* stream) {
  if (T < 1 || k < 1 || k > kMaxK || d < 1 || C < 1 || n_slots < 1 ||
      n_slots > 0x7fffffffLL * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gates);
  const long long* ei = static_cast<const long long*>(eidx);
  const long long* ps = static_cast<const long long*>(pos);
  const bool* kp = static_cast<const bool*>(keep);
  const int* sp = static_cast<const int*>(src);
  if (dtype == 0)
    combine_bwd<float>(dy, g, ei, ps, kp, sp, d_ob, T, static_cast<int>(k), d,
                       n_slots, C, st);
  else if (dtype == 1)
    combine_bwd<__nv_bfloat16>(dy, g, ei, ps, kp, sp, d_ob, T,
                               static_cast<int>(k), d, n_slots, C, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int moe_gates_bwd_launch(const void* dy, const void* ob,
                                    const void* eidx, const void* pos,
                                    const void* keep, void* dg, long long T,
                                    long long k, long long d, long long C,
                                    int dtype, void* stream) {
  if (T < 1 || T > 0x7fffffffLL || k < 1 || k > kMaxK || d < 1 ||
      d > kMaxGatesD || C < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long* ei = static_cast<const long long*>(eidx);
  const long long* ps = static_cast<const long long*>(pos);
  const bool* kp = static_cast<const bool*>(keep);
  float* g = static_cast<float*>(dg);
  if (dtype == 0)
    return gates_bwd<float>(dy, ob, ei, ps, kp, g, T, static_cast<int>(k),
                            static_cast<int>(d), C, st);
  if (dtype == 1)
    return gates_bwd<__nv_bfloat16>(dy, ob, ei, ps, kp, g, T,
                                    static_cast<int>(k), static_cast<int>(d),
                                    C, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The workers the persistent grids of the combine, the dispatch's
// backward and gates_bwd hold on the current device at most (the first
// two: token groups; gates_bwd: warps, a choice each), for rows of d
// elements of dtype on 16-byte storage (wide = 1) or not; negative: minus
// a CUDA error code.
extern "C" long long moe_combine_workers(long long d, int dtype, int wide) {
  if (d < 1) return -static_cast<long long>(cudaErrorInvalidValue);
  if (dtype == 0)
    return wide && d % 4 == 0 ? combine_workers<float, 4>(d)
                              : combine_workers<float, 1>(d);
  if (dtype == 1)
    return wide && d % 8 == 0 ? combine_workers<__nv_bfloat16, 8>(d)
                              : combine_workers<__nv_bfloat16, 1>(d);
  return -static_cast<long long>(cudaErrorInvalidValue);
}

extern "C" long long moe_dispatch_bwd_workers(long long d, int dtype,
                                              int wide) {
  if (d < 1) return -static_cast<long long>(cudaErrorInvalidValue);
  if (dtype == 0)
    return wide && d % 4 == 0 ? dispatch_bwd_workers<float, 4>(d)
                              : dispatch_bwd_workers<float, 1>(d);
  if (dtype == 1)
    return wide && d % 8 == 0 ? dispatch_bwd_workers<__nv_bfloat16, 8>(d)
                              : dispatch_bwd_workers<__nv_bfloat16, 1>(d);
  return -static_cast<long long>(cudaErrorInvalidValue);
}

extern "C" long long moe_gates_bwd_workers(long long d, int dtype, int wide) {
  const bool w = wide && d % 32 == 0;
  if (dtype == 0)
    return w ? gates_workers<float, 4>() : gates_workers<float, 1>();
  if (dtype == 1)
    return w ? gates_workers<__nv_bfloat16, 8>()
             : gates_workers<__nv_bfloat16, 1>();
  return -static_cast<long long>(cudaErrorInvalidValue);
}

extern "C" const char* moe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
