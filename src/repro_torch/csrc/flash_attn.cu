// Flash attention of the dense family, forward and the custom VJP's
// backward, for Hopper (sm_90a).
//
// Replaces the JAX package's flash_attention (src/repro/models/
// attention.py:39, its jnp oracle of a TPU Pallas kernel) with
// flash_fwd_wgmma_kernel, and the custom VJP's backward (_vjp_bwd, :99)
// with flash_bwd_dq_wgmma_kernel and flash_bwd_dkdv_wgmma_kernel (bf16;
// the f32 parity runs take the FFMA kernels below), and computes what
// they compute for q [B,K,G,S,D], k and v [B,K,S,D] (K kv heads, G query
// heads a kv head, Sq == Sk == S), causal, with an optional window:
//   s    = (q . k^T in f32) * D^-0.5, masked to NEG_INF = -1e30 (not -inf)
//          where key j > query i or i - j >= window (window > 0);
//   fwd  : the online softmax (m, l, acc) over key tiles in order, m and
//          l starting at -1e30 and 0; p = exp(s - m_new) rounded to v's
//          dtype before the PV product (f32 sums); out = acc / max(l,
//          1e-30) in v's dtype and lse = m + log(max(l, 1e-30)) in f32;
//   bwd  : delta = sum(g * out) in f32, p = exp(s - lse) in f32,
//          dv = p^T g, dp = g v^T, ds = p (dp - delta),
//          dq = ds k * sc, dk = ds^T q * sc, in the operands' dtypes.
// The plain versions are kernels/ref.py::flash_fwd_ref / flash_bwd_ref,
// which keep the reference's key blocks of 512; the kernels state their
// own tiles (below). A tile only reorders the sums and moves the points
// where p is rounded against its running max, so the card holds the
// kernels to the plain versions within a tolerance (chip_smoke.py).
//
// Key tiles that lie wholly above the causal diagonal, or wholly before
// a query tile's window, are skipped. That is exact: every row's
// diagonal key is valid, so in the reference such a block adds exp(-1e30
// - m) = 0 (after the diagonal), or is wiped by the next valid block's
// correction exp(-1e30 - m) = 0 (before the window), and in the backward
// its p = exp(-1e30 - lse) is 0. A masked row inside a visited tile keeps
// the reference's arithmetic (its p = 1 until a valid key wipes it).
//
// What bounds it on this card. At llama3-8b's prefill (B=4, 32 heads on
// 8 kv heads, S=641, D=128, bf16) bytes, by a little: 52 MB of q, out
// and the kv heads' k and v (0.0158 ms at 3.35 TB/s) against the
// forward's two products over the causal half, 13.5 GFLOP (0.0136 ms at
// 989 TFLOP/s); at h2o-danube-1.8b's training shape (B=4, 32 heads,
// S=1,024, D=80) operations: 21.5 GFLOP (0.0217 ms) against 42 MB. The
// backward's five products are 2.5x the forward's (0.0543 ms at danube's
// shape); this backward runs ten product-equivalents, the hi / lo split
// below doubling three of them and the dq kernel recomputing two. The
// card runs' account of what holds the kernels above that (the k and v
// tiles each 128-row query tile reads from L2 again; the exponentials,
// 16 a clock an SM) is in PERF.md.
//
// Where the reference's products are exact in f32 the tensor cores are
// too: a product of two bf16 values is exact in f32, so q.k^T, the
// rounded p times v and g.v^T are formed exactly and only summed in
// another order. p^T.g, ds.k and ds^T.q have an f32 factor (p and ds stay
// f32 in the reference's backward): it is split into hi = bf16(x) and
// lo = bf16(x - hi) and run as two bf16 products into one accumulator
// (what is dropped is under 2^-17 |x|), as ssd_chunk.cu splits its
// decay. TF32 would keep 2^-11 and is not used. exp is taken in base 2
// on the MUFU (p = 2^(x sl - m sl), sl = D^-0.5 log2 e, one FFMA: see
// kMaskRaw): ex2's error (under 2^-22 relative) and the exponent's one
// rounding (2^-24 of its magnitude) sit far inside the card's
// tolerances (lse within 1e-5).
//
// Design (bf16, the serve and train paths). Each kernel is persistent
// (a block of 384 threads an SM, walking its list of work items: see
// Walk) and warp-specialised:
//  * warpgroup 0 is the producer: setmaxnreg lowers it to 40 registers
//    (56 in dk / dv, whose producer warp also loads lse and delta, and in
//    MLA's forward, whose warps 1-3 split the f32 keys) and one thread
//    issues the TMA loads (UTMALDG) into a ring of 2 shared-memory
//    stages, each completed on an mbarrier with the transaction's bytes
//    (and in MLA's forward the splitting warps' arrivals); the consumers
//    release a stage through a second mbarrier (an arrival a consumer
//    warp);
//  * warpgroups 1 and 2 are the consumers (setmaxnreg raises them to 232
//    registers, 224 in dk / dv and MLA's forward; no bf16 instance
//    spills), each owning 64
//    rows of the item, and run wgmma (HGMMA): s = q k^T with both
//    operands in shared memory, then the probabilities, converted
//    pairwise to bf16 in registers, are the register A operand of the
//    next product (the m64nN f32 accumulator layout is the A fragment
//    layout of m64k16), against v read MN-major from the same tile the
//    TMA wrote;
//  * shared-memory tiles hold D as 64-column regions of 128-byte rows
//    with the 128-byte swizzle (one TMA box of 64 rows each), and
//    D = 80's last 16 columns as a region of 32-byte rows with the
//    32-byte swizzle; the wgmma descriptors read both layouts. D = 128
//    and 80 are compiled exactly; any other multiple of 16 up to 128
//    takes the D = 128 instance, the columns past D zero-filled by TMA
//    (they add exact zeros) and never stored;
//  * rows past S come in zero-filled by TMA and are masked like keys
//    past the diagonal; every operand is read through its strides by a
//    rank-5 tensor map (D, row, g, kv head, b) encoded on the host (a
//    broadcast, stride 0, the wrapper copies dense: a map takes none);
//  * outputs leave through shared memory (the item's own q, or k and v,
//    tile) by TMA stores, rows and columns past the tensor's clipped.
//  flash_fwd_wgmma_kernel: items (b, kv head, g, q-tile of 128 rows);
//    two q buffers (the next item's q loads during this one); key and
//    value tiles of 128 keys through the ring (separate barriers, so
//    q k^T starts before v lands).
//  flash_bwd_dq_wgmma_kernel: the same items, with g beside q; first
//    delta of its rows (g from shared memory, out from device memory),
//    kept for dk / dv; then per k and v tile of 64 keys s and dp again
//    (two m64n64 products) and ds split hi / lo as the A operand of
//    dq += ds k (k read MN-major); dq in registers.
//  flash_bwd_dkdv_wgmma_kernel: items (b, kv head, key tile of 128);
//    k and v stay in shared memory while q, g, lse and delta tiles of 64
//    queries of every g that reaches the keys stream through the ring
//    (lse and delta by the producer warp's loads, released by its
//    arrival), each in two halves of 32: s^T and dp^T with keys as rows,
//    so p^T and ds^T, split hi / lo, are the A operands of dv += p^T g
//    and dk += ds^T q; dk and dv in registers.
//  The backward is two kernels and deterministic: every element of dq,
//  dk, dv and delta is summed by one thread (or one quad) in a fixed
//  order, without atomics, so two calls on the same inputs give the same
//  bits. A one-pass backward would add dq across key tiles with atomics,
//  in no fixed order; the price of two passes is dq's recompute of s and
//  dp.
// f32 inputs (the f32 parity runs) run on the CUDA cores (FFMA), a warp
// a query row (a key row in dk/dv), lanes over the 32 keys (queries) of
// a tile in shared memory and over D for the accumulators:
// flash_fwd_f32_kernel, flash_delta_kernel, flash_bwd_dq_f32_kernel,
// flash_bwd_dkdv_f32_kernel; every operand read through its strides (b,
// kv head, g, row; unit stride along D), outputs dense.
//
// MLA (minicpm3-4b's prefill and training, mla_forward at src/repro/
// models/attention.py:339) runs the forward with q and k of Dq = nd + rd
// columns
// and v and out of Dv (64 + 32 and 64), and in bf16 runs with f32 keys
// beside bf16 q and v: the reference's k_nope is an f32 product and the
// concatenation with the rope key promotes the whole k, so its score
// product reads f32 keys. flash_fwd_mla_launch reads MLA's parts where
// they lie, with no concatenation: q from q_nope (a strided view of the
// projection) and q_rope, k from k_nope (f32) and the rope key k_rope
// [B,1,S,rd] that every head shares (bf16; its map has no head: each
// head's tile comes from the one tensor, through L2). q's tile is a
// 64-column region (q_nope's map) and a 32-column tail of 64-byte rows
// (q_rope's map, 64-byte swizzle); a key tile is the same layout, its
// region hi = bf16(k_nope) and its tail the rope key, plus a second
// region lo = bf16(k_nope - hi). The TMA thread loads each f32 k_nope
// tile (a map of 64 floats a row, no swizzle) into one of two staging
// slots of shared memory a tile ahead, and the producer warpgroup's
// warps 1-3 split it into the stage's hi and lo (split_key_tile, which
// MLA's backward reuses) while the consumers work on the tile before;
// the consumers form s = q . hi over the 6 k16 steps, then + q . lo over
// the nope region's 4, in one f32 accumulator: the split the backward
// uses for its f32 factors, what is dropped under 2^-17 |k|; the rope key
// is bf16, so its lo is 0 and is not multiplied (so out and lse are those
// of a split over all 96 columns, bit for bit). Each key tile is released
// to the split right after its q . k^T, while its v is still in use.
// Splitting in a pass of its own over a concatenated k, or loading
// k_nope with the splitting warps' own 16-byte loads, took more time on
// an H100 80GB HBM3 at 700 W (PERF.md section 6), as did a 128-column
// layout of q and k (4.6% more than 64 + 32).
// Any Dq, Dv up to 128 of one dtype take the 128-column instance for
// both, with TMA's zero fill (D = 80 alone has its own). The f32 kernels
// (forward and backward) take Dv apart from Dq and q and k from two parts
// each (MLA's f32 runs). The dense bf16 backward keeps Dq == Dv and one
// dtype.
//
// MLA's backward (mla_forward's gradient, the custom VJP at :99 on the
// reference's concatenations, then their transposes) runs from the parts
// too, through flash_bwd_mla_launch: flash_bwd_dq_mla_kernel and
// flash_bwd_dkdv_mla_kernel lay q, k and dq out as the forward's q and k
// (Cols<1, 32>: 64 + 32 columns), v, g and out as one 64-column region
// (Cols<1, 0>). Each kernel's producer stages the f32 k_nope tiles by TMA
// (a slot a stage in dq, one a key tile in dk / dv) and its warps 1-3
// split them into hi and lo (split_key_tile); the rope key comes from
// k_rope's head-less map. s = q . hi + q_nope . lo as in the forward;
// dq += ds . k splits both f32 factors over the nope columns (ds_hi k_hi
// + ds_lo k_hi + ds_hi k_lo) and ds alone over the bf16 rope columns; dk
// = ds^T q and dv = p^T g with p^T and ds^T split; delta = sum g . out
// over Dv. dk leaves in f32 (the reference's keys are f32) straight from
// the accumulator fragments, as do dq and dv (bf16), a pair of columns a
// store; flash_rope_sum_kernel then sums each head's rope columns of dk
// into the one rope key's gradient as XLA's CPU program sums the
// broadcast's transpose (windows of 32 heads, in the key's dtype, every
// add rounded). Shared memory, counted as fwd_smem counts it (1 KB of
// alignment slack, the barriers): dq 2 (q, g) pairs of 40 KB and 2
// stages of 44 KB (the key tile's 12 + 8 KB, v 8 KB, the f32 slot 16
// KB): 169.1 KB; dk / dv the key tile's 40 KB, v 16 KB, the f32 slot 32
// KB and 2 stages of 20.5 KB: 130.1 KB; both under 227 KB, one block an
// SM. A first form, right before fast: its times beside the bound and
// SDPA's backward are in PERF.md section 6.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;

// element strides of one operand: batch, kv head, query group, row
struct View {
  long long b, h, g, s;
};

struct Shape {
  int B, K, G, S;
  int D;      // q's and k's head dim (Dq)
  int Dv;     // v's and out's (the backward's D too)
  int window;
  float sc;
  float sl;   // sc * log2(e)
};

__device__ __forceinline__ bool valid_key(int qi, int kj, int S,
                                          int window) {
  return kj <= qi && qi < S && (window <= 0 || qi - kj < window);
}

// ======================================================================
// bf16: the warp-specialised wgmma kernels
// ======================================================================
constexpr int kWG = 128;                 // threads of a warpgroup
constexpr int kThreadsWS = 3 * kWG;      // the producer + 2 consumers
constexpr int kStages = 2;               // ring depth
// registers a thread after setmaxnreg: the producer's, the consumers'
// (P x 128 + C x 256 <= 168 x 384, the launch's)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
// dk / dv: its producer warp also loads lse and delta
constexpr int kKvProducerRegs = 56, kKvConsumerRegs = 224;
// MLA's forward: its producer warpgroup's warps 1-3 split the f32 keys
// (kSplitWarps), staged in kMlaSlots slots of shared memory by TMA
constexpr int kMlaProducerRegs = 56, kMlaConsumerRegs = 224;
constexpr int kSplitWarps = 3, kMlaSlots = 2;
constexpr int kBox = 64;                 // rows of a TMA box
constexpr int kFwdQ = 128, kFwdN = 128;  // forward: query rows, keys
constexpr int kDqQ = 128, kDqN = 64;     // dq: query rows, keys
constexpr int kKvN = 128, kKvQ = 64;     // dk / dv: keys, query rows

// The shared-memory layout of a tile of R rows of D columns: NR regions
// of 64 columns (128-byte rows, 128-byte swizzle), region r at
// r * R * 128 bytes, then TL tail columns at NR * R * 128: 16 (32-byte
// rows, 32-byte swizzle) or 32 (64-byte rows, 64-byte swizzle; K-major
// operands only: MLA's Dq = 96 as 64 + 32).
__host__ __device__ constexpr int row_bytes(int nr, int tl) {
  return nr * 128 + tl * 2;
}
template <int NR, int TL>
struct Cols {
  static_assert(TL == 0 || TL == 16 || TL == 32, "a tail of 16 or 32");
  static constexpr int kRow = row_bytes(NR, TL);       // bytes a row
  static constexpr int kSteps = NR * 4 + TL / 16;     // k16 steps over D
};

// the tensor maps of the operands and outputs: [op][0] D in boxes of 64
// columns, [op][1] the tail's box (16 columns, D = 80; 32, MLA's rope
// part: q_rope's for q, k_rope's for k, whose nope part the kernel loads
// itself); o0 is out, dq or dk, o1 dv
enum { kMq = 0, kMk = 1, kMv = 2, kMg = 3, kMo0 = 4, kMo1 = 5 };
struct Maps {
  CUtensorMap t[6][2];
};

// ---- PTX wrappers ------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

// after the inits, before any use: visible to the async proxy
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait past about
// ten seconds (a lost arrival: a fault of the kernel) traps, so the
// launch fails instead of holding the card.
__device__ __forceinline__ bool mbar_try(uint32_t bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, unsigned parity) {
  if (mbar_try(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// one box of a rank-5 tensor map into shared memory, completing on bar
__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int c0, int c1,
                                          int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// one box of shared memory into a rank-5 tensor map (rows and columns
// past the tensor's are not written)
__device__ __forceinline__ void tma_store5(const CUtensorMap* map,
                                           uint32_t src, int c0, int c1,
                                           int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5, %6}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}
// the stores issued so far have read their shared memory
__device__ __forceinline__ void tma_store_read_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
// the writing threads' shared-memory stores, visible to the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
// a barrier of one consumer warpgroup (ids 1 and 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int cw) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ float4 ld_shared_f4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_shared2(uint32_t addr, uint32_t a,
                                           uint32_t b) {
  asm volatile("st.shared.v2.u32 [%0], {%1, %2};" ::"r"(addr), "r"(a),
               "r"(b)
               : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
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

// Shared-memory matrix descriptor of a swizzled layout: start address,
// leading byte offset 1 (unused: one swizzle atom spans the product's K
// (K-major) or N (MN-major) extent here), stride byte offset `sbo` (the
// next 8-row group), layout type in bits 62-63.
constexpr uint64_t kSw128 = 1ull << 62, kSw64 = 2ull << 62,
                   kSw32 = 3ull << 62;
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | layout;
}

// K-major operand: the rows of a tile of R rows from `row` on (64 of them
// as A; as B, as many as the product's N), k16 step kk over D. Within a
// 128-byte (64-byte) swizzle atom a step is the start address plus 32
// bytes.
template <int NR, int TL>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int R, int row,
                                           int kk) {
  if (kk < NR * 4)
    return make_desc(tile + (kk >> 2) * R * 128 + row * 128 + (kk & 3) * 32,
                     1024, kSw128);
  if (TL == 32)
    return make_desc(tile + NR * R * 128 + row * 64 + (kk - NR * 4) * 32,
                     512, kSw64);
  return make_desc(tile + NR * R * 128 + row * 32, 256, kSw32);
}

// MN-major B operand: rows [16 j, 16 j + 16) of a tile of R rows (the
// product's K), the 64 columns of region r (N), or the 16 tail columns
// for r == NR (a tail of 16 only)
template <int NR>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int R, int r,
                                            int j) {
  if (r < NR) return make_desc(tile + r * R * 128 + j * 2048, 1024, kSw128);
  return make_desc(tile + NR * R * 128 + j * 512, 256, kSw32);
}

// d = A . B^T (+ d where acc) over one k16 step, A and B from shared
// memory, both K-major; m64n32k16, bf16 in, f32 accumulate
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(acc));
}

// the same, m64n64k16
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

// the same, m64n128k16
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(a), "l"(b), "r"(acc));
}

// d += A . B over one k16 step, A (m64 x k16 bf16) from registers in
// the accumulator-shaped fragment layout, B from shared memory,
// MN-major; m64n64k16, f32 accumulate
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
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
// the accumulator-shaped fragment layout, B from shared memory,
// MN-major; m64n16k16, f32 accumulate
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the same, m64n32k16 (MLA's backward: the 32-column rope tail)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t* a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// MN-major B operand of a 32-column tail of 64-byte rows (64-byte
// swizzle) at `tail`: rows [16 j, 16 j + 16) (the product's K), its 32
// columns (N)
__device__ __forceinline__ uint64_t mnmajor_t32(uint32_t tail, int j) {
  return make_desc(tail + j * 1024, 512, kSw64);
}

// ---- helpers -------------------------------------------------------------
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// x = hi + lo with hi = bf16(x), lo = bf16(x - hi), for a pair
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// the A fragments of an m64n(8 N8) accumulator, k16 step j: element
// 4 jj + e of the accumulator is row (e < 2 ? r : r + 8), column
// 8 jj + cp + (e & 1)
template <int N>
__device__ __forceinline__ void to_frags(const float (&x)[N],
                                         uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}
template <int N>
__device__ __forceinline__ void to_frags_split(const float (&x)[N],
                                               uint32_t (&hi)[N / 2],
                                               uint32_t (&lo)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    split_pair(x[2 * i], x[2 * i + 1], hi[i], lo[i]);
}

// The f32 keys' nope part as the bf16 K-major tiles wgmma reads: a tile
// of R rows of 64 floats in shared memory at `keys` (256-byte rows, no
// swizzle: a TMA box's layout, columns past nd and rows past S zero),
// split into hi = bf16(k) and lo = bf16(k - hi) (k - hi is exact in f32;
// what lo drops is under 2^-17 |k|), each a region of R rows of 128
// bytes with the 128-byte swizzle (the layout a TMA box of 64 bf16
// columns writes). By the NT threads tid in [0, NT): 16 a row, a float4
// each (a warp reads 512 contiguous bytes and its stores fill 256),
// kUnroll loads in flight a thread. The caller fences the tiles for the
// async proxy (fence_async_smem) before it signals wgmma's threads.
template <int R, int NT>
__device__ __forceinline__ void split_key_tile(uint32_t keys, uint32_t hi,
                                               uint32_t lo, int tid) {
  constexpr int kUnits = R * 16, kUnroll = 4;
  for (int u0 = tid; u0 < kUnits; u0 += NT * kUnroll) {
    float4 x[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (u0 + j * NT < kUnits) x[j] = ld_shared_f4(keys + (u0 + j * NT) * 16);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int u = u0 + j * NT, r = u >> 4, c4 = u & 15;
      if (u >= kUnits) break;
      uint32_t h0, l0, h1, l1;
      split_pair(x[j].x, x[j].y, h0, l0);
      split_pair(x[j].z, x[j].w, h1, l1);
      const uint32_t off =
          r * 128 + (((c4 >> 1) ^ (r & 7)) << 4) + (c4 & 1) * 8;
      st_shared2(hi + off, h0, h1);
      st_shared2(lo + off, l0, l1);
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x on the MUFU (relative error under 2^-22; results below 2^-126 are
// 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The probabilities are formed in base 2 from the raw scores x = q . k:
// p = 2^(x * sl - m * sl), sl = D^-0.5 log2(e), one FFMA and one ex2,
// with m the running max of the raw scores (max(round(x sc)) =
// round(max(x) sc): the reference's max of the scaled scores is m sc).
// A masked score is kMaskRaw = -2^100, whose product with sl is exact:
// a row whose keys so far are all masked has m = kMaskRaw and p =
// 2^0 = 1, as the reference's exp(-1e30 - -1e30), and any other row
// gets p = 0 there, as exp(-1e30 - m) is.
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kMaskRaw = -1.2676506002282294e30f;   // -2^100

// Sets the masked entries of an m64nN accumulator tile to `fill`:
// element 4 jj + e lies in row h = (e >> 1) of this thread's pair, at
// column offset off = 8 jj + (e & 1) from the thread's first column; it
// is kept iff lo[h] < off <= hi[h].
template <int N>
__device__ __forceinline__ void mask_tile(float (&x)[N], int lo0, int hi0,
                                          int lo1, int hi1, float fill) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int off = 8 * (i >> 2) + (i & 1);
    const bool h = i & 2;
    if (!(off > (h ? lo1 : lo0) && off <= (h ? hi1 : hi0))) x[i] = fill;
  }
}
constexpr int kNoBound = 1 << 30;

__device__ __forceinline__ uint32_t align1024(uint32_t a) {
  return (a + 1023u) & ~1023u;
}

// R rows of operand `op`'s tail (its map [op][1], from column tc0) from
// row0 into the tail of a tile at dst, in boxes of 64 rows
template <int NR, int TL, int R>
__device__ __forceinline__ void tma_tail(uint32_t dst, const Maps& m,
                                         int op, uint32_t bar, int tc0,
                                         int row0, int g, int h, int b) {
#pragma unroll
  for (int half = 0; half < R / kBox; ++half)
    tma_load5(dst + NR * R * 128 + half * kBox * TL * 2, &m.t[op][1], bar,
              tc0, row0 + half * kBox, g, h, b);
}

// R rows of operand `op` from row0 (of query group g, kv head h, batch b)
// into a tile at dst, in boxes of 64 rows: the regions of 64 columns,
// then the tail from column tc0 of its map (NR * 64: one tensor; 0: a
// part of its own, MLA's rope part)
template <int NR, int TL, int R>
__device__ __forceinline__ void tma_tile(uint32_t dst, const Maps& m,
                                         int op, uint32_t bar, int row0,
                                         int g, int h, int b,
                                         int tc0 = NR * 64) {
#pragma unroll
  for (int half = 0; half < R / kBox; ++half)
#pragma unroll
    for (int r = 0; r < NR; ++r)
      tma_load5(dst + r * R * 128 + half * kBox * 128, &m.t[op][0], bar,
                r * 64, row0 + half * kBox, g, h, b);
  if (TL) tma_tail<NR, TL, R>(dst, m, op, bar, tc0, row0, g, h, b);
}

// A block's work items: nz heads ((b, kv head, g), or (b, kv head) in
// dk / dv) x nr ranks (q-tiles from the last, or key tiles from the
// first: the longest causal walks first). Heads go in groups of hg =
// max(1, grid / nr), so that a group's items (about one a block) share
// their heads' k and v (q and g) in L2 while they run; within a group the
// blocks take the items longest first (block c the c-th, c + grid-th,
// ...), and in every other group in reverse, so that a block's long item
// of one group pairs with a short one of the next. Producer and
// consumers walk the same list.
struct Walk {
  int gi = 0, k = 0;   // the group, this block's next turn in it
  __device__ bool next(int nz, int nr, int& z, int& rank) {
    const int grid = gridDim.x, hg = max(1, grid / nr);
    for (; gi * hg < nz; ++gi, k = 0) {
      const int hz = min(hg, nz - gi * hg), size = hz * nr;
      const int p = blockIdx.x + k * grid;
      if (p < size) {
        const int q = (gi & 1) ? size - 1 - p : p;
        rank = q / hz;
        z = gi * hg + q % hz;
        ++k;
        return true;
      }
    }
    return false;
  }
};

// The epilogue: a consumer writes its 64 rows of an output (bf16 pairs
// from the m64 accumulators, rows r and r + 8 of each thread) into its own
// rows [64 cw, 64 cw + 64) of a tile of R rows (a tile it alone reads, its
// products done) in the layout TMA reads, and one thread stores them as
// boxes of 64 rows; the tile is free again once `tma_store_read_wait`
// returns. Each value is divided by (DIV) or multiplied by its row's s0
// or s1 before the rounding.
template <int NR, int TL, int R, bool DIV>
__device__ __forceinline__ void stage_rows(uint32_t tile, int cw, int warp,
                                           int lane, const float (&a)[NR][32],
                                           const float (&at)[8], float s0,
                                           float s1) {
  const int cp = 2 * (lane & 3);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = cw * 64 + 16 * warp + (lane >> 2) + 8 * h;
    const float sc = h ? s1 : s0;
    auto f = [sc](float x) { return DIV ? x / sc : x * sc; };
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        st_shared(tile + r * R * 128 + row * 128 + ((jj ^ (row & 7)) << 4) +
                      cp * 2,
                  pack_bf16(f(a[r][4 * jj + 2 * h]),
                            f(a[r][4 * jj + 2 * h + 1])));
    if (TL) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
        st_shared(tile + NR * R * 128 + row * 32 +
                      ((jj ^ ((row >> 2) & 1)) << 4) + cp * 2,
                  pack_bf16(f(at[4 * jj + 2 * h]), f(at[4 * jj + 2 * h + 1])));
    }
  }
}
template <int NR, int TL, int R>
__device__ __forceinline__ void store_rows(uint32_t tile, const Maps& m,
                                           int op, int cw, int row0, int g,
                                           int h, int b) {
#pragma unroll
  for (int r = 0; r < NR; ++r)
    tma_store5(&m.t[op][0], tile + r * R * 128 + cw * 64 * 128, r * 64,
               row0 + cw * 64, g, h, b);
  if (TL)
    tma_store5(&m.t[op][1], tile + NR * R * 128 + cw * 64 * 32, NR * 64,
               row0 + cw * 64, g, h, b);
}

// (b, kv head, g, q-tile) work items of the forward and dq kernels (rank
// r: the q-tile nqt - 1 - r), and the key tiles [t_lo, t_hi] of BN keys
// that reach a q-tile of BM rows
struct QItem {
  int z, g, h, b, q0, t_lo, t_hi;
};
__device__ __forceinline__ QItem q_item(const Shape& sh, int z, int rank,
                                        int nqt, int BM, int BN) {
  QItem w;
  w.z = z;
  w.g = w.z % sh.G;
  w.h = (w.z / sh.G) % sh.K;
  w.b = w.z / (sh.G * sh.K);
  w.q0 = (nqt - 1 - rank) * BM;
  const int klo = sh.window > 0 ? max(0, w.q0 - sh.window + 1) : 0;
  const int khi = min(sh.S, w.q0 + BM);
  w.t_lo = klo / BN;
  w.t_hi = (khi - 1) / BN;
  return w;
}

struct FwdArgs {
  float* lse;     // [B,K,G,S]; out goes by its tensor map
  Shape sh;
  int nqt;
};

// The key tiles of the forward's work items in the order the block
// walks them (a cursor the producer's TMA thread runs ahead with)
struct TileCursor {
  Walk walk;
  QItem w;
  int t = 0;
  bool ok = false;
  __device__ void item(const Shape& sh, int nqt) {
    int z, rank;
    ok = walk.next(sh.B * sh.K * sh.G, nqt, z, rank);
    if (ok) {
      w = q_item(sh, z, rank, nqt, kFwdQ, kFwdN);
      t = w.t_lo;
    }
  }
  __device__ void next(const Shape& sh, int nqt) {
    if (++t > w.t_hi) item(sh, nqt);
  }
};

// ----------------------------------------------------------------------
// bf16: forward
// ----------------------------------------------------------------------
// q and k laid out as Cols<NRQ, TLQ>, v and out as Cols<NRV, TLV>. With
// MLA, q's region and tail come from two maps (q_nope's, q_rope's); a key
// tile is hi = bf16(k_nope) in the region, the shared rope key in the tail
// (k_rope's map at head 0), and lo = bf16(k_nope - hi) in a region of its
// own after it: the TMA thread loads each f32 k_nope tile ([kMk][0])
// into a staging slot up to kMlaSlots tiles ahead, and the producer's
// warps 1-3 split it into the stage's hi and lo (split_key_tile); s =
// q . hi over every k16 step, then + q . lo over the region's, in one
// f32 accumulator. out is staged in the q tile, each consumer in its own
// rows (so its regions must lie inside q's).
template <int NRQ, int TLQ, int NRV, int TLV, bool MLA>
__global__ void __launch_bounds__(kThreadsWS, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ Maps maps,
                           const FwdArgs a) {
  using LQ = Cols<NRQ, TLQ>;
  static_assert(TLV == 0 || TLV == 16, "v's tail is 16 columns or none");
  static_assert(NRV <= NRQ && (TLV == 0 || (NRV == NRQ && TLV == TLQ)),
                "out's regions must lie inside q's");
  static_assert(!MLA || (NRQ == 1 && TLQ == 32),
                "MLA's parts: a nope region of 64 columns, a rope tail of 32");
  constexpr int kSlots = MLA ? kMlaSlots : 0;
  constexpr uint32_t kQBytes = kFwdQ * LQ::kRow, kKBytes = kFwdN * LQ::kRow,
                     kLoBytes = MLA ? kFwdN * NRQ * 128 : 0,
                     kKStage = kKBytes + kLoBytes,
                     kVBytes = kFwdN * row_bytes(NRV, TLV),
                     kFBytes = kFwdN * 64 * 4;   // an f32 k_nope tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t sQ = align1024(smem_u32(smem_raw));      // [2]
  const uint32_t sK = sQ + 2 * kQBytes;                    // [stage]
  const uint32_t sV = sK + kStages * kKStage;
  const uint32_t sF = sV + kStages * kVBytes;              // [slot]
  // mbarriers: q full, q empty (a pair each: the next item's q loads
  // during this one), then per stage k full, v full, empty, then (MLA)
  // per stage k empty (the key tile read: the split of the next one
  // starts while the consumers still run the probabilities and PV; the
  // stage's empty then frees its v) and per slot f full, f empty
  const uint32_t bars = sF + kSlots * kFBytes;
  const uint32_t q_full = bars, q_empty = bars + 16;
  const uint32_t k_full = bars + 32, v_full = k_full + 8 * kStages,
                 empty = v_full + 8 * kStages,
                 k_empty = MLA ? empty + 8 * kStages : empty,
                 f_full = empty + 16 * kStages, f_empty = f_full + 8 * kSlots;
  const Shape sh = a.sh;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 2);
    }
    for (int s = 0; s < kStages; ++s) {
      // MLA: the TMA thread's arrival and one a splitting warp
      mbar_init(k_full + 8 * s, MLA ? 1 + kSplitWarps : 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
      if (MLA) mbar_init(k_empty + 8 * s, 8);
    }
    for (int f = 0; f < kSlots; ++f) {
      mbar_init(f_full + 8 * f, 1);
      mbar_init(f_empty + 8 * f, kSplitWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;

  if (wg == 0) {  // the producer
    setmaxnreg_dec<MLA ? kMlaProducerRegs : kProducerRegs>();
    if (threadIdx.x == 0) {   // the TMA loads
      int c = 0, fc = 0, z, rank;
      Walk walk;
      TileCursor ahead;   // MLA: the f32 tiles' loads, a slot ahead
      if (MLA) ahead.item(sh, a.nqt);
      for (int it = 0; walk.next(sh.B * sh.K * sh.G, a.nqt, z, rank); ++it) {
        const QItem w = q_item(sh, z, rank, a.nqt, kFwdQ, kFwdN);
        const uint32_t qf = q_full + 8 * (it & 1);
        mbar_wait(q_empty + 8 * (it & 1), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(qf, kQBytes);
        tma_tile<NRQ, TLQ, kFwdQ>(sQ + (it & 1) * kQBytes, maps, kMq, qf,
                                  w.q0, w.g, w.h, w.b, MLA ? 0 : NRQ * 64);
        for (int t = w.t_lo; t <= w.t_hi; ++t, ++c) {
          const int s = c % kStages;
          const uint32_t kt = sK + s * kKStage;
          for (; MLA && ahead.ok && fc < c + kSlots; ++fc) {
            const int f = fc % kSlots;
            mbar_wait(f_empty + 8 * f, ((fc / kSlots) & 1) ^ 1);
            mbar_expect_tx(f_full + 8 * f, kFBytes);
#pragma unroll
            for (int half = 0; half < kFwdN / kBox; ++half)
              tma_load5(sF + f * kFBytes + half * kBox * 256, &maps.t[kMk][0],
                        f_full + 8 * f, 0, ahead.t * kFwdN + half * kBox, 0,
                        ahead.w.h, ahead.w.b);
            ahead.next(sh, a.nqt);
          }
          if (MLA) {   // the rope key's tail; the region is split
            mbar_wait(k_empty + 8 * s, ((c / kStages) & 1) ^ 1);
            mbar_expect_tx(k_full + 8 * s, kFwdN * TLQ * 2);
            tma_tail<NRQ, TLQ, kFwdN>(kt, maps, kMk, k_full + 8 * s, 0,
                                      t * kFwdN, 0, 0, w.b);
          }
          mbar_wait(empty + 8 * s, ((c / kStages) & 1) ^ 1);
          if (!MLA) {
            mbar_expect_tx(k_full + 8 * s, kKBytes);
            tma_tile<NRQ, TLQ, kFwdN>(kt, maps, kMk, k_full + 8 * s,
                                      t * kFwdN, 0, w.h, w.b);
          }
          mbar_expect_tx(v_full + 8 * s, kVBytes);
          tma_tile<NRV, TLV, kFwdN>(sV + s * kVBytes, maps, kMv,
                                    v_full + 8 * s, t * kFwdN, 0, w.h, w.b);
        }
      }
    } else if (MLA && threadIdx.x >= 32) {   // warps 1-3: the key split
      int c = 0, z, rank;
      Walk walk;
      while (walk.next(sh.B * sh.K * sh.G, a.nqt, z, rank)) {
        const QItem w = q_item(sh, z, rank, a.nqt, kFwdQ, kFwdN);
        for (int t = w.t_lo; t <= w.t_hi; ++t, ++c) {
          const int s = c % kStages, f = c % kSlots;
          const uint32_t kt = sK + s * kKStage;
          mbar_wait(k_empty + 8 * s, ((c / kStages) & 1) ^ 1);
          mbar_wait(f_full + 8 * f, (c / kSlots) & 1);
          split_key_tile<kFwdN, 32 * kSplitWarps>(sF + f * kFBytes, kt,
                                                  kt + kKBytes,
                                                  threadIdx.x - 32);
          fence_async_smem();
          __syncwarp();
          if ((threadIdx.x & 31) == 0) {
            mbar_arrive(k_full + 8 * s);
            mbar_arrive(f_empty + 8 * f);
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<MLA ? kMlaConsumerRegs : kConsumerRegs>();
  const int cw = wg - 1, tid = threadIdx.x % kWG;
  const int warp = tid >> 5, lane = tid & 31;
  const int cp = 2 * (lane & 3);
  int c = 0, z, rank;
  Walk walk;
  for (int it = 0; walk.next(sh.B * sh.K * sh.G, a.nqt, z, rank); ++it) {
    const QItem w = q_item(sh, z, rank, a.nqt, kFwdQ, kFwdN);
    const int rlo = w.q0 + cw * 64, rhi = rlo + 63;
    const int r0 = rlo + 16 * warp + (lane >> 2), r1 = r0 + 8;
    float o[NRV][32], ot[8];
#pragma unroll
    for (int r = 0; r < NRV; ++r)
#pragma unroll
      for (int i = 0; i < 32; ++i) o[r][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) ot[i] = 0.f;
    // the running max of the raw scores, and the row sums
    float m0 = kMaskRaw, m1 = kMaskRaw, l0 = 0.f, l1 = 0.f;
    const uint32_t qt = sQ + (it & 1) * kQBytes;
    mbar_wait(q_full + 8 * (it & 1), (it >> 1) & 1);
    for (int t = w.t_lo; t <= w.t_hi; ++t, ++c) {
      const int s = c % kStages;
      const unsigned ph = (c / kStages) & 1;
      const uint32_t kt = sK + s * kKStage, vt = sV + s * kVBytes;
      const int k0 = t * kFwdN;
      float x[64];
      mbar_wait(k_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < LQ::kSteps; ++kk)
        wgmma_ss_n128(x, kmajor<NRQ, TLQ>(qt, kFwdQ, cw * 64, kk),
                      kmajor<NRQ, TLQ>(kt, kFwdN, 0, kk), kk);
      if (MLA) {
#pragma unroll
        for (int kk = 0; kk < NRQ * 4; ++kk)
          wgmma_ss_n128(x, kmajor<NRQ, TLQ>(qt, kFwdQ, cw * 64, kk),
                        kmajor<NRQ, TLQ>(kt + kKBytes, kFwdN, 0, kk), 1);
      }
      wgmma_commit_wait();
      fence_regs(x);
      if (MLA && lane == 0) mbar_arrive(k_empty + 8 * s);
      // mask a tile that crosses the diagonal or the window's edge: key
      // k0 + cp + off is kept for query r iff off <= r - k0 - cp and,
      // with a window, off > r - k0 - cp - window
      if (k0 + kFwdN - 1 > rlo || (sh.window > 0 && rhi - k0 >= sh.window)) {
        const int h0 = r0 - k0 - cp, h1 = r1 - k0 - cp;
        const int wn = sh.window > 0 ? sh.window : kNoBound;
        mask_tile(x, h0 - wn, h0, h1 - wn, h1, kMaskRaw);
      }
      // the running max, the probabilities, the sums, the rescale
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (i & 2)
          mx1 = fmaxf(mx1, x[i]);
        else
          mx0 = fmaxf(mx0, x[i]);
      }
      mx0 = quad_max(mx0);
      mx1 = quad_max(mx1);
      const float c0 = ex2((m0 - mx0) * sh.sl), c1 = ex2((m1 - mx1) * sh.sl);
      m0 = mx0;
      m1 = mx1;
      const float b0 = m0 * sh.sl, b1 = m1 * sh.sl;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float p = ex2(fmaf(x[i], sh.sl, -((i & 2) ? b1 : b0)));
        x[i] = p;
        if (i & 2)
          s1 += p;
        else
          s0 += p;
      }
      l0 = l0 * c0 + s0;
      l1 = l1 * c1 + s1;
#pragma unroll
      for (int r = 0; r < NRV; ++r)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[r][i] *= (i & 2) ? c1 : c0;
#pragma unroll
      for (int i = 0; i < 8; ++i) ot[i] *= (i & 2) ? c1 : c0;
      // acc += bf16(p) . v, p as the register A operand
      uint32_t pa[32];
      to_frags(x, pa);
      mbar_wait(v_full + 8 * s, ph);
#pragma unroll
      for (int r = 0; r < NRV; ++r) fence_regs(o[r]);
      if (TLV) fence_regs(ot);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kFwdN / 16; ++j) {
#pragma unroll
        for (int r = 0; r < NRV; ++r)
          wgmma_rs_n64(o[r], pa + 4 * j, mnmajor<NRV>(vt, kFwdN, r, j));
        if (TLV) wgmma_rs_n16(ot, pa + 4 * j, mnmajor<NRV>(vt, kFwdN, NRV, j));
      }
      wgmma_commit_wait();
#pragma unroll
      for (int r = 0; r < NRV; ++r) fence_regs(o[r]);
      if (TLV) fence_regs(ot);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // the row sums over the quad, then out (acc / l, through the q tile
    // and a TMA store) and lse
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float ls0 = fmaxf(l0, 1e-30f), ls1 = fmaxf(l1, 1e-30f);
    stage_rows<NRV, TLV, kFwdQ, true>(qt, cw, warp, lane, o, ot, ls0, ls1);
    fence_async_smem();
    wg_sync(cw);
    if (tid == 0) {
      store_rows<NRV, TLV, kFwdQ>(qt, maps, kMo0, cw, w.q0, w.g, w.h, w.b);
      tma_store_read_wait();
      mbar_arrive(q_empty + 8 * (it & 1));
    }
    __syncwarp();
    const long long zrow = static_cast<long long>(w.z) * sh.S;
    if (cp == 0 && r0 < sh.S) a.lse[zrow + r0] = m0 * sh.sc + logf(ls0);
    if (cp == 0 && r1 < sh.S) a.lse[zrow + r1] = m1 * sh.sc + logf(ls1);
  }
}

struct BwdArgs {
  const float* lse;     // [B,K,G,S]
  float* delta;         // [B,K,G,S]: written by dq, read by dk / dv
  const bf16* out;      // [B,K,G,S,D] through ov; dq, dk and dv go by
  View ov;              // their tensor maps
  Shape sh;
  int nt;               // q-tiles (dq) or key tiles (dk / dv)
};

// delta = sum(g * out) of row `row` (within the tile) of the g tile at
// gtile (R rows) and its row `orow` of out: this lane takes the 16-byte
// chunks c = q4, q4 + 4, ... of D, the quad sums them (the same order on
// every call)
template <int NR, int TL, int R>
__device__ __forceinline__ float row_delta(uint32_t gtile, int row,
                                           const bf16* orow, int q4, int D) {
  float acc = 0.f;
#pragma unroll
  for (int c = q4; c < NR * 8 + TL / 8; c += 4) {
    if (c * 8 >= D) break;
    const uint32_t at =
        c < NR * 8 ? gtile + (c >> 3) * R * 128 + row * 128 +
                         (((c & 7) ^ (row & 7)) << 4)
                   : gtile + NR * R * 128 + row * 32 +
                         ((((c - NR * 8) & 1) ^ ((row >> 2) & 1)) << 4);
    uint4 gv;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(gv.x), "=r"(gv.y), "=r"(gv.z), "=r"(gv.w)
                 : "r"(at));
    const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
    const uint32_t gw[4] = {gv.x, gv.y, gv.z, gv.w};
    const uint32_t ow[4] = {ov.x, ov.y, ov.z, ov.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 gf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&gw[e]));
      const float2 of = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&ow[e]));
      acc = fmaf(gf.x, of.x, acc);
      acc = fmaf(gf.y, of.y, acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  return acc + __shfl_xor_sync(0xffffffffu, acc, 2);
}

// ----------------------------------------------------------------------
// bf16: backward, dq
// ----------------------------------------------------------------------
template <int NR, int TL>
__global__ void __launch_bounds__(kThreadsWS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ Maps maps,
                              const BwdArgs a) {
  using L = Cols<NR, TL>;
  constexpr uint32_t kQBytes = kDqQ * L::kRow, kKVBytes = kDqN * L::kRow;
  extern __shared__ unsigned char smem_raw[];
  // two (q, g) pairs, item by item: sQ[i] at sQ + 2 i kQBytes, sG[i]
  // after it
  const uint32_t sQ = align1024(smem_u32(smem_raw));
  const uint32_t sK = sQ + 4 * kQBytes;
  const uint32_t sV = sK + kStages * kKVBytes;
  const uint32_t bars = sV + kStages * kKVBytes;
  const uint32_t q_full = bars, q_empty = bars + 16;
  const uint32_t k_full = bars + 32, v_full = k_full + 8 * kStages,
                 empty = v_full + 8 * kStages;
  const Shape sh = a.sh;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 2);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;

  if (wg == 0) {  // the producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int c = 0, z, rank;
      Walk walk;
      for (int it = 0; walk.next(sh.B * sh.K * sh.G, a.nt, z, rank); ++it) {
        const QItem w = q_item(sh, z, rank, a.nt, kDqQ, kDqN);
        const uint32_t qf = q_full + 8 * (it & 1);
        const uint32_t qt = sQ + (it & 1) * 2 * kQBytes;
        mbar_wait(q_empty + 8 * (it & 1), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(qf, 2 * kQBytes);
        tma_tile<NR, TL, kDqQ>(qt, maps, kMq, qf, w.q0, w.g, w.h, w.b);
        tma_tile<NR, TL, kDqQ>(qt + kQBytes, maps, kMg, qf, w.q0, w.g, w.h,
                               w.b);
        for (int t = w.t_lo; t <= w.t_hi; ++t, ++c) {
          const int s = c % kStages;
          mbar_wait(empty + 8 * s, ((c / kStages) & 1) ^ 1);
          mbar_expect_tx(k_full + 8 * s, kKVBytes);
          tma_tile<NR, TL, kDqN>(sK + s * kKVBytes, maps, kMk,
                                 k_full + 8 * s, t * kDqN, 0, w.h, w.b);
          mbar_expect_tx(v_full + 8 * s, kKVBytes);
          tma_tile<NR, TL, kDqN>(sV + s * kKVBytes, maps, kMv,
                                 v_full + 8 * s, t * kDqN, 0, w.h, w.b);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kConsumerRegs>();
  const int cw = wg - 1, tid = threadIdx.x % kWG;
  const int warp = tid >> 5, lane = tid & 31;
  const int cp = 2 * (lane & 3);
  int c = 0, z, rank;
  Walk walk;
  for (int it = 0; walk.next(sh.B * sh.K * sh.G, a.nt, z, rank); ++it) {
    const QItem w = q_item(sh, z, rank, a.nt, kDqQ, kDqN);
    const int rlo = w.q0 + cw * 64, rhi = rlo + 63;
    const int r0 = rlo + 16 * warp + (lane >> 2), r1 = r0 + 8;
    const long long zrow = static_cast<long long>(w.z) * sh.S;
    // rows past S: zero q and g rows, so s = dp = 0 and ds = 0 there;
    // lse in base 2
    const float lse0 = r0 < sh.S ? a.lse[zrow + r0] * kLog2e : 0.f;
    const float lse1 = r1 < sh.S ? a.lse[zrow + r1] * kLog2e : 0.f;
    float acc[NR][32], acct[8];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[r][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acct[i] = 0.f;
    const uint32_t qt = sQ + (it & 1) * 2 * kQBytes, gt = qt + kQBytes;
    mbar_wait(q_full + 8 * (it & 1), (it >> 1) & 1);
    // delta of this thread's rows, from g in shared memory and out; kept
    // for the dk / dv kernel
    // (every lane, for the quad's shuffles: a row past S reads out's last
    // row against g's zero row)
    const bf16* ob = a.out + w.b * a.ov.b + w.h * a.ov.h + w.g * a.ov.g;
    const int q4 = lane & 3;
    const float del0 = row_delta<NR, TL, kDqQ>(
        gt, r0 - w.q0, ob + min(r0, sh.S - 1) * a.ov.s, q4, sh.D);
    const float del1 = row_delta<NR, TL, kDqQ>(
        gt, r1 - w.q0, ob + min(r1, sh.S - 1) * a.ov.s, q4, sh.D);
    if (q4 == 0 && r0 < sh.S) a.delta[zrow + r0] = del0;
    if (q4 == 0 && r1 < sh.S) a.delta[zrow + r1] = del1;
    for (int t = w.t_lo; t <= w.t_hi; ++t, ++c) {
      const int s = c % kStages;
      const unsigned ph = (c / kStages) & 1;
      const uint32_t kt = sK + s * kKVBytes, vt = sV + s * kKVBytes;
      const int k0 = t * kDqN;
      float x[32], dp[32];
      mbar_wait(k_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < L::kSteps; ++kk)
        wgmma_ss_n64(x, kmajor<NR, TL>(qt, kDqQ, cw * 64, kk),
                     kmajor<NR, TL>(kt, kDqN, 0, kk), kk);
      mbar_wait(v_full + 8 * s, ph);
#pragma unroll
      for (int kk = 0; kk < L::kSteps; ++kk)
        wgmma_ss_n64(dp, kmajor<NR, TL>(gt, kDqQ, cw * 64, kk),
                     kmajor<NR, TL>(vt, kDqN, 0, kk), kk);
      wgmma_commit_wait();
      fence_regs(x);
      fence_regs(dp);
      // ds = p (dp - delta), p = 2^(x sl - lse log2 e) (0 where masked)
      if (k0 + kDqN - 1 > rlo || (sh.window > 0 && rhi - k0 >= sh.window)) {
        const int h0 = r0 - k0 - cp, h1 = r1 - k0 - cp;
        const int wn = sh.window > 0 ? sh.window : kNoBound;
        mask_tile(x, h0 - wn, h0, h1 - wn, h1, kMaskRaw);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hr = i & 2;
        const float p = ex2(fmaf(x[i], sh.sl, -(hr ? lse1 : lse0)));
        x[i] = p * (dp[i] - (hr ? del1 : del0));
      }
      // dq += ds . k, ds split into bf16 hi + lo, k read MN-major
      uint32_t hi[16], lo[16];
      to_frags_split(x, hi, lo);
#pragma unroll
      for (int r = 0; r < NR; ++r) fence_regs(acc[r]);
      if (TL) fence_regs(acct);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kDqN / 16; ++j) {
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const uint64_t d = mnmajor<NR>(kt, kDqN, r, j);
          wgmma_rs_n64(acc[r], hi + 4 * j, d);
          wgmma_rs_n64(acc[r], lo + 4 * j, d);
        }
        if (TL) {
          const uint64_t d = mnmajor<NR>(kt, kDqN, NR, j);
          wgmma_rs_n16(acct, hi + 4 * j, d);
          wgmma_rs_n16(acct, lo + 4 * j, d);
        }
      }
      wgmma_commit_wait();
#pragma unroll
      for (int r = 0; r < NR; ++r) fence_regs(acc[r]);
      if (TL) fence_regs(acct);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // dq = acc * sc, through the q tile and a TMA store
    stage_rows<NR, TL, kDqQ, false>(qt, cw, warp, lane, acc, acct, sh.sc,
                                    sh.sc);
    fence_async_smem();
    wg_sync(cw);
    if (tid == 0) {
      store_rows<NR, TL, kDqQ>(qt, maps, kMo0, cw, w.q0, w.g, w.h, w.b);
      tma_store_read_wait();
      mbar_arrive(q_empty + 8 * (it & 1));
    }
    __syncwarp();
  }
}

// ----------------------------------------------------------------------
// bf16: backward, dk and dv (keys as the product rows)
// ----------------------------------------------------------------------
// (b, kv head, key tile) items (rank r: the key tile r, reached by the
// most queries first), and the q-tiles [qt_lo, qt_hi] of kKvQ rows that
// reach the tile's keys
struct KItem {
  int zk, h, b, k0, qt_lo, nq;
};
__device__ __forceinline__ KItem k_item(const Shape& sh, int zk, int rank) {
  KItem w;
  w.zk = zk;
  w.h = w.zk % sh.K;
  w.b = w.zk / sh.K;
  w.k0 = rank * kKvN;
  const int qend =
      sh.window > 0 ? min(sh.S, w.k0 + kKvN - 1 + sh.window) : sh.S;
  w.qt_lo = w.k0 / kKvQ;
  w.nq = (qend - 1) / kKvQ - w.qt_lo + 1;
  return w;
}

template <int NR, int TL>
__global__ void __launch_bounds__(kThreadsWS, 1)
    flash_bwd_dkdv_wgmma_kernel(const __grid_constant__ Maps maps,
                                const BwdArgs a) {
  using L = Cols<NR, TL>;
  constexpr uint32_t kKBytes = kKvN * L::kRow, kQBytes = kKvQ * L::kRow;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gbase = smem_raw + (align1024(smem_u32(smem_raw)) -
                                     smem_u32(smem_raw));
  const uint32_t sK = smem_u32(gbase), sV = sK + kKBytes;
  const uint32_t sQ = sV + kKBytes;                  // [kStages]
  const uint32_t sG = sQ + kStages * kQBytes;        // [kStages]
  const uint32_t sRows = sG + kStages * kQBytes;     // lse, delta [kStages]
  float* rows = reinterpret_cast<float*>(gbase + (sRows - sK));
  const uint32_t bars = sRows + kStages * 2 * kKvQ * 4;
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  const uint32_t full = bars + 16, empty = full + 8 * kStages;
  const Shape sh = a.sh;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 2);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;

  if (wg == 0) {  // the producer: warp 0 (lse and delta by its lanes)
    setmaxnreg_dec<kKvProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int c = 0, zk, rank;
      Walk walk;
      for (int it = 0; walk.next(sh.B * sh.K, a.nt, zk, rank); ++it) {
        const KItem w = k_item(sh, zk, rank);
        if (lane == 0) {
          mbar_wait(kv_empty, (it & 1) ^ 1);
          mbar_expect_tx(kv_full, 2 * kKBytes);
          tma_tile<NR, TL, kKvN>(sK, maps, kMk, kv_full, w.k0, 0, w.h, w.b);
          tma_tile<NR, TL, kKvN>(sV, maps, kMv, kv_full, w.k0, 0, w.h, w.b);
        }
        for (int gq = 0; gq < sh.G; ++gq) {
          const long long zq =
              (static_cast<long long>(w.zk) * sh.G + gq) * sh.S;
          for (int n = 0; n < w.nq; ++n, ++c) {
            const int s = c % kStages, q0 = (w.qt_lo + n) * kKvQ;
            mbar_wait(empty + 8 * s, ((c / kStages) & 1) ^ 1);
            float* lr = rows + s * 2 * kKvQ;
            for (int e = lane; e < kKvQ; e += 32) {
              const int qi = q0 + e;
              lr[e] = qi < sh.S ? a.lse[zq + qi] * kLog2e : 0.f;
              lr[kKvQ + e] = qi < sh.S ? a.delta[zq + qi] : 0.f;
            }
            __syncwarp();
            if (lane == 0) {   // its arrival releases the lanes' stores
              mbar_expect_tx(full + 8 * s, 2 * kQBytes);
              tma_tile<NR, TL, kKvQ>(sQ + s * kQBytes, maps, kMq,
                                     full + 8 * s, q0, gq, w.h, w.b);
              tma_tile<NR, TL, kKvQ>(sG + s * kQBytes, maps, kMg,
                                     full + 8 * s, q0, gq, w.h, w.b);
            }
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kKvConsumerRegs>();
  const int cw = wg - 1, tid = threadIdx.x % kWG;
  const int warp = tid >> 5, lane = tid & 31;
  const int cp = 2 * (lane & 3);
  int c = 0, zk, rank;
  Walk walk;
  for (int it = 0; walk.next(sh.B * sh.K, a.nt, zk, rank); ++it) {
    const KItem w = k_item(sh, zk, rank);
    const int klo = w.k0 + cw * 64, khi = klo + 63;
    const int kr0 = klo + 16 * warp + (lane >> 2), kr1 = kr0 + 8;
    float dk[NR][32], dv[NR][32], dkt[8], dvt[8];
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int i = 0; i < 32; ++i) dk[r][i] = dv[r][i] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) dkt[i] = dvt[i] = 0.f;
    mbar_wait(kv_full, it & 1);
    for (int gq = 0; gq < sh.G; ++gq) {
      for (int n = 0; n < w.nq; ++n, ++c) {
        const int s = c % kStages, q0 = (w.qt_lo + n) * kKvQ;
        const uint32_t qt = sQ + s * kQBytes, gt = sG + s * kQBytes;
        const float* lr = rows + s * 2 * kKvQ;
        mbar_wait(full + 8 * s, (c / kStages) & 1);
        // the stage's queries in two halves of 32 (half the score
        // registers): s^T and dp^T of the half, then its two k16 steps
        // of the dv and dk products
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {
          const int qh = q0 + 32 * hq;
          float st[16], dpt[16];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < L::kSteps; ++kk)
            wgmma_ss_n32(st, kmajor<NR, TL>(sK, kKvN, cw * 64, kk),
                         kmajor<NR, TL>(qt, kKvQ, 32 * hq, kk), kk);
#pragma unroll
          for (int kk = 0; kk < L::kSteps; ++kk)
            wgmma_ss_n32(dpt, kmajor<NR, TL>(sV, kKvN, cw * 64, kk),
                         kmajor<NR, TL>(gt, kKvQ, 32 * hq, kk), kk);
          wgmma_commit_wait();
          fence_regs(st);
          fence_regs(dpt);
          // p^T and ds^T: rows are keys, columns the queries qh + cp + off;
          // query qi is kept for key j iff j <= qi < S and, with a window,
          // qi - j < window
          if (qh < khi || qh + 32 > sh.S ||
              (sh.window > 0 && qh + 31 - klo >= sh.window)) {
            const int e0 = kr0 - qh - cp, e1 = kr1 - qh - cp;
            const int top = sh.S - qh - cp - 1;
            const int wn = sh.window > 0 ? sh.window : kNoBound;
            mask_tile(st, e0 - 1, min(top, e0 + wn - 1), e1 - 1,
                      min(top, e1 + wn - 1), kMaskRaw);
          }
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int col = 32 * hq + 8 * (i >> 2) + cp + (i & 1);
            const float p = ex2(fmaf(st[i], sh.sl, -lr[col]));
            st[i] = p;
            dpt[i] = p * (dpt[i] - lr[kKvQ + col]);
          }
          // dv += p^T g, dk += ds^T q, the f32 factor split into hi +
          // lo, g and q read MN-major
          uint32_t ph[8], pl[8], dh[8], dl[8];
          to_frags_split(st, ph, pl);
          to_frags_split(dpt, dh, dl);
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            fence_regs(dk[r]);
            fence_regs(dv[r]);
          }
          if (TL) fence_regs(dkt);
          if (TL) fence_regs(dvt);
          wgmma_fence();
#pragma unroll
          for (int j = 0; j < 2; ++j) {
#pragma unroll
            for (int r = 0; r < NR; ++r) {
              const uint64_t dg = mnmajor<NR>(gt, kKvQ, r, 2 * hq + j);
              const uint64_t dq = mnmajor<NR>(qt, kKvQ, r, 2 * hq + j);
              wgmma_rs_n64(dv[r], ph + 4 * j, dg);
              wgmma_rs_n64(dv[r], pl + 4 * j, dg);
              wgmma_rs_n64(dk[r], dh + 4 * j, dq);
              wgmma_rs_n64(dk[r], dl + 4 * j, dq);
            }
            if (TL) {
              const uint64_t dg = mnmajor<NR>(gt, kKvQ, NR, 2 * hq + j);
              const uint64_t dq = mnmajor<NR>(qt, kKvQ, NR, 2 * hq + j);
              wgmma_rs_n16(dvt, ph + 4 * j, dg);
              wgmma_rs_n16(dvt, pl + 4 * j, dg);
              wgmma_rs_n16(dkt, dh + 4 * j, dq);
              wgmma_rs_n16(dkt, dl + 4 * j, dq);
            }
          }
          wgmma_commit_wait();
#pragma unroll
          for (int r = 0; r < NR; ++r) {
            fence_regs(dk[r]);
            fence_regs(dv[r]);
          }
          if (TL) fence_regs(dkt);
          if (TL) fence_regs(dvt);
        }
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }
    // dk = acc * sc and dv, through the k and v tiles and TMA stores
    stage_rows<NR, TL, kKvN, false>(sK, cw, warp, lane, dk, dkt, sh.sc,
                                    sh.sc);
    stage_rows<NR, TL, kKvN, false>(sV, cw, warp, lane, dv, dvt, 1.f, 1.f);
    fence_async_smem();
    wg_sync(cw);
    if (tid == 0) {
      store_rows<NR, TL, kKvN>(sK, maps, kMo0, cw, w.k0, 0, w.h, w.b);
      store_rows<NR, TL, kKvN>(sV, maps, kMo1, cw, w.k0, 0, w.h, w.b);
      tma_store_read_wait();
      mbar_arrive(kv_empty);
    }
    __syncwarp();
  }
}

// ----------------------------------------------------------------------
// bf16: MLA's backward, from its parts
// ----------------------------------------------------------------------
// q, k and dq are laid out as MLA's forward lays out q and k (Cols<1, 32>:
// the nope region from q_nope's map or the split key, the rope tail from
// q_rope's map or the head-less k_rope map at head 0), a key tile's lo =
// bf16(k_nope - hi) in a region of its own after it; v and g as one
// 64-column region (Cols<1, 0>). Each f32 k_nope tile lands by TMA in a
// staging slot of its stage (no swizzle), and the producer warpgroup's
// warps 1-3 split it (split_key_tile) once it has landed; the stage's
// consumers release the slot and the key tile together. Outputs go from
// the accumulator fragments straight to device memory (dq bf16, dk f32,
// dv bf16, dense), a pair of columns a store: dk must leave in f32, which
// the bf16 TMA stores through the tiles cannot carry.
using LMq = Cols<1, 32>;   // q, k: nope region + rope tail
using LMv = Cols<1, 0>;    // v, g: one region

struct MlaBwdArgs {
  const float* lse;     // [B,H,1,S]
  float* delta;         // [B,H,1,S]: written by dq, read by dk / dv
  const bf16* out;      // [B,H,1,S,Dv] through ov
  View ov;
  bf16* dq;             // [B,H,S,nd + rd] (dense)
  float* dk;            // [B,H,S,nd + rd] (dense, f32)
  bf16* dv;             // [B,H,S,Dv] (dense)
  Shape sh;             // K = H, G = 1, D = nd + rd
  int nd, rd;
  int nt;               // q-tiles (dq) or key tiles (dk / dv)
};

// rows r and r + 8 (h = 0, 1) of an m64nN accumulator x, times `sc`, into
// columns [c0, c0 + n) of rows `row0` / `row1` (at most `rows`) of a dense
// output of `ld` columns at `base`: element 4 jj + 2 h + e is column
// 8 jj + cp + e; bf16 pairs (T = bf16) or f32 pairs
template <typename T, int N>
__device__ __forceinline__ void store_frag(T* base, long long ld, int row0,
                                           int row1, int rows, int c0, int n,
                                           int cp, const float (&x)[N],
                                           float sc) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = h ? row1 : row0;
    if (row >= rows) continue;
    T* r = base + row * ld + c0;
#pragma unroll
    for (int jj = 0; jj < N / 4; ++jj) {
      const int col = 8 * jj + cp;
      if (col >= n) continue;
      const float a = x[4 * jj + 2 * h] * sc, b = x[4 * jj + 2 * h + 1] * sc;
      if constexpr (sizeof(T) == 2)
        *reinterpret_cast<uint32_t*>(r + col) = pack_bf16(a, b);
      else
        *reinterpret_cast<float2*>(r + col) = make_float2(a, b);
    }
  }
}

// dq of MLA: items (b, head, q-tile of 128 rows) with g beside q; delta
// of the item's rows first; per key tile of 64 keys s = q . hi + q_nope .
// lo (10 k16 steps) and dp = g . v^T (4), then ds split hi / lo and dq +=
// ds . k over k's f32 nope columns as the file splits f32 factors (ds_hi
// k_hi + ds_lo k_hi + ds_hi k_lo) and over its bf16 rope columns (ds_hi
// kr + ds_lo kr), k read MN-major from the key tile the split wrote.
__global__ void __launch_bounds__(kThreadsWS, 1)
    flash_bwd_dq_mla_kernel(const __grid_constant__ Maps maps,
                            const MlaBwdArgs a) {
  constexpr uint32_t kQBytes = kDqQ * LMq::kRow, kGBytes = kDqQ * LMv::kRow,
                     kPair = kQBytes + kGBytes,
                     kKBytes = kDqN * LMq::kRow, kLoBytes = kDqN * 128,
                     kKStage = kKBytes + kLoBytes,
                     kVBytes = kDqN * LMv::kRow,
                     kFBytes = kDqN * 64 * 4;   // an f32 k_nope tile
  extern __shared__ unsigned char smem_raw[];
  // two (q, g) pairs, item by item; per stage a key tile (hi, rope, lo),
  // a v tile and the f32 staging slot
  const uint32_t sQ = align1024(smem_u32(smem_raw));
  const uint32_t sK = sQ + 2 * kPair;
  const uint32_t sV = sK + kStages * kKStage;
  const uint32_t sF = sV + kStages * kVBytes;
  const uint32_t bars = sF + kStages * kFBytes;
  const uint32_t q_full = bars, q_empty = bars + 16;
  const uint32_t k_full = bars + 32, v_full = k_full + 8 * kStages,
                 empty = v_full + 8 * kStages, f_full = empty + 8 * kStages;
  const Shape sh = a.sh;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(q_full + 8 * i, 1);
      mbar_init(q_empty + 8 * i, 2);
    }
    for (int s = 0; s < kStages; ++s) {
      // the TMA thread's arrival (the rope tail) and one a splitting warp
      mbar_init(k_full + 8 * s, 1 + kSplitWarps);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
      mbar_init(f_full + 8 * s, 1);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;
  const int nz = sh.B * sh.K;

  if (wg == 0) {  // the producer
    setmaxnreg_dec<kMlaProducerRegs>();
    if (threadIdx.x == 0) {   // the TMA loads
      int c = 0, z, rank;
      Walk walk;
      for (int it = 0; walk.next(nz, a.nt, z, rank); ++it) {
        const QItem w = q_item(sh, z, rank, a.nt, kDqQ, kDqN);
        const uint32_t qf = q_full + 8 * (it & 1), qt = sQ + (it & 1) * kPair;
        mbar_wait(q_empty + 8 * (it & 1), ((it >> 1) & 1) ^ 1);
        mbar_expect_tx(qf, kPair);
        tma_tile<1, 32, kDqQ>(qt, maps, kMq, qf, w.q0, 0, w.h, w.b, 0);
        tma_tile<1, 0, kDqQ>(qt + kQBytes, maps, kMg, qf, w.q0, 0, w.h, w.b);
        for (int t = w.t_lo; t <= w.t_hi; ++t, ++c) {
          const int s = c % kStages;
          const uint32_t kt = sK + s * kKStage;
          // the slot and the key tile are free once the stage is
          mbar_wait(empty + 8 * s, ((c / kStages) & 1) ^ 1);
          mbar_expect_tx(f_full + 8 * s, kFBytes);
          tma_load5(sF + s * kFBytes, &maps.t[kMk][0], f_full + 8 * s, 0,
                    t * kDqN, 0, w.h, w.b);
          mbar_expect_tx(k_full + 8 * s, kDqN * 32 * 2);
          tma_tail<1, 32, kDqN>(kt, maps, kMk, k_full + 8 * s, 0, t * kDqN,
                                0, 0, w.b);
          mbar_expect_tx(v_full + 8 * s, kVBytes);
          tma_tile<1, 0, kDqN>(sV + s * kVBytes, maps, kMv, v_full + 8 * s,
                               t * kDqN, 0, w.h, w.b);
        }
      }
    } else if (threadIdx.x >= 32) {   // warps 1-3: the key split
      int c = 0, z, rank;
      Walk walk;
      while (walk.next(nz, a.nt, z, rank)) {
        const QItem w = q_item(sh, z, rank, a.nt, kDqQ, kDqN);
        for (int t = w.t_lo; t <= w.t_hi; ++t, ++c) {
          const int s = c % kStages;
          const uint32_t kt = sK + s * kKStage;
          mbar_wait(f_full + 8 * s, (c / kStages) & 1);
          split_key_tile<kDqN, 32 * kSplitWarps>(sF + s * kFBytes, kt,
                                                 kt + kKBytes,
                                                 threadIdx.x - 32);
          fence_async_smem();
          __syncwarp();
          if ((threadIdx.x & 31) == 0) mbar_arrive(k_full + 8 * s);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<kMlaConsumerRegs>();
  const int cw = wg - 1, tid = threadIdx.x % kWG;
  const int warp = tid >> 5, lane = tid & 31;
  const int cp = 2 * (lane & 3);
  const int Dq = sh.D;
  int c = 0, z, rank;
  Walk walk;
  for (int it = 0; walk.next(nz, a.nt, z, rank); ++it) {
    const QItem w = q_item(sh, z, rank, a.nt, kDqQ, kDqN);
    const int rlo = w.q0 + cw * 64;
    const int r0 = rlo + 16 * warp + (lane >> 2), r1 = r0 + 8;
    const long long zrow = static_cast<long long>(w.z) * sh.S;
    // rows past S: zero q and g rows, so s = dp = 0 and ds = 0 there
    const float lse0 = r0 < sh.S ? a.lse[zrow + r0] * kLog2e : 0.f;
    const float lse1 = r1 < sh.S ? a.lse[zrow + r1] * kLog2e : 0.f;
    float acc[32], acct[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) acct[i] = 0.f;
    const uint32_t qt = sQ + (it & 1) * kPair, gt = qt + kQBytes;
    mbar_wait(q_full + 8 * (it & 1), (it >> 1) & 1);
    const bf16* ob = a.out + w.b * a.ov.b + w.h * a.ov.h;
    const int q4 = lane & 3;
    const float del0 = row_delta<1, 0, kDqQ>(
        gt, r0 - w.q0, ob + min(r0, sh.S - 1) * a.ov.s, q4, sh.Dv);
    const float del1 = row_delta<1, 0, kDqQ>(
        gt, r1 - w.q0, ob + min(r1, sh.S - 1) * a.ov.s, q4, sh.Dv);
    if (q4 == 0 && r0 < sh.S) a.delta[zrow + r0] = del0;
    if (q4 == 0 && r1 < sh.S) a.delta[zrow + r1] = del1;
    for (int t = w.t_lo; t <= w.t_hi; ++t, ++c) {
      const int s = c % kStages;
      const unsigned ph = (c / kStages) & 1;
      const uint32_t kt = sK + s * kKStage, vt = sV + s * kVBytes;
      const int k0 = t * kDqN;
      float x[32], dp[32];
      mbar_wait(k_full + 8 * s, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < LMq::kSteps; ++kk)
        wgmma_ss_n64(x, kmajor<1, 32>(qt, kDqQ, cw * 64, kk),
                     kmajor<1, 32>(kt, kDqN, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(x, kmajor<1, 32>(qt, kDqQ, cw * 64, kk),
                     kmajor<1, 32>(kt + kKBytes, kDqN, 0, kk), 1);
      mbar_wait(v_full + 8 * s, ph);
#pragma unroll
      for (int kk = 0; kk < LMv::kSteps; ++kk)
        wgmma_ss_n64(dp, kmajor<1, 0>(gt, kDqQ, cw * 64, kk),
                     kmajor<1, 0>(vt, kDqN, 0, kk), kk);
      wgmma_commit_wait();
      fence_regs(x);
      fence_regs(dp);
      // ds = p (dp - delta), p = 2^(x sl - lse log2 e) (0 where masked)
      if (k0 + kDqN - 1 > rlo) {
        const int h0 = r0 - k0 - cp, h1 = r1 - k0 - cp;
        mask_tile(x, h0 - kNoBound, h0, h1 - kNoBound, h1, kMaskRaw);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hr = i & 2;
        const float p = ex2(fmaf(x[i], sh.sl, -(hr ? lse1 : lse0)));
        x[i] = p * (dp[i] - (hr ? del1 : del0));
      }
      // dq += ds . k: ds split into bf16 hi + lo, k (hi, lo, rope) read
      // MN-major
      uint32_t hi[16], lo[16];
      to_frags_split(x, hi, lo);
      fence_regs(acc);
      fence_regs(acct);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < kDqN / 16; ++j) {
        const uint64_t dh = mnmajor<1>(kt, kDqN, 0, j);
        const uint64_t dl = mnmajor<1>(kt + kKBytes, kDqN, 0, j);
        const uint64_t dr = mnmajor_t32(kt + kDqN * 128, j);
        wgmma_rs_n64(acc, hi + 4 * j, dh);
        wgmma_rs_n64(acc, lo + 4 * j, dh);
        wgmma_rs_n64(acc, hi + 4 * j, dl);
        wgmma_rs_n32(acct, hi + 4 * j, dr);
        wgmma_rs_n32(acct, lo + 4 * j, dr);
      }
      wgmma_commit_wait();
      fence_regs(acc);
      fence_regs(acct);
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // dq = acc * sc in bf16: nope columns, then rope columns
    bf16* dqz = a.dq + zrow * Dq;
    store_frag<bf16, 32>(dqz, Dq, r0, r1, sh.S, 0, a.nd, cp, acc, sh.sc);
    store_frag<bf16, 16>(dqz, Dq, r0, r1, sh.S, a.nd, a.rd, cp, acct,
                         sh.sc);
    wg_sync(cw);
    if (tid == 0) mbar_arrive(q_empty + 8 * (it & 1));
    __syncwarp();
  }
}

// dk and dv of MLA: items (b, head, key tile of 128): the key tile (its f32
// nope part split by the producer's warps 1-3, the rope tail) and v stay in
// shared memory while q, g, lse and delta tiles of 64 queries stream
// through the ring, each in two halves of 32: s^T = k . q^T (k hi and its
// rope tail over 6 k16 steps, then lo . q_nope over 4) and dp^T = v . g^T
// with keys as rows, then dv += p^T g and dk += ds^T q (q's nope region,
// its rope tail), p^T and ds^T split hi / lo.
__global__ void __launch_bounds__(kThreadsWS, 1)
    flash_bwd_dkdv_mla_kernel(const __grid_constant__ Maps maps,
                              const MlaBwdArgs a) {
  constexpr uint32_t kKBytes = kKvN * LMq::kRow, kLoBytes = kKvN * 128,
                     kVBytes = kKvN * LMv::kRow, kFBytes = kKvN * 64 * 4,
                     kQBytes = kKvQ * LMq::kRow, kGBytes = kKvQ * LMv::kRow;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* gbase = smem_raw + (align1024(smem_u32(smem_raw)) -
                                     smem_u32(smem_raw));
  const uint32_t sK = smem_u32(gbase), sLo = sK + kKBytes;
  const uint32_t sV = sLo + kLoBytes, sF = sV + kVBytes;
  const uint32_t sQ = sF + kFBytes;                  // [kStages]
  const uint32_t sG = sQ + kStages * kQBytes;        // [kStages]
  const uint32_t sRows = sG + kStages * kGBytes;     // lse, delta [kStages]
  float* rows = reinterpret_cast<float*>(gbase + (sRows - sK));
  const uint32_t bars = sRows + kStages * 2 * kKvQ * 4;
  const uint32_t kv_full = bars, kv_empty = bars + 8, f_full = bars + 16;
  const uint32_t full = bars + 24, empty = full + 8 * kStages;
  const Shape sh = a.sh;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1 + kSplitWarps);
    mbar_init(kv_empty, 2);
    mbar_init(f_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int wg = threadIdx.x / kWG;
  const int nz = sh.B * sh.K;

  if (wg == 0) {  // the producer
    setmaxnreg_dec<kMlaProducerRegs>();
    if (threadIdx.x < 32) {   // warp 0: TMA, lse and delta
      const int lane = threadIdx.x;
      int c = 0, zk, rank;
      Walk walk;
      for (int it = 0; walk.next(nz, a.nt, zk, rank); ++it) {
        const KItem w = k_item(sh, zk, rank);
        if (lane == 0) {
          mbar_wait(kv_empty, (it & 1) ^ 1);
          mbar_expect_tx(f_full, kFBytes);
#pragma unroll
          for (int half = 0; half < kKvN / kBox; ++half)
            tma_load5(sF + half * kBox * 256, &maps.t[kMk][0], f_full, 0,
                      w.k0 + half * kBox, 0, w.h, w.b);
          mbar_expect_tx(kv_full, kKvN * 32 * 2 + kVBytes);
          tma_tail<1, 32, kKvN>(sK, maps, kMk, kv_full, 0, w.k0, 0, 0, w.b);
          tma_tile<1, 0, kKvN>(sV, maps, kMv, kv_full, w.k0, 0, w.h, w.b);
        }
        const long long zq = static_cast<long long>(w.zk) * sh.S;
        for (int n = 0; n < w.nq; ++n, ++c) {
          const int s = c % kStages, q0 = (w.qt_lo + n) * kKvQ;
          mbar_wait(empty + 8 * s, ((c / kStages) & 1) ^ 1);
          float* lr = rows + s * 2 * kKvQ;
          for (int e = lane; e < kKvQ; e += 32) {
            const int qi = q0 + e;
            lr[e] = qi < sh.S ? a.lse[zq + qi] * kLog2e : 0.f;
            lr[kKvQ + e] = qi < sh.S ? a.delta[zq + qi] : 0.f;
          }
          __syncwarp();
          if (lane == 0) {   // its arrival releases the lanes' stores
            mbar_expect_tx(full + 8 * s, kQBytes + kGBytes);
            tma_tile<1, 32, kKvQ>(sQ + s * kQBytes, maps, kMq, full + 8 * s,
                                  q0, 0, w.h, w.b, 0);
            tma_tile<1, 0, kKvQ>(sG + s * kGBytes, maps, kMg, full + 8 * s,
                                 q0, 0, w.h, w.b);
          }
        }
      }
    } else {   // warps 1-3: the key split, once an item
      int zk, rank;
      Walk walk;
      for (int it = 0; walk.next(nz, a.nt, zk, rank); ++it) {
        mbar_wait(f_full, it & 1);
        split_key_tile<kKvN, 32 * kSplitWarps>(sF, sK, sLo,
                                               threadIdx.x - 32);
        fence_async_smem();
        __syncwarp();
        if ((threadIdx.x & 31) == 0) mbar_arrive(kv_full);
      }
    }
    return;
  }

  setmaxnreg_inc<kMlaConsumerRegs>();
  const int cw = wg - 1, tid = threadIdx.x % kWG;
  const int warp = tid >> 5, lane = tid & 31;
  const int cp = 2 * (lane & 3);
  const int Dq = sh.D;
  int c = 0, zk, rank;
  Walk walk;
  for (int it = 0; walk.next(nz, a.nt, zk, rank); ++it) {
    const KItem w = k_item(sh, zk, rank);
    const int klo = w.k0 + cw * 64, khi = klo + 63;
    const int kr0 = klo + 16 * warp + (lane >> 2), kr1 = kr0 + 8;
    float dk[32], dkt[16], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) dkt[i] = 0.f;
    mbar_wait(kv_full, it & 1);
    for (int n = 0; n < w.nq; ++n, ++c) {
      const int s = c % kStages, q0 = (w.qt_lo + n) * kKvQ;
      const uint32_t qt = sQ + s * kQBytes, gt = sG + s * kGBytes;
      const float* lr = rows + s * 2 * kKvQ;
      mbar_wait(full + 8 * s, (c / kStages) & 1);
#pragma unroll
      for (int hq = 0; hq < 2; ++hq) {
        const int qh = q0 + 32 * hq;
        float st[16], dpt[16];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < LMq::kSteps; ++kk)
          wgmma_ss_n32(st, kmajor<1, 32>(sK, kKvN, cw * 64, kk),
                       kmajor<1, 32>(qt, kKvQ, 32 * hq, kk), kk);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss_n32(st, kmajor<1, 32>(sLo, kKvN, cw * 64, kk),
                       kmajor<1, 32>(qt, kKvQ, 32 * hq, kk), 1);
#pragma unroll
        for (int kk = 0; kk < LMv::kSteps; ++kk)
          wgmma_ss_n32(dpt, kmajor<1, 0>(sV, kKvN, cw * 64, kk),
                       kmajor<1, 0>(gt, kKvQ, 32 * hq, kk), kk);
        wgmma_commit_wait();
        fence_regs(st);
        fence_regs(dpt);
        // p^T and ds^T: rows are keys, columns the queries qh + cp + off;
        // query qi is kept for key j iff j <= qi < S
        if (qh < khi || qh + 32 > sh.S) {
          const int e0 = kr0 - qh - cp, e1 = kr1 - qh - cp;
          const int top = sh.S - qh - cp - 1;
          mask_tile(st, e0 - 1, top, e1 - 1, top, kMaskRaw);
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int col = 32 * hq + 8 * (i >> 2) + cp + (i & 1);
          const float p = ex2(fmaf(st[i], sh.sl, -lr[col]));
          st[i] = p;
          dpt[i] = p * (dpt[i] - lr[kKvQ + col]);
        }
        uint32_t ph[8], pl[8], dh[8], dl[8];
        to_frags_split(st, ph, pl);
        to_frags_split(dpt, dh, dl);
        fence_regs(dk);
        fence_regs(dkt);
        fence_regs(dv);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const uint64_t dg = mnmajor<1>(gt, kKvQ, 0, 2 * hq + j);
          const uint64_t dq = mnmajor<1>(qt, kKvQ, 0, 2 * hq + j);
          const uint64_t dr = mnmajor_t32(qt + kKvQ * 128, 2 * hq + j);
          wgmma_rs_n64(dv, ph + 4 * j, dg);
          wgmma_rs_n64(dv, pl + 4 * j, dg);
          wgmma_rs_n64(dk, dh + 4 * j, dq);
          wgmma_rs_n64(dk, dl + 4 * j, dq);
          wgmma_rs_n32(dkt, dh + 4 * j, dr);
          wgmma_rs_n32(dkt, dl + 4 * j, dr);
        }
        wgmma_commit_wait();
        fence_regs(dk);
        fence_regs(dkt);
        fence_regs(dv);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
    // dk = acc * sc in f32 (nope, then rope columns) and dv in bf16
    const long long zrow = static_cast<long long>(w.zk) * sh.S;
    float* dkz = a.dk + zrow * Dq;
    store_frag<float, 32>(dkz, Dq, kr0, kr1, sh.S, 0, a.nd, cp, dk, sh.sc);
    store_frag<float, 16>(dkz, Dq, kr0, kr1, sh.S, a.nd, a.rd, cp, dkt,
                          sh.sc);
    store_frag<bf16, 32>(a.dv + zrow * sh.Dv, sh.Dv, kr0, kr1, sh.S, 0,
                         sh.Dv, cp, dv, 1.f);
    wg_sync(cw);
    if (tid == 0) mbar_arrive(kv_empty);
    __syncwarp();
  }
}

// dk_rope [B,1,S,rd]: the rope columns of dk [B,H,S,Dq] (f32) summed over
// the heads as XLA's CPU program sums the reference's broadcast's
// transpose (kernels/ref.py::gate_window_sum): in windows of 32 heads (the
// heads padded with zeros to a multiple of 32, half the pad first), each
// window in order, then the windows in order; in bf16 runs each term
// rounded to bf16 first and every add rounded to bf16. A thread a (b, row,
// column); the columns of a row are adjacent threads.
__global__ void flash_rope_sum_kernel(const float* __restrict__ dk,
                                      void* __restrict__ out, int B, int H,
                                      int S, int Dq, int nd, int rd,
                                      int to_bf16) {
  const long long n = (long long)B * S * rd;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int col = i % rd, row = (i / rd) % S, b = i / ((long long)rd * S);
  const float* p = dk + ((long long)b * H * S + row) * Dq + nd + col;
  const long long hstep = (long long)S * Dq;
  auto rnd = [to_bf16](float x) {
    return to_bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
  };
  const int nw = (H + 31) / 32, before = (nw * 32 - H) / 2;
  float total = 0.f;
  for (int wdx = 0; wdx < nw; ++wdx) {
    float acc = 0.f;
    for (int j = 0; j < 32; ++j) {
      const int h = wdx * 32 + j - before;
      if (h >= 0 && h < H) acc = rnd(acc + rnd(p[h * hstep]));
    }
    total = wdx == 0 ? acc : rnd(total + acc);
  }
  if (to_bf16)
    static_cast<bf16*>(out)[i] = __float2bfloat16_rn(total);
  else
    static_cast<float*>(out)[i] = total;
}

// ----------------------------------------------------------------------
// f32: delta = sum(g * out) over Dv; a warp a row (bf16: in the dq kernel)
// ----------------------------------------------------------------------
__global__ void flash_delta_kernel(const float* __restrict__ g,
                                   const float* __restrict__ o,
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
  const float* gr = g + b * gv.b + kh * gv.h + gq * gv.g + qi * gv.s;
  const float* orow = o + b * ov.b + kh * ov.h + gq * ov.g + qi * ov.s;
  float acc = 0.f;
  for (int d = lane; d < sh.Dv; d += 32) acc += gr[d] * orow[d];
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
// zero past S; with a second part (src2, rows ld2 apart: MLA's rope
// part), columns [nd, D) from it, the first nd from src
__device__ __forceinline__ void load_rows_f32(float* dst, const float* src,
                                              long long ld, int row0, int R,
                                              int S, int D, int SD,
                                              const float* src2 = nullptr,
                                              long long ld2 = 0,
                                              int nd = 1 << 30) {
  for (int c = threadIdx.x; c < R * D; c += blockDim.x) {
    const int r = c / D, d = c - r * D;
    const long long row = row0 + r;
    dst[r * SD + d] = row >= S   ? 0.f
                      : d < nd ? src[row * ld + d]
                               : src2[row * ld2 + d - nd];
  }
}

// q's and k's columns [0, nd) from q and k, [nd, D) from q2 and k2
// (MLA's nope and rope parts; nd = D: one tensor each)
__global__ void __launch_bounds__(kRows * 32)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ q2,
                         const float* __restrict__ k,
                         const float* __restrict__ k2,
                         const float* __restrict__ v, float* __restrict__ out,
                         float* __restrict__ lse, Shape sh, View qv,
                         View q2v, View kv, View k2v, View vv, int nd) {
  const int D = sh.D, Dv = sh.Dv, S = sh.S, SD = D + 1, SV = Dv + 1;
  extern __shared__ float fsm[];
  float* Qs = fsm;                   // [kRows][D]
  float* Ks = Qs + kRows * D;        // [kT][SD]
  float* Vs = Ks + kT * SD;          // [kT][SV]
  float* Ps = Vs + kT * SV;          // [kRows][kT]
  const int nblk = (S + kRows - 1) / kRows;
  const int i0 = (nblk - 1 - blockIdx.x) * kRows;
  const int z = blockIdx.y;
  const int gq = z % sh.G, kh = (z / sh.G) % sh.K, b = z / (sh.G * sh.K);
  const float* qb = q + b * qv.b + kh * qv.h + gq * qv.g;
  const float* q2b = q2 + b * q2v.b + kh * q2v.h + gq * q2v.g;
  const float* kb = k + b * kv.b + kh * kv.h;
  const float* k2b = k2 + b * k2v.b + kh * k2v.h;
  const float* vb = v + b * vv.b + kh * vv.h;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = i0 + w;
  const int klo = sh.window > 0 ? max(0, i0 - sh.window + 1) : 0;
  const int khi = min(S, i0 + kRows);
  load_rows_f32(Qs, qb, qv.s, i0, kRows, S, D, D, q2b, q2v.s, nd);
  float m = kNegInf, l = 0.f, acc[kMaxC] = {0.f, 0.f, 0.f, 0.f};
  for (int kt0 = (klo / kT) * kT; kt0 < khi; kt0 += kT) {
    __syncthreads();
    load_rows_f32(Ks, kb, kv.s, kt0, kT, S, D, SD, k2b, k2v.s, nd);
    load_rows_f32(Vs, vb, vv.s, kt0, kT, S, Dv, SV);
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
      if (d < Dv) {
        float pv = 0.f;
        for (int j = 0; j < kT; ++j) pv = fmaf(Ps[w * kT + j], Vs[j * SV + d], pv);
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
      if (d < Dv) out[zr * Dv + d] = acc[c] / l_safe;
    }
    if (lane == 0) lse[zr] = m + logf(l_safe);
  }
}

// The backward's f32 kernels: q's and k's columns [0, nd) from q and k,
// [nd, D) from q2 and k2 (MLA's nope and rope parts; nd = D: one tensor
// each), v, g and out of Dv columns; dq [B,K,G,S,D], dk [B,K,S,D] and dv
// [B,K,S,Dv] dense
__global__ void __launch_bounds__(kRows * 32)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ q2,
                            const float* __restrict__ k,
                            const float* __restrict__ k2,
                            const float* __restrict__ v,
                            const float* __restrict__ g,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, Shape sh, View qv,
                            View q2v, View kv, View k2v, View vv, View gv,
                            int nd) {
  const int D = sh.D, Dv = sh.Dv, S = sh.S, SD = D + 1, SV = Dv + 1;
  extern __shared__ float fsm[];
  float* Qs = fsm;                   // [kRows][D]
  float* Gs = Qs + kRows * D;        // [kRows][Dv]
  float* Ks = Gs + kRows * Dv;       // [kT][SD]
  float* Vs = Ks + kT * SD;          // [kT][SV]
  float* Ps = Vs + kT * SV;          // [kRows][kT]
  const int nblk = (S + kRows - 1) / kRows;
  const int i0 = (nblk - 1 - blockIdx.x) * kRows;
  const int z = blockIdx.y;
  const int gq = z % sh.G, kh = (z / sh.G) % sh.K, b = z / (sh.G * sh.K);
  const float* qb = q + b * qv.b + kh * qv.h + gq * qv.g;
  const float* q2b = q2 + b * q2v.b + kh * q2v.h + gq * q2v.g;
  const float* gb = g + b * gv.b + kh * gv.h + gq * gv.g;
  const float* kb = k + b * kv.b + kh * kv.h;
  const float* k2b = k2 + b * k2v.b + kh * k2v.h;
  const float* vb = v + b * vv.b + kh * vv.h;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qi = i0 + w;
  const long long zr = (long long)z * S + qi;
  const float lse_i = qi < S ? lse[zr] : 0.f;
  const float del_i = qi < S ? delta[zr] : 0.f;
  const int klo = sh.window > 0 ? max(0, i0 - sh.window + 1) : 0;
  const int khi = min(S, i0 + kRows);
  load_rows_f32(Qs, qb, qv.s, i0, kRows, S, D, D, q2b, q2v.s, nd);
  load_rows_f32(Gs, gb, gv.s, i0, kRows, S, Dv, Dv);
  float acc[kMaxC] = {0.f, 0.f, 0.f, 0.f};
  for (int kt0 = (klo / kT) * kT; kt0 < khi; kt0 += kT) {
    __syncthreads();
    load_rows_f32(Ks, kb, kv.s, kt0, kT, S, D, SD, k2b, k2v.s, nd);
    load_rows_f32(Vs, vb, vv.s, kt0, kT, S, Dv, SV);
    __syncthreads();
    const int kj = kt0 + lane;
    float s = 0.f, dp = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(Qs[w * D + d], Ks[lane * SD + d], s);
    for (int d = 0; d < Dv; ++d)
      dp = fmaf(Gs[w * Dv + d], Vs[lane * SV + d], dp);
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
                              const float* __restrict__ q2,
                              const float* __restrict__ k,
                              const float* __restrict__ k2,
                              const float* __restrict__ v,
                              const float* __restrict__ g,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              float* __restrict__ dk, float* __restrict__ dv,
                              Shape sh, View qv, View q2v, View kv, View k2v,
                              View vv, View gv, int nd) {
  const int D = sh.D, Dv = sh.Dv, S = sh.S, SD = D + 1, SV = Dv + 1;
  extern __shared__ float fsm[];
  float* Ks = fsm;                   // [kRows][D]
  float* Vs = Ks + kRows * D;        // [kRows][Dv]
  float* Qs = Vs + kRows * Dv;       // [kT][SD]
  float* Gs = Qs + kT * SD;          // [kT][SV]
  float* Ls = Gs + kT * SV;          // [kT]
  float* Dl = Ls + kT;               // [kT]
  float* Ps = Dl + kT;               // [kRows][kT]
  float* Ss = Ps + kRows * kT;       // [kRows][kT]
  const int nblk = (S + kRows - 1) / kRows;
  const int j0 = (nblk - 1 - blockIdx.x) * kRows;
  const int z = blockIdx.y;                 // b * K + kv head
  const int kh = z % sh.K, b = z / sh.K;
  const float* kb = k + b * kv.b + kh * kv.h;
  const float* k2b = k2 + b * k2v.b + kh * k2v.h;
  const float* vb = v + b * vv.b + kh * vv.h;
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kj = j0 + w;
  const int qend = sh.window > 0 ? min(S, j0 + kRows - 1 + sh.window) : S;
  load_rows_f32(Ks, kb, kv.s, j0, kRows, S, D, D, k2b, k2v.s, nd);
  load_rows_f32(Vs, vb, vv.s, j0, kRows, S, Dv, Dv);
  float ak[kMaxC] = {0.f, 0.f, 0.f, 0.f}, av[kMaxC] = {0.f, 0.f, 0.f, 0.f};
  for (int gq = 0; gq < sh.G; ++gq) {
    const float* qb = q + b * qv.b + kh * qv.h + gq * qv.g;
    const float* q2b = q2 + b * q2v.b + kh * q2v.h + gq * q2v.g;
    const float* gb = g + b * gv.b + kh * gv.h + gq * gv.g;
    const long long zq = (long long)(z * sh.G + gq) * S;
    for (int qt0 = (j0 / kT) * kT; qt0 < qend; qt0 += kT) {
      __syncthreads();
      load_rows_f32(Qs, qb, qv.s, qt0, kT, S, D, SD, q2b, q2v.s, nd);
      load_rows_f32(Gs, gb, gv.s, qt0, kT, S, Dv, SV);
      if (threadIdx.x < kT) {
        const int qi = qt0 + threadIdx.x;
        Ls[threadIdx.x] = qi < S ? lse[zq + qi] : 0.f;
        Dl[threadIdx.x] = qi < S ? delta[zq + qi] : 0.f;
      }
      __syncthreads();
      const int qi = qt0 + lane;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(Qs[lane * SD + d], Ks[w * D + d], s);
      for (int d = 0; d < Dv; ++d)
        dp = fmaf(Gs[lane * SV + d], Vs[w * Dv + d], dp);
      const float p = valid_key(qi, kj, S, sh.window) && kj < S
                          ? expf(s * sh.sc - Ls[lane])
                          : 0.f;
      Ps[w * kT + lane] = p;
      Ss[w * kT + lane] = p * (dp - Dl[lane]);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        const int d = lane + 32 * c;
        for (int i = 0; i < kT; ++i) {
          if (d < Dv) av[c] = fmaf(Ps[w * kT + i], Gs[i * SV + d], av[c]);
          if (d < D) ak[c] = fmaf(Ss[w * kT + i], Qs[i * SD + d], ak[c]);
        }
      }
    }
  }
  if (kj < S) {
    const long long zr = (long long)z * S + kj;
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) dk[zr * D + d] = ak[c] * sh.sc;
      if (d < Dv) dv[zr * Dv + d] = av[c];
    }
  }
}


// ----------------------------------------------------------------------
// launches
// ----------------------------------------------------------------------
template <typename F>
cudaError_t allow_smem(F* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

View view_of(const long long* st) { return View{st[0], st[1], st[2], st[3]}; }

// cuTensorMapEncodeTiled, through the runtime's driver entry point (the
// library links no libcuda)
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// Errors of the tensor maps' encoding come back as -(1000 + CUresult).
constexpr int kMapError = 1000;

// An operand of D columns and G query groups (1 for k and v), element
// strides `v`, as a rank-5 map (D, row, g, kv head, b) with boxes of 64
// rows and `cols` columns swizzled `sw`; a stride of 0 (a dim of size 1)
// becomes a legal one, never stepped. bf16 unless `type` (of `esize`
// bytes) says otherwise.
int encode(CUtensorMap* map, const void* ptr, const Shape& sh, int D, int G,
           const View& v, int cols, CUtensorMapSwizzle sw,
           CUtensorMapDataType type = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
           int esize = 2) {
  EncodeFn fn = encoder();
  if (fn == nullptr) return -kMapError;
  const cuuint64_t dims[5] = {
      static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(sh.S),
      static_cast<cuuint64_t>(G), static_cast<cuuint64_t>(sh.K),
      static_cast<cuuint64_t>(sh.B)};
  const long long el[4] = {v.s, v.g, v.h, v.b};
  cuuint64_t strides[4];
  for (int i = 0; i < 4; ++i)
    strides[i] = static_cast<cuuint64_t>(el[i] ? el[i] : D) * esize;
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(cols), kBox, 1, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map, type, 5, const_cast<void*>(ptr),
         dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(kMapError + static_cast<int>(r));
}

// both maps of one operand of D columns: the 64-column boxes, and the
// tail's box for TL = 16 (32-byte swizzle) or 32 (64-byte swizzle)
template <int TL>
int encode_operand(CUtensorMap (&m)[2], const void* ptr, const Shape& sh,
                   int D, int G, const View& v) {
  int err = encode(&m[0], ptr, sh, D, G, v, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0 && TL)
    err = encode(&m[1], ptr, sh, D, G, v, TL,
                 TL == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                          : CU_TENSOR_MAP_SWIZZLE_32B);
  return err;
}

// the element strides of a dense [B,K,G,S,D] (G = 1: [B,K,S,D])
View dense(const Shape& sh, int D, int G) {
  const long long row = D, g = row * sh.S, h = g * G, b = h * sh.K;
  return View{b, h, G > 1 ? g : 0, row};
}

constexpr size_t kBarBytes = 128;   // the mbarriers, padded
constexpr size_t kAlignSlack = 1024;

template <int NRQ, int TLQ, int NRV, int TLV, bool MLA>
size_t fwd_smem() {
  const size_t q_row = Cols<NRQ, TLQ>::kRow;
  return kAlignSlack + 2 * kFwdQ * q_row +
         kStages * kFwdN * (q_row + (MLA ? NRQ * 128 : 0) +
                            static_cast<size_t>(row_bytes(NRV, TLV))) +
         (MLA ? kMlaSlots * kFwdN * 64 * 4 : 0) + kBarBytes;
}
template <int NR, int TL>
size_t dq_smem() {
  const size_t row = Cols<NR, TL>::kRow;
  return kAlignSlack + (4 * kDqQ + 2 * kStages * kDqN) * row + kBarBytes;
}
template <int NR, int TL>
size_t dkdv_smem() {
  const size_t row = Cols<NR, TL>::kRow;
  return kAlignSlack + (2 * kKvN + 2 * kStages * kKvQ) * row +
         kStages * 2 * kKvQ * 4 + kBarBytes;
}

// a persistent grid: one block an SM, at most one a work item
int grid_for(int items, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *grid = items < sms ? items : sms;
  return static_cast<int>(err);
}

// one launch of a forward instance on its maps and arguments
template <int NRQ, int TLQ, int NRV, int TLV, bool MLA>
int launch_fwd_kernel(const Maps& maps, const FwdArgs& a,
                      cudaStream_t stream) {
  auto kern = flash_fwd_wgmma_kernel<NRQ, TLQ, NRV, TLV, MLA>;
  const size_t smem = fwd_smem<NRQ, TLQ, NRV, TLV, MLA>();
  int grid = 0;
  int err = static_cast<int>(allow_smem(kern, smem));
  if (!err) err = grid_for(a.nqt * a.sh.B * a.sh.K * a.sh.G, &grid);
  if (err) return err;
  kern<<<grid, kThreadsWS, smem, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

// q, k and v (one dtype, bf16) into out and lse, one launch
template <int NRQ, int TLQ, int NRV, int TLV>
int fwd_bf16(const void* q, const void* k, const void* v, void* out,
             float* lse, const Shape& sh, const long long* st,
             cudaStream_t stream) {
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  int err = encode_operand<TLQ>(maps.t[kMq], q, sh, sh.D, sh.G, view_of(st));
  if (!err)
    err = encode_operand<TLQ>(maps.t[kMk], k, sh, sh.D, 1, view_of(st + 4));
  if (!err)
    err = encode_operand<TLV>(maps.t[kMv], v, sh, sh.Dv, 1, view_of(st + 8));
  if (!err)
    err = encode_operand<TLV>(maps.t[kMo0], out, sh, sh.Dv, sh.G,
                              dense(sh, sh.Dv, sh.G));
  if (err) return err;
  const FwdArgs a{lse, sh, (sh.S + kFwdQ - 1) / kFwdQ};
  return launch_fwd_kernel<NRQ, TLQ, NRV, TLV, false>(maps, a, stream);
}

// MLA's parts (bf16 q_nope, q_rope, k_rope and v, f32 k_nope; `st` their
// strides in that order, k_nope's third) into out and lse, one launch:
// q's region from q_nope, its tail from q_rope, the keys' f32 nope part
// in boxes of 64 floats (no swizzle: the split reads it), their tail from
// k_rope (a map of one head), v and out of one 64-column region
int fwd_mla(const void* qn, const void* qr, const void* kn, const void* kr,
            const void* v, void* out, float* lse, const Shape& sh, int nd,
            int rd, const long long* st, cudaStream_t stream) {
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  Shape one = sh;   // k_rope: one head, every head's tiles at head 0
  one.K = 1;
  int err = encode(&maps.t[kMq][0], qn, sh, nd, 1, view_of(st), 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode(&maps.t[kMq][1], qr, sh, rd, 1, view_of(st + 4), 32,
                 CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err)
    err = encode(&maps.t[kMk][0], kn, sh, nd, 1, view_of(st + 8), 64,
                 CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                 4);
  if (!err)
    err = encode(&maps.t[kMk][1], kr, one, rd, 1, view_of(st + 12), 32,
                 CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err)
    err = encode_operand<0>(maps.t[kMv], v, sh, sh.Dv, 1, view_of(st + 16));
  if (!err)
    err = encode_operand<0>(maps.t[kMo0], out, sh, sh.Dv, 1,
                            dense(sh, sh.Dv, 1));
  if (err) return err;
  const FwdArgs a{lse, sh, (sh.S + kFwdQ - 1) / kFwdQ};
  return launch_fwd_kernel<1, 32, 1, 0, true>(maps, a, stream);
}

// the f32 forward (FFMA): q's and k's first nd columns from q and k, the
// rest from q2 and k2 (strides qv, q2v, kv, k2v, vv)
int fwd_f32(const void* q, const void* q2, const void* k, const void* k2,
            const void* v, void* out, float* lse, const Shape& sh, int nd,
            View qv, View q2v, View kv, View k2v, View vv,
            cudaStream_t stream) {
  const int Dq = sh.D, Dv = sh.Dv;
  const size_t smem =
      (size_t)(kRows * Dq + kT * (Dq + 1) + kT * (Dv + 1) + kRows * kT) * 4;
  cudaError_t err = allow_smem(flash_fwd_f32_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sh.S + kRows - 1) / kRows, sh.B * sh.K * sh.G);
  flash_fwd_f32_kernel<<<grid, kRows * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(q2),
      static_cast<const float*>(k), static_cast<const float*>(k2),
      static_cast<const float*>(v), static_cast<float*>(out), lse, sh, qv,
      q2v, kv, k2v, vv, nd);
  return static_cast<int>(cudaGetLastError());
}

template <int NR, int TL>
int bwd_bf16(const void* q, const void* k, const void* v, const void* g,
             const void* out, const float* lse, float* delta, void* dq,
             void* dk, void* dv, const Shape& sh, const long long* st,
             cudaStream_t stream) {
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const int D = sh.D;
  int err = encode_operand<TL>(maps.t[kMq], q, sh, D, sh.G, view_of(st));
  if (!err) err = encode_operand<TL>(maps.t[kMk], k, sh, D, 1, view_of(st + 4));
  if (!err) err = encode_operand<TL>(maps.t[kMv], v, sh, D, 1, view_of(st + 8));
  if (!err)
    err = encode_operand<TL>(maps.t[kMg], g, sh, D, sh.G, view_of(st + 12));
  if (!err)
    err = encode_operand<TL>(maps.t[kMo0], dq, sh, D, sh.G,
                             dense(sh, D, sh.G));
  if (err) return err;
  Maps kv_maps = maps;   // dk and dv as the dk / dv kernel's outputs
  err = encode_operand<TL>(kv_maps.t[kMo0], dk, sh, D, 1, dense(sh, D, 1));
  if (!err)
    err = encode_operand<TL>(kv_maps.t[kMo1], dv, sh, D, 1, dense(sh, D, 1));
  if (err) return err;
  auto kdq = flash_bwd_dq_wgmma_kernel<NR, TL>;
  auto kkv = flash_bwd_dkdv_wgmma_kernel<NR, TL>;
  err = static_cast<int>(allow_smem(kdq, dq_smem<NR, TL>()));
  if (!err) err = static_cast<int>(allow_smem(kkv, dkdv_smem<NR, TL>()));
  if (err) return err;
  BwdArgs a{lse, delta, static_cast<const bf16*>(out), view_of(st + 16),
            sh, (sh.S + kDqQ - 1) / kDqQ};
  int grid = 0;
  err = grid_for(a.nt * sh.B * sh.K * sh.G, &grid);
  if (err) return err;
  kdq<<<grid, kThreadsWS, dq_smem<NR, TL>(), stream>>>(maps, a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  a.nt = (sh.S + kKvN - 1) / kKvN;
  err = grid_for(a.nt * sh.B * sh.K, &grid);
  if (err) return err;
  kkv<<<grid, kThreadsWS, dkdv_smem<NR, TL>(), stream>>>(kv_maps, a);
  return static_cast<int>(cudaGetLastError());
}

// the f32 backward (FFMA): delta, dq, then dk and dv; q's and k's first
// nd columns from q and k, the rest from q2 and k2
int bwd_f32(const void* g, const void* q, const void* q2, const void* k,
            const void* k2, const void* v, const void* out, const float* lse,
            float* delta, void* dq, void* dk, void* dv, const Shape& sh,
            int nd, View qv, View q2v, View kv, View k2v, View vv, View gv,
            View ov, cudaStream_t stream) {
  const int D = sh.D, Dv = sh.Dv;
  const long long rows = (long long)sh.B * sh.K * sh.G * sh.S;
  const unsigned dblocks = static_cast<unsigned>((rows + 7) / 8);
  flash_delta_kernel<<<dblocks, 256, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(out), delta,
      sh, gv, ov);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t sdq = (size_t)(kRows * (D + Dv) + kT * (D + 1) +
                              kT * (Dv + 1) + kRows * kT) * 4;
  err = allow_smem(flash_bwd_dq_f32_kernel, sdq);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((sh.S + kRows - 1) / kRows, sh.B * sh.K * sh.G);
  flash_bwd_dq_f32_kernel<<<grid, kRows * 32, sdq, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(q2),
      static_cast<const float*>(k), static_cast<const float*>(k2),
      static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
      static_cast<float*>(dq), sh, qv, q2v, kv, k2v, vv, gv, nd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t skv = (size_t)(kRows * (D + Dv) + kT * (D + 1) +
                              kT * (Dv + 1) + 2 * kT + 2 * kRows * kT) * 4;
  err = allow_smem(flash_bwd_dkdv_f32_kernel, skv);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 gk((sh.S + kRows - 1) / kRows, sh.B * sh.K);
  flash_bwd_dkdv_f32_kernel<<<gk, kRows * 32, skv, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(q2),
      static_cast<const float*>(k), static_cast<const float*>(k2),
      static_cast<const float*>(v), static_cast<const float*>(g), lse, delta,
      static_cast<float*>(dk), static_cast<float*>(dv), sh, qv, q2v, kv, k2v,
      vv, gv, nd);
  return static_cast<int>(cudaGetLastError());
}

size_t dq_mla_smem() {
  return kAlignSlack +
         2 * kDqQ * static_cast<size_t>(LMq::kRow + LMv::kRow) +
         kStages * kDqN * static_cast<size_t>(LMq::kRow + 128 + LMv::kRow +
                                               64 * 4) +
         kBarBytes;
}
size_t dkdv_mla_smem() {
  return kAlignSlack +
         kKvN * static_cast<size_t>(LMq::kRow + 128 + LMv::kRow + 64 * 4) +
         kStages * kKvQ * static_cast<size_t>(LMq::kRow + LMv::kRow + 2 * 4) +
         kBarBytes;
}

// MLA's bf16 backward from its parts (the strides of q_nope, q_rope,
// k_nope, k_rope, v, g and out in `st`): dq with delta, then dk and dv
int bwd_mla(const void* g, const void* qn, const void* qr, const void* kn,
            const void* kr, const void* v, const void* out, const float* lse,
            float* delta, void* dq, void* dk, void* dv, const Shape& sh,
            int nd, int rd, const long long* st, cudaStream_t stream) {
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  Shape one = sh;   // k_rope: one head, every head's tiles at head 0
  one.K = 1;
  int err = encode(&maps.t[kMq][0], qn, sh, nd, 1, view_of(st), 64,
                   CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = encode(&maps.t[kMq][1], qr, sh, rd, 1, view_of(st + 4), 32,
                 CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err)
    err = encode(&maps.t[kMk][0], kn, sh, nd, 1, view_of(st + 8), 64,
                 CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                 4);
  if (!err)
    err = encode(&maps.t[kMk][1], kr, one, rd, 1, view_of(st + 12), 32,
                 CU_TENSOR_MAP_SWIZZLE_64B);
  if (!err)
    err = encode_operand<0>(maps.t[kMv], v, sh, sh.Dv, 1, view_of(st + 16));
  if (!err)
    err = encode_operand<0>(maps.t[kMg], g, sh, sh.Dv, 1, view_of(st + 20));
  if (err) return err;
  const size_t sdq = dq_mla_smem(), skv = dkdv_mla_smem();
  err = static_cast<int>(allow_smem(flash_bwd_dq_mla_kernel, sdq));
  if (!err) err = static_cast<int>(allow_smem(flash_bwd_dkdv_mla_kernel, skv));
  if (err) return err;
  MlaBwdArgs a{lse,
               delta,
               static_cast<const bf16*>(out),
               view_of(st + 24),
               static_cast<bf16*>(dq),
               static_cast<float*>(dk),
               static_cast<bf16*>(dv),
               sh,
               nd,
               rd,
               (sh.S + kDqQ - 1) / kDqQ};
  int grid = 0;
  err = grid_for(a.nt * sh.B * sh.K, &grid);
  if (err) return err;
  flash_bwd_dq_mla_kernel<<<grid, kThreadsWS, sdq, stream>>>(maps, a);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  a.nt = (sh.S + kKvN - 1) / kKvN;
  err = grid_for(a.nt * sh.B * sh.K, &grid);
  if (err) return err;
  flash_bwd_dkdv_mla_kernel<<<grid, kThreadsWS, skv, stream>>>(maps, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k and v of one dtype). `strides` holds 4
// element strides (batch, kv head, query group, row) per operand: q, k,
// v for the forward; q, k, v, g, out for the backward (k's and v's group
// stride is unused). Rows are unit-stride along the head dim; for bf16
// every row start is 16-byte aligned (the wrapper checks). The forward's
// q and k have Dq columns, v and out Dv; the backward's all D. out
// [B,K,G,S,Dv], lse and delta [B,K,G,S], dq [B,K,G,S,D], dk and dv
// [B,K,S,D] are dense. Each returns cudaGetLastError() (0 = launched),
// or below 0 where a tensor map could not be encoded
// (flash_error_string says which).
extern "C" int flash_fwd_launch(const void* q, const void* k, const void* v,
                                void* out, void* lse, int B, int K, int G,
                                int S, int Dq, int Dv, int window, float sc,
                                int dtype, const long long* strides,
                                void* stream) {
  const Shape sh{B, K, G, S, Dq, Dv, window, sc, sc * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1) {
    if (Dq == 80 && Dv == 80)
      return fwd_bf16<1, 16, 1, 16>(q, k, v, out, l, sh, strides, st);
    return fwd_bf16<2, 0, 2, 0>(q, k, v, out, l, sh, strides, st);
  }
  const View qv = view_of(strides), kv = view_of(strides + 4);
  return fwd_f32(q, q, k, k, v, out, l, sh, Dq, qv, qv, kv, kv,
                 view_of(strides + 8), st);
}

// MLA's forward (mla_forward, causal, no window) from its parts: q_nope
// [B,H,S,nd], q_rope [B,H,S,rd], k_nope [B,H,S,nd], k_rope [B,1,S,rd] (the
// one rope key of every head) and v [B,H,S,Dv] into out [B,H,1,S,Dv] and
// lse [B,H,1,S] (dense), scaled by sc ((nd + rd)^-0.5). `strides` holds
// their 4 element strides each (batch, head, 0, row), in that order;
// rows are unit-stride. dtype 1: k_nope f32, the rest bf16 (all read by
// TMA: every row start 16-byte aligned), nd <= 64, rd <= 32, Dv <= 64:
// the wgmma kernel, which splits k_nope into bf16 hi and lo on its way
// from a staging slot into the key tiles; dtype 0: all f32, the FFMA
// kernel. Returns as flash_fwd_launch.
extern "C" int flash_fwd_mla_launch(const void* q_nope, const void* q_rope,
                                    const void* k_nope, const void* k_rope,
                                    const void* v, void* out, void* lse,
                                    int B, int H, int S, int nd, int rd,
                                    int Dv, float sc, int dtype,
                                    const long long* strides, void* stream) {
  const Shape sh{B, H, 1, S, nd + rd, Dv, 0, sc, sc * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 1) {
    if (nd > 64 || rd > 32 || Dv > 64)
      return static_cast<int>(cudaErrorInvalidValue);
    return fwd_mla(q_nope, q_rope, k_nope, k_rope, v, out, l, sh, nd, rd,
                   strides, st);
  }
  return fwd_f32(q_nope, q_rope, k_nope, k_rope, v, out, l, sh, nd,
                 view_of(strides), view_of(strides + 4), view_of(strides + 8),
                 view_of(strides + 12), view_of(strides + 16), st);
}

extern "C" int flash_bwd_launch(const void* g, const void* q, const void* k,
                                const void* v, const void* out,
                                const void* lse, void* delta, void* dq,
                                void* dk, void* dv, int B, int K, int G,
                                int S, int D, int window, float sc,
                                int dtype, const long long* strides,
                                void* stream) {
  const Shape sh{B, K, G, S, D, D, window, sc, sc * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  const View gv = view_of(strides + 12), ov = view_of(strides + 16);
  if (dtype == 1) {
    if (D == 80)
      return bwd_bf16<1, 16>(q, k, v, g, out, l, dl, dq, dk, dv, sh, strides,
                             st);
    return bwd_bf16<2, 0>(q, k, v, g, out, l, dl, dq, dk, dv, sh, strides,
                          st);
  }
  return bwd_f32(g, q, q, k, k, v, out, l, dl, dq, dk, dv, sh, D,
                 view_of(strides), view_of(strides), view_of(strides + 4),
                 view_of(strides + 4), view_of(strides + 8), gv, ov, st);
}

// MLA's backward (mla_forward's flash, causal, no window) from its parts:
// g [B,H,1,S,Dv] the cotangent of out, q_nope [B,H,S,nd], q_rope
// [B,H,S,rd], k_nope [B,H,S,nd], k_rope [B,1,S,rd] (the one rope key of
// every head), v [B,H,S,Dv], out [B,H,1,S,Dv] and lse [B,H,1,S] (the
// forward's) into dq [B,H,S,nd + rd] (q's dtype), dk [B,H,S,nd + rd] (f32,
// the reference's: its k is f32), dv [B,H,S,Dv] and dk_rope [B,1,S,rd]
// (k_rope's dtype: dk's rope columns summed over the heads), all dense;
// delta [B,H,1,S] f32 scratch. `strides` holds the 4 element strides
// (batch, head, 0, row) of q_nope, q_rope, k_nope, k_rope, v, g and out,
// in that order. dtype 1: k_nope f32, the rest bf16 (read by TMA: row
// starts 16-byte aligned), nd <= 64, rd <= 32, Dv <= 64: the wgmma
// kernels, which split k_nope into bf16 hi and lo on its way from a
// staging slot into the key tiles; dtype 0: all f32, the FFMA kernels.
// Three launches in bf16 (dq with delta, dk / dv, the head sum), four in
// f32 (delta first). Returns as flash_bwd_launch.
extern "C" int flash_bwd_mla_launch(
    const void* g, const void* q_nope, const void* q_rope,
    const void* k_nope, const void* k_rope, const void* v, const void* out,
    const void* lse, void* delta, void* dq, void* dk, void* dv,
    void* dk_rope, int B, int H, int S, int nd, int rd, int Dv, float sc,
    int dtype, const long long* strides, void* stream) {
  const Shape sh{B, H, 1, S, nd + rd, Dv, 0, sc, sc * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  int err;
  if (dtype == 1) {
    if (nd > 64 || rd > 32 || Dv > 64)
      return static_cast<int>(cudaErrorInvalidValue);
    err = bwd_mla(g, q_nope, q_rope, k_nope, k_rope, v, out, l, dl, dq, dk,
                  dv, sh, nd, rd, strides, st);
  } else {
    err = bwd_f32(g, q_nope, q_rope, k_nope, k_rope, v, out, l, dl, dq, dk,
                  dv, sh, nd, view_of(strides), view_of(strides + 4),
                  view_of(strides + 8), view_of(strides + 12),
                  view_of(strides + 16), view_of(strides + 20),
                  view_of(strides + 24), st);
  }
  if (err) return err;
  const long long n = (long long)B * S * rd;
  flash_rope_sum_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                          st>>>(static_cast<const float*>(dk), dk_rope, B, H,
                                S, nd + rd, nd, rd, dtype);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* flash_error_string(int code) {
  if (code == -kMapError)
    return "cuTensorMapEncodeTiled is not in the CUDA driver";
  if (code < 0) {
    static thread_local char msg[96];
    snprintf(msg, sizeof(msg),
             "a TMA tensor map could not be encoded (CUresult %d)",
             -code - kMapError);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
