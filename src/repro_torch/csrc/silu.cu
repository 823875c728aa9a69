// Mamba-2's two SiLU gates, the SwiGLU gate, and their gradients,
// rounded where the JAX package's compiled CPU program rounds them, for
// Hopper (sm_90a).
//
// The JAX package has no kernel here: src/repro/models/ssm.py calls
// jax.nn.silu on the causal conv's output (:137, :184) and on the gate z
// in rms_norm(y * silu(z)) (:152, :200), and XLA expands the logistic to
// 1 / (1 + exp(-x)), rounding each op to the compute dtype. In bf16 that
// rounds four times where one fused silu rounds once, and the served ids
// follow the rounding. The plain PyTorch versions
// (kernels/ref.py::silu_ref, silu_gate_ref, silu_bwd_ref, ...) do the
// same in eager ops, five to twelve kernels a call; these do it in one,
// in registers:
//
//  * silu_kernel: out = silu(x), each op rounded to T;
//  * silu_bwd_kernel: SiLU's gradient (src/repro/models/ssm.py:137)
//    given its cotangent g, as the compiled `jax.vjp(jax.nn.silu)`
//    rounds it: with s the logistic above,
//      dx = g*s + (x*g) * (s*(1 - s))
//    every product, the difference and the sum rounded to T (the gate's
//    dz below with y = 1). 6 bytes an element in bf16 (g, x in; dx
//    out); plain version silu_bwd_ref.
//  * silu_gate_kernel: s = silu(z) as above, prod = y * s in f32, and
//    both prod (f32, what the norm's variance reads: XLA drops that
//    convert pair) and prod rounded to T (the norm's value path). With
//    a null prod it stores the rounded value only (the dense family's
//    SwiGLU MLP, src/repro/models/layers.py:89, reads nothing else):
//    6 bytes an element in bf16 instead of 10.
//  * silu_gate_bwd_kernel: the gradient of the SwiGLU gate's value
//    silu(z) * y (src/repro/models/layers.py:89) given its cotangent g,
//    in the ops XLA derives for it and rounds each op of, in bf16
//    (jax.jit(jax.vjp(...)).lower(...).compile().as_text()):
//      s  = 1 / (1 + exp(-z))         each op rounded, as above
//      dy = g * (z * s)               g times the forward's rounded silu
//      gy = g * y
//      dz = gy * s + (z * gy) * (s * (1 - s))
//    every product, the difference and the sum rounded to T; the
//    derivative of the logistic stays the product rule's two terms, as
//    XLA keeps them. 10 bytes an element in bf16 (g, y, z in; dy, dz
//    out); plain version silu_gate_bwd_ref. With gf, the f32
//    product's cotangent, it is the SSM gate's gradient (both outputs
//    of silu_gate_kernel; src/repro/models/ssm.py:152): the cotangent
//    of the product is g = rnd(g + rnd(gf)), as XLA rounds the
//    variance path's cotangent to T before it adds the value path's.
//    14 bytes an element in bf16; plain version silu_gate_prod_bwd_ref.
//
// All are elementwise and read their inputs once: bound by bytes. The
// inputs are read through strides, rows `ld` apart and elements `inc`
// apart (z is a slice of the in-projection's output; the decode step's
// conv output comes out of einsum transposed); the outputs are dense.
//
// silu_kernel and silu_bwd_kernel, bf16 at unit stride (the SSM's
// prefill and train calls; NVIDIA H100 80GB HBM3, 700 W, measured by
// scripts/silu_ab.py and chip_smoke.py). Both are bound by the bytes;
// the design attacks the two limits the earlier form hit: few bytes in
// flight (8 bytes an input a thread, a block row per tensor row) and a
// chain that takes each op f32 -> bf16 -> f32 and divides by the IEEE
// divide.
//  - memory: 16-byte loads (8 elements), kSlots of them a lane an
//    input, all issued before any arithmetic, read-only and kept out of
//    L1 (each byte is touched once; the output is stored streaming for
//    silu_bwd only, see Silu2); a warp takes a chunk of 32 x kSlots slots,
//    each of its loads 512 contiguous bytes; dense rows are one flat
//    range. silu walks it with a persistent grid (as many blocks as are
//    resident); silu_bwd gives each warp one chunk (a persistent grid and
//    a ring of 1-D bulk copies into shared memory, scripts/silu_bulk.cu,
//    were both slower for it: scripts/silu_forms.py). A slot is W
//    elements aligned to W in memory; a row start off that alignment,
//    or a row whose width is not a multiple of W, gets a head and a tail
//    element by element inside the same kernel; where the streams'
//    starts differ mod 16 bytes, W drops to 4 or 2 (8- or 4-byte
//    accesses); at odd element offsets the strided kernel takes the call.
//    What bounds them: each runs at the same walk with no arithmetic
//    (the memory floor, scripts/silu_floors.cu; scripts/silu_ab.py times
//    both), and silu_bwd's floor is the pace of PyTorch's own kernels
//    that read two bf16 tensors and write one.
//  - arithmetic (~16 and ~18 SASS instructions an element, counted by
//    chip_smoke.py; the issue floors, scripts/silu_floors.cu, under the
//    memory floors): each op whose inputs are bf16 values runs as
//    sm_90's bf16x2 instruction (mul / add / sub .rn.bf16x2: two
//    elements, one rounding, no conversion). The exact
//    product or sum of two bf16 values rounds to the same bf16 as the
//    f32 op rounded again (a product has at most 16 significant bits,
//    exact in f32 down to 2^-134, half bf16's least subnormal; a sum is
//    inexact in f32 only 16 binades below its larger term, far from a
//    bf16 midpoint): the plain version's bits, not an approximation.
//    exp(-x) stays expf, the op PyTorch's eager exp runs (ex2.approx on
//    x * log2(e) is not bit-equal on every input: scripts/silu_forms.py
//    counts the outputs that differ). The reciprocal 1/u
//    (u = rnd(1 + e) >= 1) is rcp.approx of u / 4 times 1/4 in place of
//    the IEEE divide (fewer instructions an element):
//    |1/u - m| >= 2^-17 |1/u| for every bf16 u and bf16 midpoint m, so
//    its error of ~2^-23 cannot cross one, and the non-flushing multiply
//    by 1/4 makes the subnormal results (x = -87.5, -88, -88.5). No
//    fast-math flag: subnormals are kept, as the eager ops keep them.
//  These are not the ops of PyTorch's eager kernels; the proof that the
//  bits are the same is exhaustive, on the card: tests/test_torch_silu.py
//  holds silu on all 65,536 bf16 inputs (in six layouts) and silu_bwd on
//  every (g, x) pair of bf16 values to the plain versions.
//
// The strided calls (f32, or a bf16 row read at inc != 1: the decode
// step's transposed conv output) take one element a thread through a
// block row per tensor row, with expf, the IEEE divide and the _rn
// intrinsics, each op rounded to T: the ops PyTorch's eager kernels
// use, so the bits equal the plain version's. So do the gate kernels,
// which take 4 bf16 elements a thread with one 8-byte load where the
// rows allow.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;

// elements of T a thread of the gate kernels takes with one load
template <typename T>
constexpr int kVec = 4;
template <>
constexpr int kVec<float> = 1;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T, back in f32
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f32(from_f32<T>(v));
}

// x * (1 / (1 + exp(-x))), each op rounded to T
template <typename T>
__device__ __forceinline__ float silu_of(float x) {
  const float e = rnd<T>(expf(-x));
  const float u = rnd<T>(__fadd_rn(1.0f, e));
  const float r = rnd<T>(__fdiv_rn(1.0f, u));
  return rnd<T>(__fmul_rn(x, r));
}

// the gradient of silu_of given its cotangent g, each op rounded to T
template <typename T>
__device__ __forceinline__ float silu_bwd_of(float g, float x) {
  const float e = rnd<T>(expf(-x));
  const float u = rnd<T>(__fadd_rn(1.0f, e));
  // x * g before the divide: in the f32 instance it then keeps fewer
  // values live across the divide's slow-path call (no spill)
  const float xg = rnd<T>(__fmul_rn(x, g));
  const float s = rnd<T>(__fdiv_rn(1.0f, u));
  const float t1 = rnd<T>(__fmul_rn(g, s));
  const float ds = rnd<T>(__fmul_rn(s, rnd<T>(__fsub_rn(1.0f, s))));
  return __fadd_rn(t1, rnd<T>(__fmul_rn(xg, ds)));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// ---- bf16 pairs: two elements in a 32-bit word, low half first ----

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t sub2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ float lo_f32(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f32(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}
// (lo, hi) rounded to bf16, packed
__device__ __forceinline__ uint32_t pack_rn(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}
// 1/u for u in [1, 2^128), inf or NaN (see the head comment):
// rcp.approx.ftz of u / 4, a normal number with a normal reciprocal,
// times 1/4, exact, or rounded to a subnormal (the multiply does not
// flush) where u > 2^126
__device__ __forceinline__ float rcp_of(float u) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(__fmul_rn(u, 0.25f)));
  return __fmul_rn(r, 0.25f);
}

constexpr uint32_t kOne2 = 0x3f803f80u;  // (1, 1) in bf16

// s = rnd(1 / rnd(1 + rnd(exp(-x)))) of both halves
__device__ __forceinline__ uint32_t logistic2(uint32_t x) {
  const uint32_t e = pack_rn(expf(-lo_f32(x)), expf(-hi_f32(x)));
  const uint32_t u = add2(kOne2, e);
  return pack_rn(rcp_of(lo_f32(u)), rcp_of(hi_f32(u)));
}

// the ops of the vector walk: kIn inputs, and whether the output is
// stored streaming: write-back for silu (streaming stores made its time
// swing between CUDA graphs), streaming for silu_bwd (faster so), as
// scripts/silu_forms.py measures on an H100 (PERF.md).
struct Silu2 {
  static constexpr int kIn = 1;
  static constexpr bool kEvictFirst = false;
  __device__ __forceinline__ static uint32_t apply(const uint32_t (&v)[1]) {
    return mul2(v[0], logistic2(v[0]));
  }
};

// inputs (g, x)
struct SiluBwd2 {
  static constexpr int kIn = 2;
  static constexpr bool kEvictFirst = true;
  __device__ __forceinline__ static uint32_t apply(const uint32_t (&v)[2]) {
    const uint32_t g = v[0], x = v[1];
    const uint32_t s = logistic2(x);
    const uint32_t ds = mul2(s, sub2(kOne2, s));
    return add2(mul2(g, s), mul2(mul2(x, g), ds));
  }
};

// W bf16 elements as W / 2 words
template <int W>
struct Words {
  uint32_t w[W / 2];
};

// W elements (W * 2 bytes, aligned to that) of an input: read-only, not
// kept in L1
template <int W>
__device__ __forceinline__ Words<W> load_nc(const __nv_bfloat16* p) {
  Words<W> v;
  if constexpr (W == 8)
    asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
        : "=r"(v.w[0]), "=r"(v.w[1]), "=r"(v.w[2]), "=r"(v.w[3])
        : "l"(p));
  else if constexpr (W == 4)
    asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
        : "=r"(v.w[0]), "=r"(v.w[1])
        : "l"(p));
  else
    asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v.w[0]) : "l"(p));
  return v;
}

// W elements of the output; kEvictFirst stores them streaming (st.cs:
// the first lines to leave L2), else write-back as any store
template <int W, bool kEvictFirst>
__device__ __forceinline__ void store(__nv_bfloat16* p, const Words<W>& v) {
  if constexpr (W == 8) {
    const uint4 q = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
    if constexpr (kEvictFirst)
      __stcs(reinterpret_cast<uint4*>(p), q);
    else
      *reinterpret_cast<uint4*>(p) = q;
  } else if constexpr (W == 4) {
    const uint2 q = make_uint2(v.w[0], v.w[1]);
    if constexpr (kEvictFirst)
      __stcs(reinterpret_cast<uint2*>(p), q);
    else
      *reinterpret_cast<uint2*>(p) = q;
  } else {
    if constexpr (kEvictFirst)
      __stcs(reinterpret_cast<unsigned int*>(p), v.w[0]);
    else
      *reinterpret_cast<unsigned int*>(p) = v.w[0];
  }
}

__device__ __forceinline__ uint32_t bits_of(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// N streams of rows in T: input i's row r at in[i] + r * ld[i], its
// elements inc[i] apart; the output's row r at out + r * d, dense. The
// bf16 vector kernels read at unit stride, with `cpr` chunks a row and
// the grid's stride in chunks as (step_r rows, step_j chunks).
template <typename T, int N>
struct Rows {
  const T* in[N];
  long long ld[N];
  long long inc[N];
  T* out;
  long long rows, d, cpr, step_r, step_j;
};

// Op on each word of one slot's inputs
template <class Op, int W>
__device__ __forceinline__ Words<W> apply_slot(const Words<W> (&v)[Op::kIn]) {
  Words<W> o;
#pragma unroll
  for (int w = 0; w < W / 2; ++w) {
    uint32_t args[Op::kIn];
#pragma unroll
    for (int i = 0; i < Op::kIn; ++i) args[i] = v[i].w[w];
    o.w[w] = Op::apply(args);
  }
  return o;
}

// The bf16 vector walk (see the head comment): chunk j of row r covers
// the row's elements [j * C - a, (j + 1) * C - a), C = 32 * K * W and a
// the row start's offset in elements past a W boundary (the same for
// every stream); a lane's slot k in it starts (32 * k + lane) * W
// further. A chunk inside the row loads all its slots first; one at an
// edge takes each slot that is whole as a vector and the rest element
// by element.
template <class Op, int W, int K>
__device__ __forceinline__ void stream_rows(
    const Rows<__nv_bfloat16, Op::kIn>& s) {
  constexpr int N = Op::kIn;
  constexpr long long C = 32LL * K * W;
  const int lane = threadIdx.x & 31;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) >> 5;
  long long r = warp / s.cpr, j = warp - r * s.cpr;
  while (r < s.rows) {
    const __nv_bfloat16* in[N];
#pragma unroll
    for (int i = 0; i < N; ++i) in[i] = s.in[i] + r * s.ld[i];
    __nv_bfloat16* out = s.out + r * s.d;
    const long long a =
        static_cast<long long>(reinterpret_cast<uintptr_t>(in[0]) >> 1) &
        (W - 1);
    const long long first = j * C - a;
    const long long c0 = first + lane * W;
    if (first >= 0 && first + C <= s.d) {
      Words<W> v[K][N];
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < N; ++i)
          v[k][i] = load_nc<W>(in[i] + c0 + 32 * k * W);
#pragma unroll
      for (int k = 0; k < K; ++k)
        store<W, Op::kEvictFirst>(out + c0 + 32 * k * W,
                                  apply_slot<Op, W>(v[k]));
    } else {
      for (int k = 0; k < K; ++k) {
        const long long lo = c0 + 32 * k * W;
        if (lo >= 0 && lo + W <= s.d) {
          Words<W> v[N];
#pragma unroll
          for (int i = 0; i < N; ++i) v[i] = load_nc<W>(in[i] + lo);
          store<W, Op::kEvictFirst>(out + lo, apply_slot<Op, W>(v));
        } else {
          for (long long c = lo < 0 ? 0 : lo; c < lo + W && c < s.d; ++c) {
            uint32_t args[N];
#pragma unroll
            for (int i = 0; i < N; ++i) args[i] = bits_of(in[i][c]);
            out[c] = __ushort_as_bfloat16(
                static_cast<unsigned short>(Op::apply(args)));
          }
        }
      }
    }
    j += s.step_j;
    r += s.step_r;
    if (j >= s.cpr) {
      j -= s.cpr;
      ++r;
    }
  }
}

// rows of x -> out = silu(x): W > 1 the bf16 vector walk (K slots a
// lane), W == 1 one element a thread through the strides, a block row
// per tensor row
template <typename T, int W, int K>
__global__ void __launch_bounds__(kThreads)
silu_kernel(const Rows<T, 1> s) {
  if constexpr (W > 1) {
    stream_rows<Silu2, W, K>(s);
  } else {
    for (long long r = blockIdx.y; r < s.rows; r += gridDim.y)
      for (long long c = blockIdx.x * static_cast<long long>(kThreads) +
                         threadIdx.x;
           c < s.d; c += static_cast<long long>(gridDim.x) * kThreads)
        s.out[r * s.d + c] = from_f32<T>(
            silu_of<T>(to_f32(s.in[0][r * s.ld[0] + c * s.inc[0]])));
  }
}

// rows of (g, x) -> dx, SiLU's gradient; W and K as silu_kernel's
template <typename T, int W, int K>
__global__ void __launch_bounds__(kThreads)
silu_bwd_kernel(const Rows<T, 2> s) {
  if constexpr (W > 1) {
    stream_rows<SiluBwd2, W, K>(s);
  } else {
    for (long long r = blockIdx.y; r < s.rows; r += gridDim.y)
      for (long long c = blockIdx.x * static_cast<long long>(kThreads) +
                         threadIdx.x;
           c < s.d; c += static_cast<long long>(gridDim.x) * kThreads)
        s.out[r * s.d + c] = from_f32<T>(silu_bwd_of<T>(
            to_f32(s.in[0][r * s.ld[0] + c * s.inc[0]]),
            to_f32(s.in[1][r * s.ld[1] + c * s.inc[1]])));
  }
}

// y [rows, d] rows `ldy` apart, elements `incy` apart; z likewise ->
// value [rows, d] in T and prod [rows, d] in f32 (skipped where prod is
// null), both dense
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
silu_gate_kernel(const T* __restrict__ y, long long ldy, long long incy,
                 const T* __restrict__ z, long long ldz, long long incz,
                 T* __restrict__ value, float* __restrict__ prod,
                 long long rows, long long d) {
  const long long cols = d / V;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    for (long long c = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
         c < cols; c += static_cast<long long>(gridDim.x) * kThreads) {
      const Vec<T, V> yv =
          *reinterpret_cast<const Vec<T, V>*>(y + r * ldy + c * V * incy);
      const Vec<T, V> zv =
          *reinterpret_cast<const Vec<T, V>*>(z + r * ldz + c * V * incz);
      Vec<T, V> o;
      Vec<float, V> p;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        p.v[i] = __fmul_rn(to_f32(yv.v[i]), silu_of<T>(to_f32(zv.v[i])));
        o.v[i] = from_f32<T>(p.v[i]);
      }
      *reinterpret_cast<Vec<T, V>*>(value + r * d + c * V) = o;
      if (prod != nullptr)
        *reinterpret_cast<Vec<float, V>*>(prod + r * d + c * V) = p;
    }
  }
}

// g, y, z [rows, d], each rows `ld*` apart and elements `inc*` apart ->
// dy, dz [rows, d] in T, dense. gf [rows, d] f32, dense, is added to g
// where it is not null.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
silu_gate_bwd_kernel(const T* __restrict__ g, long long ldg, long long incg,
                     const float* __restrict__ gf,
                     const T* __restrict__ y, long long ldy, long long incy,
                     const T* __restrict__ z, long long ldz, long long incz,
                     T* __restrict__ dy, T* __restrict__ dz, long long rows,
                     long long d) {
  const long long cols = d / V;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    for (long long c = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
         c < cols; c += static_cast<long long>(gridDim.x) * kThreads) {
      const Vec<T, V> gv =
          *reinterpret_cast<const Vec<T, V>*>(g + r * ldg + c * V * incg);
      const Vec<T, V> zv =
          *reinterpret_cast<const Vec<T, V>*>(z + r * ldz + c * V * incz);
      Vec<float, V> gfv;
      if (gf != nullptr)
        gfv = *reinterpret_cast<const Vec<float, V>*>(gf + r * d + c * V);
      const Vec<T, V> yv =
          *reinterpret_cast<const Vec<T, V>*>(y + r * ldy + c * V * incy);
      Vec<T, V> dyv, dzv;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        float gi = to_f32(gv.v[i]);
        if (gf != nullptr) gi = rnd<T>(__fadd_rn(gi, rnd<T>(gfv.v[i])));
        const float zi = to_f32(zv.v[i]);
        const float e = rnd<T>(expf(-zi));
        const float u = rnd<T>(__fadd_rn(1.0f, e));
        const float s = rnd<T>(__fdiv_rn(1.0f, u));
        const float silu = rnd<T>(__fmul_rn(zi, s));
        dyv.v[i] = from_f32<T>(__fmul_rn(gi, silu));
        const float gy = rnd<T>(__fmul_rn(gi, to_f32(yv.v[i])));
        const float t1 = rnd<T>(__fmul_rn(gy, s));
        const float zg = rnd<T>(__fmul_rn(zi, gy));
        const float ds = rnd<T>(__fmul_rn(s, rnd<T>(__fsub_rn(1.0f, s))));
        const float t2 = rnd<T>(__fmul_rn(zg, ds));
        dzv.v[i] = from_f32<T>(__fadd_rn(t1, t2));
      }
      *reinterpret_cast<Vec<T, V>*>(dy + r * d + c * V) = dyv;
      *reinterpret_cast<Vec<T, V>*>(dz + r * d + c * V) = dzv;
    }
  }
}

bool aligned(const void* p, long long bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// kVec<T> elements a thread where rows have unit stride and every row
// start is aligned to the vector
template <typename T>
bool use_vec(long long d, long long ld, long long inc, const void* p) {
  return kVec<T> > 1 && inc == 1 && d % kVec<T> == 0 &&
         ld % kVec<T> == 0 && aligned(p, sizeof(T) * kVec<T>);
}

dim3 grid_of(long long rows, long long cols) {
  long long gx = (cols + kThreads - 1) / kThreads;
  long long gy = rows < kMaxGridY ? rows : kMaxGridY;
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
}

// slots a lane of the bf16 vector kernels takes a chunk
constexpr int kSlots = 2;

int sm_count() {
  static const int n = [] {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    return sms;
  }();
  return n;
}

// blocks of kernel F resident on one SM, read once
template <auto F>
int resident_blocks() {
  static const int n = [] {
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, F, kThreads, 0);
    return b > 0 ? b : 1;
  }();
  return n;
}

// The widest W in {8, 4, 2} at which every stream's row starts lie at
// one offset mod W elements (so one head aligns them all), else 1: the
// strided kernel. Rows are unit stride here.
template <int N>
int vec_width(const Rows<__nv_bfloat16, N>& s) {
  for (int w = 8; w > 1; w /= 2) {
    bool ok = true;
    for (int i = 0; i < N; ++i)
      ok = ok && (reinterpret_cast<uintptr_t>(s.in[i]) -
                  reinterpret_cast<uintptr_t>(s.out)) % (2 * w) == 0 &&
           (s.rows == 1 || (s.ld[i] - s.d) % w == 0);
    if (ok) return w;
  }
  return 1;
}

// launches kernel F<W, kSlots> over s's chunks: a persistent grid (as
// many blocks as are resident) or, not kPersistent, a chunk a warp
template <auto F, int W, bool kPersistent, int N>
void launch_stream(Rows<__nv_bfloat16, N> s, cudaStream_t st) {
  constexpr long long C = 32LL * kSlots * W;
  s.cpr = (s.d - 1 + W - 1) / C + 1;
  const long long warps_per_block = kThreads / 32;
  const long long units = s.rows * s.cpr;
  const long long needed = (units + warps_per_block - 1) / warps_per_block;
  long long blocks = needed;
  if (kPersistent) {
    const long long resident =
        static_cast<long long>(resident_blocks<F>()) * sm_count();
    if (blocks > resident) blocks = resident;
  }
  const long long warps = blocks * warps_per_block;
  s.step_r = warps / s.cpr;
  s.step_j = warps % s.cpr;
  F<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(s);
}

// dense rows collapse into one flat row
template <typename T, int N>
void flatten(Rows<T, N>& s) {
  bool dense = true;
  for (int i = 0; i < N; ++i)
    dense = dense && s.inc[i] == 1 && s.ld[i] == s.d;
  if (dense && s.rows > 1) {
    s.d *= s.rows;
    s.rows = 1;
    for (int i = 0; i < N; ++i) s.ld[i] = s.d;
  }
}

template <int N>
bool unit_stride(const Rows<__nv_bfloat16, N>& s) {
  for (int i = 0; i < N; ++i)
    if (s.inc[i] != 1) return false;
  return true;
}

// bf16 rows at unit stride take the vector walk, the rest the strided
// kernel
template <typename T>
void silu(Rows<T, 1> s, cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    flatten(s);
    if (unit_stride(s)) {
      switch (vec_width(s)) {
        case 8:
          return launch_stream<&silu_kernel<T, 8, kSlots>, 8, true>(s, st);
        case 4:
          return launch_stream<&silu_kernel<T, 4, kSlots>, 4, true>(s, st);
        case 2:
          return launch_stream<&silu_kernel<T, 2, kSlots>, 2, true>(s, st);
      }
    }
  }
  silu_kernel<T, 1, 1><<<grid_of(s.rows, s.d), kThreads, 0, st>>>(s);
}

template <typename T>
void silu_bwd(Rows<T, 2> s, cudaStream_t st) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    flatten(s);
    if (unit_stride(s)) {
      switch (vec_width(s)) {
        case 8:
          return launch_stream<&silu_bwd_kernel<T, 8, kSlots>, 8, false>(s, st);
        case 4:
          return launch_stream<&silu_bwd_kernel<T, 4, kSlots>, 4, false>(s, st);
        case 2:
          return launch_stream<&silu_bwd_kernel<T, 2, kSlots>, 2, false>(s, st);
      }
    }
  }
  silu_bwd_kernel<T, 1, 1><<<grid_of(s.rows, s.d), kThreads, 0, st>>>(s);
}

template <typename T>
void silu_gate(const void* y, long long ldy, long long incy, const void* z,
               long long ldz, long long incz, void* value, void* prod,
               long long rows, long long d, cudaStream_t st) {
  const T* yt = static_cast<const T*>(y);
  const T* zt = static_cast<const T*>(z);
  T* vt = static_cast<T*>(value);
  float* pt = static_cast<float*>(prod);
  if (use_vec<T>(d, ldy, incy, y) && use_vec<T>(d, ldz, incz, z) &&
      aligned(value, sizeof(T) * kVec<T>) && aligned(prod, 4 * kVec<T>))
    silu_gate_kernel<T, kVec<T>>
        <<<grid_of(rows, d / kVec<T>), kThreads, 0, st>>>(
            yt, ldy, 1, zt, ldz, 1, vt, pt, rows, d);
  else
    silu_gate_kernel<T, 1><<<grid_of(rows, d), kThreads, 0, st>>>(
        yt, ldy, incy, zt, ldz, incz, vt, pt, rows, d);
}

template <typename T>
void silu_gate_bwd(const void* g, long long ldg, long long incg,
                   const float* gf, const void* y, long long ldy,
                   long long incy, const void* z, long long ldz,
                   long long incz, void* dy, void* dz, long long rows,
                   long long d, cudaStream_t st) {
  const T* gt = static_cast<const T*>(g);
  const T* yt = static_cast<const T*>(y);
  const T* zt = static_cast<const T*>(z);
  T* dyt = static_cast<T*>(dy);
  T* dzt = static_cast<T*>(dz);
  // a null gf is aligned
  if (use_vec<T>(d, ldg, incg, g) && use_vec<T>(d, ldy, incy, y) &&
      use_vec<T>(d, ldz, incz, z) && aligned(dy, sizeof(T) * kVec<T>) &&
      aligned(dz, sizeof(T) * kVec<T>) && aligned(gf, 4 * kVec<T>))
    silu_gate_bwd_kernel<T, kVec<T>>
        <<<grid_of(rows, d / kVec<T>), kThreads, 0, st>>>(
            gt, ldg, 1, gf, yt, ldy, 1, zt, ldz, 1, dyt, dzt, rows, d);
  else
    silu_gate_bwd_kernel<T, 1><<<grid_of(rows, d), kThreads, 0, st>>>(
        gt, ldg, incg, gf, yt, ldy, incy, zt, ldz, incz, dyt, dzt, rows, d);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16. Each returns cudaGetLastError() (0 =
// launched). The caller checks shapes, types, rows >= 1 and d >= 1;
// the outputs are dense and do not overlap the inputs; silu_gate's prod
// may be null, and so may silu_gate_bwd's gf (dense f32).
extern "C" int silu_launch(const void* x, long long ldx, long long incx,
                           void* out, long long rows, long long d, int dtype,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    silu<float>({{static_cast<const float*>(x)}, {ldx}, {incx},
                 static_cast<float*>(out), rows, d}, st);
  else if (dtype == 1)
    silu<__nv_bfloat16>({{static_cast<const __nv_bfloat16*>(x)}, {ldx},
                         {incx}, static_cast<__nv_bfloat16*>(out), rows, d},
                        st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int silu_bwd_launch(const void* g, long long ldg, long long incg,
                               const void* x, long long ldx, long long incx,
                               void* dx, long long rows, long long d,
                               int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    silu_bwd<float>({{static_cast<const float*>(g),
                      static_cast<const float*>(x)}, {ldg, ldx},
                     {incg, incx}, static_cast<float*>(dx), rows, d}, st);
  else if (dtype == 1)
    silu_bwd<__nv_bfloat16>(
        {{static_cast<const __nv_bfloat16*>(g),
          static_cast<const __nv_bfloat16*>(x)}, {ldg, ldx}, {incg, incx},
         static_cast<__nv_bfloat16*>(dx), rows, d}, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int silu_gate_launch(const void* y, long long ldy, long long incy,
                                const void* z, long long ldz, long long incz,
                                void* value, void* prod, long long rows,
                                long long d, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    silu_gate<float>(y, ldy, incy, z, ldz, incz, value, prod, rows, d, st);
  else if (dtype == 1)
    silu_gate<__nv_bfloat16>(y, ldy, incy, z, ldz, incz, value, prod, rows,
                             d, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int silu_gate_bwd_launch(const void* g, long long ldg,
                                    long long incg, const void* gf,
                                    const void* y, long long ldy,
                                    long long incy, const void* z,
                                    long long ldz, long long incz, void* dy,
                                    void* dz, long long rows, long long d,
                                    int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* gff = static_cast<const float*>(gf);
  if (dtype == 0)
    silu_gate_bwd<float>(g, ldg, incg, gff, y, ldy, incy, z, ldz, incz, dy,
                         dz, rows, d, st);
  else if (dtype == 1)
    silu_gate_bwd<__nv_bfloat16>(g, ldg, incg, gff, y, ldy, incy, z, ldz,
                                 incz, dy, dz, rows, d, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* silu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
