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
// (kernels/ref.py::silu_ref, silu_gate_ref) do the same in eager ops,
// five and eight kernels a call; these do it in one, in registers:
//
//  * silu_kernel: out = silu(x), each op rounded to T;
//  * silu_gate_kernel: s = silu(z) as above, prod = y * s in f32, and
//    both prod (f32, what the norm's variance reads: XLA drops that
//    convert pair) and prod rounded to T (the norm's value path). With
//    a null prod it stores the rounded value only (the dense family's
//    SwiGLU MLP, src/repro/models/layers.py:89, reads nothing else):
//    6 bytes an element in bf16 instead of 10.
//
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
//    out); the plain version is kernels/ref.py::silu_gate_bwd_ref.
//    The same kernel is two more gradients, by its null pointers:
//    - SiLU's (src/repro/models/ssm.py:137): no y and no dy. The
//      compiled `jax.vjp(jax.nn.silu)` rounds as dz above with y = 1
//      (g * 1 is g): dx = g*s + (x*g) * (s*(1 - s)). 6 bytes an
//      element in bf16; plain version silu_bwd_ref.
//    - the SSM gate's, both outputs of silu_gate_kernel
//      (src/repro/models/ssm.py:152, rms_norm(y * silu(z))): with gf,
//      the f32 product's cotangent (the norm's variance path), the
//      cotangent of the product is g = rnd(g + rnd(gf)): XLA rounds
//      the variance path's cotangent to T before it adds the value
//      path's, then rounds the sum. 14 bytes an element in bf16 (g,
//      gf, y, z in; dy, dz out); plain version silu_gate_prod_bwd_ref.
//
// All are elementwise and read their inputs once: bound by bytes. On
// bf16 (the serve model's prefill) a thread takes 4 elements of each
// input with one 8-byte load where the rows allow (unit stride, a
// multiple of 4 wide, 8-byte aligned), else one element; f32 inputs (a
// decode step's conv output, read transposed, and the f32 model) take
// one, since wider f32 vectors made the gate kernel spill around the
// IEEE divide's slow-path call. The
// inputs are read through strides, rows `ld` apart and elements `inc`
// apart (z is a slice of the in-projection's output; the decode step's
// conv output comes out of einsum transposed); the outputs are dense.
// expf, the IEEE divide and the _rn intrinsics are the ops PyTorch's
// eager kernels use, so the bits equal the plain version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;

// elements of T a thread takes with one load (see the head comment)
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

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// rows [rows, d] of x, `ldx` apart, elements `incx` apart (1 when V >
// 1) -> out [rows, d] dense
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
silu_kernel(const T* __restrict__ x, long long ldx, long long incx,
            T* __restrict__ out, long long rows, long long d) {
  const long long cols = d / V;
  for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
    for (long long c = blockIdx.x * static_cast<long long>(kThreads) +
                       threadIdx.x;
         c < cols; c += static_cast<long long>(gridDim.x) * kThreads) {
      const Vec<T, V> in =
          *reinterpret_cast<const Vec<T, V>*>(x + r * ldx + c * V * incx);
      Vec<T, V> o;
#pragma unroll
      for (int i = 0; i < V; ++i)
        o.v[i] = from_f32<T>(silu_of<T>(to_f32(in.v[i])));
      *reinterpret_cast<Vec<T, V>*>(out + r * d + c * V) = o;
    }
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
// where it is not null; a null y reads as 1 (SiLU's gradient), and a
// null dy is not stored.
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
      Vec<T, V> yv;
      if (y != nullptr)
        yv = *reinterpret_cast<const Vec<T, V>*>(y + r * ldy + c * V * incy);
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
        const float gy =
            y != nullptr ? rnd<T>(__fmul_rn(gi, to_f32(yv.v[i]))) : gi;
        const float t1 = rnd<T>(__fmul_rn(gy, s));
        const float zg = rnd<T>(__fmul_rn(zi, gy));
        const float ds = rnd<T>(__fmul_rn(s, rnd<T>(__fsub_rn(1.0f, s))));
        const float t2 = rnd<T>(__fmul_rn(zg, ds));
        dzv.v[i] = from_f32<T>(__fadd_rn(t1, t2));
      }
      if (dy != nullptr)
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

template <typename T>
void silu(const void* x, long long ldx, long long incx, void* out,
          long long rows, long long d, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (use_vec<T>(d, ldx, incx, x) && aligned(out, sizeof(T) * kVec<T>))
    silu_kernel<T, kVec<T>><<<grid_of(rows, d / kVec<T>), kThreads, 0, st>>>(
        xt, ldx, 1, ot, rows, d);
  else
    silu_kernel<T, 1><<<grid_of(rows, d), kThreads, 0, st>>>(
        xt, ldx, incx, ot, rows, d);
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
  // a null pointer is aligned and has no strides to check
  if (use_vec<T>(d, ldg, incg, g) &&
      (y == nullptr || use_vec<T>(d, ldy, incy, y)) &&
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
// may be null, and so may silu_gate_bwd's gf (dense f32), y (then 1)
// and dy (then not stored).
extern "C" int silu_launch(const void* x, long long ldx, long long incx,
                           void* out, long long rows, long long d, int dtype,
                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    silu<float>(x, ldx, incx, out, rows, d, st);
  else if (dtype == 1)
    silu<__nv_bfloat16>(x, ldx, incx, out, rows, d, st);
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
