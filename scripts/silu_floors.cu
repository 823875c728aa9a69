// The two floors of the bf16 SiLU kernels of src/repro_torch/csrc/silu.cu,
// for timing beside them (scripts/silu_ab.py builds this file with the
// same nvcc flags):
//
//  * the memory floor: the same walk (stream_rows: 16-byte streaming
//    loads, K slots a lane, each kernel's grid: persistent for silu, a
//    chunk a warp for silu_bwd) with the same bytes and no arithmetic:
//    out = x for silu's shape, out = g ^ x for silu_bwd's;
//  * the issue floor: the same arithmetic (Silu2, SiluBwd2) on values
//    made in registers from the element's index (two integer
//    instructions a word), with no load and one store a thread.
//
// Both take a flat, dense bf16 range of n elements, as the SSM's calls
// are.
#include "../src/repro_torch/csrc/silu.cu"

namespace {

template <int N>
struct Copy2 {
  static constexpr int kIn = N;
  static constexpr bool kEvictFirst = N > 1;  // as Silu2, SiluBwd2
  __device__ __forceinline__ static uint32_t apply(const uint32_t (&v)[N]) {
    uint32_t o = v[0];
#pragma unroll
    for (int i = 1; i < N; ++i) o ^= v[i];
    return o;
  }
};

template <int N, int W, int K>
__global__ void __launch_bounds__(kThreads)
copy_floor_kernel(const Rows<__nv_bfloat16, N> s) {
  stream_rows<Copy2<N>, W, K>(s);
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
issue_floor_kernel(long long words, uint32_t seed, uint32_t* sink) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  uint32_t acc = 0;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) +
                     threadIdx.x;
       i < words; i += stride) {
    uint32_t args[Op::kIn];
    const uint32_t h = static_cast<uint32_t>(i) * 0x9e3779b1u;
#pragma unroll
    for (int k = 0; k < Op::kIn; ++k) args[k] = h ^ (seed + k);
    acc ^= Op::apply(args);
  }
  if (acc == seed) sink[0] = acc;
}

template <class Op>
void issue_floor(long long n, void* sink, cudaStream_t st) {
  const long long words = n / 2;
  long long blocks =
      static_cast<long long>(resident_blocks<&issue_floor_kernel<Op>>()) *
      sm_count();
  const long long needed = (words + kThreads - 1) / kThreads;
  if (blocks > needed) blocks = needed;
  issue_floor_kernel<Op><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      words, 0x2545f491u, static_cast<uint32_t*>(sink));
}

}  // namespace

// n_in 1: out = a (silu's bytes); 2: out = a ^ b (silu_bwd's). a, b and
// out dense bf16 of n elements, 16-byte aligned.
extern "C" int silu_copy_floor_launch(int n_in, const void* a, const void* b,
                                      void* out, long long n, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  using B = __nv_bfloat16;
  if (n_in == 1)
    launch_stream<&copy_floor_kernel<1, 8, kSlots>, 8, true>(
        Rows<B, 1>{{static_cast<const B*>(a)}, {n}, {1}, static_cast<B*>(out),
                   1, n},
        st);
  else
    launch_stream<&copy_floor_kernel<2, 8, kSlots>, 8, false>(
        Rows<B, 2>{{static_cast<const B*>(a), static_cast<const B*>(b)},
                   {n, n}, {1, 1}, static_cast<B*>(out), 1, n},
        st);
  return static_cast<int>(cudaGetLastError());
}

// kind 0: silu's arithmetic on n elements; 1: silu_bwd's. sink: one
// 32-bit word of device memory.
extern "C" int silu_issue_floor_launch(int kind, long long n, void* sink,
                                       void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    issue_floor<Silu2>(n, sink, st);
  else
    issue_floor<SiluBwd2>(n, sink, st);
  return static_cast<int>(cudaGetLastError());
}
