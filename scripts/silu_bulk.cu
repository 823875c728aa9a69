// The 1-D bulk-copy form of the bf16 SiLU kernels of
// src/repro_torch/csrc/silu.cu, for timing beside them
// (scripts/silu_forms.py builds it with the same nvcc flags; the port
// does not use it): one producer warp a block copies tiles of each input
// with cp.async.bulk into a ring of shared memory, completing on an
// mbarrier a slot; eight consumer warps read a tile's 16-byte pieces,
// release the slot, run the same arithmetic (Silu2, SiluBwd2) and store
// the output from registers. A flat, dense, 16-byte aligned range of n
// elements, as the SSM's calls are; a persistent grid over the tiles.
#include "../src/repro_torch/csrc/silu.cu"

namespace {

constexpr int kTile = 4096;    // elements of each input a tile
constexpr int kStages = 4;     // tiles in flight a block
constexpr int kConsumers = 8;  // warps

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n\t.reg .pred p;\n"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
      "@!p bra WAIT;\n}" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

template <class Op>
__global__ void __launch_bounds__((kConsumers + 1) * 32)
silu_bulk_kernel(const Rows<__nv_bfloat16, Op::kIn> s) {
  constexpr int N = Op::kIn;
  constexpr int kPer = kTile / 8 / (kConsumers * 32);  // pieces a thread
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(smem + kStages * N * kTile * 2);
  unsigned long long* empty = full + kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long n8 = s.d & ~7LL;  // bulk copies move 16-byte multiples
  const long long tiles = (n8 + kTile - 1) / kTile;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  long long i = 0;
  if (warp == kConsumers) {
    if (lane == 0)
      for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int st = static_cast<int>(i % kStages);
        const unsigned round = static_cast<unsigned>(i / kStages);
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        const long long off = t * kTile;
        const long long e = n8 - off < kTile ? n8 - off : kTile;
        const unsigned bytes = static_cast<unsigned>(e * 2);
        mbar_expect_tx(&full[st], N * bytes);
        for (int k = 0; k < N; ++k)
          bulk_load(ring + (st * N + k) * kTile, s.in[k] + off, bytes,
                    &full[st]);
      }
    return;
  }
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int st = static_cast<int>(i % kStages);
    mbar_wait(&full[st], static_cast<unsigned>(i / kStages) & 1);
    const long long off = t * kTile;
    const long long e = n8 - off < kTile ? n8 - off : kTile;
    Words<8> v[kPer][N];
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int piece = threadIdx.x + p * kConsumers * 32;
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (piece * 8 < e) {
          const uint4 q = *reinterpret_cast<const uint4*>(
              ring + (st * N + k) * kTile + piece * 8);
          v[p][k].w[0] = q.x, v[p][k].w[1] = q.y, v[p][k].w[2] = q.z,
          v[p][k].w[3] = q.w;
        }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int piece = threadIdx.x + p * kConsumers * 32;
      if (piece * 8 < e)
        store<8, Op::kEvictFirst>(s.out + off + piece * 8,
                                  apply_slot<Op, 8>(v[p]));
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < s.d - n8) {
    const long long c = n8 + threadIdx.x;
    uint32_t args[N];
    for (int k = 0; k < N; ++k) args[k] = bits_of(s.in[k][c]);
    s.out[c] = __ushort_as_bfloat16(
        static_cast<unsigned short>(Op::apply(args)));
  }
}

template <class Op>
void silu_bulk(Rows<__nv_bfloat16, Op::kIn> s, cudaStream_t st) {
  constexpr int threads = (kConsumers + 1) * 32;
  constexpr int smem = kStages * Op::kIn * kTile * 2 + 2 * kStages * 8;
  static const int per_sm = [] {
    cudaFuncSetAttribute(silu_bulk_kernel<Op>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int b = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, silu_bulk_kernel<Op>,
                                                  threads, smem);
    return b > 0 ? b : 1;
  }();
  const long long tiles = ((s.d & ~7LL) + kTile - 1) / kTile;
  long long blocks = static_cast<long long>(per_sm) * sm_count();
  if (blocks > tiles) blocks = tiles;
  if (blocks < 1) blocks = 1;
  silu_bulk_kernel<Op>
      <<<static_cast<unsigned>(blocks), threads, smem, st>>>(s);
}

}  // namespace

// kind 0: out = silu(a); 1: out = silu_bwd(g = a, x = b). a, b and out
// dense bf16 of n elements, 16-byte aligned. Returns cudaGetLastError().
extern "C" int silu_bulk_launch(int kind, const void* a, const void* b,
                                void* out, long long n, void* stream) {
  using B = __nv_bfloat16;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 0)
    silu_bulk<Silu2>({{static_cast<const B*>(a)}, {n}, {1},
                      static_cast<B*>(out), 1, n}, st);
  else
    silu_bulk<SiluBwd2>({{static_cast<const B*>(a), static_cast<const B*>(b)},
                         {n, n}, {1, 1}, static_cast<B*>(out), 1, n}, st);
  return static_cast<int>(cudaGetLastError());
}
