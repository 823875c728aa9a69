// Random-forest ensemble inference over complete binary trees, for
// Hopper (sm_90a).
//
// Replaces the JAX package's TPU kernel
// src/repro/kernels/rf_predict.py::rf_predict_pallas (body _rf_kernel),
// and computes exactly what it computes: each sample descends `depth`
// levels of every tree (node -> 2*node+1+(x[max(feat,0)] > thr)); the
// leaf values are summed over trees IN TREE ORDER in f32, and the sum
// is multiplied by the f32 reciprocal of T (XLA rewrites the TPU
// kernel's `acc / n_trees` into that multiply, so a divide here would
// differ in the last bit). A feature index past the row reads 0, as
// the TPU kernel's one-hot select does.
//
// What bounds it on this card. Not arithmetic (a compare per level)
// and not device-memory bytes (the paper's 100-tree, depth-10 forest is
// 0.8 MB of nodes and 0.4 MB of leaves, resident in the 50 MB L2), but
// its gathers: one sample visits T*depth nodes, each level's node index
// depends on the previous level's load, and the L1/L2 path serves a
// warp's load one line or sector at a time, so a load whose 32 lanes
// read 32 unrelated nodes costs 32 times one whose lanes share a node.
//
// The nodes are 8 bytes, {int32 feat, f32 thr} (kernels/rf_predict.py::
// pack_nodes builds the [T, 2^d-1, 2] int32 layout once per forest), so
// a level is one load, not two. Two kernels share that layout:
//
//  * rf_tile_kernel, for a batch: lanes are samples. A block takes a
//    tile of 32 samples (a persistent grid loops over the tiles); its
//    warp w walks trees w, w+W, ... for the 32, kIlp trees side by side,
//    so kIlp dependent chains are in flight and the upper levels' loads
//    are broadcasts (at level l the lanes touch at most min(2^l, 32)
//    nodes) where one thread per (sample, tree) reads 32 trees' nodes.
//    The walks write their leaf values to shared memory as [T][32]; one
//    warp then adds each sample's T values in tree order, deferred by a
//    tile so that it overlaps the next tile's walks. The tile's rows
//    sit in shared memory at an odd stride (no bank conflicts) with a
//    zero column at F that a feature index past the row reads, copied
//    one tile ahead by cp.async. (One block a tile, without the loop, measured slower
//    on the card; PERF.md, rf_predict.)
//  * rf_pair_kernel, for a few tiles (the first design, on the packed
//    nodes): one thread per (sample, tree) pair, so the dependent chain
//    is `depth` loads long and every tree runs side by side; at a
//    handful of tiles that chain, not the gathers' traffic, is the time.
//
// Tried on the card and dropped (PERF.md, rf_predict): staging the trees'
// top levels, or whole trees, in shared memory (the deep levels' gathers
// carry the time, and a block holding part of the forest needs the
// others' leaf values), and splitting a tile's trees over the blocks of
// a cluster or over blocks that meet at a counter (the per-tile barrier
// or fence cost more than the walks it joined).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;            // samples a tile: one per lane
constexpr int kMaxThreads = 1024;
constexpr int kIlp = 4;              // trees a warp walks side by side
constexpr int kPairThreads = 256;
constexpr int kMaxDevices = 16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from global to shared without holding the thread (cp.async);
// `valid` false writes a zero instead
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_done() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// starts copying tile `tile`'s rows into xs (kTile x xs_stride; zero
// past the row and past n); copies_done() and a barrier complete it
__device__ __forceinline__ void load_rows(const float* __restrict__ x,
                                          float* xs, int tile, int n,
                                          int n_feat, int xs_stride) {
  const int s0 = tile * kTile;
  for (int i = threadIdx.x; i < kTile * xs_stride; i += blockDim.x) {
    const int r = i / xs_stride;
    const int c = i - r * xs_stride;
    const bool valid = c < n_feat && s0 + r < n;
    copy4(xs + i, valid ? x + static_cast<size_t>(s0 + r) * n_feat + c : x,
          valid);
  }
}

// one level: node -> 2*node+1+(x[min(max(feat,0),F)] > thr), where
// x[F] is the zero column
__device__ __forceinline__ int step(int node, int2 nd, const float* xrow,
                                    int n_feat) {
  const int f = min(max(nd.x, 0), n_feat);
  return 2 * node + 1 + (xrow[f] > __int_as_float(nd.y) ? 1 : 0);
}

// a tile's sum, one sample a lane, in tree order; the _rn intrinsics
// keep the compiler from contracting into an FMA
__device__ __forceinline__ void sum_tile(const float* vals, float* out,
                                         int tile, int n, int n_trees,
                                         float inv_trees, int lane) {
  float acc = 0.0f;
  for (int t = 0; t < n_trees; ++t)
    acc = __fadd_rn(acc, vals[t * kTile + lane]);
  const int s = tile * kTile + lane;
  if (s < n) out[s] = __fmul_rn(acc, inv_trees);
}

// shared memory: vals [2][T][32] f32, then rows [2][32][xs_stride] f32
__global__ void __launch_bounds__(kMaxThreads)
rf_tile_kernel(const int2* __restrict__ nodes,   // [T, 2^d-1] {feat, thr}
               const float* __restrict__ leaf,   // [T, 2^d]
               const float* __restrict__ x,      // [n, F]
               float* __restrict__ out,          // [n]
               int n, int n_feat, int n_trees, int depth, int xs_stride,
               float inv_trees) {
  extern __shared__ __align__(16) float smem[];
  float* vals = smem;
  float* xs = smem + 2 * n_trees * kTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const long long n_int = (1LL << depth) - 1;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int sum_warp = n_warps - 1;          // it has the fewest trees

  if (static_cast<int>(blockIdx.x) < n_tiles)
    load_rows(x, xs, blockIdx.x, n, n_feat, xs_stride);
  copies_done();
  __syncthreads();

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int b = it & 1;
    // the next tile's rows, one tile ahead (that buffer's last readers
    // passed the previous barrier)
    if (tile + static_cast<int>(gridDim.x) < n_tiles)
      load_rows(x, xs + (b ^ 1) * kTile * xs_stride, tile + gridDim.x, n,
                n_feat, xs_stride);
    const float* xrow = xs + (b * kTile + lane) * xs_stride;
    float* vb = vals + b * n_trees * kTile + lane;
    for (int j0 = warp; j0 < n_trees; j0 += kIlp * n_warps) {
      int node[kIlp], t[kIlp];
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        // a slot past the last tree walks slot 0's tree again (the same
        // addresses, so its loads hit L1) and writes nothing
        t[i] = j0 + i * n_warps < n_trees ? j0 + i * n_warps : j0;
        node[i] = 0;
      }
      for (int lv = 0; lv < depth; ++lv) {
#pragma unroll
        for (int i = 0; i < kIlp; ++i)
          node[i] = step(node[i], __ldg(nodes + t[i] * n_int + node[i]),
                         xrow, n_feat);
      }
#pragma unroll
      for (int i = 0; i < kIlp; ++i) {
        const float v = __ldg(leaf + t[i] * (n_int + 1) + (node[i] - n_int));
        if (j0 + i * n_warps < n_trees) vb[t[i] * kTile] = v;
      }
    }
    // the previous tile's sum, while the other warps walk this one
    if (warp == sum_warp && it > 0)
      sum_tile(vals + (b ^ 1) * n_trees * kTile, out, tile - gridDim.x, n,
               n_trees, inv_trees, lane);
    copies_done();
    __syncthreads();
  }
  if (warp == sum_warp && it > 0)
    sum_tile(vals + ((it - 1) & 1) * n_trees * kTile, out,
             blockIdx.x + (it - 1) * gridDim.x, n, n_trees, inv_trees, lane);
}

// shared memory: rows [spb][F], then vals [spb][T]
__global__ void __launch_bounds__(kPairThreads)
rf_pair_kernel(const int2* __restrict__ nodes,   // [T, 2^d-1] {feat, thr}
               const float* __restrict__ leaf,   // [T, 2^d]
               const float* __restrict__ x,      // [n, F]
               float* __restrict__ out,          // [n]
               int n, int n_feat, int n_trees, int depth,
               int samples_per_block, float inv_trees) {
  extern __shared__ float psmem[];
  float* xs = psmem;
  float* vals = psmem + samples_per_block * n_feat;
  const int s0 = blockIdx.x * samples_per_block;
  const int ns = min(samples_per_block, n - s0);
  const long long n_int = (1LL << depth) - 1;

  for (int i = threadIdx.x; i < ns * n_feat; i += blockDim.x)
    xs[i] = __ldg(x + static_cast<size_t>(s0) * n_feat + i);
  __syncthreads();

  for (int p = threadIdx.x; p < ns * n_trees; p += blockDim.x) {
    const int s = p / n_trees;
    const int t = p - s * n_trees;
    const int2* nt = nodes + t * n_int;
    const float* xr = xs + s * n_feat;
    int node = 0;
    for (int level = 0; level < depth; ++level) {
      const int2 nd = __ldg(nt + node);
      const int f = max(nd.x, 0);
      const float xv = f < n_feat ? xr[f] : 0.0f;
      node = 2 * node + 1 + (xv > __int_as_float(nd.y) ? 1 : 0);
    }
    vals[p] = __ldg(leaf + t * (n_int + 1) + (node - n_int));
  }
  __syncthreads();

  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const float* v = vals + s * n_trees;
    float acc = 0.0f;
    for (int t = 0; t < n_trees; ++t) acc = __fadd_rn(acc, v[t]);
    out[s0 + s] = __fmul_rn(acc, inv_trees);
  }
}

// A measurement yardstick, not part of the prediction: the port never
// launches it. Replayed in a graph (chip_smoke.py's launch_floor_ms), its
// time is the launch floor that a call at a handful of tiles is read
// against.
__global__ void empty_kernel() {}

size_t tile_smem(int n_trees, int xs_stride) {
  return static_cast<size_t>(2) * (n_trees + xs_stride) * kTile *
         sizeof(float);
}

// blocks of rf_tile_kernel that run at once on the current device at
// this shape (cached per device and shape); negative: a CUDA error. The
// kernel's dynamic shared memory limit is raised once per device to the
// card's opt-in maximum (never lowered: a lower limit set for one
// forest would refuse a later, larger one). quantize.cu has its own
// helper with one entry a device, because its kernel's block and shared
// memory are fixed; here both vary with the forest, and each source
// builds into a library of its own (kernels/build.py hashes only the
// source), so the two share no header.
int coresident_blocks(size_t smem, int threads) {
  struct Entry { size_t smem; int threads, blocks; };
  constexpr int kEntries = 16;
  static Entry cache[kMaxDevices][kEntries] = {};
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  Entry* row = dev < kMaxDevices ? cache[dev] : nullptr;
  if (row)
    for (int i = 0; i < kEntries; ++i)
      if (row[i].blocks > 0 && row[i].smem == smem &&
          row[i].threads == threads)
        return row[i].blocks;
  if (dev >= kMaxDevices || !opted_in[dev]) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(rf_tile_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e != cudaSuccess) return -static_cast<int>(e);
    if (dev < kMaxDevices) opted_in[dev] = true;
  }
  int per_sm = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, rf_tile_kernel,
                                                    threads, smem);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  if (per_sm * sms <= 0)
    return -static_cast<int>(cudaErrorInvalidConfiguration);
  if (row) {
    int i = 0;
    while (i < kEntries - 1 && row[i].blocks > 0) ++i;
    row[i] = {smem, threads, per_sm * sms};
  }
  return per_sm * sms;
}

}  // namespace

// Launches the tile kernel (blocks of `warps` warps; as many as run at
// once, at most one a tile) on `stream`; returns a cudaError_t (0 =
// launched). The
// caller checks shapes, types, contiguity, 1 <= warps <= 32 and that
// 2 * (T + ((F + 1) | 1)) * 32 * 4 bytes of shared memory fit a block.
extern "C" int rf_predict_tile_launch(const void* nodes, const void* leaf,
                                      const void* x, void* out, int n,
                                      int n_feat, int n_trees, int depth,
                                      int warps, float inv_trees,
                                      void* stream) {
  const int xs_stride = (n_feat + 1) | 1;
  const size_t smem = tile_smem(n_trees, xs_stride);
  const int threads = 32 * warps;
  const int cores = coresident_blocks(smem, threads);
  if (cores < 0) return -cores;
  const int n_tiles = (n + kTile - 1) / kTile;
  const int blocks = n_tiles < cores ? n_tiles : cores;
  rf_tile_kernel<<<blocks, threads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(nodes), static_cast<const float*>(leaf),
      static_cast<const float*>(x), static_cast<float*>(out), n, n_feat,
      n_trees, depth, xs_stride, inv_trees);
  return static_cast<int>(cudaGetLastError());
}

// Launches the pair kernel (256 threads a block, samples_per_block
// samples each) on `stream`; returns cudaGetLastError(). The caller
// checks shapes, types, contiguity and the shared memory:
// samples_per_block * (n_feat + n_trees) * 4 <= 48 KB.
extern "C" int rf_predict_pair_launch(const void* nodes, const void* leaf,
                                      const void* x, void* out, int n,
                                      int n_feat, int n_trees, int depth,
                                      int samples_per_block, float inv_trees,
                                      void* stream) {
  const int blocks = (n + samples_per_block - 1) / samples_per_block;
  const size_t smem = static_cast<size_t>(samples_per_block) *
                      (n_feat + n_trees) * sizeof(float);
  rf_pair_kernel<<<blocks, kPairThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(nodes), static_cast<const float*>(leaf),
      static_cast<const float*>(x), static_cast<float*>(out), n, n_feat,
      n_trees, depth, samples_per_block, inv_trees);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rf_predict_pair_threads() { return kPairThreads; }

extern "C" const char* rf_predict_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// One launch of the empty kernel (the launch-floor yardstick) on
// `stream`; returns cudaGetLastError().
extern "C" int rf_predict_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
