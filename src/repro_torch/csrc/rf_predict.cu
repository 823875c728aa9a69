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
// What bounds it on this card: not arithmetic (a compare per level)
// and not bytes (the paper's 100-tree, depth-10 forest is 1.23 MB,
// far inside the 50 MB L2), but the latency of dependent loads: one
// sample visits T*depth nodes, and each level's node index depends on
// the previous level's load. One thread per sample would serialise
// 1,000 loads per thread at only ~192 rows per fleet tick.
//
// What the design does about it: one thread per (sample, tree) pair,
// so the dependent chain is `depth` loads long and T chains run side
// by side. The forest is read through the read-only path (__ldg) and
// stays resident in L2 across launches; it does not fit in one block's
// shared memory at 100x10, so no block stages it. The sample rows sit
// in shared memory (indexed by a data-dependent feature), and each
// pair writes its leaf value to shared memory; one thread per sample
// then sums its T values in tree order, which keeps the bits equal to
// the reference.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
rf_predict_kernel(const int* __restrict__ feat,     // [T, 2^d-1]
                  const float* __restrict__ thr,    // [T, 2^d-1]
                  const float* __restrict__ leaf,   // [T, 2^d]
                  const float* __restrict__ x,      // [n, F]
                  float* __restrict__ out,          // [n]
                  int n, int n_feat, int n_trees, int depth,
                  int samples_per_block, float inv_trees) {
  extern __shared__ float smem[];
  float* xs = smem;                                      // [spb, F]
  float* vals = smem + samples_per_block * n_feat;       // [spb, T]
  const int s0 = blockIdx.x * samples_per_block;
  const int ns = min(samples_per_block, n - s0);
  const int n_int = (1 << depth) - 1;

  for (int i = threadIdx.x; i < ns * n_feat; i += blockDim.x)
    xs[i] = x[static_cast<size_t>(s0) * n_feat + i];
  __syncthreads();

  // one (sample, tree) pair per thread: a chain of `depth` loads
  for (int p = threadIdx.x; p < ns * n_trees; p += blockDim.x) {
    const int s = p / n_trees;
    const int t = p - s * n_trees;
    const int* ft = feat + static_cast<size_t>(t) * n_int;
    const float* tt = thr + static_cast<size_t>(t) * n_int;
    const float* xr = xs + s * n_feat;
    int node = 0;
    for (int level = 0; level < depth; ++level) {
      const int f = max(__ldg(ft + node), 0);
      const float xv = f < n_feat ? xr[f] : 0.0f;
      node = 2 * node + 1 + (xv > __ldg(tt + node) ? 1 : 0);
    }
    vals[p] = __ldg(leaf + static_cast<size_t>(t) * (n_int + 1) +
                    (node - n_int));
  }
  __syncthreads();

  // per-sample sum in tree order, then the f32 reciprocal multiply;
  // the _rn intrinsics keep the compiler from contracting into an FMA
  for (int s = threadIdx.x; s < ns; s += blockDim.x) {
    const float* v = vals + s * n_trees;
    float acc = 0.0f;
    for (int t = 0; t < n_trees; ++t) acc = __fadd_rn(acc, v[t]);
    out[s0 + s] = __fmul_rn(acc, inv_trees);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 = launched).
// The caller checks shapes, types, contiguity and the shared-memory
// size: samples_per_block * (n_feat + n_trees) * 4 bytes <= 48 KB.
extern "C" int rf_predict_launch(const void* feat, const void* thr,
                                 const void* leaf, const void* x, void* out,
                                 int n, int n_feat, int n_trees, int depth,
                                 int samples_per_block, float inv_trees,
                                 void* stream) {
  const int blocks = (n + samples_per_block - 1) / samples_per_block;
  const size_t smem = static_cast<size_t>(samples_per_block) *
                      (n_feat + n_trees) * sizeof(float);
  rf_predict_kernel<<<blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(feat), static_cast<const float*>(thr),
      static_cast<const float*>(leaf), static_cast<const float*>(x),
      static_cast<float*>(out), n, n_feat, n_trees, depth,
      samples_per_block, inv_trees);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rf_predict_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int rf_predict_threads() { return kThreads; }
