// The per-row tree descent shared by the two forest kernels
// (fused_forest.cu and leaf_sum.cu).
//
// Device twin of the JAX package's traversal core `_tree_block_leaf_sum`
// (ops/pallas_forest.py), which both of its forest kernels share. The
// Pallas core runs two dense products per tree; here the tables come in
// the descent form ops/forest_kernels.py::to_kernel_tables derives from
// the same dense tables: per tree, its nodes in breadth-first order from
// the root (node 0), each one 16-byte record
//
//   {feature, threshold bits, left child, right child}
//
// where a leaf is {0, value bits, itself, itself}, and the tree's depth.
// Per tree and row the walk descends from the root, `depth` times
//
//   node = x[feature] <= threshold ? left : right,
//
// the same gather and the same IEEE compare as the dense form's
// d = proj <= thresh, and then reads the value of the leaf it stands on.
// That is the function's own work: one compare per level of the row's
// path (the old walk evaluated all Ip nodes and rebuilt z for all Lp
// leaves of every tree, ~1.7e10 operations per 65,536 rows at T=100,
// depth 8, against ~5.9e7 here).
//
// Level-synchronous: every tree runs its full depth and a row that lands
// on a shallower leaf loops on it, so the lanes of a warp never diverge
// in the loop (the trip count is uniform). Each thread walks
// kTreesInFlight trees at once as independent chains of dependent loads,
// which hides the load latency, and then adds their values to its sum
// one after another, so the trees are added in order t = 0..T-1 as the
// plain models/forest.py::gemm_leaf_sum adds them: the two agree bit for
// bit, in every z mode (the descent tables do not depend on it).
//
// The node records are read through the read-only data path (__ldg) from
// device memory: L2 holds the whole forest (~0.8 MB at T=100, depth 8)
// and L1 the trees in use, with no barrier and no copy. A block's shared
// memory holds only its scaled feature tile, so the trees' size never
// limits admission. Staging groups of trees in shared memory with
// cp.async was measured too and saved ~0.04 ms per 65,536-row batch,
// which no path shows end to end; ten trees in flight took the fused
// kernel from ~0.29 to ~0.17 ms at that size (tools/torch_walk_forms.py
// times this form against others; PERF.md, section 6).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Rows (threads) per block; BLOCK_ROWS in ops/forest_kernels.py.
constexpr int kForestRows = 128;
// Trees each thread walks at once; TREES_IN_FLIGHT in
// ops/forest_kernels.py. The tree count is padded to a multiple of 10.
constexpr int kTreesInFlight = 10;
// The most dynamic shared memory a block of an sm_90 kernel may opt in to.
constexpr int kMaxSmem = 227 * 1024;

// A forest in the descent form (ops/forest_kernels.py::ForestTables).
struct DescentForest {
  const int4* nodes;  // [T, N] {feature, threshold bits, left, right}
  const int* depth;   // [T] trip count of each tree's descent
  int T, N;           // T % kTreesInFlight == 0
};

// Shared-memory bytes of one block: the scaled feature tile [Fp][rows].
// ops/forest_kernels.py::smem_bytes computes the same number for the
// admission predicate.
__host__ __device__ inline int forest_smem_bytes(int Fp) {
  return kForestRows * Fp * 4;
}

// Sum over trees t = 0..T-1, in order, of the value of the leaf that this
// thread's row reaches. `xs` is the block's scaled feature tile
// [Fp][kForestRows]; the thread reads its own column only.
__device__ __forceinline__ float forest_leaf_sum(const DescentForest& f,
                                                 const float* xs, int tid) {
  float acc = 0.f;
  for (int t0 = 0; t0 < f.T; t0 += kTreesInFlight) {
    const int4* root[kTreesInFlight];
    const int4* at[kTreesInFlight];
    int steps = 0;
#pragma unroll
    for (int k = 0; k < kTreesInFlight; ++k) {
      root[k] = at[k] = f.nodes + (size_t)(t0 + k) * f.N;
      steps = max(steps, __ldg(f.depth + t0 + k));
    }
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < kTreesInFlight; ++k) {
        const int4 n = __ldg(at[k]);
        const float v = xs[n.x * kForestRows + tid];
        at[k] = root[k] + (v <= __int_as_float(n.y) ? n.z : n.w);
      }
    }
#pragma unroll
    for (int k = 0; k < kTreesInFlight; ++k) {
      acc += __int_as_float(__ldg(&at[k]->y));
    }
  }
  return acc;
}

// Checks a launch's shape and opts `kernel` in to more than the default
// 48 KB of dynamic shared memory where it needs it. Returns the CUDA error
// (0 = ok).
template <typename Kernel>
inline cudaError_t forest_launch_setup(Kernel kernel, int smem, int T,
                                       int N, int B) {
  if (B < 1 || N < 1 || T < kTreesInFlight || T % kTreesInFlight != 0 ||
      smem > kMaxSmem) {
    return cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  return cudaSuccess;
}
