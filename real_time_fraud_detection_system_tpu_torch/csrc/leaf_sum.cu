// Classify-only forest kernel for Hopper (sm_90a): scaled features -> the
// sum over trees of the matched leaf value.
//
// Replaces the TPU kernel `pallas_leaf_sum` / `_leaf_sum_kernel` of
// real_time_fraud_detection_system_tpu/ops/pallas_forest.py (core
// `_tree_block_leaf_sum`). It serves the gbt model (sigmoid(base + sum));
// the forest's step takes the fused kernel, whose admission is the same.
//
// Design. The same descent as the fused kernel (forest_walk.cuh, one
// thread per row, 128 rows per block, ten trees in flight per thread,
// node records read through the read-only path): each thread loads its
// row of x into the block's shared tile, zero-filling the pad columns up
// to Fp, and descends every tree in order. The tile is all the block's
// shared memory, so the depth of the trees does not limit admission
// (ops/forest_kernels.py::admit_tables).
//
// What bounds it. Data in: x, 60 B per row, and the trees (a feature and
// a threshold per internal node, a value per leaf: ~0.3 MB at T=100,
// depth 8); out: 4 B per row. At 65,536 rows that is ~4.5 MB, ~1.3 us at
// 3.35 TB/s. The function needs, per tree and row, one compare per level
// of the path the row takes plus the leaf add (~0.9k per row at T=100,
// depth 8), ~6e7 in all, ~0.9 us at the card's 32-bit rate: bytes bound
// it. The first version walked every node and every leaf's entries
// (~1.7e10 operations; its times are in PERF.md); the descent does the
// ~6e7 the function needs. Far above the bound still: each level is a
// dependent load whose warp scatters over up to 32 lines, and at 65,536
// rows the card holds ~15.5 warps per SM.
//
// Exactness. Built with the fused kernel's flags (no fast math,
// -ftz=false, --fmad=false): decisions and sums match the plain
// gemm_leaf_sum bit for bit, in every z mode.

#include <cuda_runtime.h>
#include <stdint.h>

#include "forest_walk.cuh"

namespace {

struct LeafSumArgs {
  const float* x;  // [B, F] scaled features, F <= Fp
  DescentForest forest;
  float* out;  // [B]
  int B, F, Fp;
};

__global__ void __launch_bounds__(kForestRows) leaf_sum_kernel(LeafSumArgs a) {
  extern __shared__ float xs[];  // [Fp][kForestRows]

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kForestRows + tid;
  const bool live_row = row < a.B;

  for (int f = 0; f < a.Fp; ++f) {
    xs[f * kForestRows + tid] =
        (live_row && f < a.F) ? a.x[(size_t)row * a.F + f] : 0.f;
  }
  const float acc = forest_leaf_sum(a.forest, xs, tid);
  if (live_row) a.out[row] = acc;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block; ops/forest_kernels.py::smem_bytes
// computes the same number for the admission predicate.
int leaf_sum_smem_bytes(int Fp) { return forest_smem_bytes(Fp); }

int leaf_sum_block_rows() { return kForestRows; }

int leaf_sum_trees_in_flight() { return kTreesInFlight; }

int leaf_sum_max_smem() { return kMaxSmem; }

// Launches the kernel on `stream` and returns the CUDA error (0 = ok).
int leaf_sum_launch(const float* x, const int* nodes, const int* depth,
                    float* out, int B, int F, int Fp, int T, int N,
                    void* stream) {
  if (F < 1 || Fp < F) return (int)cudaErrorInvalidValue;
  LeafSumArgs a;
  a.x = x;
  a.forest.nodes = reinterpret_cast<const int4*>(nodes);
  a.forest.depth = depth;
  a.forest.T = T; a.forest.N = N;
  a.out = out;
  a.B = B; a.F = F; a.Fp = Fp;
  const int smem = forest_smem_bytes(Fp);
  const cudaError_t e = forest_launch_setup(leaf_sum_kernel, smem, T, N, B);
  if (e != cudaSuccess) return (int)e;
  leaf_sum_kernel<<<(B + kForestRows - 1) / kForestRows, kForestRows, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
