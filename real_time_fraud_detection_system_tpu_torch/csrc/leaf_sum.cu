// Classify-only forest kernel for Hopper (sm_90a): scaled features -> the
// sum over trees of the matched leaf value.
//
// Replaces the TPU kernel `pallas_leaf_sum` / `_leaf_sum_kernel` of
// real_time_fraud_detection_system_tpu/ops/pallas_forest.py (core
// `_tree_block_leaf_sum`). It serves the gbt model (sigmoid(base + sum))
// and the forest's unfused step (sum / n_trees) when the fused kernel does
// not admit the tables.
//
// Design. The same walk as the fused kernel (forest_walk.cuh, one thread
// per row, 128 rows per block, each tree's tables staged in shared memory,
// decisions as bit words): each thread loads its row of x into the block's
// shared tile, zero-filling the pad columns up to Fp, and walks every tree
// in order. The block's shared memory grows with the tables (Ip and Lp),
// so this kernel opts in to up to 227 KB, past the 48 KB default: it
// admits trees of depth up to 12, which the fused kernel refuses
// (ops/forest_kernels.py::admit_leaf_sum).
//
// What bounds it. Data in: x, 60 B per row, and the compact tables
// (~1.2 MB at T=100, depth 8); out: 4 B per row. At 65,536 rows that is
// ~5.4 MB, ~1.6 us at 3.35 TB/s. The function needs, per tree and row, one
// compare per level of the path the row takes plus the leaf add (~0.9k
// per row at T=100, depth 8), ~6e7 in all, ~0.9 us at the card's 32-bit
// rate: bytes bound it. The walk does far more (~2.6k integer operations
// per tree per row: every node, every leaf's entries), as the fused kernel
// does; a per-row descent is later work.
//
// Exactness. Built with the fused kernel's flags (no fast math,
// -ftz=false, --fmad=false): decisions and sums match the plain
// gemm_leaf_sum bit for bit, in every z mode.

#include <cuda_runtime.h>
#include <stdint.h>

#include "forest_walk.cuh"

namespace {

// The most dynamic shared memory a block of an sm_90 kernel may opt in to.
constexpr int kMaxSmem = 227 * 1024;

struct LeafSumArgs {
  const float* x;  // [B, F] scaled features, F <= Fp
  CompactForest forest;
  float* out;  // [B]
  int B, F, Fp;
};

__global__ void __launch_bounds__(kForestRows) leaf_sum_kernel(LeafSumArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);  // [Fp][rows]

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kForestRows + tid;
  const bool live_row = row < a.B;

  for (int f = 0; f < a.Fp; ++f) {
    xs[f * kForestRows + tid] =
        (live_row && f < a.F) ? a.x[(size_t)row * a.F + f] : 0.f;
  }
  const float acc = forest_leaf_sum(a.forest, xs, a.Fp, tid);
  if (live_row) a.out[row] = acc;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block; ops/forest_kernels.py::smem_bytes
// computes the same number for admit_leaf_sum.
int leaf_sum_smem_bytes(int Fp, int Ip, int Lp) {
  return forest_smem_bytes(Fp, Ip, Lp);
}

int leaf_sum_block_rows() { return kForestRows; }

int leaf_sum_max_smem() { return kMaxSmem; }

// Launches the kernel on `stream` and returns the CUDA error (0 = ok).
int leaf_sum_launch(const float* x, const int* node_feat,
                    const float* node_thresh, const int* leaf_entries,
                    const int* leaf_target, const float* leaf_value,
                    float* out, int B, int F, int Fp, int T, int Ip, int Lp,
                    int D, void* stream) {
  const int smem = forest_smem_bytes(Fp, Ip, Lp);
  if (F < 1 || Fp < F || Ip % 32 != 0 || B < 1 || D < 4 || D % 4 != 0 ||
      smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        leaf_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  LeafSumArgs a;
  a.x = x;
  a.forest.node_feat = node_feat; a.forest.node_thresh = node_thresh;
  a.forest.leaf_entries = leaf_entries; a.forest.leaf_target = leaf_target;
  a.forest.leaf_value = leaf_value;
  a.forest.T = T; a.forest.Ip = Ip; a.forest.Lp = Lp; a.forest.D = D;
  a.out = out;
  a.B = B; a.F = F; a.Fp = Fp;

  const int grid = (B + kForestRows - 1) / kForestRows;
  leaf_sum_kernel<<<grid, kForestRows, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
