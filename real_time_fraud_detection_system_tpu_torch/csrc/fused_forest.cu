// Fused featurize -> forest kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_forest_leaf_sum` / `_fused_forest_kernel`
// of real_time_fraud_detection_system_tpu/ops/pallas_forest.py (its feature
// half is `assemble_features` in ops/pallas_kernels.py, its traversal core
// `_tree_block_leaf_sum`). Per row it computes the same function, from the
// feature-state tables instead of a gathered copy of their rows:
//
//   customer rows (bd, cnt, amt) and terminal rows (bd, cnt, frd), read by
//   slot from the tables
//   -> the 15 raw features (age-mask windows, terminal delay, weekend and
//      night flags), written out                         (features.cuh)
//   -> standardized (x - mean) / scale, kept in shared memory
//   -> for each tree t, the value of the leaf the row reaches, added in
//      tree order                                        (forest_walk.cuh)
//
// Design. One thread per row, 128 rows per block. The Pallas kernel runs
// the traversal as two dense products per tree ([B,16]x[16,I] and
// [B,I]x[I,L]); on CUDA cores that is ~8.6e11 multiply-adds per 65,536-row
// batch at T=100, depth 8. Both tables are extremely sparse, so the host
// derives a per-tree node table from them once
// (ops/forest_kernels.py::to_kernel_tables) and each row descends each
// tree (forest_walk.cuh): one node load through the read-only path and
// one compare per level. The scaled feature tile never leaves shared
// memory. The feature half reads each row's runs by slot from the
// feature-state tables, a 32-byte sector at a time (features.cuh, shared
// with the fused logreg kernel), so the block's shared memory is still
// the feature tile alone.
//
// What bounds it. The function starts from the tables: per distinct slot
// of the batch, three arrays of NB words (~7.2 MB for the ~5,000
// customers and ~10,000 terminals a 65,536-row batch of the default
// dataset reaches), plus the slots and 12 B of scalars per row, the trees,
// and 64 B out per row (15 features + the leaf sum): ~13 MB, ~4 us at
// 3.35 TB/s. The function itself needs few operations: ~1k per row for
// the features and, per tree, one compare per level of the path the row
// takes plus the leaf add (~0.9k per row at T=100, depth 8), ~1.2e8 in
// all, ~2 us at the card's 32-bit rate. So the function is memory-bound
// at ~4 us per 65,536 rows. The first version of this kernel evaluated
// every node and walked every leaf's entries of every tree (~1.7e10
// operations; its times are in PERF.md), restaging each tree's tables in
// shared memory behind two barriers; the descent does the ~5.9e7 the
// function needs, with no barrier, and keeps ten trees' chains of
// dependent loads in flight per thread. What remains between it and the
// bound: the node loads of a warp scatter over up to 32 lines at the deep
// levels, and at 65,536 rows a card of 132 SMs holds only ~15.5 warps per
// SM.
//
// Exactness. Decisions must match the plain PyTorch path bit for bit, so
// this file is built without --use_fast_math, with the defaults
// -prec-div=true (IEEE division in the feature averages and the
// standardization) and -ftz=false (denormals compare as they are; see
// models/forest.py::ftz_safe_thresholds), and with --fmad=false so no
// product is contracted into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include "features.cuh"
#include "forest_walk.cuh"

namespace {

struct FusedForestArgs {
  FeatureArgs in;
  const float* mean;   // [F]
  const float* scale;  // [F]
  DescentForest forest;
  float* leaf_sum;  // [B]
  float* feats;     // [B, F]
  int F, Fp;
};

__global__ void __launch_bounds__(kForestRows)
fused_forest_kernel(FusedForestArgs a) {
  extern __shared__ float xs[];  // [Fp][kForestRows]

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kForestRows + tid;
  const bool live_row = row < a.in.B;

  for (int f = 0; f < a.Fp; ++f) xs[f * kForestRows + tid] = 0.f;

  // ---- 1. features, written out and standardized into the tile (every
  // thread of a warp reads rows; one past the batch emits nothing)
  float* frow = a.feats + (size_t)row * a.F;
  row_features(a.in, row, [&](int f, float v) {
    frow[f] = v;
    xs[f * kForestRows + tid] = (v - a.mean[f]) / a.scale[f];
  });

  // ---- 2. trees, in order t = 0..T-1 (the thread reads its own column
  // of the tile)
  const float acc = forest_leaf_sum(a.forest, xs, tid);
  if (live_row) a.leaf_sum[row] = acc;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block; ops/forest_kernels.py::smem_bytes
// computes the same number for the admission predicate.
int fused_forest_smem_bytes(int Fp) { return forest_smem_bytes(Fp); }

int fused_forest_block_rows() { return kForestRows; }

int fused_forest_trees_in_flight() { return kTreesInFlight; }

int fused_forest_max_smem() { return kMaxSmem; }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
int fused_forest_launch(
    const int* c_bd, const float* c_cnt, const float* c_amt,
    const int* t_bd, const float* t_cnt, const float* t_frd,
    const long long* c_slot, const long long* t_slot,
    const int* day, const int* tod, const float* amount,
    const float* mean, const float* scale,
    const int* nodes, const int* depth,
    float* leaf_sum, float* feats,
    int B, int NB, int T, int N, int F, int Fp,
    int n_win, int w0, int w1, int w2, int w3,
    int delay, int weekend_start, int night_end,
    void* stream) {
  if (n_win < 1 || n_win > kMaxWindows || F != 3 + 4 * n_win || Fp < F ||
      NB < 1) {
    return (int)cudaErrorInvalidValue;
  }
  FusedForestArgs a;
  a.in.c_bd = c_bd; a.in.c_cnt = c_cnt; a.in.c_amt = c_amt;
  a.in.t_bd = t_bd; a.in.t_cnt = t_cnt; a.in.t_frd = t_frd;
  a.in.c_slot = c_slot; a.in.t_slot = t_slot;
  a.in.day = day; a.in.tod = tod; a.in.amount = amount;
  a.in.B = B; a.in.NB = NB;
  a.in.n_win = n_win;
  a.in.win[0] = w0; a.in.win[1] = w1; a.in.win[2] = w2; a.in.win[3] = w3;
  a.in.delay = delay;
  a.in.weekend_start = weekend_start;
  a.in.night_end = night_end;
  a.mean = mean; a.scale = scale;
  a.forest.nodes = reinterpret_cast<const int4*>(nodes);
  a.forest.depth = depth;
  a.forest.T = T; a.forest.N = N;
  a.leaf_sum = leaf_sum; a.feats = feats;
  a.F = F; a.Fp = Fp;
  const int smem = forest_smem_bytes(Fp);
  const cudaError_t e = forest_launch_setup(fused_forest_kernel, smem, T, N, B);
  if (e != cudaSuccess) return (int)e;
  fused_forest_kernel<<<(B + kForestRows - 1) / kForestRows, kForestRows,
                        smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
