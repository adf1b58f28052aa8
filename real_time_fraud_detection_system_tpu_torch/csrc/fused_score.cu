// Fused featurize -> logistic-regression kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_featurize_score` / `_score_kernel` of
// real_time_fraud_detection_system_tpu/ops/pallas_kernels.py. Per row it
// computes the same function, from the feature-state tables instead of a
// gathered copy of their rows:
//
//   customer rows (bd, cnt, amt) and terminal rows (bd, cnt, frd), read by
//   slot from the tables
//   -> the 15 raw features, written out                  (features.cuh)
//   -> x = (feature - mean) / scale
//   -> z = sum_f x_f * w_f, added in feature order, + b
//   -> sigmoid(z) * valid
//
// Design. One thread per row, 128 rows per block, no shared memory. The
// feature half is the fused forest kernel's own device code
// (features.cuh): each thread reads its own row's runs by slot, a 32-byte
// sector of each array at a time (two back-to-back 16-byte loads where
// NB % 4 == 0, narrower loads otherwise), and adds them in ring order.
// Each feature is standardized and added into z as it comes, so the row's
// features never come back from memory. The 15-wide dot is a loop in the
// thread (no library product); unlike the Pallas kernel, any B is taken
// (the last block masks its ragged edge).
//
// What bounds it. The function starts from the tables: per distinct slot
// of the batch, three arrays of NB words, plus the slots (16 B), 13 B of
// scalars per row, and 64 B out per row (15 features and the probability).
// A 65,536-row batch of the default dataset reaches ~5,000 customers and
// ~10,000 terminals: ~7.2 MB of distinct rows, ~13 MB in all, ~4 us at
// 3.35 TB/s. The operations (~1.1k per row: the window sums, ratios,
// standardization, the dot and the sigmoid) take ~1 us at the card's
// 32-bit rate: bytes bound it. The six arrays a feature reads (11.8 MB at
// the default capacities) stay in the 50 MB L2, so the rows that repeat
// within a batch come from there; the kernel reads 960 B per row through
// L2 either way. Before this design each thread read its row of a
// gathered [B, 40] copy one word at a time (a warp's loads 160 B apart),
// and eight PyTorch row gathers wrote that copy on every batch. Staging
// each warp's rows in shared memory with coalesced cp.async, so that a
// warp instruction reads whole sectors of four rows, measured no faster
// than these per-thread loads (PERF.md, section 6).
//
// Exactness. Built without fast math, with -prec-div=true, -ftz=false and
// --fmad=false: the features and z match the plain version
// (ops/score_kernels.py::fused_featurize_score_plain) bit for bit; the
// sigmoid's expf may differ from PyTorch's by an ulp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "features.cuh"

namespace {

constexpr int kScoreRows = 128;  // rows (threads) per block; BLOCK_ROWS in ops/score_kernels.py

struct ScoreArgs {
  FeatureArgs in;
  const unsigned char* valid;  // [B] bool
  const float* mean;           // [F]
  const float* scale;          // [F]
  const float* w;              // [F]
  const float* b;              // [] (a device scalar: no host sync)
  float* probs;                // [B]
  float* feats;                // [B, F]
  int F;
};

__global__ void __launch_bounds__(kScoreRows)
fused_score_kernel(ScoreArgs a) {
  const int row = blockIdx.x * kScoreRows + threadIdx.x;
  float* frow = a.feats + (size_t)row * a.F;
  float z = 0.f;
  // every thread of a warp reads rows; one past the batch emits nothing
  row_features(a.in, row, [&](int f, float v) {
    frow[f] = v;
    const float x = (v - a.mean[f]) / a.scale[f];
    z = z + x * a.w[f];
  });
  if (row >= a.in.B) return;
  z = z + a.b[0];
  const float p = 1.f / (1.f + expf(-z));
  a.probs[row] = p * (a.valid[row] ? 1.f : 0.f);
}

}  // namespace

extern "C" {

int fused_score_block_rows() { return kScoreRows; }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
int fused_score_launch(
    const int* c_bd, const float* c_cnt, const float* c_amt,
    const int* t_bd, const float* t_cnt, const float* t_frd,
    const long long* c_slot, const long long* t_slot,
    const int* day, const int* tod, const float* amount,
    const unsigned char* valid,
    const float* mean, const float* scale, const float* w, const float* b,
    float* probs, float* feats,
    int B, int NB, int F,
    int n_win, int w0, int w1, int w2, int w3,
    int delay, int weekend_start, int night_end,
    void* stream) {
  if (n_win < 1 || n_win > kMaxWindows || F != 3 + 4 * n_win || B < 1 ||
      NB < 1) {
    return (int)cudaErrorInvalidValue;
  }
  ScoreArgs a;
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
  a.valid = valid;
  a.mean = mean; a.scale = scale; a.w = w; a.b = b;
  a.probs = probs; a.feats = feats;
  a.F = F;

  const int grid = (B + kScoreRows - 1) / kScoreRows;
  fused_score_kernel<<<grid, kScoreRows, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
