// The 15-feature assembly of one row, shared by the two fused kernels.
//
// Device twin of ops/features_fused.py::assemble_features (the JAX
// package's ops/pallas_kernels.py::assemble_features, the feature half of
// both of its fused Pallas kernels). fused_forest.cu and fused_score.cu
// both include this header, so their features cannot drift apart.
//
// Exactness: window sums add buckets in ring order 0..NB-1, the order
// ops/windows.py::window_sums uses; the averages are IEEE divisions
// (-prec-div=true), and the file that includes this is built with
// --fmad=false and without fast math.

#pragma once

#include <cuda_runtime.h>

constexpr int kMaxWindows = 4;

// Gathered state rows and per-row scalars of one batch, and the feature
// config.
struct FeatureArgs {
  const int* c_bd;     // [B, NB] customer bucket days
  const float* c_cnt;  // [B, NB]
  const float* c_amt;  // [B, NB]
  const int* t_bd;     // [B, NB] terminal bucket days
  const float* t_cnt;  // [B, NB]
  const float* t_frd;  // [B, NB]
  const int* day;      // [B]
  const int* tod;      // [B] second of the day
  const float* amount; // [B]
  int NB;
  int n_win;
  int win[kMaxWindows];
  int delay, weekend_start, night_end;
};

__device__ __forceinline__ int floor_mod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

__device__ __forceinline__ int floor_div(int a, int m) {
  const int q = a / m;
  return (q * m != a && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ float ratio(float num, float cnt) {
  return cnt > 0.f ? num / fmaxf(cnt, 1.f) : 0.f;
}

// Calls emit(f, v) for each raw feature f = 0 .. 3 + 4*n_win - 1 of `row`,
// in feature order (features/spec.py::FEATURE_NAMES): amount, weekend,
// night, then (count, average amount) per customer window, then (count,
// risk) per delay-shifted terminal window.
template <class Emit>
__device__ __forceinline__ void row_features(const FeatureArgs& a, int row,
                                             Emit&& emit) {
  const int day = a.day[row];
  float cc[kMaxWindows], ca[kMaxWindows], tc[kMaxWindows], tf[kMaxWindows];
#pragma unroll
  for (int w = 0; w < kMaxWindows; ++w) cc[w] = ca[w] = tc[w] = tf[w] = 0.f;
  const size_t base = (size_t)row * a.NB;
  for (int k = 0; k < a.NB; ++k) {
    const int cs = a.c_bd[base + k];
    const int cage = day - cs;
    const bool clive = cs >= 0 && cage >= 0;
    const float ccnt = a.c_cnt[base + k];
    const float camt = a.c_amt[base + k];
    const int ts = a.t_bd[base + k];
    const int tage = day - a.delay - ts;
    const bool tlive = ts >= 0 && tage >= 0;
    const float tcnt = a.t_cnt[base + k];
    const float tfrd = a.t_frd[base + k];
#pragma unroll
    for (int w = 0; w < kMaxWindows; ++w) {
      if (w < a.n_win) {
        if (clive && cage < a.win[w]) {
          cc[w] += ccnt;
          ca[w] += camt;
        }
        if (tlive && tage < a.win[w]) {
          tc[w] += tcnt;
          tf[w] += tfrd;
        }
      }
    }
  }
  emit(0, a.amount[row]);
  emit(1, floor_mod(day + 3, 7) >= a.weekend_start ? 1.f : 0.f);
  emit(2, floor_div(a.tod[row], 3600) <= a.night_end ? 1.f : 0.f);
#pragma unroll
  for (int w = 0; w < kMaxWindows; ++w) {
    if (w < a.n_win) {
      emit(3 + 2 * w, cc[w]);
      emit(4 + 2 * w, ratio(ca[w], cc[w]));
    }
  }
  const int tbase = 3 + 2 * a.n_win;
#pragma unroll
  for (int w = 0; w < kMaxWindows; ++w) {
    if (w < a.n_win) {
      emit(tbase + 2 * w, tc[w]);
      emit(tbase + 1 + 2 * w, ratio(tf[w], tc[w]));
    }
  }
}
