// The 15-feature assembly of one row, shared by the two fused kernels.
//
// Device twin of ops/features_fused.py::assemble_features on the rows that
// ops/features_fused.py::gather_feature_rows takes from the feature-state
// tables (the JAX package's ops/pallas_kernels.py::assemble_features, the
// feature half of both of its fused Pallas kernels, on the rows of
// ops/windows.py::gather_state_rows). fused_forest.cu and fused_score.cu
// both include this header, so their features cannot drift apart.
//
// The kernels read the state rows by slot from the tables themselves: no
// gathered copy of them is written. The Pallas kernel left the gather to
// XLA because Mosaic has no vectorized dynamic row gather; here each
// thread loads its own rows through the loader below.
//
// Exactness: one thread per row owns the row's window sums and adds its
// buckets in ring order 0..NB-1, the order ops/windows.py::window_sums
// uses; the averages are IEEE divisions (-prec-div=true), and the file
// that includes this is built with --fmad=false and without fast math.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

constexpr int kMaxWindows = 4;
// Words of a run (one slot's NB buckets of one array) the loader brings in
// at a time: one 32-byte sector.
constexpr int kChunk = 8;

// The feature-state tables, the batch's slots and per-row scalars, and the
// feature config.
struct FeatureArgs {
  const int* c_bd;     // [c_cap, NB] customer bucket days
  const float* c_cnt;  // [c_cap, NB]
  const float* c_amt;  // [c_cap, NB]
  const int* t_bd;     // [t_cap, NB] terminal bucket days
  const float* t_cnt;  // [t_cap, NB]
  const float* t_frd;  // [t_cap, NB]
  const long long* c_slot;  // [B] in [0, c_cap)
  const long long* t_slot;  // [B] in [0, t_cap)
  const int* day;      // [B]
  const int* tod;      // [B] second of the day
  const float* amount; // [B]
  int B, NB;
  int n_win;
  int win[kMaxWindows];
  int delay, weekend_start, night_end;
};

// ---- loader: begin (form: direct)
//
// Each thread reads its own row's runs by slot, a chunk of kChunk words of
// each of the three arrays at a time, through the read-only path: two
// back-to-back 16-byte loads per 32-byte sector where NB % 4 == 0 puts
// every run on a 16-byte boundary (ops/features_fused.py::
// check_feature_inputs holds the tables to 16-byte alignment), four 8-byte
// loads where NB is even, 4-byte loads otherwise and in a ragged last
// chunk. No shared memory. A staged form (each warp copying its 32 rows'
// runs into a shared tile with coalesced cp.async) measured no faster;
// tools/torch_loader_forms.py times it beside this one.

template <class T, class V4, class V2>
__device__ __forceinline__ void load_chunk(const T* p, int cw, int nb,
                                           T (&out)[kChunk]) {
  if (cw == kChunk && nb % 4 == 0) {
    const V4 lo = __ldg(reinterpret_cast<const V4*>(p));
    const V4 hi = __ldg(reinterpret_cast<const V4*>(p) + 1);
    out[0] = lo.x; out[1] = lo.y; out[2] = lo.z; out[3] = lo.w;
    out[4] = hi.x; out[5] = hi.y; out[6] = hi.z; out[7] = hi.w;
  } else if (cw == kChunk && nb % 2 == 0) {
#pragma unroll
    for (int j = 0; j < kChunk / 2; ++j) {
      const V2 v = __ldg(reinterpret_cast<const V2*>(p) + j);
      out[2 * j] = v.x;
      out[2 * j + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) out[k] = k < cw ? __ldg(p + k) : T(0);
  }
}

// Calls sink(table, cw, bd, x0, x1) for each chunk of this thread's rows,
// the customer table's (table 0: bd, cnt, amt) in ring order, then the
// terminal table's (table 1: bd, cnt, frd); cw words of the chunk are
// live. Every thread of a warp calls it, a thread past the batch with
// slot 0, so a loader may use the warp's lanes together.
template <class Sink>
__device__ __forceinline__ void stream_rows(const FeatureArgs& a, int cslot,
                                            int tslot, Sink&& sink) {
  for (int table = 0; table < 2; ++table) {
    const size_t base = (size_t)(table ? tslot : cslot) * a.NB;
    const int* bd = (table ? a.t_bd : a.c_bd) + base;
    const float* x0 = (table ? a.t_cnt : a.c_cnt) + base;
    const float* x1 = (table ? a.t_frd : a.c_amt) + base;
    for (int k0 = 0; k0 < a.NB; k0 += kChunk) {
      const int cw = min(kChunk, a.NB - k0);
      int b[kChunk];
      float v0[kChunk], v1[kChunk];
      load_chunk<int, int4, int2>(bd + k0, cw, a.NB, b);
      load_chunk<float, float4, float2>(x0 + k0, cw, a.NB, v0);
      load_chunk<float, float4, float2>(x1 + k0, cw, a.NB, v1);
      sink(table, cw, b, v0, v1);
    }
  }
}
// ---- loader: end

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

// Adds the live words of one chunk of a run into the window sums: a bucket
// stamped with day s counts toward window w iff 0 <= now - s < win[w]
// (empty buckets carry -1). `now` is the day, less the delay for the
// terminal table.
__device__ __forceinline__ void add_chunk(const FeatureArgs& a, int now,
                                          int cw, const int (&bd)[kChunk],
                                          const float (&n)[kChunk],
                                          const float (&v)[kChunk],
                                          float (&ns)[kMaxWindows],
                                          float (&vs)[kMaxWindows]) {
#pragma unroll
  for (int k = 0; k < kChunk; ++k) {
    const int s = k < cw ? bd[k] : -1;  // words past the run are not read
    const int age = now - s;
    const bool live = s >= 0 && age >= 0;
#pragma unroll
    for (int w = 0; w < kMaxWindows; ++w) {
      if (w < a.n_win && live && age < a.win[w]) {
        ns[w] += n[k];
        vs[w] += v[k];
      }
    }
  }
}

// Calls emit(f, v) for each raw feature f = 0 .. 3 + 4*n_win - 1 of `row`,
// in feature order (features/spec.py::FEATURE_NAMES): amount, weekend,
// night, then (count, average amount) per customer window, then (count,
// risk) per delay-shifted terminal window. Every thread of a warp calls
// it; a row past the batch emits nothing.
template <class Emit>
__device__ __forceinline__ void row_features(const FeatureArgs& a, int row,
                                             Emit&& emit) {
  const bool live_row = row < a.B;
  const int cslot = live_row ? (int)a.c_slot[row] : 0;
  const int tslot = live_row ? (int)a.t_slot[row] : 0;
  const int day = live_row ? a.day[row] : 0;
  float cc[kMaxWindows], ca[kMaxWindows], tc[kMaxWindows], tf[kMaxWindows];
#pragma unroll
  for (int w = 0; w < kMaxWindows; ++w) cc[w] = ca[w] = tc[w] = tf[w] = 0.f;
  stream_rows(a, cslot, tslot,
              [&](int table, int cw, const int (&bd)[kChunk],
                  const float (&x0)[kChunk], const float (&x1)[kChunk]) {
                if (table == 0) {
                  add_chunk(a, day, cw, bd, x0, x1, cc, ca);
                } else {
                  add_chunk(a, day - a.delay, cw, bd, x0, x1, tc, tf);
                }
              });
  if (!live_row) return;
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
