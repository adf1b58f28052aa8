// Fused featurize -> forest kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel `fused_forest_leaf_sum` / `_fused_forest_kernel`
// of real_time_fraud_detection_system_tpu/ops/pallas_forest.py (its feature
// half is `assemble_features` in ops/pallas_kernels.py, its traversal core
// `_tree_block_leaf_sum`). Per row it computes the same function:
//
//   gathered customer rows (bd, cnt, amt) and terminal rows (bd, cnt, frd)
//   -> the 15 raw features (age-mask windows, terminal delay, weekend and
//      night flags), written out
//   -> standardized (x - mean) / scale, kept in shared memory
//   -> for each tree t: d_i = (x[feat_i] <= thresh_i) per internal node,
//      z_l = sum_i path[i,l] * d_i per leaf, and leaf_val[l] added where
//      z_l == target_l.
//
// Design. One thread per row, 128 rows per block. The Pallas kernel runs
// the traversal as two dense products per tree ([B,16]x[16,I] and
// [B,I]x[I,L]); on CUDA cores that is ~8.6e11 multiply-adds per 65,536-row
// batch at T=100, depth 8. Both tables are extremely sparse, so the host
// compacts them once (ops/forest_kernels.py::to_kernel_tables): each node
// keeps its one feature index (`sel` is one-hot), each leaf its <= depth
// (node, +-1) entries, and the target is an integer. The kernel then does
// ~2.6k integer operations per tree per row. The per-row decisions of a
// tree live in shared memory as bit words, laid out thread-minor so a
// warp's loads hit 32 consecutive words (no bank conflicts). A tree's node
// and leaf tables are staged in shared memory; its leaf entry lists are
// read through the read-only cache (every thread of a warp reads the same
// word, a broadcast). z is an exact integer, so the int8, bf16 and f32
// forms of the dense path table give bit-identical leaf sums.
//
// What bounds it. Data in: ~1 KB of gathered rows per row (6 x 40 words)
// plus 12 B of scalars; out: 64 B (15 features + the leaf sum). At 65,536
// rows that is ~68 MB, ~20 us at 3.35 TB/s. The function itself needs few
// operations: ~1k per row for the features and, per tree, one compare per
// level of the path the row takes plus the leaf add (~0.9k per row at
// T=100, depth 8), ~1.2e8 in all, ~2 us at the card's 32-bit rate. So the
// function is memory-bound at ~20 us per 65,536 rows. This first kernel is
// far from that bound: its compact algorithm evaluates every node and
// walks every leaf's entries (~2.6k integer operations per tree per row,
// ~1.7e10 in all, each also paying a shared-memory or L1 load) instead of
// descending one path. A descent per row (or warp-cooperative traversal),
// an int8 mma for a dense z, and moving the slot gather into the kernel
// are later work.
//
// Exactness. Decisions must match the plain PyTorch path bit for bit, so
// this file is built without --use_fast_math, with the defaults
// -prec-div=true (IEEE division in the feature averages and the
// standardization) and -ftz=false (denormals compare as they are; see
// models/forest.py::ftz_safe_thresholds), and with --fmad=false so no
// product is contracted into an FMA. Window sums add buckets in ring order
// 0..NB-1, the order ops/windows.py::window_sums uses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockRows = 128;  // rows (threads) per block; BLOCK_ROWS in ops/forest_kernels.py
constexpr int kMaxWindows = 4;

struct FusedForestArgs {
  const int* c_bd;
  const float* c_cnt;
  const float* c_amt;
  const int* t_bd;
  const float* t_cnt;
  const float* t_frd;
  const int* day;
  const int* tod;
  const float* amount;
  const float* mean;   // [F]
  const float* scale;  // [F]
  const int* node_feat;      // [T, Ip]; -1 = no feature (projection is 0)
  const float* node_thresh;  // [T, Ip]
  const int* leaf_entries;   // [T, Lp, D], D % 4 == 0; 2*node + (sign > 0), -1 pads
  const int* leaf_target;    // [T, Lp]
  const float* leaf_value;   // [T, Lp]
  float* leaf_sum;  // [B]
  float* feats;     // [B, F]
  int B, NB, T, Ip, Lp, D, F, Fp;
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

// Writes raw feature f of this row and its standardized value.
__device__ __forceinline__ void put_feature(float* frow, float* xcol,
                                            const float* mean,
                                            const float* scale, int f,
                                            float v) {
  frow[f] = v;
  xcol[f * kBlockRows] = (v - mean[f]) / scale[f];
}

// One leaf entry's term of z: +d or -d of its node, 0 for padding (-1).
__device__ __forceinline__ int entry_term(int code, const uint32_t* dbits,
                                          int tid) {
  const int node = max(code, 0) >> 1;
  const int bit = (dbits[(node >> 5) * kBlockRows + tid] >> (node & 31)) & 1;
  return code < 0 ? 0 : ((code & 1) ? bit : -bit);
}

__device__ __forceinline__ float ratio(float num, float cnt) {
  return cnt > 0.f ? num / fmaxf(cnt, 1.f) : 0.f;
}

__global__ void __launch_bounds__(kBlockRows)
fused_forest_kernel(FusedForestArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);                  // [Fp][rows]
  uint32_t* dbits = reinterpret_cast<uint32_t*>(xs + a.Fp * kBlockRows);
  const int words = a.Ip >> 5;                                 // [words][rows]
  int* s_feat = reinterpret_cast<int*>(dbits + words * kBlockRows);  // [Ip]
  float* s_th = reinterpret_cast<float*>(s_feat + a.Ip);             // [Ip]
  int* s_tgt = reinterpret_cast<int*>(s_th + a.Ip);                  // [Lp]
  float* s_val = reinterpret_cast<float*>(s_tgt + a.Lp);             // [Lp]

  const int tid = threadIdx.x;
  const int row = blockIdx.x * kBlockRows + tid;
  const bool live_row = row < a.B;

  for (int f = 0; f < a.Fp; ++f) xs[f * kBlockRows + tid] = 0.f;

  // ---- 1. features (ops/features_fused.py::assemble_features)
  if (live_row) {
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
    float* frow = a.feats + (size_t)row * a.F;
    float* xcol = xs + tid;
    put_feature(frow, xcol, a.mean, a.scale, 0, a.amount[row]);
    put_feature(frow, xcol, a.mean, a.scale, 1,
                floor_mod(day + 3, 7) >= a.weekend_start ? 1.f : 0.f);
    put_feature(frow, xcol, a.mean, a.scale, 2,
                floor_div(a.tod[row], 3600) <= a.night_end ? 1.f : 0.f);
    const int tbase = 3 + 2 * a.n_win;
#pragma unroll
    for (int w = 0; w < kMaxWindows; ++w) {
      if (w < a.n_win) {
        put_feature(frow, xcol, a.mean, a.scale, 3 + 2 * w, cc[w]);
        put_feature(frow, xcol, a.mean, a.scale, 4 + 2 * w,
                    ratio(ca[w], cc[w]));
        put_feature(frow, xcol, a.mean, a.scale, tbase + 2 * w, tc[w]);
        put_feature(frow, xcol, a.mean, a.scale, tbase + 1 + 2 * w,
                    ratio(tf[w], tc[w]));
      }
    }
  }

  // ---- 2. trees, in order t = 0..T-1
  float acc = 0.f;
  for (int t = 0; t < a.T; ++t) {
    __syncthreads();  // the previous tree's staged tables are no longer read
    for (int i = tid; i < a.Ip; i += kBlockRows) {
      s_feat[i] = a.node_feat[(size_t)t * a.Ip + i];
      s_th[i] = a.node_thresh[(size_t)t * a.Ip + i];
    }
    for (int l = tid; l < a.Lp; l += kBlockRows) {
      s_tgt[l] = a.leaf_target[(size_t)t * a.Lp + l];
      s_val[l] = a.leaf_value[(size_t)t * a.Lp + l];
    }
    __syncthreads();

    for (int w = 0; w < words; ++w) {
      uint32_t bits = 0;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const int node = (w << 5) + k;
        const int f = s_feat[node];
        const float v = f >= 0 ? xs[f * kBlockRows + tid] : 0.f;
        bits |= (uint32_t)(v <= s_th[node]) << k;
      }
      dbits[w * kBlockRows + tid] = bits;
    }

    // A leaf's entries come as 16-byte vectors and the padding (-1) adds 0
    // by a select, so a leaf's loads issue together and neighbouring
    // leaves' chains interleave (no data-dependent exit).
    const int q = a.D >> 2;
    const int4* ent = reinterpret_cast<const int4*>(a.leaf_entries) +
                      (size_t)t * a.Lp * q;
#pragma unroll 4
    for (int l = 0; l < a.Lp; ++l) {
      int z = 0;
      for (int j = 0; j < q; ++j) {
        const int4 c = __ldg(ent + l * q + j);
        z += entry_term(c.x, dbits, tid) + entry_term(c.y, dbits, tid) +
             entry_term(c.z, dbits, tid) + entry_term(c.w, dbits, tid);
      }
      if (z == s_tgt[l]) acc += s_val[l];
    }
  }
  if (live_row) a.leaf_sum[row] = acc;
}

}  // namespace

extern "C" {

// Shared-memory bytes of one block; ops/forest_kernels.py::smem_bytes
// computes the same number for the admission predicate.
int fused_forest_smem_bytes(int Fp, int Ip, int Lp) {
  return kBlockRows * (Fp * 4 + (Ip / 32) * 4) + Ip * 8 + Lp * 8;
}

int fused_forest_block_rows() { return kBlockRows; }

// Launches the kernel on `stream` and returns cudaGetLastError() (0 = ok).
int fused_forest_launch(
    const int* c_bd, const float* c_cnt, const float* c_amt,
    const int* t_bd, const float* t_cnt, const float* t_frd,
    const int* day, const int* tod, const float* amount,
    const float* mean, const float* scale,
    const int* node_feat, const float* node_thresh,
    const int* leaf_entries, const int* leaf_target, const float* leaf_value,
    float* leaf_sum, float* feats,
    int B, int NB, int T, int Ip, int Lp, int D, int F, int Fp,
    int n_win, int w0, int w1, int w2, int w3,
    int delay, int weekend_start, int night_end,
    void* stream) {
  // The block's shared memory stays within the 48 KB a launch gets without
  // opting in to more (ops/forest_kernels.py::admit_tables holds to it).
  const int smem = fused_forest_smem_bytes(Fp, Ip, Lp);
  if (n_win < 1 || n_win > kMaxWindows || F != 3 + 4 * n_win || Fp < F ||
      Ip % 32 != 0 || B < 1 || D < 4 || D % 4 != 0 || smem > 48 * 1024) {
    return (int)cudaErrorInvalidValue;
  }
  FusedForestArgs a;
  a.c_bd = c_bd; a.c_cnt = c_cnt; a.c_amt = c_amt;
  a.t_bd = t_bd; a.t_cnt = t_cnt; a.t_frd = t_frd;
  a.day = day; a.tod = tod; a.amount = amount;
  a.mean = mean; a.scale = scale;
  a.node_feat = node_feat; a.node_thresh = node_thresh;
  a.leaf_entries = leaf_entries; a.leaf_target = leaf_target;
  a.leaf_value = leaf_value;
  a.leaf_sum = leaf_sum; a.feats = feats;
  a.B = B; a.NB = NB; a.T = T; a.Ip = Ip; a.Lp = Lp; a.D = D;
  a.F = F; a.Fp = Fp;
  a.n_win = n_win;
  a.win[0] = w0; a.win[1] = w1; a.win[2] = w2; a.win[3] = w3;
  a.delay = delay; a.weekend_start = weekend_start; a.night_end = night_end;

  const int grid = (B + kBlockRows - 1) / kBlockRows;
  fused_forest_kernel<<<grid, kBlockRows, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
