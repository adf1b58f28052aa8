// The per-row tree walk over compact forest tables, shared by the two
// forest kernels (fused_forest.cu and leaf_sum.cu).
//
// Device twin of the JAX package's traversal core `_tree_block_leaf_sum`
// (ops/pallas_forest.py), which both of its forest kernels share. The
// Pallas core runs two dense products per tree; here the tables come in
// the compact form ops/forest_kernels.py::to_kernel_tables builds (one
// feature per node, <= depth (node, +-1) entries per leaf, an integer
// target), so per tree and row the walk computes
//
//   d_i = (x[feat_i] <= thresh_i) for every internal node i,
//   z_l = sum of the leaf's entries (+d or -d of its node),
//   and adds leaf_val[l] where z_l == target_l.
//
// One thread per row, kForestRows rows per block. The per-row decisions of
// a tree live in shared memory as bit words, laid out thread-minor so a
// warp's loads hit 32 consecutive words (no bank conflicts). A tree's node
// and leaf tables are staged in shared memory; its leaf entry lists are
// read through the read-only cache (every thread of a warp reads the same
// word, a broadcast). Trees are added in order t = 0..T-1, the order the
// plain models/forest.py::gemm_leaf_sum uses, so the two agree bit for
// bit; z is an exact integer, so the int8, bf16 and f32 forms of the dense
// path table give the same sums.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Rows (threads) per block of both forest kernels; BLOCK_ROWS in
// ops/forest_kernels.py.
constexpr int kForestRows = 128;

// A forest in the compact form (ops/forest_kernels.py::ForestTables).
struct CompactForest {
  const int* node_feat;      // [T, Ip]; -1 = no feature (projection is 0)
  const float* node_thresh;  // [T, Ip]
  const int* leaf_entries;   // [T, Lp, D], D % 4 == 0; 2*node + (sign > 0), -1 pads
  const int* leaf_target;    // [T, Lp]
  const float* leaf_value;   // [T, Lp]
  int T, Ip, Lp, D;
};

// Shared-memory bytes of one block: the scaled feature tile [Fp][rows],
// the decision bit words [Ip/32][rows], and one tree's node and leaf
// tables. ops/forest_kernels.py::smem_bytes computes the same number for
// the admission predicates.
__host__ __device__ inline int forest_smem_bytes(int Fp, int Ip, int Lp) {
  return kForestRows * (Fp * 4 + (Ip / 32) * 4) + Ip * 8 + Lp * 8;
}

// One leaf entry's term of z: +d or -d of its node, 0 for padding (-1).
__device__ __forceinline__ int entry_term(int code, const uint32_t* dbits,
                                          int tid) {
  const int node = max(code, 0) >> 1;
  const int bit = (dbits[(node >> 5) * kForestRows + tid] >> (node & 31)) & 1;
  return code < 0 ? 0 : ((code & 1) ? bit : -bit);
}

// Sum over trees t = 0..T-1, in order, of the value of the leaf that this
// thread's row reaches. `xs` is the block's scaled feature tile
// [Fp][kForestRows] at the start of the dynamic shared memory (a thread
// reads its own column only); the walk's scratch follows it. Every thread
// of the block must call this: it synchronises.
__device__ __forceinline__ float forest_leaf_sum(const CompactForest& f,
                                                 float* xs, int Fp, int tid) {
  uint32_t* dbits = reinterpret_cast<uint32_t*>(xs + Fp * kForestRows);
  const int words = f.Ip >> 5;                                       // [words][rows]
  int* s_feat = reinterpret_cast<int*>(dbits + words * kForestRows);  // [Ip]
  float* s_th = reinterpret_cast<float*>(s_feat + f.Ip);              // [Ip]
  int* s_tgt = reinterpret_cast<int*>(s_th + f.Ip);                   // [Lp]
  float* s_val = reinterpret_cast<float*>(s_tgt + f.Lp);              // [Lp]

  float acc = 0.f;
  for (int t = 0; t < f.T; ++t) {
    __syncthreads();  // the previous tree's staged tables are no longer read
    for (int i = tid; i < f.Ip; i += kForestRows) {
      s_feat[i] = f.node_feat[(size_t)t * f.Ip + i];
      s_th[i] = f.node_thresh[(size_t)t * f.Ip + i];
    }
    for (int l = tid; l < f.Lp; l += kForestRows) {
      s_tgt[l] = f.leaf_target[(size_t)t * f.Lp + l];
      s_val[l] = f.leaf_value[(size_t)t * f.Lp + l];
    }
    __syncthreads();

    for (int w = 0; w < words; ++w) {
      uint32_t bits = 0;
#pragma unroll 8
      for (int k = 0; k < 32; ++k) {
        const int node = (w << 5) + k;
        const int feat = s_feat[node];
        const float v = feat >= 0 ? xs[feat * kForestRows + tid] : 0.f;
        bits |= (uint32_t)(v <= s_th[node]) << k;
      }
      dbits[w * kForestRows + tid] = bits;
    }

    // A leaf's entries come as 16-byte vectors and the padding (-1) adds 0
    // by a select, so a leaf's loads issue together and neighbouring
    // leaves' chains interleave (no data-dependent exit).
    const int q = f.D >> 2;
    const int4* ent = reinterpret_cast<const int4*>(f.leaf_entries) +
                      (size_t)t * f.Lp * q;
#pragma unroll 4
    for (int l = 0; l < f.Lp; ++l) {
      int z = 0;
      for (int j = 0; j < q; ++j) {
        const int4 c = __ldg(ent + l * q + j);
        z += entry_term(c.x, dbits, tid) + entry_term(c.y, dbits, tid) +
             entry_term(c.z, dbits, tid) + entry_term(c.w, dbits, tid);
      }
      if (z == s_tgt[l]) acc += s_val[l];
    }
  }
  return acc;
}
