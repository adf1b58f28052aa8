// The sequence step's serving transformer in one kernel for Hopper
// (sm_90a): each history [K, n_in] -> the logit at its own position.
//
// Replaces no TPU kernel: the JAX package computes this forward as XLA
// ops outside Pallas. It was added for the sequence step
// (features/history.py::update_and_score), whose plain PyTorch forward,
// models/sequence.py::transformer_last_logit, runs each step (the
// embedding, every block's norms and products, the softmax, the GELU) as
// its own launch through device memory: at B = 65,536 and K = D = 32 each
// [B, K, D] float32 intermediate is 268 MB.
//
// The function, per row (exactly transformer_last_logit with naive causal
// attention): h = x @ embed_w + embed_b at every position; every block
// but the last at every position (pre-LN, causal attention over the row's
// own positions, GELU MLP); the last block's keys and values at every
// position and its query, attention, output, MLP, the final norm and the
// head at qpos alone.
//
// What bounds it. In: hist, n_in floats per position (67 MB at the main
// path's 65,536 x 32 x 8), the weights once per block (~68 KB); out: 4 B
// per row: ~20 us at 3.35 TB/s. Operations: ~0.82 MFLOP per row counted
// from the shapes (fraudbench/counts/step.py), 53.7 GFLOP per 65,536
// rows, 0.80 ms at the card's 67 TFLOP/s of float32 outside the tensor
// cores. So the operations bound it, and the design keeps every
// activation on chip and feeds the FMA pipe from registers and
// broadcast shared-memory reads.
//
// Design. Persistent blocks, one per SM: a block stages every weight in
// shared memory once (the wide ones row-major, d_ff padded to a multiple
// of 32 with zeros, which adds exact zeros), then walks over tiles of
// `rows` histories, one thread per position (KT = 32 or 64 threads per
// row). A thread keeps its position's residual stream h [32] in
// registers; each position-wise product reads its input vector from the
// thread's own row of shared memory (one 16-byte read per four inputs)
// and the weight row by 16-byte reads that every thread of the warp
// shares (a broadcast), four FMAs per read, into 32 accumulators in
// registers. Keys and values go to per-position rows of shared memory
// (stride 36 floats: the 16-byte stores of a quarter warp hit distinct
// banks), read back by broadcast in the attention. Block 1's attention
// runs per position and head over keys j <= qpos (positions past the
// row's qpos never reach its logit, so a warp of them skips its work):
// float32 scores times 1/sqrt(Dh), -inf where j > t, max-subtracted
// softmax, then the weighted sum of values. The last block computes keys
// and values at every position, then one warp per row computes the rest
// at qpos with one lane per feature (query, output, norms, MLP, head) or
// per key (scores), with warp shuffles for the norms, the softmax and the
// head. Barriers only between phases: keys and values written, read,
// and the tile's end.
//
// Precision. Float32 throughout, as the configuration states: no TF32,
// no half types. The build keeps --fmad=false (ops/cuda_lib.py), so the
// products are written as explicit __fmaf_rn and every other operation
// rounds on its own. The layer norms take the mean, then the mean of
// squares about it, then rsqrtf(var + 1e-6); GELU is the tanh form. The
// sums run in another order than PyTorch's and each product-add rounds
// once, so logits differ from the plain version by ~1e-6.
//
// Support (ops/sequence_kernels.py::kernel_support checks it before a
// launch, and the launch refuses the rest): d_model 32; n_heads 2; K <=
// 64; n_in <= 16; d_ff <= 128, the same in every block; any
// number of layers up to kMaxLayers whose weights fit in a block's shared
// memory beside one tile row (six layers at d_ff 64). Rows per tile: as
// many as kMaxThreads and the shared memory allow (11 at the main path).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 32;             // d_model
constexpr int kHeads = 2;          // the instance built (a template arg)
constexpr int kMaxThreads = 384;   // per block
constexpr int kMaxIn = 16;
constexpr int kMaxFF = 128;
constexpr int kMaxK = 64;
constexpr int kMaxLayers = 8;
constexpr int kRow = 36;           // floats per position row of scratch
constexpr int kMaxSmem = 227 * 1024;
constexpr int kParamsPerLayer = 12;
constexpr int kParamsOuter = 6;

// Offsets inside one layer's weights (floats); w1 is [32, ff_pad].
constexpr int kLn1G = 0, kLn1B = 32, kWq = 64, kWk = kWq + kD * kD,
              kWv = kWk + kD * kD, kWo = kWv + kD * kD,
              kLn2G = kWo + kD * kD, kLn2B = kLn2G + kD, kW1 = kLn2B + kD;

struct LayerPtrs {
  const float *ln1_g, *ln1_b, *wq, *wk, *wv, *wo, *ln2_g, *ln2_b, *w1, *b1,
      *w2, *b2;
};

// Where everything lives in shared memory (floats), and the tile shape.
struct Layout {
  int in_pad, ff_pad, n_layers, heads, kt, rows;

  __host__ __device__ int emb_b() const { return in_pad * kD; }
  __host__ __device__ int layer_stride() const {
    return kW1 + 65 * ff_pad + kD;  // w1, b1, w2, b2
  }
  __host__ __device__ int layer(int l) const {
    return in_pad * kD + kD + l * layer_stride();
  }
  __host__ __device__ int final_norm() const { return layer(n_layers); }
  __host__ __device__ int weights() const { return final_norm() + 100; }
  // per row: hq, q, o, hn2 [32 each], p [heads, kt], f [ff_pad]
  __host__ __device__ int row_scratch() const {
    return 4 * kD + heads * kt + ff_pad;
  }
  __host__ __device__ int per_row() const {
    return kt * 3 * kRow + row_scratch();
  }
  __host__ __device__ int floats() const {
    return weights() + rows * per_row();
  }
};

struct SeqArgs {
  const float* hist;  // [B, K, n_in]
  const int* qpos;    // [B]
  const float *embed_w, *embed_b, *lnf_g, *lnf_b, *head_w, *head_b;
  LayerPtrs layer[kMaxLayers];
  float* out;  // [B]
  int B, K, n_in, d_ff;
  Layout lay;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.f + tanhf(inner));
}

// dst [dst_rows, dst_cols] <- src [rows, cols] row-major, zero elsewhere.
__device__ void stage(float* dst, const float* __restrict__ src, int rows,
                      int cols, int dst_rows, int dst_cols) {
  const int n = dst_rows * dst_cols;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = i / dst_cols, c = i - r * dst_cols;
    dst[i] = (r < rows && c < cols) ? __ldg(src + r * cols + c) : 0.f;
  }
}

// acc[c] += sum_{i < n} x[i] * w[i * ldw + c], c < 32, i ascending; x is
// the thread's own row of shared memory, w a broadcast weight block;
// n a multiple of 4.
__device__ __forceinline__ void matvec(const float* __restrict__ x,
                                       const float* __restrict__ w, int ldw,
                                       int n, float (&acc)[kD]) {
#pragma unroll 1
  for (int i = 0; i < n; i += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(x + i);
    const float xi[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4* wr = reinterpret_cast<const float4*>(w + (i + u) * ldw);
#pragma unroll
      for (int c4 = 0; c4 < kD / 4; ++c4) {
        const float4 wv = wr[c4];
        acc[4 * c4 + 0] = __fmaf_rn(xi[u], wv.x, acc[4 * c4 + 0]);
        acc[4 * c4 + 1] = __fmaf_rn(xi[u], wv.y, acc[4 * c4 + 1]);
        acc[4 * c4 + 2] = __fmaf_rn(xi[u], wv.z, acc[4 * c4 + 2]);
        acc[4 * c4 + 3] = __fmaf_rn(xi[u], wv.w, acc[4 * c4 + 3]);
      }
    }
  }
}

__device__ __forceinline__ void zero(float (&a)[kD]) {
#pragma unroll
  for (int c = 0; c < kD; ++c) a[c] = 0.f;
}

__device__ __forceinline__ void store_row(float* dst, const float (&a)[kD]) {
#pragma unroll
  for (int c4 = 0; c4 < kD / 4; ++c4) {
    reinterpret_cast<float4*>(dst)[c4] =
        make_float4(a[4 * c4], a[4 * c4 + 1], a[4 * c4 + 2], a[4 * c4 + 3]);
  }
}

// out <- ((h - mean) * rsqrt(var + 1e-6)) * g + b, var the mean of
// squares about the mean (models/sequence.py::_ln).
__device__ __forceinline__ void layer_norm(const float (&h)[kD],
                                           const float* g, const float* b,
                                           float* out) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < kD; ++c) s += h[c];
  const float mu = s * (1.f / kD);
  float v = 0.f;
#pragma unroll
  for (int c = 0; c < kD; ++c) {
    const float d = h[c] - mu;
    v += d * d;
  }
  const float r = rsqrtf(v * (1.f / kD) + 1e-6f);
  float y[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) y[c] = ((h[c] - mu) * r) * g[c] + b[c];
  store_row(out, y);
}

// Causal attention of one position t over keys j <= min(t, qrow) of its
// row, every head; o (the thread's own row) <- the heads' outputs.
template <int H, int KT>
__device__ __forceinline__ void attend(const float (&q)[kD],
                                       const float* __restrict__ keys,
                                       const float* __restrict__ vals, int t,
                                       int qrow, float inv_scale, float* o) {
  constexpr int Dh = kD / H;
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    float s[KT];
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      s[j] = -INFINITY;
      if (j <= qrow) {
        const float4* kr =
            reinterpret_cast<const float4*>(keys + j * kRow + hh * Dh);
        float dot = 0.f;
#pragma unroll
        for (int e4 = 0; e4 < Dh / 4; ++e4) {
          const float4 kv = kr[e4];
          dot = __fmaf_rn(q[hh * Dh + 4 * e4 + 0], kv.x, dot);
          dot = __fmaf_rn(q[hh * Dh + 4 * e4 + 1], kv.y, dot);
          dot = __fmaf_rn(q[hh * Dh + 4 * e4 + 2], kv.z, dot);
          dot = __fmaf_rn(q[hh * Dh + 4 * e4 + 3], kv.w, dot);
        }
        if (j <= t) s[j] = dot * inv_scale;
        m = fmaxf(m, s[j]);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j <= qrow) {
        s[j] = expf(s[j] - m);
        sum += s[j];
      }
    }
    const float rs = 1.f / sum;
    float acc[Dh];
#pragma unroll
    for (int e = 0; e < Dh; ++e) acc[e] = 0.f;
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      if (j <= qrow) {
        const float p = s[j] * rs;
        const float4* vr =
            reinterpret_cast<const float4*>(vals + j * kRow + hh * Dh);
#pragma unroll
        for (int e4 = 0; e4 < Dh / 4; ++e4) {
          const float4 vv = vr[e4];
          acc[4 * e4 + 0] = __fmaf_rn(p, vv.x, acc[4 * e4 + 0]);
          acc[4 * e4 + 1] = __fmaf_rn(p, vv.y, acc[4 * e4 + 1]);
          acc[4 * e4 + 2] = __fmaf_rn(p, vv.z, acc[4 * e4 + 2]);
          acc[4 * e4 + 3] = __fmaf_rn(p, vv.w, acc[4 * e4 + 3]);
        }
      }
    }
#pragma unroll
    for (int e4 = 0; e4 < Dh / 4; ++e4) {
      reinterpret_cast<float4*>(o + hh * Dh)[e4] =
          make_float4(acc[4 * e4], acc[4 * e4 + 1], acc[4 * e4 + 2],
                      acc[4 * e4 + 3]);
    }
  }
}

// The last block from its keys and values at qpos, the final norm and the
// head, by the row's first warp: lane = feature (or key, for scores).
template <int H, int KT>
__device__ __forceinline__ float last_position(
    const float* __restrict__ w, const float* __restrict__ fin,
    const float* __restrict__ hnq, const float* __restrict__ keys,
    const float* __restrict__ vals, float* rs, int qrow, int ff_pad,
    float inv_scale, int lane) {
  constexpr int Dh = kD / H;
  float* hq = rs;
  float* sq = rs + kD;
  float* so = rs + 2 * kD;
  float* shn = rs + 3 * kD;
  float* sp = rs + 4 * kD;
  float* sf = sp + H * KT;

  // the query at qpos
  float qc = 0.f;
#pragma unroll
  for (int d = 0; d < kD; ++d) qc = __fmaf_rn(hnq[d], w[kWq + d * kD + lane], qc);
  sq[lane] = qc;
  __syncwarp();

  // scores of the query against keys j = lane + 32 jj, softmax per head
#pragma unroll
  for (int hh = 0; hh < H; ++hh) {
    float s[KT / 32];
    float m = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < KT / 32; ++jj) {
      const int j = lane + 32 * jj;
      s[jj] = -INFINITY;
      if (j <= qrow) {
        const float4* kr =
            reinterpret_cast<const float4*>(keys + j * kRow + hh * Dh);
        const float4* qr = reinterpret_cast<const float4*>(sq + hh * Dh);
        float dot = 0.f;
#pragma unroll
        for (int e4 = 0; e4 < Dh / 4; ++e4) {
          const float4 kv = kr[e4], qv = qr[e4];
          dot = __fmaf_rn(qv.x, kv.x, dot);
          dot = __fmaf_rn(qv.y, kv.y, dot);
          dot = __fmaf_rn(qv.z, kv.z, dot);
          dot = __fmaf_rn(qv.w, kv.w, dot);
        }
        s[jj] = dot * inv_scale;
      }
      m = fmaxf(m, s[jj]);
    }
    m = warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < KT / 32; ++jj) {
      s[jj] = expf(s[jj] - m);  // 0 where masked
      sum += s[jj];
    }
    const float r = 1.f / warp_sum(sum);
#pragma unroll
    for (int jj = 0; jj < KT / 32; ++jj) sp[hh * KT + lane + 32 * jj] = s[jj] * r;
  }
  __syncwarp();

  // the heads' outputs: feature lane of head lane / Dh
  const float* ph = sp + (lane / Dh) * KT;
  float oc = 0.f;
  for (int j = 0; j <= qrow; ++j) oc = __fmaf_rn(ph[j], vals[j * kRow + lane], oc);
  so[lane] = oc;
  __syncwarp();

  float ac = 0.f;
#pragma unroll
  for (int c = 0; c < kD; ++c) ac = __fmaf_rn(so[c], w[kWo + c * kD + lane], ac);
  float x = hq[lane] + ac;

  // the MLP's norm across the lanes
  float mu = warp_sum(x) * (1.f / kD);
  float d = x - mu;
  float r = rsqrtf(warp_sum(d * d) * (1.f / kD) + 1e-6f);
  shn[lane] = ((x - mu) * r) * w[kLn2G + lane] + w[kLn2B + lane];
  __syncwarp();

  const float* w1 = w + kW1;
  const float* b1 = w1 + kD * ff_pad;
  const float* w2 = b1 + ff_pad;
  const float* b2 = w2 + ff_pad * kD;
  for (int m0 = 0; m0 < ff_pad; m0 += 32) {
    float fc = 0.f;
#pragma unroll
    for (int dd = 0; dd < kD; ++dd)
      fc = __fmaf_rn(shn[dd], w1[dd * ff_pad + m0 + lane], fc);
    sf[m0 + lane] = gelu_tanh(fc + b1[m0 + lane]);
  }
  __syncwarp();
  float yc = 0.f;
  for (int j = 0; j < ff_pad; ++j) yc = __fmaf_rn(sf[j], w2[j * kD + lane], yc);
  x = (x + yc) + b2[lane];

  // the final norm and the head
  mu = warp_sum(x) * (1.f / kD);
  d = x - mu;
  r = rsqrtf(warp_sum(d * d) * (1.f / kD) + 1e-6f);
  const float hf = ((x - mu) * r) * fin[lane] + fin[kD + lane];
  return warp_sum(hf * fin[2 * kD + lane]) + fin[3 * kD];
}

template <int H, int KT>
__global__ void __launch_bounds__(kMaxThreads, 1)
    fused_sequence_kernel(SeqArgs a) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const Layout& L = a.lay;
  const int ff_pad = L.ff_pad;

  // --- every weight, once per block
  stage(sm, a.embed_w, a.n_in, kD, L.in_pad, kD);
  stage(sm + L.emb_b(), a.embed_b, 1, kD, 1, kD);
  for (int l = 0; l < L.n_layers; ++l) {
    float* w = sm + L.layer(l);
    const LayerPtrs& p = a.layer[l];
    stage(w + kLn1G, p.ln1_g, 1, kD, 1, kD);
    stage(w + kLn1B, p.ln1_b, 1, kD, 1, kD);
    stage(w + kWq, p.wq, kD, kD, kD, kD);
    stage(w + kWk, p.wk, kD, kD, kD, kD);
    stage(w + kWv, p.wv, kD, kD, kD, kD);
    stage(w + kWo, p.wo, kD, kD, kD, kD);
    stage(w + kLn2G, p.ln2_g, 1, kD, 1, kD);
    stage(w + kLn2B, p.ln2_b, 1, kD, 1, kD);
    stage(w + kW1, p.w1, kD, a.d_ff, kD, ff_pad);
    stage(w + kW1 + kD * ff_pad, p.b1, 1, a.d_ff, 1, ff_pad);
    stage(w + kW1 + kD * ff_pad + ff_pad, p.w2, a.d_ff, kD, ff_pad, kD);
    stage(w + kW1 + 65 * ff_pad, p.b2, 1, kD, 1, kD);
  }
  float* fin = sm + L.final_norm();
  stage(fin, a.lnf_g, 1, kD, 1, kD);
  stage(fin + kD, a.lnf_b, 1, kD, 1, kD);
  stage(fin + 2 * kD, a.head_w, kD, 1, kD, 1);
  stage(fin + 3 * kD, a.head_b, 1, 1, 1, 4);

  const int tid = threadIdx.x;
  const int g = tid / KT;  // the tile's row
  const int t = tid - g * KT;  // the position
  float* xs_all = sm + L.weights();
  float* xs = xs_all + tid * kRow;  // own input row
  float* keys = xs_all + L.rows * KT * kRow + g * KT * kRow;  // the row's
  float* vals = keys + L.rows * KT * kRow;
  float* rs = xs_all + 3 * L.rows * KT * kRow + g * L.row_scratch();
  float* ks = keys + t * kRow;
  float* vs = vals + t * kRow;
  const float inv_scale = 1.f / sqrtf((float)(kD / H));
  const int ntiles = (a.B + L.rows - 1) / L.rows;
  __syncthreads();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int row = tile * L.rows + g;
    int qrow = -1;  // -1: nothing to compute for this row
    if (row < a.B) {
      const int q = __ldg(a.qpos + row);
      if (q >= 0 && q < a.K) {
        qrow = q;
      } else if (t == 0) {
        a.out[row] = __int_as_float(0x7fffffff);  // NaN: qpos off the row
      }
    }
    // a warp whose positions all lie past qpos does nothing for the logit
    const bool live = (t & ~31) <= qrow;

    float h[kD];
    float q[kD];
    float acc[kD];
    if (live) {
      // --- the embedding
      const float* x = a.hist + ((size_t)row * a.K + t) * a.n_in;
      for (int i = 0; i < L.in_pad; ++i)
        xs[i] = (t < a.K && i < a.n_in) ? __ldg(x + i) : 0.f;
      zero(acc);
      matvec(xs, sm, kD, L.in_pad, acc);
#pragma unroll
      for (int c = 0; c < kD; ++c) h[c] = acc[c] + sm[L.emb_b() + c];
    }

    // --- every block but the last, at every position
    for (int l = 0; l + 1 < L.n_layers; ++l) {
      const float* w = sm + L.layer(l);
      if (live) {
        layer_norm(h, w + kLn1G, w + kLn1B, xs);
        zero(acc);
        matvec(xs, w + kWk, kD, kD, acc);
        store_row(ks, acc);
        zero(acc);
        matvec(xs, w + kWv, kD, kD, acc);
        store_row(vs, acc);
        zero(q);
        matvec(xs, w + kWq, kD, kD, q);
      }
      __syncthreads();  // the row's keys and values are written
      if (live) {
        attend<H, KT>(q, keys, vals, t, qrow, inv_scale, xs);
        zero(acc);
        matvec(xs, w + kWo, kD, kD, acc);
#pragma unroll
        for (int c = 0; c < kD; ++c) h[c] = h[c] + acc[c];
      }
      __syncthreads();  // the row's keys and values are read
      if (live) {
        layer_norm(h, w + kLn2G, w + kLn2B, xs);
        const float* w1 = w + kW1;
        const float* b1 = w1 + kD * ff_pad;
        const float* w2 = b1 + ff_pad;
        const float* b2 = w2 + ff_pad * kD;
        float y[kD];
        zero(y);
        for (int m0 = 0; m0 < ff_pad; m0 += 32) {
          zero(acc);
          matvec(xs, w1 + m0, ff_pad, kD, acc);
#pragma unroll
          for (int c = 0; c < kD; ++c) acc[c] = gelu_tanh(acc[c] + b1[m0 + c]);
          store_row(ks, acc);  // own key row as scratch
          matvec(ks, w2 + m0 * kD, kD, 32, y);
        }
#pragma unroll
        for (int c = 0; c < kD; ++c) h[c] = (h[c] + y[c]) + b2[c];
      }
    }

    // --- the last block: keys and values at every position
    const float* w = sm + L.layer(L.n_layers - 1);
    if (live) {
      layer_norm(h, w + kLn1G, w + kLn1B, xs);
      zero(acc);
      matvec(xs, w + kWk, kD, kD, acc);
      store_row(ks, acc);
      zero(acc);
      matvec(xs, w + kWv, kD, kD, acc);
      store_row(vs, acc);
      if (t == qrow) store_row(rs, h);  // hq
    }
    __syncthreads();
    // ... and the rest at qpos, by the row's first warp
    if (t < 32 && qrow >= 0) {
      const float* hnq = xs_all + (g * KT + qrow) * kRow;
      const float z = last_position<H, KT>(w, fin, hnq, keys, vals, rs,
                                           qrow, ff_pad, inv_scale, t);
      if (t == 0) a.out[row] = z;
    }
    __syncthreads();  // the tile's scratch is free
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return n;
}

// The tile shape for these widths; rows = 0 when not even one row fits.
Layout layout(int n_in, int n_layers, int d_ff, int k, int heads) {
  Layout L;
  L.in_pad = (n_in + 3) / 4 * 4;
  L.ff_pad = (d_ff + 31) / 32 * 32;
  L.n_layers = n_layers;
  L.heads = heads;
  L.kt = k <= 32 ? 32 : 64;
  L.rows = 0;
  const int room = kMaxSmem / 4 - L.weights();
  const int by_smem = room > 0 ? room / L.per_row() : 0;
  const int by_threads = kMaxThreads / L.kt;
  L.rows = by_smem < by_threads ? by_smem : by_threads;
  return L;
}

template <int H, int KT>
cudaError_t launch(const SeqArgs& a, cudaStream_t stream) {
  auto kernel = fused_sequence_kernel<H, KT>;
  const int smem = a.lay.floats() * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const int threads = a.lay.rows * KT;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int ntiles = (a.B + a.lay.rows - 1) / a.lay.rows;
  int blocks = sm_count() * per_sm;
  if (blocks < 1) return cudaErrorInvalidDevice;
  if (blocks > ntiles) blocks = ntiles;
  kernel<<<blocks, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_sequence_d_model() { return kD; }

int fused_sequence_max_k() { return kMaxK; }

int fused_sequence_max_in() { return kMaxIn; }

int fused_sequence_max_ff() { return kMaxFF; }

int fused_sequence_max_layers() { return kMaxLayers; }

int fused_sequence_heads() { return kHeads; }

// Rows per tile for these widths (0: they do not fit);
// ops/sequence_kernels.py::tile_rows computes the same.
int fused_sequence_rows(int n_in, int n_layers, int d_ff, int k, int heads) {
  return layout(n_in, n_layers, d_ff, k, heads).rows;
}

// Shared-memory bytes of one block; ops/sequence_kernels.py::smem_bytes.
int fused_sequence_smem_bytes(int n_in, int n_layers, int d_ff, int k,
                              int heads) {
  return layout(n_in, n_layers, d_ff, k, heads).floats() * 4;
}

// Launches the kernel on `stream` and returns the CUDA error (0 = ok).
// `params` holds 6 + 12 n_layers device pointers: embed_w, embed_b,
// lnf_g, lnf_b, head_w, head_b, then per layer the BlockParams leaves in
// their order (ln1_g, ln1_b, wq, wk, wv, wo, ln2_g, ln2_b, w1, b1, w2,
// b2).
int fused_sequence_launch(const float* hist, const int* qpos,
                          const void* const* params, int n_params,
                          float* out, int B, int K, int n_in, int n_layers,
                          int d_ff, int heads, void* stream) {
  if (B < 1 || K < 1 || K > kMaxK || n_in < 1 || n_in > kMaxIn ||
      n_layers < 1 || n_layers > kMaxLayers || d_ff < 1 || d_ff > kMaxFF ||
      n_params != kParamsOuter + kParamsPerLayer * n_layers)
    return (int)cudaErrorInvalidValue;
  SeqArgs a;
  a.hist = hist;
  a.qpos = qpos;
  const float* const* p = reinterpret_cast<const float* const*>(params);
  a.embed_w = p[0];
  a.embed_b = p[1];
  a.lnf_g = p[2];
  a.lnf_b = p[3];
  a.head_w = p[4];
  a.head_b = p[5];
  for (int l = 0; l < n_layers; ++l) {
    const float* const* q = p + kParamsOuter + kParamsPerLayer * l;
    a.layer[l] = LayerPtrs{q[0], q[1], q[2], q[3], q[4],  q[5],
                           q[6], q[7], q[8], q[9], q[10], q[11]};
  }
  a.out = out;
  a.B = B;
  a.K = K;
  a.n_in = n_in;
  a.d_ff = d_ff;
  a.lay = layout(n_in, n_layers, d_ff, K, heads);
  if (a.lay.rows < 1) return (int)cudaErrorInvalidValue;
  if (heads != kHeads) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a.lay.kt == 64 ? launch<kHeads, 64>(a, s)
                              : launch<kHeads, 32>(a, s));
}

}  // extern "C"
