#!/usr/bin/env python3
"""Time forms of the fused kernels' row loader on one card.

    python3 tools/torch_loader_forms.py

The port's two fused kernels (``csrc/fused_score.cu``,
``csrc/fused_forest.cu``) share one loader of the state rows, the section
of ``csrc/features.cuh`` between ``// ---- loader: begin`` and
``// ---- loader: end``. This script rebuilds both kernels' own sources
against copies of that header whose loader section is one of:

- ``direct``: the port's: each thread reads its own rows by slot, two
  back-to-back 16-byte loads per 32-byte sector through the read-only
  path (narrower loads where NB % 4 != 0), with no shared memory;
- ``staged``: each warp streams its 32 rows' runs through a
  double-buffered tile in static shared memory with 4-byte ``cp.async``,
  eight lanes on one row's 32-byte sector, while each lane adds the
  previous chunk of its own row.

It binds each build through the port's own wrappers
(``ops/score_kernels.py``, ``ops/forest_kernels.py``, so the launch
interface is the port's), checks that every build's features, sums and
probabilities equal the port's bit for bit, then times them in turns (in
order, then in reverse order; device time of launches captured in a CUDA
graph, ``chip_smoke.graph_ms``) at B = 65,536 rows and NB = 40 on
``chip_smoke.py``'s inputs (state tables at the default capacities, slots
over the default dataset's ids) and its flagship forest (T=100, depth 8,
int8 tables), twice: with the slots as drawn, and with each slot column
sorted (neighbouring rows of a warp then read the same or neighbouring
runs). Prints one JSON line per slot order, kernel and form, with the
card's name and power limit, then a line with each form's time relative
to the direct one's. Exits non-zero without CUDA.
"""

from __future__ import annotations

import json
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
ROWS = 65536
REPS = 50
BEGIN = "// ---- loader: begin"
END = "// ---- loader: end\n"

_STAGED = r""" (form: staged)
//
// Each warp owns 32 consecutive rows of the batch and streams their runs
// through a tile of shared memory, kChunk words of every run at a time:
// the customer table's chunks, then the terminal table's. Lane l copies
// word l % 8 of the chunk of rows 4i + l / 8 (i = 0..7) with 4-byte
// cp.async, so eight lanes cover one row's 32-byte sector and a warp
// instruction reads four whole sectors; 4-byte copies take every NB. Two
// buffers: chunk j+1's copies are in flight while each lane adds chunk j
// of its own row from the tile. Tile: per buffer three arrays of [32
// rows][8 words], word w of row r at r * 8 + (w ^ (r & 4)), so a copy
// instruction writes 32 consecutive words and each quarter-warp's 16-byte
// reads of its eight rows fall on eight distinct bank groups. The tiles of
// a block's four warps (both kernels run 128-row blocks) are static shared
// memory, 24 KB.

constexpr int kWarpRows = 32;
constexpr int kLoaderWarps = 4;
constexpr int kTileWords = kWarpRows * kChunk;  // one array, one buffer
constexpr int kBufferWords = 3 * kTileWords;

__device__ __forceinline__ void cp_async4(int* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <class Sink>
__device__ __forceinline__ void stream_rows(const FeatureArgs& a, int cslot,
                                            int tslot, Sink&& sink) {
  __shared__ __align__(16) int tiles[kLoaderWarps][2 * kBufferWords];
  int* stage = tiles[threadIdx.x / kWarpRows];
  const int lane = threadIdx.x % kWarpRows;
  const int w = lane % kChunk;
  constexpr int kRowsPerCopy = kWarpRows / kChunk;
  int cs[kChunk], ts[kChunk];  // the slots of the rows this lane copies for
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    cs[i] = __shfl_sync(0xffffffffu, cslot, i * kRowsPerCopy + lane / kChunk);
    ts[i] = __shfl_sync(0xffffffffu, tslot, i * kRowsPerCopy + lane / kChunk);
  }
  const int chunks = (a.NB + kChunk - 1) / kChunk;
  const int n_stages = 2 * chunks;

  auto copy_stage = [&](int s) {
    const bool term = s >= chunks;
    const int k = (s - (term ? chunks : 0)) * kChunk + w;
    const int* bd = term ? a.t_bd : a.c_bd;
    const float* x0 = term ? a.t_cnt : a.c_cnt;
    const float* x1 = term ? a.t_frd : a.c_amt;
    int* buf = stage + (s & 1) * kBufferWords;
    if (k < a.NB) {
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int r = i * kRowsPerCopy + lane / kChunk;
        const size_t off = (size_t)(term ? ts[i] : cs[i]) * a.NB + k;
        const int at = r * kChunk + (w ^ (r & 4));
        cp_async4(buf + at, bd + off);
        cp_async4(buf + kTileWords + at, x0 + off);
        cp_async4(buf + 2 * kTileWords + at, x1 + off);
      }
    }
    cp_async_commit();
  };

  copy_stage(0);
  for (int s = 0; s < n_stages; ++s) {
    if (s + 1 < n_stages) {
      copy_stage(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const bool term = s >= chunks;
    const int k0 = (s - (term ? chunks : 0)) * kChunk;
    const int* buf = stage + (s & 1) * kBufferWords;
    const int lo = (lane >> 2) & 1;  // the vector that holds words 0..3
    int v[3][kChunk];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int4* row =
          reinterpret_cast<const int4*>(buf + p * kTileWords + lane * kChunk);
      const int4 a0 = row[lo], a1 = row[lo ^ 1];
      v[p][0] = a0.x; v[p][1] = a0.y; v[p][2] = a0.z; v[p][3] = a0.w;
      v[p][4] = a1.x; v[p][5] = a1.y; v[p][6] = a1.z; v[p][7] = a1.w;
    }
    __syncwarp();  // every lane has read the buffer before it is refilled
    float x0[kChunk], x1[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      x0[j] = __int_as_float(v[1][j]);
      x1[j] = __int_as_float(v[2][j]);
    }
    sink(term ? 1 : 0, min(kChunk, a.NB - k0), v[0], x0, x1);
  }
}
"""
# form → loader section after the begin marker (None: the port's own)
FORMS = {"direct": None, "staged": _STAGED}
KERNELS = ("fused_featurize_score", "fused_forest_leaf_sum")


def _loader(text: str) -> tuple:
    """(head, loader section, tail) of features.cuh."""
    head, rest = text.split(BEGIN, 1)
    section, tail = rest.split(END, 1)
    return head, section, tail


def _build(cuda_lib, form: str) -> Path:
    """Both fused kernels' sources built against the form's header;
    returns the directory that holds them."""
    head, own, tail = _loader((cuda_lib.CSRC / "features.cuh").read_text())
    if "(form: direct)" not in own.splitlines()[0]:
        raise RuntimeError("csrc/features.cuh's loader is not the direct "
                           "form")
    section = FORMS[form] or own
    src = cuda_lib.BUILD_DIR / "loader_forms" / form
    src.mkdir(parents=True, exist_ok=True)
    (src / "features.cuh").write_text(head + BEGIN + section + END + tail)
    shutil.copy(cuda_lib.CSRC / "forest_walk.cuh", src / "forest_walk.cuh")
    for name in ("fused_score.cu", "fused_forest.cu"):
        text = (cuda_lib.CSRC / name).read_text()
        # a line of its own makes each form's library a build of its own
        (src / name).write_text(f"// loader form: {form}\n{text}")
        cuda_lib.build_library(src / name)
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_loader_forms: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        synthetic_ensemble,
        to_gemm,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        fit_scaler,
    )
    from real_time_fraud_detection_system_tpu_torch.ops import cuda_lib
    from real_time_fraud_detection_system_tpu_torch.ops import (
        forest_kernels as fk,
    )
    from real_time_fraud_detection_system_tpu_torch.ops import (
        score_kernels as sk,
    )
    from real_time_fraud_detection_system_tpu_torch.ops.features_fused import (
        assemble_features,
        gather_feature_rows,
    )

    dev = torch.device("cuda", 0)
    info = chip_smoke.phase_device()
    shutil.rmtree(cuda_lib.BUILD_DIR / "loader_forms", ignore_errors=True)
    with ThreadPoolExecutor(len(FORMS)) as pool:
        futures = {f: pool.submit(_build, cuda_lib, f) for f in FORMS}
        # bound (and their layout checked) by the port's own loaders
        libs = {f: {KERNELS[0]: sk._library(src / "fused_score.cu"),
                    KERNELS[1]: fk._library(src / "fused_forest.cu")}
                for f, src in ((f, fut.result())
                               for f, fut in futures.items())}

    rng = np.random.default_rng(0)
    args = chip_smoke._feature_inputs(rng, ROWS, 40, dev)
    feats = assemble_features(
        *gather_feature_rows(args["customer"], args["terminal"],
                             args["cust_slot"], args["term_slot"]),
        args["day"], args["tod_s"], args["amount"], windows=(1, 7, 30),
        delay=7, weekend_start=5, night_end=6)
    scaler = fit_scaler(feats.cpu().numpy(), device=dev)
    args.update(scaler_mean=scaler.mean, scaler_scale=scaler.scale)
    extra = dict(valid=torch.as_tensor(rng.random(ROWS) < 0.95, device=dev),
                 w=torch.as_tensor(np.random.default_rng(0).normal(size=15)
                                   .astype(np.float32), device=dev),
                 b=torch.tensor(0.0, device=dev))
    tables = fk.to_kernel_tables(
        to_gemm(synthetic_ensemble(100, 8, 15, seed=0, device=dev), 15),
        "int8")
    orders = {"drawn": args,
              "sorted": dict(args, **{k: torch.sort(args[k]).values
                                      for k in ("cust_slot", "term_slot")})}

    def run(form, kern, fargs):
        """One launch through the port's wrapper with the form's library
        in place of the port's."""
        lib = libs[form][kern]
        mod = sk if kern == KERNELS[0] else fk
        saved = mod._library
        mod._library = lambda: lib
        try:
            if kern == KERNELS[0]:
                return sk.fused_featurize_score(**fargs, **extra)
            return fk.fused_forest_leaf_sum(tables, **fargs)
        finally:
            mod._library = saved

    for order, fargs in orders.items():
        want = {KERNELS[0]: sk.fused_featurize_score(**fargs, **extra),
                KERNELS[1]: fk.fused_forest_leaf_sum(tables, **fargs)}
        for form in libs:
            for kern in KERNELS:
                got = run(form, kern, fargs)
                torch.cuda.synchronize()
                chip_smoke.check(all(torch.equal(g, w) for g, w
                                     in zip(got, want[kern])),
                                 f"form {form} differs from the port on "
                                 f"{kern} ({order} slots)")
        times = {(form, kern): [] for form in libs for kern in KERNELS}
        for form, kern in list(times) + list(times)[::-1]:
            times[form, kern].append(chip_smoke.graph_ms(
                lambda: run(form, kern, fargs), REPS))
        mean = {key: sum(ms) / len(ms) for key, ms in times.items()}
        for (form, kern), ms in times.items():
            print(json.dumps({
                "kernel": kern, "form": form, "slots": order, "rows": ROWS,
                "nb": 40, "ms_runs": ms, "ms": mean[form, kern],
                "card": info["smi_name"], "power_limit": info["power_limit"],
            }), flush=True)
        print(json.dumps({
            "slots": order,
            "relative_to_direct": {
                kern: {form: mean[form, kern] / mean["direct", kern]
                       for form in libs} for kern in KERNELS},
            "card": info["smi_name"], "power_limit": info["power_limit"],
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
