#!/usr/bin/env python3
"""Time forms of the forest walk's inner loop on one card.

    python3 tools/torch_walk_forms.py

The port's two forest kernels share one descent (``csrc/forest_walk.cuh``):
per row, ``kTreesInFlight`` trees at a time, node records read through the
read-only path. This script rebuilds both kernels' own sources against
copies of that header that differ in one respect each:

- ``pointer``: the port's form: ten trees in flight, each chain keeping a
  pointer to its current record, 128 rows per block;
- ``offset``: each chain keeps its record's index within the group;
- ``x5`` and ``x20``: five or twenty trees in flight;
- ``rows256``: 256 rows per block;

binds each build through the port's own wrappers (``ops/forest_kernels.py``,
so the launch interface is the port's), checks that every build's sums and
features equal the port's bit for bit, then times them in turns (in order,
then in reverse order; device time of launches captured in a CUDA graph,
``chip_smoke.graph_ms``) at B = 65,536 rows on the T=100 forests of
``chip_smoke.py``'s phase ``kernel``, int8 tables. Prints one JSON line per
forest, kernel and form, with the card's name and power limit. Exits
non-zero without CUDA.
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

_POINTER = """\
    const int4* root[kTreesInFlight];
    const int4* at[kTreesInFlight];
    int steps = 0;
#pragma unroll
    for (int k = 0; k < kTreesInFlight; ++k) {
      root[k] = at[k] = f.nodes + (size_t)(t0 + k) * f.N;
      steps = max(steps, __ldg(f.depth + t0 + k));
    }
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < kTreesInFlight; ++k) {
        const int4 n = __ldg(at[k]);
        const float v = xs[n.x * kForestRows + tid];
        at[k] = root[k] + (v <= __int_as_float(n.y) ? n.z : n.w);
      }
    }
#pragma unroll
    for (int k = 0; k < kTreesInFlight; ++k) {
      acc += __int_as_float(__ldg(&at[k]->y));
    }
"""
_OFFSET = """\
    const int4* group = f.nodes + (size_t)t0 * f.N;
    int at[kTreesInFlight];
    int steps = 0;
#pragma unroll
    for (int k = 0; k < kTreesInFlight; ++k) {
      at[k] = k * f.N;
      steps = max(steps, __ldg(f.depth + t0 + k));
    }
    for (int s = 0; s < steps; ++s) {
#pragma unroll
      for (int k = 0; k < kTreesInFlight; ++k) {
        const int4 n = __ldg(group + at[k]);
        const float v = xs[n.x * kForestRows + tid];
        at[k] = k * f.N + (v <= __int_as_float(n.y) ? n.z : n.w);
      }
    }
#pragma unroll
    for (int k = 0; k < kTreesInFlight; ++k) {
      acc += __int_as_float(__ldg(&group[at[k]].y));
    }
"""
# form → (loop body, trees in flight, rows per block)
FORMS = {"pointer": (_POINTER, 10, 128), "offset": (_OFFSET, 10, 128),
         "x5": (_POINTER, 5, 128), "x20": (_POINTER, 20, 128),
         "rows256": (_POINTER, 10, 256)}


def _header(text: str, body: str, k: int, rows: int) -> str:
    """The port's header with the group loop's body, the trees in flight
    and the rows per block replaced."""
    loop = "  for (int t0 = 0; t0 < f.T; t0 += kTreesInFlight) {\n"
    head, rest = text.split(loop, 1)
    old, tail = rest.split("  }\n  return acc;\n", 1)
    if old not in (_POINTER, _OFFSET):
        raise RuntimeError("csrc/forest_walk.cuh's loop is not a known form")
    out = head + loop + body + "  }\n  return acc;\n" + tail
    out = out.replace("kForestRows = 128;", f"kForestRows = {rows};")
    return out.replace("kTreesInFlight = 10;", f"kTreesInFlight = {k};")


def _build(cuda_lib, form: str) -> Path:
    """Both kernels' sources built against the form's header; returns the
    directory that holds them."""
    body, k, rows = FORMS[form]
    src = cuda_lib.BUILD_DIR / "walk_forms" / form
    src.mkdir(parents=True, exist_ok=True)
    for name in ("features.cuh", "fused_forest.cu", "leaf_sum.cu"):
        text = (cuda_lib.CSRC / name).read_text()
        # a line of its own makes each form's library a build of its own
        (src / name).write_text(f"// walk form: {form}\n{text}")
    (src / "forest_walk.cuh").write_text(
        _header((cuda_lib.CSRC / "forest_walk.cuh").read_text(), body, k,
                rows))
    for name in ("fused_forest.cu", "leaf_sum.cu"):
        cuda_lib.build_library(src / name)
    return src


def _bind(fk, form: str, src: Path) -> dict:
    """The form's two libraries, bound (and their layout checked) by the
    port's own loaders: {"fused": lib, "leaf": lib}."""
    _, k, rows = FORMS[form]
    saved = fk.TREES_IN_FLIGHT, fk.BLOCK_ROWS
    fk.TREES_IN_FLIGHT, fk.BLOCK_ROWS = k, rows
    try:
        return {"fused": fk._library(src / "fused_forest.cu"),
                "leaf": fk._leaf_sum_library(src / "leaf_sum.cu")}
    finally:
        fk.TREES_IN_FLIGHT, fk.BLOCK_ROWS = saved


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_walk_forms: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        ragged_ensemble,
        synthetic_ensemble,
        to_gemm,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        fit_scaler,
        transform,
    )
    from real_time_fraud_detection_system_tpu_torch.ops import cuda_lib
    from real_time_fraud_detection_system_tpu_torch.ops import (
        forest_kernels as fk,
    )
    from real_time_fraud_detection_system_tpu_torch.ops.features_fused import (
        assemble_features,
        gather_feature_rows,
    )

    dev = torch.device("cuda", 0)
    info = chip_smoke.phase_device()
    shutil.rmtree(cuda_lib.BUILD_DIR / "walk_forms", ignore_errors=True)
    with ThreadPoolExecutor(len(FORMS)) as pool:
        futures = {f: pool.submit(_build, cuda_lib, f) for f in FORMS}
        libs = {f: _bind(fk, f, fut.result()) for f, fut in futures.items()}

    # the fused kernel's arguments by keyword, as chip_smoke.py builds them
    args = chip_smoke._feature_inputs(np.random.default_rng(0), ROWS, 40, dev)
    feats = assemble_features(
        *gather_feature_rows(args["customer"], args["terminal"],
                             args["cust_slot"], args["term_slot"]),
        args["day"], args["tod_s"], args["amount"], windows=(1, 7, 30),
        delay=7, weekend_start=5, night_end=6)
    scaler = fit_scaler(feats.cpu().numpy(), device=dev)
    args.update(scaler_mean=scaler.mean, scaler_scale=scaler.scale)
    x = transform(scaler, feats).contiguous()
    for fname, (n_trees, depth, ragged) in chip_smoke.FORESTS.items():
        if n_trees != 100:
            continue
        make = ragged_ensemble if ragged else synthetic_ensemble
        tables = fk.to_kernel_tables(
            to_gemm(make(n_trees, depth, 15, seed=0, device=dev), 15), "int8")
        want = fk.fused_forest_leaf_sum(tables, **args), fk.leaf_sum(tables, x)
        times = {(form, kern): [] for form in libs
                 for kern in ("fused", "leaf")}

        def run(form, kern):
            """One launch through the port's wrapper with the form's
            library in place of the port's."""
            lib = libs[form]
            saved = fk._library, fk._leaf_sum_library
            fk._library, fk._leaf_sum_library = (lambda: lib["fused"],
                                                 lambda: lib["leaf"])
            try:
                if kern == "fused":
                    return fk.fused_forest_leaf_sum(tables, **args)
                return fk.leaf_sum(tables, x)
            finally:
                fk._library, fk._leaf_sum_library = saved

        for form in libs:
            leaf, kfeats = run(form, "fused")
            lsum = run(form, "leaf")
            torch.cuda.synchronize()
            chip_smoke.check(torch.equal(leaf, want[0][0])
                             and torch.equal(kfeats, want[0][1])
                             and torch.equal(lsum, want[1]),
                             f"form {form} differs from the port on {fname}")
        order = list(times) + list(times)[::-1]
        for form, kern in order:
            times[form, kern].append(chip_smoke.graph_ms(
                lambda: run(form, kern), REPS))
        for (form, kern), ms in times.items():
            print(json.dumps({
                "forest": fname, "kernel": kern, "form": form, "rows": ROWS,
                "ms_runs": ms, "ms": sum(ms) / len(ms),
                "card": info["smi_name"], "power_limit": info["power_limit"],
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
