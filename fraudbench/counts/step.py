"""Operations of one scored row of each configuration's whole step,
counted from the shapes, for ``step_mfu``: the step's share of the
card's 67 TFLOP/s of float32 outside the tensor cores (the
configurations keep float32 products at the "highest" precision).

- Forest: the features' operations (a copy of ``chip_smoke.py``'s
  ``_feature_ops``: per table and day bucket an age, two liveness
  compares and, per window, a compare and two adds; the ratios and
  flags; the standardization) plus the descent's (per tree one compare
  per level and one leaf add). The key directory's and the sketch's
  integer work is not counted.
- Sequence: a copy of ``models/sequence.py::transformer_flops`` (a
  multiply-add is 2): the layers before the last at every position, the
  last block, the final norm and the head at the row's own position.
"""

from __future__ import annotations


def forest_ops_per_row(n_day_buckets: int, n_windows: int, n_features: int,
                       n_trees: int, max_depth: int) -> int:
    features = (2 * n_day_buckets * (3 + 3 * n_windows) + 2 * n_windows + 4
                + 2 * n_features)
    return features + n_trees * (max_depth + 1)


def transformer_ops_per_row(n_in: int, d_model: int, n_heads: int,
                            n_layers: int, d_ff: int, k: int) -> int:
    d, f = d_model, d_ff
    hd = (d_model // n_heads) * n_heads
    proj = 2 * d * hd  # one of q/k/v/o at one position
    full = k * (4 * proj + 2 * 2 * d * f) + 2 * 2 * k * k * hd
    per_row = 2 * k * n_in * d + (n_layers - 1) * full
    per_row += k * 2 * proj + 2 * proj + 2 * 2 * d * f + 2 * 2 * k * hd
    per_row += 2 * d
    return int(per_row)
