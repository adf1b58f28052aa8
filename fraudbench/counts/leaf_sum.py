"""Bytes and operations of the leaf sum (``csrc/leaf_sum.cu``): per row
and tree, one compare per level of the path the row takes and one add
of its leaf; each input byte read once and each output byte written
once, whatever the kernel reads again (the rows' scaled features
``[B, F]`` float32, the trees: per internal node its feature and
threshold, per leaf its value, 4 B each) and the sum ``[B]`` float32.

A copy of ``chip_smoke.py``'s ``_bound``, ``_walk_ops`` and
``_tree_bytes`` for complete trees, where every path has ``max_depth``
levels."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores


def leaf_sum_counts(rows: int, n_features: int, n_trees: int,
                    max_depth: int) -> dict:
    """One launch over ``rows`` rows (the padded bucket)."""
    internal = n_trees * (2 ** max_depth - 1)
    leaves = n_trees * 2 ** max_depth
    nbytes = rows * n_features * 4 + rows * 4 + 8 * internal + 4 * leaves
    ops = rows * n_trees * (max_depth + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
