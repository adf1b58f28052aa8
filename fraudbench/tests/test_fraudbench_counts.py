"""The counts kept with the benchmark agree with shapes worked out by
hand."""

import math

from fraudbench.counts.leaf_sum import leaf_sum_counts
from fraudbench.counts.step import forest_ops_per_row, transformer_ops_per_row


def test_leaf_sum_bytes_and_operations():
    c = leaf_sum_counts(65536, 15, 100, 8)
    # x [65536, 15] f32 + out [65536] f32 + 100 trees of 255 internal
    # nodes (feature, threshold) and 256 leaves (value)
    assert c["bytes"] == 65536 * 15 * 4 + 65536 * 4 + 100 * (255 * 8
                                                             + 256 * 4)
    assert c["bytes"] == 4_500_704
    assert c["ops"] == 65536 * 100 * (8 + 1)
    assert c["bound_by"] == "bytes"
    assert math.isclose(c["bound_s"], 4_500_704 / 3.35e12)


def test_forest_step_operations():
    # features: 2 tables x 40 buckets x (3 + 3 x 3 windows), 2 x 3 ratios,
    # 4 flag operations, 2 x 15 for the standardization; the descent:
    # 100 trees x (8 compares + 1 add)
    assert forest_ops_per_row(40, 3, 15, 100, 8) == (
        2 * 40 * 12 + 6 + 4 + 30) + 900 == 1900


def test_transformer_operations_match_the_ports_count():
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        init_transformer,
        transformer_flops,
    )

    p = init_transformer(d_model=32, n_heads=2, n_layers=2, d_ff=64,
                         device="cpu")
    assert transformer_ops_per_row(8, 32, 2, 2, 64, 32) == transformer_flops(
        p, 1, 32)
    # by hand: embedding 2·32·8·32; the first layer at 32 positions
    # (q, k, v, o 4·2·32·32 each, the MLP 2·2·32·64, scores and weighted
    # sums 2·2·32·32·32); the last layer's k and v at 32 positions, q, o
    # and the MLP at one, one query's scores and sums; the head 2·32
    first = 32 * (4 * 2048 + 8192) + 4 * 32 * 32 * 32
    last = 32 * 2 * 2048 + 2 * 2048 + 8192 + 4 * 32 * 32
    assert transformer_ops_per_row(8, 32, 2, 2, 64, 32) == (
        2 * 32 * 8 * 32 + first + last + 64)
