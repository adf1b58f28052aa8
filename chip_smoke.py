#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving paths on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. ``device`` — the card's name and count, and nvidia-smi's name and power
   limit (also printed as nvidia-smi gives them).
2. ``build`` — build every kernel from ``csrc/`` (one nvcc for each source,
   all started together, for sm_90a), one line per library with the
   compiler's register and shared-memory report.
3. ``kernel`` — each kernel against its plain PyTorch version on the card,
   with its device time (``graph_ms``), the plain version's time and its
   bound: the fused
   featurize→forest kernel and the leaf-sum kernel, bit for bit, in every
   z mode, on three forests of T=100 — the flagship shape (complete trees
   of depth 8), ragged trees of depths 1..8 and ragged trees of depths
   1..12 (``models/forest.py::ragged_ensemble``, seeded numpy: leaves at
   many depths, trees of different depths side by side), and ten complete
   trees of depth 11 — and the fused featurize→logreg kernel, each at a
   ragged B = 300 and the serving bucket B = 65,536, and at B = 300 with
   NB = 38. The fused kernels read feature-state tables of the default
   capacities by slots drawn over the default dataset's id ranges; beside
   them ``gathers_ms`` times the row gathers they make unnecessary. The
   stamp kernel (``csrc/stamp.cu``) brackets bfloat16 products of about
   0.2, 1 and 4 ms: each interval between its two stamps against CUDA
   events recorded just outside them on the same stream, within
   ``ATOL_STAMP_MS``.
4. ``main_path`` — the default dataset (``DataConfig()``, seed 0) served
   through ``ScoringEngine.run`` at 65,536-row batches into a
   ``MemorySink``, once per model kind: forest (the fused forest kernel),
   logreg (the fused logreg kernel) and gbt (the unfused step with the
   leaf-sum kernel). The weights are synthetic, seeded from 0, and reach
   the engine through the port's own artifact writer and reader. Every
   launch counter is set to 0 just before each run and read just after:
   the path's own kernel must launch once per batch and the others not at
   all. The first two batches are held against a CPU-device engine.
   Each path runs at the engine's default ``pipeline_depth=2``; the host
   prep must take the native route (``native/hostprep.cc``).
5. ``serving_loop`` — the forest path over the full dataset at pipeline
   depths 1, 2 and 3, and at depth 2 with ``coalesce_rows=65536`` over a
   16,384-row source: the sink output bit-identical across depths, and the
   coalesced output identical to the 65,536-row source's; rows/s, latency
   and stage medians of each run. Then a few batches at depth 1 and depth
   2 under ``torch.profiler``: the packed batch's copy must be ``Pinned ->
   Device`` and the result copies ``Device -> Pinned``, with the device's
   idle share of each.
6. ``hash_path`` — forest, logreg and gbt with ``key_mode="hash"`` at the
   default capacities; ``cms_path`` — forest and gbt with
   ``customer_source="cms"`` (the leaf-sum kernel serves both). The same
   checks as ``main_path``: each path's own kernel once per batch, the
   others never, the first two batches equal to a CPU-device engine.
7. ``cli`` — ``cli.main(["score", ...])`` on the card over the default
   dataset and the forest artifact written to a temporary directory:
   columnar over every row, and envelope mode on a slice through the
   native decoder; the slice again with ``--prefetch-batches 2
   --metrics-dump --flight-record --trace-out`` (a record and a dispatch
   span per batch); and the default dataset's first 2 batches with
   ``--out`` on the card and with ``--scorer cpu`` (the host's NumPy
   oracle), probabilities within 1e-6 of each other (the card machine has no pyarrow: ``--out``
   lands in an in-memory sink).
8. ``recovery`` — exactly-once durability on the forest path (whole-dollar
   amounts, checkpoints every 8 batches, a full every 4 saves, a local
   ``Checkpointer`` in a temporary directory; results kept by
   ``batch_index``, a replay overwriting its entry): (a) the clean run
   with and without checkpoints — save ms and bytes (full, delta), restore
   ms (a full, a delta chain), rows/s of both, and one full save and one
   restore taken apart (the copies, CRC32, the npz write and read); (b) one supervised run with
   a crash (poll 13) and a stall (poll 22, 5 s watchdog), equal to (a) bit
   for bit with one restart of each cause; (c) the newest checkpoint with
   a flipped byte: one ``checksum`` corruption, one fallback, the resumed
   output equal to (a); (d) 3 poisoned rows in batch 20 under
   ``crash_loop_k=2``: the dead-letter queue holds exactly them and every
   other row equals a clean run without them. Steps run (replays and
   bisection probes included) against the fused kernel's launches.
9. ``exact_path`` — the tiered store (``key_mode="exact"``), which
   serves tree kinds through the leaf-sum kernel: (a) the whole-dollar
   dataset with the forest at the default capacities (the hot tier holds
   every key) equals the direct path's fused-kernel run bit for bit;
   (b) the JAX bench's ``state_scale`` deployment (capacities and sketch
   width 32,768, compaction every 4 batches, a 256 MB budget) under
   Zipf(1.1) traffic over 65,536, 1,048,576 and 10M keys (the forest;
   gbt on the 1M universe too): rows/s, latency, stage medians, the dense
   hit rate, reclaims, occupancy and the state's bytes, the two warm
   batches against a CPU-device engine (directories bit for bit), and
   dense + cms reads = 2 × rows in every batch; (c) 48 batches of the 1M
   universe with the day advancing every batch: reclaims > 0, and the
   compaction's device ms; (d) the 10M universe with a hot tier of 2^22
   slots per table (~5.4 GB of window tables); (e) the 100M universe with
   the host cold tier: demotions, cold keys and promotions > 0, a
   checkpoint with the cold lineage restored into a fresh engine; (f) a
   few batches under ``torch.profiler``. The leaf-sum kernel launches once
   per batch, the fused kernels never.
10. ``learning`` — the learning loop, 12 batches per part over the
   whole-dollar dataset: (a) logreg with in-step SGD on in-band labels
   (``online_lr=1e-3``) at depths 1 and 2 — the fused logreg kernel once
   per batch, ``w`` never rebound, depth 1 equal to depth 2 bit for bit,
   4 batches' params and probabilities against a CPU engine, rows/s
   against ``online_lr=0``; (b) the direct forest with a
   ``FeedbackLoop`` whose labels arrive 3 batches late through an
   ``InProcBroker`` and a 1M-row ``FeatureCache`` — the fused forest
   kernel once per batch, the loop's stats and the window state equal a
   CPU engine's bit for bit, probabilities against the plain predict over
   the CPU engine's features, ms per ``apply_state_feedback`` and rows/s
   against no feedback; (c) the same on the tiered store (exact_path (b)'s
   1M-key deployment, labels at 5%) — the leaf-sum kernel once per batch,
   the directories, the dense fraud sums and the sketch's fraud column
   equal a CPU engine's, both tiers > 0; (d) logreg with the feedback's
   backtracking SGD — params against a CPU engine, ms per
   ``apply_feedback``, halvings; (e) the learning loop (a blind champion,
   a registry in a temporary directory, ``StreamingLearner`` on its own
   stream, ``ShadowScorer``, ``LearningLoop``) — ≥ 2 versions published,
   shadow rows, exactly one promotion, the next batch equal to a fresh
   engine on the promoted artifact, shadow and learner ms, rows/s against
   the same chunks without the loop; (f) a second forest hot-reloaded
   after batch 6 — ``params_epoch`` advances, the tables are re-derived,
   every batch equal to the plain predict of the params it was launched
   with — and an externally published forest candidate shadow-scored
   through the leaf-sum kernel, bit for bit with its plain version.
11. ``zoo`` — the rest of the model zoo, whose steps launch none of the
   three kernels (every counter must stay 0): (a) the mlp (hidden 64, 32)
   and the autoencoder (hidden 32, 8), seeded weights through the port's
   artifact format, over 8 batches of the whole-dollar dataset — features
   bit for bit and probabilities within 1e-5 of a CPU engine, then with
   ``online_lr=1e-3`` on in-band labels (params within 2e-6 of the CPU
   engine's, never rebound); then the mlp with the feedback SGD on labels
   3 batches late, a ``StreamingLearner`` and ``ShadowScorer`` on its
   candidate (published versions, shadow rows, the shadow's scores
   against the plain predict); (b) the sequence kind at the JAX bench's
   widths (d_model 32, 2 heads, 2 layers, d_ff 64, K = 32, naive
   attention, capacity 8192) over 8 batches of 65,536 rows — 2 batches
   against a CPU engine, 48 rows of the last batch against the offline
   oracle (``event_features`` windows through the full
   ``transformer_logits``), rows/s, the step's device ms and its FLOPs;
   (c) K = 256 at 8,192-row batches (blockwise attention, asserted) over a
   seeded stream of 256 customers whose rings wrap, with the oracle;
   (d) capacity 2^20 (1.07 GB of events, 134 MB of positions) under
   Zipf(1.1) keys: rows/s, peak device memory, FLOPs; (e) 24 batches
   under ``run_with_recovery``, checkpoints every 8, one crash (poll 13):
   the probabilities and the history state (rows ``[:C]``) equal the
   clean run bit for bit.
12. ``precompile`` — the precompiled step (one CUDA graph per dispatch
   signature). Per path — forest, logreg, logreg with ``online_lr``, gbt,
   the cms forest, the exact path over 1M Zipf keys (the JAX bench's
   ``state_scale`` deployment, compaction every 4 batches), the mlp and
   the sequence kind at K=32 — one eager and one precompiled engine serve
   one batch eagerly, then the same 8 whole-dollar batches of 65,536
   rows; the line gives precompile and capture seconds, graphs, pool
   bytes, and dispatch ms p50 and rows/s of both, and the script checks
   outputs and state bit for bit, precompile leaving the state, params
   and counters as they were, no recapture, and each path's kernel once
   per batch. Then every bucket of the default ladder captured once and
   replayed; selective (at most 1% flagged), bf16 and full emission on
   the forest's graphs (D2H bytes, sink and result-wait ms per batch;
   flagged rows bit-identical to full emission, bf16 the float32
   features rounded); the non-finite guard on ``tests/test_faults.py``'s
   degenerate scaler; an overload cycle under a scripted backlog
   (3 climbs, deferral, replay, 3 descents, nothing recaptured, scores
   equal to an unthrottled run's).
13. ``ingest`` — ingest and observability on the forest path, 65,536-row
   batches at depth 2, the fused forest kernel once per batch in every
   run: (a) 8 batches through ``ReplaySource(mode="envelope")`` with 8
   decode workers, plain and under ``PrefetchSource(max_batches=2)`` and
   ``(4)``, the outputs bit for bit; rows/s, the loop's ``source_poll``
   and ``host_prep`` p50, the prefetch wait and mean queue depth, and
   the device's idle share under the profiler over 3 batches; (b) the
   whole-dollar dataset supervised under prefetch with checkpoints every
   8 batches, a crash (poll 13) and 3 poisoned rows (batch 20): the
   output by ``batch_index`` equal to a clean run's, the dead letters
   exactly the poisoned rows, isolation run unprefetched, and no save's
   offsets past the consumed ones; (c) the overload ladder (CUDA graphs)
   behind an ``AsyncSink`` whose writer is slow for its first 6 batches
   (``sink_queue_batches`` 4): it climbs on ``sink_fill`` (and ``lag``),
   descends to rung 0 after a lull, recaptures nothing, and scores as an
   unthrottled run; (d) the ``MetricsServer`` on 127.0.0.1 (its four
   endpoints scraped mid-run, ``/healthz`` 200 ``ok``), the flight record
   (one record per batch, with its trace id) and the tracer (one
   ``host_prep``, ``dispatch``, ``result_wait`` and ``sink_write`` span
   per batch), rows/s and dispatch p50 with all of it on against off, in
   turns, and the ``rtfds.dispatch#…`` ranges under ``torch.profiler``;
   (e) one line naming the packages the card machine lacks for
   ``RawTableSource``, ``--raw-table`` and ``KafkaSource``.
14. ``offline`` — the offline side of the zoo on the default dataset:
   (a) ``compute_features_replay`` over the whole stream in chunks of
   8,192 (rows/s), the whole-dollar copy's first 4 chunks against a
   CPU-device replay (counts exact, the rest within ``rtol`` 1e-6), and
   ``warm_start_state`` equal to the replay's final state bit for bit;
   (b) the ``train`` command for logreg on the 153/30/30 split, then
   logreg, mlp (64, 32), autoencoder (32, 8), gbt and the sequence
   transformer (d_model 32, 2 heads, 2 layers, d_ff 64) trained
   in-process, 5 epochs — fit and predict seconds, AUC-ROC, AP and
   CP@100 each (the one cut: the gbt grows 2 trees of depth 8, not 100,
   for the NumPy booster's host time) — and the device ms of one Adam
   step of the mlp and of the transformer (median of 20 after 3); (c)
   ``compare`` (logreg, mlp, autoencoder, sequence, 1 epoch) and
   ``select`` (logreg, two learning rates, 2 folds), both exiting 0, and
   ``train --model forest`` exiting 2 naming sklearn where it is missing;
   (d) the trained logreg artifact scored through the ``score`` command
   (the fused logreg kernel once per batch) and the trained gbt through
   ``ScoringEngine`` (the leaf-sum kernel once per batch), the first 2
   batches of each within 1e-6 of ``TrainedModel.predict_proba_np``;
   (e) ``TrainedModel.predict_proba`` of the gbt on 65,536 test rows: one
   leaf-sum launch, equal to ``leaf_sum_plain`` exactly.
15. ``profile`` — a few batches of each main path, and of the forest path
   on the customer sketch, under ``torch.profiler``: device time by
   kernel, the device's idle share, the ``[B, NB]`` row gathers (none on
   the fused paths) and the small device-to-host copies (none of four
   bytes on the forest path: the window update makes no host sync).
16. ``sharded`` — the sharded engine, its shards co-located on the card,
   over 12 whole-dollar batches of 65,536 rows with the forest (100
   trees, depth 8, int8): (a) 4 and 8 shards against the single engine
   on the same batches — features bit for bit, probabilities within 1e-6,
   the leaf-sum kernel once per chunk and the fused kernels never; rows/s,
   latency, stage medians and, under ``torch.profiler``, the device's idle
   share of each beside the single engine's; (b) the leaf-sum launch
   inside the sharded step held against ``leaf_sum_plain`` on that
   chunk's scaled features (max |Δ|, ms per launch, plain ms, bound);
   (c) 3 batches, two with 60% of the rows on one customer, at 4,096 rows
   per shard: routed chunks and the full exchange bucket, equal to the
   single engine fed the same chunks one by one; (d) ``precompile`` of
   both signatures, the same 3 batches replayed (both graphs used, the
   full-bucket chunks eager) against (c) bit for bit; (e) 6 batches at 4
   shards, a checkpoint, restored at 8 shards and at 1, the other 6
   batches equal to the single engine's; (f) gbt (the leaf-sum kernel)
   against the single engine, and logreg with ``online_lr=1e-3`` against
   the same 4 shards on the CPU (2 batches, params within 1e-6).
17. ``sharded_exact`` — the tiered store over the co-located shards
   (``key_mode="exact"``: a key directory, sketch replicas, compaction
   and cold tier per shard), the forest at int8, the leaf-sum kernel
   once per chunk and the fused kernels never: (a) the 12 whole-dollar
   batches of (16) at the default capacities, 4 and 8 shards against
   the single exact engine and the direct path, bit for bit on every
   row whose keys hold a directory entry (every shard's slots hold its
   keys; a key whose 8 probes all meet occupied entries reads the
   sketch, as in the reference, and those rows are held against the
   same shards on the CPU), dense + sketch reads = 2 × rows; (b)
   ``tools/sharded_state_scale_bench.py``'s deployment (2^15 slots per
   table, sketches 2^14 wide, compaction every 2 batches, 16,384-row
   batches, Zipf(1.1) over 65,536, 1,048,576 and 10M keys) at 1, 2 and
   4 shards under ``precompile``: rows/s, dense hit rate per shard,
   reclaims per shard, occupancy, state bytes, and at 2 and 4 shards
   the two warm batches against a CPU-device engine of the same width
   (directories bit for bit); (c) the 10M universe at 4 shards on 2^22 slots per table;
   (d) the 100M universe with the host cold tier at 4 shards:
   demotions and promotions on every shard, a checkpoint with the cold
   lineage restored into a fresh engine; (e) labels for 5% of the rows
   through ``apply_state_feedback`` after each batch, the directories,
   dense fraud sums and sketch fraud column equal to a CPU engine's;
   (f) 6 batches at 4 shards, a checkpoint restored at 8 and at 1, the
   rest equal to the single exact engine (a key that cannot place within
   the 8 probes of its new shard's rebuilt directory is refused, naming
   the fix, and the leg then restores with 16); (g) the leaf-sum launch on
   the exact chunk against ``leaf_sum_plain`` (max |Δ|, ms, bound), and
   the device's idle share under ``torch.profiler`` at 4 shards and 1.
18. ``fleet`` — the fleet of processes on the one card (each process its
   own CUDA context; gloo carries only the rendezvous), the forest at
   int8 over the 12 whole-dollar batches of (16) with terminals remapped
   so ``terminal % 4 == customer % 4`` (co-partitioned): (a) in process,
   two engines of ``ProcessTopology(2, p, 2)`` behind
   ``PartitionAffineSource`` against the single-process 4-shard engine,
   row by row by ``tx_id`` (features bit for bit, |Δp| 0), the leaf-sum
   kernel once per chunk and bit-equal to its plain version on one
   chunk; (b) the port's launcher: two coordinated worker processes
   (``--devices 2 --precompile --checkpoint-dir --metrics-dump
   --cms-exchange``) and a single-process ``--devices 4`` run, each
   worker's output, launches and timings kept by a ``sitecustomize.py``
   on the workers' path (the card machine has no pyarrow: it swaps the
   Parquet sink for one ``.npz`` per batch); exact coverage, no
   recaptures, precompiled steps, global shard ids and process labels,
   output equal to (a)'s control, rows/s per worker and for the fleet,
   the barrier's ms; (c) a resize: the two-process fleet drained by
   SIGTERM mid-stream, merged into one process by ``--resume-merge``
   under the launcher's ``--autoscale``, which grows it back to two;
   the union of every generation's output covers the stream once and
   equals the control; drain-to-final-checkpoint, merge and
   relaunch-to-first-batch ms; (d) the same shrink under ``--key-mode
   exact`` with ``--cold-store`` and ``--resume-merge-cold``: every old
   directory entry re-homed into the merged directory, the continuation
   equal to the single-process exact engine.
19. ``sharded_sequence`` — the sequence kind over shards and the
   parallel library: (a) the zoo's transformer (d_model 32, 2 heads, 2
   layers, d_ff 64, K = 32, naive attention) at 65,536-row Zipf(1.1)
   batches over 2^20 customers, on the single engine and over 4 and 8
   co-located shards with ``rows_per_shard`` the balanced share (so a hot
   shard spills into routed chunks, counted), each held against the
   single engine (|Δp| ≤ 1e-5) with no kernel launched; rows/s and, at 8
   shards under ``torch.profiler``, the device's idle share; a 1→8 and an
   8→4 restore through a checkpoint, each with its conversion
   (``feature_state_n_old``) timed and the next batch held against the
   single engine; (b) ring and Ulysses attention over 8 shards at T =
   4,096 (8 heads of 16) against ``blockwise_attention``, and
   ``make_sp_logits_fn`` against the blockwise forward, with SDPA's ms as
   a yardstick; (c) one tensor-parallel MLP step, one expert-parallel
   apply and one pipeline pass over 8 shards at 65,536 rows against
   their unsharded forms, with the ms of each.
20. ``operator`` — the operator surface through ``cli.main``: (a)
   ``demo`` at the reference's data scale (``DataConfig()``: 5,000
   customers, 10,000 terminals, 245 days, the 153/30 split) with the
   forest artifact: the first 183 days warm the state columnar, the last
   62 stream as Debezium envelopes in 65,536-row batches; the profile
   tables' sizes, the streamed rows, the fused forest kernel once per
   batch (no other), every probability finite in [0, 1], rows/s, latency
   and wall; (b) the JAX demo's default size (500 customers, 1,000
   terminals, 90 days, 45/10) on the card and on the CPU device, for the
   forest artifact, ``--model logreg`` trained on each device, and the
   forest on 4 shards (``run_demo`` at ``max_batch_rows`` 4,096: the CPU
   reference pads each step to 4 × that): counts and flags equal, the
   stream AUC within 1e-6, each path's kernel once per step; (c) a short
   checkpointed ``score`` with 3 poisoned rows, then ``ckpt`` (list,
   ``--verify``, ``--inspect``, a flipped byte → rc 1), ``trace
   --json``, ``dashboard --flight-record``, ``registry --publish
   --promote --verify``, ``dlq`` and ``dlq --replay`` (one fused-forest
   launch for the row that now scores), ``warmup`` and ``verify-device``
   (rc 0, every signature captured); where the card machine lacks
   sklearn or pyarrow, ``import-model``, ``demo --model forest``,
   ``query``, ``sql`` and ``dashboard --data`` exit 2 naming it.
21. ``dsv2_path`` — DeepSeek-V2's block as the sequence scorer
   (``models/deepseek_v2.py``) at a reduced width but the cell's depth
   (a dense layer and four expert layers: 18 stamps a step), in
   bfloat16, through ``ScoringEngine.run`` from the precompiled graph at
   depth 2 over 2,048-row batches of a synthetic stream, the tracer on:
   the stamp kernel 18 times a step and no other kernel, every row
   counted under ``rtfds_sequence_rows_scored_total{path="dsv2"}``, the
   ``device/mla`` and ``device/experts`` spans once a step and inside
   ``device/step``, the expert-slot counter at top-k slots a real
   position.
22. ``kernels`` — one line per the measurement contract, each kernel's
   launches summed over every driven path that launched it.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero without that line. Without CUDA, or outside a checkout of
the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM float32 rate outside the tensor cores, taken for the kernels'
# 32-bit integer and compare operations too (their own rate is lower, so
# the bound errs short)
INT32_OPS_PER_S = 67e12
START_EPOCH_S = 1_743_465_600  # 2025-04-01, DataConfig.start_date
ATOL_LEAF = 1e-5  # leaf sums (both sides add trees in order: expect 0)
ATOL_SIGMOID = 1e-6  # logreg and gbt probabilities: expf against PyTorch's
# the sequence kernel's logits and probabilities: float32 sums in another
# order, each product-add rounded once (__fmaf_rn)
ATOL_SEQ_LOGIT = 2e-5
ATOL_SEQ_PROB = 1e-5
RTOL_FEATURE = 1e-6  # float32 window sums in another order
# score --scorer cpu against the card's forest scores: the host walks the
# same trees over the same float32 features the card emitted
ATOL_SCORER_CPU = 1e-6
# (rows, NB): a ragged batch, the serving bucket, and NB = 38 (the 7-day
# delay + the 30-day window + 1); the second is what the kernels line
# reports.
KERNEL_CASES = ((300, 40), (65536, 40), (300, 38))
# The forests of phase ``kernel``: (trees, max depth, ragged); the first
# is the flagship shape the kernels line reports.
FORESTS = {"complete_depth8": (100, 8, False),
           "ragged_depth8": (100, 8, True),
           "ragged_depth12": (100, 12, True),
           "complete_depth11": (10, 11, False)}
BATCH_ROWS = 65536  # the main path's batch bucket
PROFILE_BATCHES = 4
# Phase recovery: the checkpoint cadence, the scripted faults' poll
# indices, the watchdog's budget, and the poisoned batch.
RECOVERY_EVERY = 8
RECOVERY_FULL_EVERY = 4
RECOVERY_CRASH_POLL = 13
RECOVERY_HANG_POLL = 22
RECOVERY_STALL_S = 5.0
RECOVERY_POISON_BATCH = 20
SERVING_DEPTHS = (1, 2, 3)
# Phase exact_path: the JAX bench's state_scale deployment (bench.py
# _state_scale_block): Zipf(1.1) traffic over these key universes, 2 warm
# batches, then 12 with the day advancing every 4 batches.
ZIPF_SKEW = 1.1
EXACT_UNIVERSES = (65_536, 1 << 20, 10_000_000)
EXACT_COLD_UNIVERSE = 100_000_000
EXACT_WARM = 2
SX_BENCH_WARM = 1  # sharded_exact (b): warm batches, held against the CPU
EXACT_BATCHES = 12
EXACT_DAY_EVERY = 4
EXACT_RECLAIM_BATCHES = 48  # day advancing every batch: past the horizon
EXACT_BIG_CAPACITY = 1 << 22  # the hot tier of a 10M-card issuer
COALESCE_POLL_ROWS = 16384
ENVELOPE_ROWS = 262144  # the slice the cli phase serves in envelope mode
# the cli phase's card and --scorer cpu runs: the host oracle walks the
# forest in NumPy at ~33k rows/s, so these batches, not the dataset
CLI_SCORER_BATCHES = 2
PATHS = ("forest", "logreg", "gbt")
# The kernel each path's step must launch once per batch.
OWN_KERNEL = {"forest": "fused_forest_leaf_sum",
              "logreg": "fused_featurize_score",
              "gbt": "leaf_sum"}
PKG = "real_time_fraud_detection_system_tpu_torch"
KERNELS = {  # name → (port source, the TPU kernel it replaces)
    "fused_forest_leaf_sum": (
        f"{PKG}/csrc/fused_forest.cu",
        "real_time_fraud_detection_system_tpu/ops/pallas_forest.py:398"),
    "leaf_sum": (
        f"{PKG}/csrc/leaf_sum.cu",
        "real_time_fraud_detection_system_tpu/ops/pallas_forest.py:283"),
    "fused_featurize_score": (
        f"{PKG}/csrc/fused_score.cu",
        "real_time_fraud_detection_system_tpu/ops/pallas_kernels.py:129"),
    "fused_last_logit": (
        f"{PKG}/csrc/fused_sequence.cu",
        "none: added for the sequence step"),
    "stamp": (
        f"{PKG}/csrc/stamp.cu",
        "none: added to time spans inside a replayed graph"),
}
# The stamp kernel's interval against CUDA events just outside it: the
# two stamps' own runs and the gaps between back-to-back nodes, a few us.
ATOL_STAMP_MS = 0.008
# DeepSeek-V2's phase: the cell's depth at a reduced width.
DSV2_SMOKE = dict(
    hidden_size=256, num_hidden_layers=5, num_attention_heads=4,
    kv_lora_rank=64, qk_nope_head_dim=64, qk_rope_head_dim=32,
    v_head_dim=64, intermediate_size=512, moe_intermediate_size=128,
    n_routed_experts=16, n_shared_experts=2, num_experts_per_tok=4,
    first_k_dense_replace=1, rms_norm_eps=1e-6, rope_theta=10000,
    q_lora_rank=None,
    rope_scaling=dict(type="yarn", factor=40,
                      original_max_position_embeddings=4096, beta_fast=32,
                      beta_slow=1, mscale=0.707, mscale_all_dim=0.707))
DSV2_ROWS = 2048
DSV2_BATCHES = 8
# The sequence kernel's case in phase ``kernel``: the main path's
# histories (d_model 32, 2 heads, 2 layers, d_ff 64, 8 channels, K 32)
SEQ_KERNEL_K = 32


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, reps: int, replays: int = 3) -> float:
    """Mean device milliseconds per call of a kernel wrapper ``fn``:
    ``reps`` calls captured back to back into one CUDA graph, replayed
    ``replays`` times between CUDA events. The host's cost of a call (the
    wrapper's checks, the launch through ctypes; ~0.03-0.08 ms) is paid at
    capture, so a kernel shorter than it is not timed as the host's rate
    of launches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (reps * replays)


def counters() -> dict:
    """Each kernel wrapper, by kernel name (its ``launches`` counter)."""
    from real_time_fraud_detection_system_tpu_torch.ops import (
        forest_kernels,
        score_kernels,
        sequence_kernels,
        stamp,
    )

    return {"fused_forest_leaf_sum": forest_kernels.fused_forest_leaf_sum,
            "leaf_sum": forest_kernels.leaf_sum,
            "fused_featurize_score": score_kernels.fused_featurize_score,
            "fused_last_logit": sequence_kernels.fused_last_logit,
            "stamp": stamp.stamp}


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name, power = (s.strip() for s in smi.split(",", 1))
    dev = {"kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "smi_name": name, "power_limit": power}
    emit({"phase": "device", **dev})
    return dev


def phase_build() -> None:
    from real_time_fraud_detection_system_tpu_torch.ops import (
        cuda_lib,
        forest_kernels,
        score_kernels,
        sequence_kernels,
        stamp,
    )

    sources = {"fused_forest_leaf_sum": forest_kernels.SOURCE,
               "leaf_sum": forest_kernels.LEAF_SUM_SOURCE,
               "fused_featurize_score": score_kernels.SOURCE,
               "fused_last_logit": sequence_kernels.SOURCE,
               "stamp": stamp.SOURCE}

    def build(src):
        t0 = time.perf_counter()
        path, report = cuda_lib.build_library(src)
        return path, report, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        futures = {k: pool.submit(build, s) for k, s in sources.items()}
        built = {k: f.result() for k, f in futures.items()}
    wall = time.perf_counter() - t0
    forest_kernels._library()
    forest_kernels._leaf_sum_library()
    score_kernels._library()
    sequence_kernels._library()
    stamp._library()
    for name, (path, report, seconds) in built.items():
        emit({"phase": "build", "kernel": name, "seconds": seconds,
              "all_builds_wall_s": wall,
              "library": str(path.relative_to(ROOT)),
              "ptxas": [ln.strip() for ln in report.splitlines()
                        if "registers" in ln or "spill" in ln]})


def _state_tables(rng, nb: int, dev):
    """Customer and terminal feature-state tables at the default
    capacities, filled like the serving path's: stamps within the last ~45
    days (some empty), small counts, cent amounts, fraud ≤ count."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        FeatureConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.ops.windows import (
        WindowState,
    )

    fcfg = FeatureConfig()
    out = []
    for cap, hi in ((fcfg.customer_capacity, 4), (fcfg.terminal_capacity,
                                                  30)):
        bd = (20200 - rng.integers(-1, 46, (cap, nb))).astype(np.int32)
        bd[rng.random((cap, nb)) < 0.3] = -1
        cnt = rng.integers(0, hi, (cap, nb)).astype(np.float32)
        amt = (cnt * rng.integers(100, 20000, (cap, nb)) / 100.0
               ).astype(np.float32)
        frd = np.minimum(rng.integers(0, 3, (cap, nb)), cnt).astype(
            np.float32)
        out.append(WindowState(*(torch.as_tensor(a, device=dev)
                                 for a in (bd, cnt, amt, frd))))
    return out


def _feature_inputs(rng, b: int, nb: int, dev) -> dict:
    """The fused kernels' feature arguments, by keyword: state tables of
    the default capacities and a batch of slots drawn, with repeats, over
    the default dataset's customer and terminal ids."""
    from real_time_fraud_detection_system_tpu_torch.config import DataConfig

    dcfg = DataConfig()
    customer, terminal = _state_tables(rng, nb, dev)
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return dict(
        customer=customer, terminal=terminal,
        cust_slot=as_t(rng.integers(0, dcfg.n_customers, b)),
        term_slot=as_t(rng.integers(0, dcfg.n_terminals, b)),
        day=as_t(np.full(b, 20200, np.int32)),
        tod_s=as_t(rng.integers(0, 86400, b).astype(np.int32)),
        amount=as_t((rng.integers(100, 30000, b) / 100.0).astype(np.float32)),
    )


def _row_bytes(args) -> int:
    """Bytes of the table rows the feature half needs: each distinct slot's
    NB words of the three arrays a feature reads, once per table."""
    nb = args["customer"].n_buckets
    return sum(int(torch.unique(args[k]).numel()) * 3 * nb * 4
               for k in ("cust_slot", "term_slot"))


def _bound(inputs, outputs, needed_ops: int, tree_bytes: int = 0,
           row_bytes: int = 0, **extra) -> dict:
    """Least time for a kernel's function on this card: the larger of its
    bytes (each of ITS inputs read once, each of its outputs written once;
    the trees counted by ``tree_bytes``, the table rows by ``row_bytes``)
    over the memory rate and the operations these inputs need over the
    32-bit rate."""
    nbytes = tree_bytes + row_bytes + sum(t.numel() * t.element_size()
                                          for t in (*inputs, *outputs))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = needed_ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "needed_ops": needed_ops, **extra}


def _feature_ops(b: int, nb: int, n_win: int, n_feat: int) -> int:
    """Operations the feature assembly needs: per table and bucket an age,
    two liveness compares and, per window, a compare and two adds; the
    ratios and flags; the standardization (a subtract and a divide per
    feature)."""
    return b * (2 * nb * (3 + 3 * n_win) + 2 * n_win + 4 + 2 * n_feat)


def _walk_ops(tables, x, n_real_trees: int) -> dict:
    """Operations the tree half needs on this run's data: per tree one
    compare per level of the path the row takes plus the add of its leaf.
    The levels are counted through the dense form with each leaf's value
    replaced by its depth. ``algorithm_ops`` is what the kernels' descent
    does instead: per row, each group of ``TREES_IN_FLIGHT`` trees steps
    for the group's largest depth (a row on a shallower leaf loops on it),
    one compare per tree and step, then one leaf add per tree walked (the
    padded trees too). Reported, not the bound."""
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        gemm_leaf_sum,
    )
    from real_time_fraud_detection_system_tpu_torch.ops.forest_kernels import (
        TREES_IN_FLIGHT,
    )

    b = x.shape[0]
    x = torch.nn.functional.pad(x, (0, tables.gemm.sel.shape[1] - x.shape[1]))
    real_leaf = (tables.gemm.target < 10 ** 9).to(torch.float32)
    depth = (tables.gemm.path != 0).sum(dim=1).to(torch.float32)
    reached = gemm_leaf_sum(tables.gemm._replace(leaf_val=real_leaf), x,
                            tables.z_mode)
    check(bool((reached == n_real_trees).all()),
          "a row does not reach exactly one leaf per tree")
    levels = int(gemm_leaf_sum(tables.gemm._replace(leaf_val=depth), x,
                               tables.z_mode).sum())
    steps = int(tables.depth.reshape(-1, TREES_IN_FLIGHT).amax(dim=1).sum())
    return {"ops": levels + b * n_real_trees,
            "mean_levels_per_tree": levels / (b * n_real_trees),
            "algorithm_ops": b * (TREES_IN_FLIGHT * steps
                                  + tables.depth.numel())}


def _tree_bytes(tables) -> int:
    """Bytes of the trees the function reads, whatever layout a kernel
    keeps them in: per internal node its feature and threshold, per leaf
    its value (4 B each), over the real trees of the dense form."""
    g, n = tables.gemm, tables.n_trees
    internal = int((g.path[:n] != 0).any(dim=2).sum())
    leaves = int((g.target[:n] < 10 ** 9 / 2).sum())
    return 8 * internal + 4 * leaves


def _time(kernel, plain, bound: dict, **extra) -> dict:
    """The kernel's mean device ms (``graph_ms``) and its plain version's
    mean ms, beside its bound."""
    return {"ms": graph_ms(kernel, 20), "plain_ms": cuda_ms(plain, 3),
            **bound, "library_ms": None, **extra}


def phase_kernel(dev) -> dict:
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        ragged_ensemble,
        synthetic_ensemble,
        to_gemm,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
        fit_scaler,
        transform,
    )
    from real_time_fraud_detection_system_tpu_torch.ops import (
        forest_kernels,
        score_kernels,
    )
    from real_time_fraud_detection_system_tpu_torch.ops.features_fused import (
        assemble_features,
        gather_feature_rows,
    )
    from real_time_fraud_detection_system_tpu_torch.ops.windows import (
        gather_state_rows,
    )

    flagship = next(iter(FORESTS))
    tables = {}
    for fname, (n_trees, depth, ragged) in FORESTS.items():
        make = ragged_ensemble if ragged else synthetic_ensemble
        g = to_gemm(make(n_trees, depth, 15, seed=0, device=dev), 15)
        check(forest_kernels.admit_tables(g).fits,
              f"{fname} forest not admitted to the forest kernels")
        tables[fname] = {z: forest_kernels.to_kernel_tables(g, z)
                         for z in ("f32", "bf16", "int8")}
    rng = np.random.default_rng(0)
    out = {k: {"max_abs_err": 0.0} for k in KERNELS}

    def record(name, b, nb, line):
        """Emit a kernel line; the serving bucket in the serving z mode
        (int8 on CUDA) on the flagship forest is what the kernels line
        reports."""
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"],
                                       line["max_abs_err"])
        if (b, nb) == KERNEL_CASES[1] \
                and line.get("z_mode", "int8") == "int8" \
                and line.get("forest", flagship) == flagship:
            out[name].update({k: line[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")})
        emit({"phase": "kernel", "kernel": name, "rows": b, "nb": nb,
              **line})

    for b, nb in KERNEL_CASES:
        args = _feature_inputs(rng, b, nb, dev)
        feats = assemble_features(
            *gather_feature_rows(args["customer"], args["terminal"],
                                 args["cust_slot"], args["term_slot"]),
            args["day"], args["tod_s"], args["amount"], windows=(1, 7, 30),
            delay=7, weekend_start=5, night_end=6)
        scaler = fit_scaler(feats.cpu().numpy(), device=dev)
        args.update(scaler_mean=scaler.mean, scaler_scale=scaler.scale)
        x = transform(Scaler(scaler.mean, scaler.scale), feats).contiguous()
        # what the function reads beside the table rows (_row_bytes)
        scalars = [args[k] for k in ("cust_slot", "term_slot", "day",
                                     "tod_s", "amount")]
        row_bytes = _row_bytes(args)
        feature_ops = _feature_ops(b, nb, 3, 15)
        # the row gathers (the port's plain gather_state_rows of both
        # tables) that the fused kernels make unnecessary
        gathers_ms = cuda_ms(lambda: (
            gather_state_rows(args["customer"], args["cust_slot"]),
            gather_state_rows(args["terminal"], args["term_slot"])), 20)
        distinct = {"distinct_customers":
                    int(torch.unique(args["cust_slot"]).numel()),
                    "distinct_terminals":
                    int(torch.unique(args["term_slot"]).numel()),
                    "row_bytes": row_bytes, "gathers_ms": gathers_ms}

        # -- fused featurize → forest, and leaf sum, on every forest in
        # every z mode: bit for bit against the plain versions
        for fname, by_mode in tables.items():
            n_trees = FORESTS[fname][0]
            walk = _walk_ops(by_mode["int8"], x, n_trees)  # alike in all modes
            tree_bytes = _tree_bytes(by_mode["int8"])
            sums = {"fused_forest_leaf_sum": {}, "leaf_sum": {}}
            for z, tab in by_mode.items():
                leaf, kfeats = forest_kernels.fused_forest_leaf_sum(tab,
                                                                    **args)
                lsum = forest_kernels.leaf_sum(tab, x)
                torch.cuda.synchronize()
                pleaf, pfeats = forest_kernels.fused_forest_leaf_sum_plain(
                    tab, **args)
                psum = forest_kernels.leaf_sum_plain(tab, x)
                check(torch.equal(kfeats, pfeats),
                      f"fused forest features differ from the plain version "
                      f"by {float((kfeats - pfeats).abs().max())}")
                runs = {
                    "fused_forest_leaf_sum": (
                        leaf, pleaf, float((kfeats - pfeats).abs().max()),
                        lambda: forest_kernels.fused_forest_leaf_sum(
                            tab, **args),
                        lambda: forest_kernels.fused_forest_leaf_sum_plain(
                            tab, **args),
                        _bound(scalars + [scaler.mean, scaler.scale],
                               [leaf, kfeats], feature_ops + walk["ops"],
                               tree_bytes, row_bytes,
                               mean_levels_per_tree=walk[
                                   "mean_levels_per_tree"],
                               algorithm_ops=walk["algorithm_ops"])),
                    "leaf_sum": (
                        lsum, psum, 0.0,
                        lambda: forest_kernels.leaf_sum(tab, x),
                        lambda: forest_kernels.leaf_sum_plain(tab, x),
                        _bound([x], [lsum], walk["ops"], tree_bytes,
                               mean_levels_per_tree=walk[
                                   "mean_levels_per_tree"],
                               algorithm_ops=walk["algorithm_ops"])),
                }
                for name, (got, want, feat_err, kernel, plain, bound) \
                        in runs.items():
                    err = float((got - want).abs().max())
                    check(torch.equal(got, want),
                          f"{name} sums differ on {fname} by {err}")
                    check(bool(((got / n_trees >= 0.5)
                                == (want / n_trees >= 0.5)).all()),
                          f"{name} decisions differ from the plain version")
                    sums[name][z] = got
                    record(name, b, nb, {
                        "forest": fname, "z_mode": z,
                        "max_abs_err": max(err, feat_err),
                        "decision_share_fraud": float((got / n_trees >= 0.5)
                                                      .float().mean()),
                        **_time(kernel, plain, bound,
                                **(distinct if name == "fused_forest_leaf_sum"
                                   else {}))})
            for name, by_z in sums.items():
                for z in ("bf16", "int8"):
                    check(torch.equal(by_z[z], by_z["f32"]),
                          f"{name} z_mode {z} is not bit-identical to f32 "
                          f"on {fname}")
            check(torch.equal(sums["leaf_sum"]["f32"],
                              sums["fused_forest_leaf_sum"]["f32"]),
                  f"the two forest kernels' sums differ on {fname}")

        # -- fused featurize → logreg
        w = torch.as_tensor(np.random.default_rng(0).normal(size=15)
                            .astype(np.float32), device=dev)
        valid = torch.as_tensor(rng.random(b) < 0.95, device=dev)
        sargs = dict(args, valid=valid, w=w,
                     b=torch.tensor(0.0, device=dev))
        probs, sfeats = score_kernels.fused_featurize_score(**sargs)
        torch.cuda.synchronize()
        pprobs, psfeats = score_kernels.fused_featurize_score_plain(**sargs)
        check(torch.equal(sfeats, psfeats),
              f"fused logreg features differ from the plain version by "
              f"{float((sfeats - psfeats).abs().max())}")
        check(torch.equal(sfeats, kfeats),
              "the two fused kernels' features differ on the same rows")
        err = float((probs - pprobs).abs().max())
        check(err <= ATOL_SIGMOID, f"fused logreg probs differ by {err}")
        check(bool(((probs >= 0.5) == (pprobs >= 0.5)).all()),
              "fused logreg decisions differ from the plain version")
        record("fused_featurize_score", b, nb, {
            "max_abs_err": max(err, float((sfeats - psfeats).abs().max())),
            "decision_share_fraud": float((probs >= 0.5).float().mean()),
            **_time(
                lambda: score_kernels.fused_featurize_score(**sargs),
                lambda: score_kernels.fused_featurize_score_plain(**sargs),
                # per row beyond the features: 15 products and adds, the
                # bias, the sigmoid (negate, exp, add, divide), the mask
                _bound(scalars + [valid, scaler.mean, scaler.scale, w,
                                  sargs["b"]], [probs, sfeats],
                       feature_ops + b * (2 * 15 + 1 + 4 + 1),
                       row_bytes=row_bytes), **distinct)})
    out["fused_last_logit"].update(_sequence_kernel_case(dev))
    out["stamp"].update(_stamp_case(dev))
    return out


def _stamp_case(dev) -> dict:
    """The stamp kernel around known device work: chains of 1, 5 and 20
    bfloat16 products of 4,096 (about 0.2, 1 and 4 ms), five times each,
    a stamp on each side and a CUDA event just outside each stamp, all
    queued behind a spin so that they run back to back. Each interval
    between the stamps against the events' elapsed time on the same
    stream; its error is the largest gap. No PyTorch call writes the
    card's clock (no plain version, no library time)."""
    from real_time_fraud_detection_system_tpu_torch.ops import stamp

    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(4096, 4096, generator=gen, device=dev,
                    dtype=torch.bfloat16)
    buf = torch.zeros(2, dtype=torch.int64, device=dev)

    def work(n: int) -> None:
        x = a
        for _ in range(n):
            x = x @ a * 0.01

    for n in (1, 5, 20):  # warm: cuBLAS's handle, the kernel's module
        work(n)
    stamp.stamp(buf, 0)
    torch.cuda.synchronize()
    gaps, spans = [], []
    for n in (1, 5, 20):
        for _ in range(5):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(20_000_000)  # ~10 ms: the host queues the rest
            e0.record()
            stamp.stamp(buf, 0)
            work(n)
            stamp.stamp(buf, 1)
            e1.record()
            torch.cuda.synchronize()
            ev_ms = e0.elapsed_time(e1)
            st_ms = (buf[1] - buf[0]).item() * 1e-6
            gaps.append(ev_ms - st_ms)
            spans.append(st_ms)
    err = max(abs(g) for g in gaps)
    check(err <= ATOL_STAMP_MS,
          f"stamp intervals differ from CUDA events by up to {err} ms "
          f"(gaps {gaps})")
    line = {"max_abs_err": err, "gaps_ms": gaps, "intervals_ms": spans,
            "ms": graph_ms(lambda: stamp.stamp(buf, 0), 20),
            "plain_ms": None, "library_ms": None,
            **_bound([], [buf[:1]], 0)}
    emit({"phase": "kernel", "kernel": "stamp", **line})
    return line


def _sequence_kernel_case(dev) -> dict:
    """The sequence step's transformer kernel at the main path's shapes
    against its plain version (``transformer_last_logit``): random
    histories at random positions (0 and K-1 among them) for the error,
    full histories (every position live, the stream's steady state) for
    the times. No PyTorch call computes this function (no library time)."""
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        init_transformer,
        transformer_flops,
    )
    from real_time_fraud_detection_system_tpu_torch.ops import (
        sequence_kernels,
    )
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    k, b = SEQ_KERNEL_K, BATCH_ROWS
    gen = torch.Generator().manual_seed(0)
    p = init_transformer(32, 2, 2, 64, seed=0, device="cpu")
    # random norms and biases, not the init's ones and zeros
    params = tree.to(tree.map(
        lambda t: t + 0.2 * torch.randn(t.shape, generator=gen)
        if t.dim() == 1 else t, p), dev)
    hist = torch.randn(b, k, 8, generator=gen).to(dev)
    hist[:, 0, 2] = 0.0
    qpos = torch.randint(0, k, (b,), generator=gen,
                         dtype=torch.int32).to(dev)
    qpos[:2] = torch.tensor([0, k - 1], dtype=torch.int32)
    z = sequence_kernels.fused_last_logit(params, hist, qpos)
    torch.cuda.synchronize()
    want = sequence_kernels.fused_last_logit_plain(params, hist, qpos)
    err = float((z - want).abs().max())
    perr = float((torch.sigmoid(z) - torch.sigmoid(want)).abs().max())
    check(err <= ATOL_SEQ_LOGIT and perr <= ATOL_SEQ_PROB,
          f"fused sequence logits differ by {err} (probabilities {perr})")
    full = torch.full_like(qpos, k - 1)
    line = {"max_abs_err": err, "max_abs_prob_err": perr,
            **_time(lambda: sequence_kernels.fused_last_logit(params, hist,
                                                              full),
                    lambda: sequence_kernels.fused_last_logit_plain(
                        params, hist, full),
                    _bound([hist, full, *tree.leaves(params)], [z],
                           transformer_flops(params, b, k)),
                    random_qpos_ms=graph_ms(
                        lambda: sequence_kernels.fused_last_logit(
                            params, hist, qpos), 20),
                    tile_rows=sequence_kernels.tile_rows(8, 2, 64, k, 2),
                    smem_bytes=sequence_kernels.smem_bytes(8, 2, 64, k, 2))}
    emit({"phase": "kernel", "kernel": "fused_last_logit", "rows": b,
          "history_len": k, **line})
    return line


def _artifact_models(scaler, dev):
    """Each path's synthetic model, seeded from 0, written and read back
    through the port's own artifact format: (model on ``dev``, model on
    the CPU, the artifact's bytes)."""
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
        dump_model_bytes,
        load_model_bytes,
    )
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        synthetic_ensemble,
    )
    from real_time_fraud_detection_system_tpu_torch.models.gbt import (
        synthetic_gbt,
    )
    from real_time_fraud_detection_system_tpu_torch.models.logreg import (
        LogRegParams,
    )

    gbt = synthetic_gbt(100, 8, 15, seed=0, device="cpu")
    # A booster's raw leaf scores carry either sign and the learning rate
    # (0.1); synthetic_gbt's are uniform on [0, 1], whose sum over 100
    # trees (~50) puts sigmoid at 1.0 in float32 for every row and would
    # make the comparison with the CPU engine vacuous.
    gbt = gbt._replace(trees=gbt.trees._replace(
        prob=0.1 * (gbt.trees.prob - 0.5)))
    params = {
        "forest": synthetic_ensemble(100, 8, 15, seed=0, device="cpu"),
        "logreg": LogRegParams(
            torch.as_tensor(np.random.default_rng(0).normal(size=15)
                            .astype(np.float32)),
            torch.tensor(0.0)),
        "gbt": gbt,
    }
    models = {}
    for kind, p in params.items():
        data = dump_model_bytes(TrainedModel(kind, scaler.to("cpu"), p))
        models[kind] = (load_model_bytes(data, device=dev),
                        load_model_bytes(data, device="cpu"), data)
        check(models[kind][0].content_sha256
              == models[kind][1].content_sha256, "artifact hash differs")
    return models


def phase_data(dev) -> dict:
    """The default dataset, the config, and a scaler fitted on the stream's
    own features (the first 4 batches, served by a throwaway engine)."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        Config,
        RuntimeConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.data import (
        generate_dataset,
    )
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        synthetic_ensemble,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        fit_scaler,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )

    t0 = time.perf_counter()
    cfg = Config(runtime=RuntimeConfig(batch_buckets=(BATCH_ROWS,)))
    _, _, txs = generate_dataset(cfg.data)
    gen_s = time.perf_counter() - t0
    check(txs.customer_id.max() < cfg.features.customer_capacity
          and txs.terminal_id.max() < cfg.features.terminal_capacity,
          "ids exceed the direct-mode capacities")
    probe = ScoringEngine(cfg, "forest",
                          synthetic_ensemble(2, 2, 15, device="cpu"),
                          fit_scaler(np.ones((2, 15)), device=dev),
                          device=dev)
    src = ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS)
    sample = [probe.process_batch(src.poll_batch()).features
              for _ in range(4)]
    scaler = fit_scaler(np.concatenate(sample), device=dev)
    # The same table with every amount rounded to whole dollars: float32
    # sums of whole dollars are exact in any order, so the card's atomic
    # adds (index_add_) give the same state on every run, and outputs of
    # two runs can be held bit for bit (phase serving_loop).
    whole = txs.slice(slice(None))
    whole.amount_cents = np.round(txs.amount_cents / 100).astype(
        np.int64) * 100
    return {"cfg": cfg, "txs": txs, "txs_whole_dollars": whole,
            "datagen_s": gen_s, "models": _artifact_models(scaler, dev)}


def drive(run):
    """Run ``run()`` with every kernel's launch counter set to 0 just
    before it; return (its result, the launches it made, by kernel)."""
    wrappers = counters()
    torch.cuda.synchronize()
    for fn in wrappers.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {name: fn.launches for name, fn in wrappers.items()}


def own_kernel(cfg, kind: str) -> str:
    """The kernel a path's step launches once per batch: the leaf sum
    serves every tree kind on the customer sketch."""
    if cfg.features.customer_source == "cms":
        return "leaf_sum"
    return OWN_KERNEL[kind]


def phase_main_path(dev, device_info, data: dict, kind: str,
                    phase: str = "main_path", cfg=None) -> dict:
    from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )

    cfg = cfg or data["cfg"]
    txs = data["txs"]
    model, cpu_model, _ = data["models"][kind]
    own = own_kernel(cfg, kind)
    eng = ScoringEngine(cfg, kind, model.params, model.scaler, device=dev)
    check((eng.tables is not None) == (own == "fused_forest_leaf_sum"),
          f"{phase} {kind}: the fused forest branch is "
          f"{eng.tables is not None}")
    check((eng.leaf_tables is not None) == (own == "leaf_sum"),
          f"{phase} {kind}: the leaf-sum branch is "
          f"{eng.leaf_tables is not None}")
    check(eng.host_prep == "native",
          f"{phase} {kind}: host prep took the {eng.host_prep} route")
    sink = MemorySink()
    stats, launches = drive(lambda: eng.run(
        ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS), sink))
    for name, n in launches.items():
        want = stats["batches"] if name == own else 0
        check(n == want, f"{phase} {kind}: {n} launches of {name} for "
                         f"{stats['batches']} batches (want {want})")
    check(stats["rows"] == txs.n, "not every row was scored")

    out = sink.concat()
    probs = out["prediction"]
    check(probs.shape == (txs.n,) and bool(np.isfinite(probs).all())
          and probs.min() >= 0.0 and probs.max() <= 1.0,
          "probabilities not finite in [0, 1]")
    check(probs.std() > 0, "every row has the same probability")
    feat_cols = [k for k in out if k.startswith(("tx_during", "customer_id_",
                                                 "terminal_id_"))]
    check(len(feat_cols) == 14 and all(np.isfinite(out[k]).all()
                                       for k in feat_cols),
          "feature columns missing or not finite")

    # The first two batches against a CPU-device engine on the same batches.
    ref = ScoringEngine(cfg, kind, cpu_model.params, cpu_model.scaler,
                        device="cpu")
    ref_sink = MemorySink()
    ref.run(ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS), ref_sink,
            max_batches=2)
    atol = ATOL_LEAF / 100 if kind == "forest" else ATOL_SIGMOID
    max_err = 0.0
    for got, want in zip(sink.batches[:2], ref_sink.batches):
        for k in feat_cols:
            if k.startswith(("tx_during", "customer_id_nb", "terminal_id_nb",
                             "terminal_id_risk")):
                check(np.array_equal(got[k], want[k]), f"{k} differs on CPU")
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL_FEATURE)
        np.testing.assert_allclose(got["prediction"], want["prediction"],
                                   rtol=0.0, atol=atol)
        check(np.array_equal(got["prediction"] >= 0.5,
                             want["prediction"] >= 0.5),
              "decisions differ from the CPU engine")
        max_err = max(max_err, float(np.abs(got["prediction"]
                                            - want["prediction"]).max()))
    emit({"phase": phase, "path": kind,
          "key_mode": cfg.features.key_mode,
          "customer_source": cfg.features.customer_source,
          "rows": stats["rows"],
          "batches": stats["batches"], "kernel_launches": launches,
          "rows_per_s": stats["rows_per_s"],
          "latency_p50_ms": stats["latency_p50_ms"],
          "latency_p99_ms": stats["latency_p99_ms"],
          "stage_ms_p50": stats["stage_ms_p50"],
          "pipeline_depth": stats["pipeline_depth"],
          "host_prep_route": stats["host_prep_route"],
          "wall_s": stats["wall_s"], "cpu_s": stats["cpu_s"],
          "datagen_s": data["datagen_s"],
          "z_mode": stats["z_mode"],
          "prob_mean": float(probs.mean()),
          "fraud_share": float((probs >= 0.5).mean()),
          "max_abs_err_vs_cpu_engine": max_err,
          "card": device_info["smi_name"],
          "power_limit": device_info["power_limit"]})
    return launches


def _profiled(eng, src, batches: int):
    """Serve ``batches`` batches of ``src`` under torch.profiler after one
    warm-up batch: (device ms by event name, wall ms, the chrome trace's
    memcpy events as (name, bytes), the profiler's events, the run's
    stats)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng.run(src, max_batches=1)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        stats = eng.run(src, max_batches=batches)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) + e.device_time_total / 1e3
    with tempfile.TemporaryDirectory() as tmp:
        prof.export_chrome_trace(f"{tmp}/trace.json")
        with open(f"{tmp}/trace.json") as f:
            trace = json.load(f)
    copies = [(ev["name"], int(ev.get("args", {}).get("bytes", -1)))
              for ev in trace.get("traceEvents", [])
              if str(ev.get("name", "")).startswith("Memcpy")]
    return device, wall_ms, copies, prof.events(), stats


def phase_serving_loop(dev, device_info, data: dict) -> dict:
    """The forest path at pipeline depths 1, 2 and 3 and coalesced, over
    the whole-dollar copy of the dataset (see ``phase_data``): outputs bit
    for bit equal; then depth 1 and depth 2 under the profiler."""
    from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )

    cfg, txs = data["cfg"], data["txs_whole_dollars"]
    model = data["models"]["forest"][0]
    totals = {name: 0 for name in KERNELS}

    def engine(depth: int, coalesce: int = 0):
        rcfg = dataclasses.replace(cfg.runtime, pipeline_depth=depth,
                                   coalesce_rows=coalesce)
        return ScoringEngine(dataclasses.replace(cfg, runtime=rcfg),
                             "forest", model.params, model.scaler,
                             device=dev)

    def serve(depth: int, coalesce: int = 0, poll_rows: int = BATCH_ROWS):
        eng = engine(depth, coalesce)
        sink = MemorySink()
        stats, launches = drive(lambda: eng.run(
            ReplaySource(txs, START_EPOCH_S, batch_rows=poll_rows), sink))
        for name, n in launches.items():
            want = stats["batches"] if name == "fused_forest_leaf_sum" else 0
            check(n == want, f"serving_loop depth {depth}: {n} launches of "
                             f"{name} for {stats['batches']} batches")
            totals[name] += n
        check(stats["rows"] == txs.n and stats["pipeline_depth"] == depth
              and stats["host_prep_route"] == "native",
              f"serving_loop depth {depth}: {stats['rows']} rows, depth "
              f"{stats['pipeline_depth']}, {stats['host_prep_route']} prep")
        out = sink.concat()
        out.pop("processed_at_us")  # the wall clock at the sink
        emit({"phase": "serving_loop", "path": "forest",
              "pipeline_depth": depth, "coalesce_rows": coalesce,
              "poll_rows": poll_rows, "rows": stats["rows"],
              "batches": stats["batches"], "rows_per_s": stats["rows_per_s"],
              "latency_p50_ms": stats["latency_p50_ms"],
              "latency_p99_ms": stats["latency_p99_ms"],
              "stage_ms_p50": stats["stage_ms_p50"],
              "wall_s": stats["wall_s"], "cpu_s": stats["cpu_s"],
              "card": device_info["smi_name"],
              "power_limit": device_info["power_limit"]})
        return out, stats

    def same(a: dict, b: dict, what: str) -> None:
        for k in a:
            check(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]),
                  f"serving_loop: column {k} differs, {what}")

    base, base_stats = serve(1)
    for depth in SERVING_DEPTHS[1:]:
        out, _ = serve(depth)
        same(base, out, f"depth {depth} against depth 1")
    out, st = serve(2, coalesce=BATCH_ROWS, poll_rows=COALESCE_POLL_ROWS)
    check(st["batches"] == base_stats["batches"],
          f"coalesced run served {st['batches']} batches, the 65,536-row "
          f"source {base_stats['batches']}")
    same(base, out, "coalesced 16,384-row polls against 65,536-row polls")
    del base, out

    idle = {}
    for depth in (1, 2):
        eng = engine(depth)
        src = ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS)
        device, wall_ms, copies, _, _ = _profiled(eng, src, PROFILE_BATCHES)
        busy = sum(device.values())
        idle[depth] = 1.0 - busy / wall_ms if device else None
        names = {}
        for name, nbytes in copies:
            names.setdefault(name, []).append(nbytes)
        # The packed batch (7 int32 rows of the bucket) once per batch, and
        # the results (probabilities, 4 B a row, and the [n, 15]
        # features), must be pinned copies; smaller ones (a scalar, a
        # count read back by a boolean index) are reported. A copy whose
        # size the trace does not give counts as large.
        big_h2d = [name for name, b in copies if "HtoD" in name
                   and (b < 0 or b >= 7 * 4 * BATCH_ROWS)]
        big_d2h = [name for name, b in copies if "DtoH" in name
                   and (b < 0 or b >= 4 * BATCH_ROWS)]
        check(len(big_h2d) >= PROFILE_BATCHES and all(
            n == "Memcpy HtoD (Pinned -> Device)" for n in big_h2d),
              f"depth {depth}: packed-batch copies {big_h2d}")
        check(len(big_d2h) >= 2 * PROFILE_BATCHES and all(
            n == "Memcpy DtoH (Device -> Pinned)" for n in big_d2h),
              f"depth {depth}: result copies {big_d2h}")
        emit({"phase": "serving_loop_profile", "path": "forest",
              "pipeline_depth": depth, "batches": PROFILE_BATCHES,
              "wall_ms_per_batch": wall_ms / PROFILE_BATCHES,
              "device_busy_ms_per_batch": busy / PROFILE_BATCHES,
              "device_idle_share": idle[depth],
              "memcpy": {name: {"count": len(b), "bytes": sorted(set(b)),
                                "device_ms_per_batch":
                                device.get(name, 0.0) / PROFILE_BATCHES}
                         for name, b in names.items()},
              "card": device_info["smi_name"],
              "power_limit": device_info["power_limit"]})
    return totals


def phase_cli(dev, device_info, data: dict) -> dict:
    """``cli.main(["score", ...])`` on the card: columnar over every row
    of the default dataset, envelope mode over a slice, from files the
    port's own writers put in a temporary directory."""
    from real_time_fraud_detection_system_tpu_torch import cli
    from real_time_fraud_detection_system_tpu_torch.core import native
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        save_transactions,
    )

    txs = data["txs"]
    decodes = {"native": 0}
    native_decode = native.decode_transaction_envelopes_native

    def counted(*args, **kw):
        decodes["native"] += 1
        return native_decode(*args, **kw)

    totals = {name: 0 for name in KERNELS}
    native.decode_transaction_envelopes_native = counted
    try:
        with tempfile.TemporaryDirectory() as tmp:
            model = f"{tmp}/forest.npz"
            with open(model, "wb") as f:
                f.write(data["models"]["forest"][2])
            t0 = time.perf_counter()
            save_transactions(f"{tmp}/txs.npz", txs)
            save_transactions(f"{tmp}/slice.npz",
                              txs.slice(slice(0, ENVELOPE_ROWS)))
            write_s = time.perf_counter() - t0
            for mode, path, rows in (("columnar", "txs.npz", txs.n),
                                     ("envelope", "slice.npz",
                                      ENVELOPE_ROWS)):
                out = io.StringIO()
                decodes["native"] = 0
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(out):
                    rc, launches = drive(lambda: cli.main([
                        "score", "--data", f"{tmp}/{path}",
                        "--model-file", model, "--mode", mode,
                        "--batch-rows", str(BATCH_ROWS)]))
                seconds = time.perf_counter() - t0
                check(rc == 0, f"cli score --mode {mode} exited {rc}")
                stats = json.loads(out.getvalue().strip().splitlines()[-1])
                check(stats["rows"] == rows and stats["device"] == "cuda"
                      and stats["host_prep_route"] == "native",
                      f"cli score --mode {mode}: {stats}")
                check(launches["fused_forest_leaf_sum"] == stats["batches"],
                      f"cli score --mode {mode}: {launches}")
                if mode == "envelope":
                    check(decodes["native"] >= stats["batches"],
                          f"the native envelope decoder ran "
                          f"{decodes['native']} times")
                for name, n in launches.items():
                    totals[name] += n
                emit({"phase": "cli", "mode": mode, "rc": rc,
                      "rows": stats["rows"], "batches": stats["batches"],
                      "native_decodes": decodes["native"],
                      "rows_per_s": stats["rows_per_s"],
                      "latency_p50_ms": stats["latency_p50_ms"],
                      "stage_ms_p50": stats["stage_ms_p50"],
                      "seconds_with_load": seconds,
                      "tables_written_s": write_s,
                      "card": device_info["smi_name"],
                      "power_limit": device_info["power_limit"]})
            _cli_ingest_runs(tmp, model, data["txs_whole_dollars"],
                             device_info, totals)
    finally:
        native.decode_transaction_envelopes_native = native_decode
    return totals


def _cli_score(argv: list) -> tuple:
    """``cli.main(["score", *argv])`` with its stdout captured and the
    launch counters reset around it: (its stats line, the launches)."""
    from real_time_fraud_detection_system_tpu_torch import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, launches = drive(lambda: cli.main(["score", *argv]))
    check(rc == 0, f"cli score {argv} exited {rc}")
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    check(launches["fused_forest_leaf_sum"] == stats["batches"]
          and launches["leaf_sum"] == launches["fused_featurize_score"] == 0,
          f"cli score {argv}: {launches} for {stats['batches']} batches")
    return stats, launches


def _cli_ingest_runs(tmp: str, model: str, txs, device_info,
                     totals: dict) -> None:
    """Phase ``cli``'s ingest and observability runs: the envelope slice
    prefetched with the metrics dump, the flight record and the span
    trace; then the default dataset (``txs``: its whole-dollar copy, so
    the two runs' window sums, added on the card in no fixed order, and
    so their features are the same bit for bit) scored on the card and
    with ``--scorer cpu`` (the host oracle), their probabilities held
    against each other. The card machine has no pyarrow, so ``--out``
    lands in an in-memory sink (``io/sink.py::make_parquet_sink``
    replaced here)."""
    from real_time_fraud_detection_system_tpu_torch.io import sink as sinks
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        save_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        FlightRecorder,
    )

    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    stats, launches = _cli_score([
        "--data", f"{tmp}/slice.npz", "--model-file", model, "--mode",
        "envelope", "--batch-rows", str(BATCH_ROWS), "--prefetch-batches",
        "2", "--metrics-dump", f"{tmp}/metrics.json", "--flight-record",
        f"{tmp}/flight.jsonl", "--trace-out", f"{tmp}/trace.json"])
    for k in totals:
        totals[k] += launches[k]
    with open(f"{tmp}/metrics.json") as f:
        dump = json.load(f)
    recs = [r for r in FlightRecorder.read(f"{tmp}/flight.jsonl")[1]
            if r["kind"] == "batch"]
    with open(f"{tmp}/trace.json") as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e["name"] == "dispatch"]
    n = stats["batches"]
    check(stats["rows"] == ENVELOPE_ROWS
          and dump["rtfds_batches_total"]["series"][0]["value"] >= n
          and "rtfds_prefetch_queue_depth" in dump
          and len(recs) == n and all(r.get("trace_id") for r in recs)
          and len(spans) == n,
          f"cli prefetch: {n} batches, {len(recs)} records, "
          f"{len(spans)} dispatch spans")
    emit({"phase": "cli", "mode": "envelope", "prefetch_batches": 2,
          "rows": stats["rows"], "batches": n,
          "rows_per_s": stats["rows_per_s"],
          "stage_ms_p50": stats["stage_ms_p50"],
          "metrics_dump_families": len(dump), "flight_records": len(recs),
          "dispatch_spans": len(spans), **card})

    save_transactions(f"{tmp}/whole.npz", txs)
    collected = {}
    make = sinks.make_parquet_sink

    def collecting(path):
        collected[path] = sinks.MemorySink()
        return collected[path]

    sinks.make_parquet_sink = collecting
    try:
        for scorer in ("tpu", "cpu"):
            t0 = time.perf_counter()
            stats, launches = _cli_score([
                "--data", f"{tmp}/whole.npz", "--model-file", model,
                "--batch-rows", str(BATCH_ROWS), "--scorer", scorer,
                "--max-batches", str(CLI_SCORER_BATCHES),
                "--out", f"{tmp}/out-{scorer}"])
            for k in totals:
                totals[k] += launches[k]
            check(stats["rows"] == min(txs.n, CLI_SCORER_BATCHES
                                       * BATCH_ROWS)
                  and stats["scorer"] == scorer,
                  f"cli --scorer {scorer}: {stats}")
            emit({"phase": "cli", "mode": "columnar", "scorer": scorer,
                  "rows": stats["rows"], "batches": stats["batches"],
                  "rows_per_s": stats["rows_per_s"],
                  "result_wait_p50_ms": stats["result_wait_p50_ms"],
                  "seconds_with_load": time.perf_counter() - t0, **card})
    finally:
        sinks.make_parquet_sink = make
    card_out, cpu_out = (collected[f"{tmp}/out-{s}"].concat()
                         for s in ("tpu", "cpu"))
    check(np.array_equal(card_out["tx_id"], cpu_out["tx_id"]),
          "cli --scorer cpu: rows differ from the card run")
    err = float(np.abs(cpu_out["prediction"]
                       - card_out["prediction"]).max())
    check(err <= ATOL_SCORER_CPU,
          f"cli --scorer cpu: max |Δ| {err} against the card run")
    emit({"phase": "cli", "part": "scorer_cpu_vs_card",
          "max_abs_err": err, "atol": ATOL_SCORER_CPU, **card})


class IndexedSink:
    """Results by ``batch_index`` (the card machine has no pyarrow for the
    Parquet sink): a replayed batch overwrites its entry, and
    ``truncate_after`` drops the entries past a restored counter, as the
    Parquet sink's restore fence drops parts."""

    def __init__(self):
        self.batches = {}

    def append(self, res) -> None:
        self.batches[res.batch_index] = (res.tx_id.copy(), res.probs.copy(),
                                         res.features.copy())

    def truncate_after(self, batch_index: int) -> None:
        for i in [i for i in self.batches if i > batch_index]:
            del self.batches[i]


def _same_batches(got: dict, want: dict, what: str, first: int = 1) -> None:
    keys = sorted(k for k in want if k >= first)
    check(sorted(k for k in got if k >= first) == keys,
          f"recovery {what}: batches {sorted(got)} against {sorted(want)}")
    for k in keys:
        for a, b in zip(got[k], want[k]):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"recovery {what}: batch {k} differs")


def _same_state(a, b, what: str) -> None:
    from real_time_fraud_detection_system_tpu_torch.utils.tree import leaves_with_path as _leaves

    for (path, x), (_, y) in zip(_leaves(a.feature_state),
                                 _leaves(b.feature_state)):
        check(x.device == y.device and torch.equal(x, y),
              f"recovery {what}: feature state {path} differs")
    check(a.offsets == b.offsets and a.batches_done == b.batches_done
          and a.rows_done == b.rows_done,
          f"recovery {what}: counters {a.offsets, a.batches_done} against "
          f"{b.offsets, b.batches_done}")


def phase_recovery(dev, device_info, data: dict) -> dict:
    """Checkpoints, the supervisor, fallback and poison isolation on the
    forest path at full width (see the module docstring, phase 8)."""
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        Checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.io.sink import (
        DeadLetterSink,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
        FlakySource,
        HangingSource,
        PoisonSource,
        run_with_recovery,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        get_registry,
    )

    txs = data["txs_whole_dollars"]
    model = data["models"]["forest"][0]
    cfg = dataclasses.replace(data["cfg"], runtime=dataclasses.replace(
        data["cfg"].runtime, checkpoint_every_batches=RECOVERY_EVERY))
    totals = {name: 0 for name in KERNELS}
    steps = {"n": 0}
    engines = []

    def make_engine():
        eng = ScoringEngine(cfg, "forest", model.params, model.scaler,
                            device=dev)
        check(eng.tables is not None, "recovery: the fused forest branch")
        step = eng._step

        def counted(packed):
            steps["n"] += 1
            return step(packed)

        eng._step = counted
        engines.append(eng)
        return eng

    def source(**kw):
        return ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS, **kw)

    def driven(run):
        out, launches = drive(run)
        for name, n in launches.items():
            totals[name] += n
        return out

    # (a) the clean run, without and with checkpoints
    clean = IndexedSink()
    eng = make_engine()
    stats_plain = driven(lambda: eng.run(source(), clean))
    want_state = eng.state
    check(stats_plain["rows"] == txs.n, "recovery: not every row scored")
    n_batches = stats_plain["batches"]
    tmp = tempfile.mkdtemp(prefix="recovery-")
    try:
        ckpt = Checkpointer(f"{tmp}/ck", full_every=RECOVERY_FULL_EVERY)
        saves = []
        save = ckpt.save

        def timed_save(state):
            t0 = time.perf_counter()
            path = save(state)
            saves.append((path, (time.perf_counter() - t0) * 1e3))
            return path

        ckpt.save = timed_save
        with_ckpt = IndexedSink()
        eng = make_engine()
        stats_ckpt = driven(lambda: eng.run(source(), with_ckpt,
                                            checkpointer=ckpt))
        # each save's kind, size and stored leaves, read after the timed run
        mans = [(ckpt.manifest(path), ms, Path(path).stat().st_size)
                for path, ms in saves]
        saves = [(m["kind"], ms, size) for m, ms, size in mans]
        delta_stored = sorted({m["meta"]["fs_leaves"].get(k, k)
                               for m, _, _ in mans if m["kind"] == "delta"
                               for k in m["stored"]})
        _same_batches(with_ckpt.batches, clean.batches, "(a) checkpointed")
        _same_state(eng.state, want_state, "(a) checkpointed")
        kinds = [k for k, _, _ in saves]
        check(kinds == ["full", "delta", "delta", "delta"],
              f"recovery: saves {kinds}")
        breakdown = _checkpoint_breakdown(eng, cfg, model, dev, tmp)
        restore_ms = {}
        for kind, name in (("full", "ckpt-0000000008.npz"),
                           ("delta_chain", "ckpt-0000000032-delta.npz")):
            fresh = ScoringEngine(cfg, "forest", model.params, model.scaler,
                                  device=dev)
            ptrs = [t.data_ptr() for t in fresh.state.feature_state.terminal]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            check(ckpt.restore(fresh.state, path=f"{tmp}/ck/{name}")
                  is not None, f"recovery: restore of {name}")
            torch.cuda.synchronize()
            restore_ms[kind] = (time.perf_counter() - t0) * 1e3
            check([t.data_ptr() for t in fresh.state.feature_state.terminal]
                  == ptrs and fresh.state.feature_state.terminal.count
                  .device == dev, "recovery: the restore moved a tensor")
            del fresh

        # (b) one supervised run with a crash and a stall
        reg = get_registry()
        m_crash = reg.counter("rtfds_engine_restarts_total", cause="crash")
        m_stall = reg.counter("rtfds_engine_restarts_total", cause="stall")
        base = (m_crash.value, m_stall.value)
        hang = HangingSource(FlakySource(source(),
                                         fail_at=(RECOVERY_CRASH_POLL,)),
                             hang_at=(RECOVERY_HANG_POLL,),
                             max_hang_s=120.0)
        supervised = IndexedSink()
        steps_b = steps["n"]
        t0 = time.perf_counter()
        try:
            stats_b = driven(lambda: run_with_recovery(
                make_engine, hang,
                Checkpointer(f"{tmp}/ck-b", full_every=RECOVERY_FULL_EVERY),
                sink=supervised, max_restarts=3,
                stall_timeout_s=RECOVERY_STALL_S))
        finally:
            hang.release.set()
            for t in threading.enumerate():
                if t.name == "engine-incarnation" \
                        and t is not threading.current_thread():
                    t.join(60.0)
        seconds_b = time.perf_counter() - t0
        restarts = {"crash": int(m_crash.value - base[0]),
                    "stall": int(m_stall.value - base[1])}
        check(restarts == {"crash": 1, "stall": 1}
              and stats_b["restarts"] == 2, f"recovery (b): {restarts}")
        _same_batches(supervised.batches, clean.batches, "(b)")
        _same_state(engines[-1].state, want_state, "(b)")
        steps_b = steps["n"] - steps_b

        # (c) a corrupt newest checkpoint
        newest = ckpt.latest()
        raw = bytearray(Path(newest).read_bytes())
        raw[len(raw) // 2] ^= 0xFF
        Path(newest).write_bytes(bytes(raw))
        corrupt = reg.counter("rtfds_checkpoint_corrupt_total",
                              reason="checksum")
        fallbacks = reg.counter("rtfds_checkpoint_fallbacks_total")
        base = (corrupt.value, fallbacks.value)
        resumed = IndexedSink()
        resumed.batches = dict(with_ckpt.batches)
        driven(lambda: run_with_recovery(
            make_engine, source(),
            Checkpointer(f"{tmp}/ck", full_every=RECOVERY_FULL_EVERY),
            sink=resumed, max_restarts=1))
        corrupt_newest = {"checksum": corrupt.value - base[0],
                          "fallbacks": fallbacks.value - base[1]}
        check(corrupt_newest == {"checksum": 1, "fallbacks": 1},
              f"recovery (c): {corrupt_newest}")
        _same_batches(resumed.batches, clean.batches, "(c)")
        _same_state(engines[-1].state, want_state, "(c)")

        # (d) poison rows in one batch
        lo = (RECOVERY_POISON_BATCH - 1) * BATCH_ROWS
        poison = [int(txs.tx_id[lo + k])
              for k in (11, BATCH_ROWS // 2 - 1, BATCH_ROWS - 7)]
        without = IndexedSink()
        eng = make_engine()
        driven(lambda: eng.run(_WithoutRows(source(), poison), without))
        want_poison_state = eng.state
        dlq = DeadLetterSink(f"{tmp}/dlq.jsonl")
        isolated = IndexedSink()
        steps_d = steps["n"]
        stats_d = driven(lambda: run_with_recovery(
            make_engine, PoisonSource(source(), poison),
            Checkpointer(f"{tmp}/ck-d", full_every=RECOVERY_FULL_EVERY),
            sink=isolated, max_restarts=3, crash_loop_k=2,
            dead_letter=dlq))
        steps_d = steps["n"] - steps_d
        check(dlq.tx_ids() == sorted(poison)
              and all(r["batch_index"] == RECOVERY_POISON_BATCH
                      for r in dlq.read_all()),
              f"recovery (d): dead-letter queue {dlq.tx_ids()}")
        dlq_rows = len(dlq)
        dlq.close()
        _same_batches(isolated.batches, without.batches, "(d)")
        _same_state(engines[-1].state, want_poison_state, "(d)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del engines[:]

    # every step ran the fused kernel once, replays and probes included
    check(totals["fused_forest_leaf_sum"] == steps["n"]
          and totals["leaf_sum"] == totals["fused_featurize_score"] == 0,
          f"recovery: {totals} launches for {steps['n']} steps")
    save_ms = {k: [ms for kind, ms, _ in saves if kind == k]
               for k in ("full", "delta")}
    save_bytes = {k: [b for kind, _, b in saves if kind == k]
                  for k in ("full", "delta")}
    emit({"phase": "recovery", "path": "forest", "batches": n_batches,
          "checkpoint_every_batches": RECOVERY_EVERY,
          "checkpoint_full_every": RECOVERY_FULL_EVERY,
          "save_ms": {k: float(np.mean(v)) for k, v in save_ms.items()},
          "save_ms_each": saves,
          "save_bytes": {k: int(np.mean(v)) for k, v in save_bytes.items()},
          "delta_stored_leaves": delta_stored,
          "restore_ms": restore_ms,
          **breakdown,
          "rows_per_s": {"without_checkpoints": stats_plain["rows_per_s"],
                         "with_checkpoints": stats_ckpt["rows_per_s"]},
          "supervised": {"restarts": restarts, "seconds": seconds_b,
                         "stall_timeout_s": RECOVERY_STALL_S,
                         "steps_run": steps_b,
                         "batches": stats_b["batches"]},
          "corrupt_newest": corrupt_newest,
          "poison": {"dead_letter_rows": dlq_rows,
                     "restarts": stats_d["restarts"],
                     "steps_run": steps_d},
          "kernel_launches": totals,
          "card": device_info["smi_name"],
          "power_limit": device_info["power_limit"]})
    return totals


def _checkpoint_breakdown(eng, cfg, model, dev, tmp: str) -> dict:
    """One full save and one restore of ``eng``'s state taken apart, each
    step timed with the card synchronized around it: the device-to-host
    copy of every leaf, the CRC32s, the npz write; the read, the npz
    parse, the CRC32 verification, the live params' CRC32 (device to
    host), and the copy into a fresh engine's tensors."""
    from real_time_fraud_detection_system_tpu_torch.io import checkpoint
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    path = f"{tmp}/breakdown.npz"
    (arrays, meta), d2h = timed(lambda: checkpoint._state_arrays(eng.state))
    crcs, crc = timed(lambda: {k: checkpoint._crc(a)
                               for k, a in arrays.items()})

    def write():
        with open(path, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)

    _, npz_write = timed(write)
    data, read = timed(lambda: Path(path).read_bytes())
    (_, _, _, parsed), parse = timed(lambda: checkpoint._parse_entry(data))
    _, verify = timed(lambda: [checkpoint._crc(a) for a in parsed.values()])
    fresh = ScoringEngine(cfg, "forest", model.params, model.scaler,
                          device=dev)
    live, live_crc = timed(lambda: checkpoint._param_crcs(
        fresh.state.params))
    fresh.state.params_crcs = live
    _, h2d = timed(lambda: checkpoint._apply_arrays(fresh.state, meta,
                                                    parsed, crcs))
    return {"save_breakdown_ms": {"d2h": d2h, "crc32": crc,
                                  "npz_write": npz_write},
            "restore_breakdown_ms": {"read": read, "npz_parse": parse,
                                     "crc32_verify": verify,
                                     "live_params_crc32": live_crc,
                                     "h2d_in_place": h2d},
            "breakdown_bytes": sum(a.nbytes for a in arrays.values())}


class _WithoutRows:
    """A source that drops the given ``tx_id`` rows from every poll: the
    batches keep their boundaries, less those rows."""

    def __init__(self, inner, tx_ids):
        self.inner = inner
        self._ids = np.asarray(sorted(tx_ids), np.int64)

    def poll_batch(self):
        cols = self.inner.poll_batch()
        if cols is None:
            return None
        keep = ~np.isin(cols["tx_id"], self._ids)
        return {k: v[keep] for k, v in cols.items()}

    @property
    def offsets(self):
        return self.inner.offsets

    def seek(self, offsets):
        self.inner.seek(offsets)


def phase_profile(dev, data: dict, kind: str, cfg=None) -> None:
    """Device time by kernel over a few batches of a path under
    torch.profiler, the device's idle share of that window, and the
    ``[B, NB]`` row gathers (``aten::index`` on a 2-D state table): the
    fused paths' kernels read the rows by slot, so only the unfused steps
    (gbt; every kind on the customer sketch, terminal rows only) gather
    them."""
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )

    cfg = cfg or data["cfg"]
    model = data["models"][kind][0]
    eng = ScoringEngine(cfg, kind, model.params, model.scaler, device=dev)
    src = ReplaySource(data["txs"], START_EPOCH_S, batch_rows=BATCH_ROWS)
    device, wall_ms, copies, events, _ = _profiled(eng, src,
                                                   PROFILE_BATCHES)
    gathers, gather_ms = 0, 0.0
    for e in events:
        if e.name == "aten::index" and e.input_shapes \
                and len(e.input_shapes[0]) == 2:
            gathers += 1
            gather_ms += e.device_time_total / 1e3
    n = PROFILE_BATCHES
    fused = eng.tables is not None or (
        kind == "logreg" and cfg.features.customer_source == "table")
    check((gathers == 0) == fused,
          f"{kind}: {gathers} [B, NB] row gathers in {n} batches")
    small_d2h = _small_d2h(copies)
    if kind == "forest" and cfg.features.customer_source == "table":
        # the window update's stale reset is a fixed-shape write: no
        # four-byte count comes back per step any more
        check(not small_d2h, f"{kind}: small device-to-host copies "
                             f"{small_d2h} in {n} batches")
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "path": kind,
          "customer_source": cfg.features.customer_source, "batches": n,
          "rows_per_batch": BATCH_ROWS,
          "wall_ms_per_batch": wall_ms / n,
          "device_ms_per_batch": ({k[:80]: v / n for k, v in top}
                                  if device else "not measured"),
          "device_busy_ms_per_batch": busy / n if device else None,
          "row_gathers_per_batch": gathers / n,
          "row_gather_ms_per_batch": gather_ms / n if device else None,
          "small_d2h_copies": small_d2h,
          "device_idle_share": 1.0 - busy / wall_ms if device else None})


def _small_d2h(copies) -> list:
    """Device-to-host copies of at most 8 bytes (a count or flag read back
    by the host) as (name, bytes)."""
    return [(name, b) for name, b in copies
            if "DtoH" in name and 0 <= b <= 8]


class _ListSource:
    """Pre-made column batches (made before the timed run, as the JAX
    bench's ``_ZipfSource``)."""

    def __init__(self, batches):
        self.batches, self.i = batches, 0

    def poll_batch(self):
        if self.i >= len(self.batches):
            return None
        self.i += 1
        return self.batches[self.i - 1]

    @property
    def offsets(self):
        return [self.i]

    def seek(self, offsets):
        self.i = int(offsets[0])


class _TierSink:
    """A ``MemorySink`` that also keeps each batch's tier reads (the
    registry's counters read at the append, after the batch's copies)."""

    def __init__(self, reg):
        from real_time_fraud_detection_system_tpu_torch.io.sink import (
            MemorySink,
        )

        self.inner, self.reg, self.per_batch = MemorySink(), reg, []
        self._last = self._reads()

    def _reads(self):
        return tuple(self.reg.get("rtfds_feature_tier_rows_total",
                                  tier=t).value for t in ("dense", "cms"))

    def append(self, res):
        now = self._reads()
        self.per_batch.append((len(res.tx_id), now[0] - self._last[0],
                               now[1] - self._last[1]))
        self._last = now
        self.inner.append(res)


def _zipf_batches(sampler, n: int, day_every: int, seed: int,
                  rows: int = BATCH_ROWS) -> list:
    """The JAX bench's Zipf source: ``n`` batches over ``sampler``'s
    universe, terminals over a universe 8× smaller, the day advancing
    every ``day_every`` batches. Amounts are rounded to whole dollars:
    a hot key's day sums thousands of them, and float32 sums of whole
    dollars are exact in any order, so the card's atomic adds and the CPU
    engine's ordered ones agree within the main path's tolerances."""
    from real_time_fraud_detection_system_tpu_torch.data.generator import (
        zipf_stream_cols,
    )

    rng = np.random.default_rng(seed)
    out = []
    for b in range(n):
        cols = zipf_stream_cols(rng, rows, sampler,
                                n_terminals=max(sampler.n_keys // 8, 64),
                                day=20200 + b // day_every,
                                tx_id_start=b * rows)
        cols["tx_amount_cents"] = (cols["tx_amount_cents"] + 50) // 100 * 100
        out.append(cols)
    return out


def _bench_cfg(cfg, **features):
    """The JAX bench's ``state_scale`` deployment (bench.py
    ``_state_scale_block``) on the serving bucket."""
    base = dict(key_mode="exact", customer_capacity=1 << 15,
                terminal_capacity=1 << 15, cms_width=1 << 15,
                compact_every=4, state_hbm_budget_mb=256.0)
    base.update(features)
    return dataclasses.replace(cfg, features=dataclasses.replace(
        cfg.features, **base))


def _dir_leaves(fs) -> dict:
    return {f"{t}.{n}": getattr(getattr(fs, f"{t}_dir"), n).cpu()
            .view(torch.int32) if n == "keys" else
            getattr(getattr(fs, f"{t}_dir"), n).cpu()
            for t in ("customer", "terminal")
            for n in ("keys", "slots", "free", "free_top")}


def _occupancy(fs) -> dict:
    return {t: int(getattr(fs, f"{t}_dir").slot_capacity
                   - int(getattr(fs, f"{t}_dir").free_top))
            for t in ("customer", "terminal")}


def _vs_cpu_engine(cfg, kind, data, batches, card_sink, card_state,
                   what: str, n_dev: int = 0) -> float:
    """The card's run of ``batches`` against a CPU-device engine's (of
    ``n_dev`` shards when given): every directory leaf bit for bit,
    counts and risks bit for bit, averages within ``RTOL_FEATURE``,
    probabilities within the main path's tolerance. Returns the largest
    probability difference."""
    from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine

    cpu_model = data["models"][kind][1]
    ref = (ShardedScoringEngine(cfg, kind, cpu_model.params,
                                cpu_model.scaler, n_devices=n_dev,
                                device="cpu") if n_dev else
           ScoringEngine(cfg, kind, cpu_model.params, cpu_model.scaler,
                         device="cpu"))
    ref_sink = MemorySink()
    ref.run(_ListSource([dict(b) for b in batches]), ref_sink)
    for k, v in _dir_leaves(ref.state.feature_state).items():
        check(torch.equal(_dir_leaves(card_state)[k], v),
              f"{what}: directory leaf {k} differs from the CPU engine")
    got, want = card_sink.concat(), ref_sink.concat()
    max_err = 0.0
    for k in want:
        if k == "processed_at_us":
            continue
        if k == "prediction":
            atol = ATOL_LEAF / 100 if kind == "forest" else ATOL_SIGMOID
            np.testing.assert_allclose(got[k], want[k], rtol=0.0, atol=atol)
            max_err = float(np.abs(got[k] - want[k]).max())
        elif "avg_amount" in k:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL_FEATURE)
        else:
            check(np.array_equal(got[k], want[k]),
                  f"{what}: column {k} differs from the CPU engine")
    return max_err


def phase_exact_path(dev, device_info, data: dict) -> dict:
    """The tiered store on the card; see the module docstring, phase 9."""
    from real_time_fraud_detection_system_tpu_torch.data.generator import (
        ZipfKeySampler,
    )
    from real_time_fraud_detection_system_tpu_torch.features.online import (
        compact_feature_state,
        state_bytes,
    )
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        Checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )

    cfg = data["cfg"]
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    totals = {name: 0 for name in KERNELS}

    def served(eng, src, sink, what: str, kind: str = "forest"):
        stats, launches = drive(lambda: eng.run(src, sink))
        own = None if kind == "logreg" else "leaf_sum"
        for name, n in launches.items():
            want = stats["batches"] if name == own else 0
            check(n == want, f"{what}: {n} launches of {name} for "
                             f"{stats['batches']} batches (want {want})")
            totals[name] += n
        return stats

    def run_line(stats) -> dict:
        return {k: stats[k] for k in (
            "rows", "batches", "rows_per_s", "latency_p50_ms",
            "latency_p99_ms", "stage_ms_p50", "wall_s")}

    # (a) the hot tier holds every key: exact equals direct bit for bit
    txs = data["txs_whole_dollars"]
    model = data["models"]["forest"][0]
    ecfg = dataclasses.replace(cfg, features=dataclasses.replace(
        cfg.features, key_mode="exact"))
    outs = {}
    for mode, mcfg in (("direct", cfg), ("exact", ecfg)):
        reg = MetricsRegistry()
        eng = ScoringEngine(mcfg, "forest", model.params, model.scaler,
                            device=dev, metrics=reg)
        sink = MemorySink()
        stats, launches = drive(lambda: eng.run(
            ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS), sink))
        own = "leaf_sum" if mode == "exact" else "fused_forest_leaf_sum"
        for name, n in launches.items():
            want = stats["batches"] if name == own else 0
            check(n == want, f"exact_path (a) {mode}: {n} launches of "
                             f"{name} (want {want})")
            totals[name] += n
        out = sink.concat()
        out.pop("processed_at_us")
        outs[mode] = out
        if mode == "exact":
            dense = reg.get("rtfds_feature_tier_rows_total",
                            tier="dense").value
            cms = reg.get("rtfds_feature_tier_rows_total", tier="cms").value
            check(dense == 2 * stats["rows"] and cms == 0,
                  f"exact_path (a): {dense} dense and {cms} sketch reads "
                  f"for {stats['rows']} rows")
        emit({"phase": "exact_path", "part": "a_parity_with_direct",
              "key_mode": mode, "kernel_launches": launches,
              **run_line(stats), **card})
    for k, v in outs["direct"].items():
        check(v.dtype == outs["exact"][k].dtype
              and np.array_equal(v, outs["exact"][k]),
              f"exact_path (a): column {k} differs from the direct path")
    del outs

    # (b) the JAX bench's deployment over three universes
    bcfg = _bench_cfg(cfg)
    sb = state_bytes(bcfg.features)
    for n_keys in EXACT_UNIVERSES:
        sampler = ZipfKeySampler(n_keys, ZIPF_SKEW)
        warm = _zipf_batches(sampler, EXACT_WARM, day_every=1, seed=7)
        main = _zipf_batches(sampler, EXACT_BATCHES,
                             day_every=EXACT_DAY_EVERY, seed=2)
        for kind in (("forest", "gbt") if n_keys == 1 << 20
                     else ("forest",)):
            m = data["models"][kind][0]
            reg = MetricsRegistry()
            torch.cuda.reset_peak_memory_stats()
            eng = ScoringEngine(bcfg, kind, m.params, m.scaler, device=dev,
                                metrics=reg)
            what = f"exact_path (b) {kind} {n_keys} keys"
            wsink = MemorySink()
            served(eng, _ListSource([dict(b) for b in warm]), wsink, what,
                   kind)
            err = _vs_cpu_engine(bcfg, kind, data, warm, wsink,
                                 eng.state.feature_state, what)
            sink = _TierSink(reg)
            stats = served(eng, _ListSource(main), sink, what, kind)
            for rows, dense, cms in sink.per_batch:
                check(dense + cms == 2 * rows,
                      f"{what}: {dense} dense + {cms} sketch reads for "
                      f"{rows} rows")
            d = sum(x[1] for x in sink.per_batch)
            c = sum(x[2] for x in sink.per_batch)
            emit({"phase": "exact_path", "part": "b_bench_deployment",
                  "path": kind, "n_keys": n_keys, "skew": ZIPF_SKEW,
                  **run_line(stats),
                  "dense_hit_rate": d / (d + c),
                  "slots_reclaimed": reg.family_total(
                      "rtfds_feature_slots_reclaimed_total"),
                  "occupancy": _occupancy(eng.state.feature_state),
                  "capacity": bcfg.features.customer_capacity,
                  "state_bytes": sb,
                  "memory_allocated": torch.cuda.memory_allocated(),
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "max_abs_err_vs_cpu_engine": err, **card})
            del eng
    torch.cuda.empty_cache()

    # (c) the day advancing every batch: history passes the horizon
    sampler = ZipfKeySampler(1 << 20, ZIPF_SKEW)
    batches = _zipf_batches(sampler, EXACT_RECLAIM_BATCHES, day_every=1,
                            seed=3)
    reg = MetricsRegistry()
    eng = ScoringEngine(bcfg, "forest", model.params, model.scaler,
                        device=dev, metrics=reg)
    stats = served(eng, _ListSource(batches), MemorySink(),
                   "exact_path (c)")
    rec = reg.family_total("rtfds_feature_slots_reclaimed_total")
    occ = _occupancy(eng.state.feature_state)
    check(rec > 0, "exact_path (c): no slot was reclaimed")
    check(all(0 <= o <= bcfg.features.customer_capacity
              for o in occ.values()), f"exact_path (c): occupancy {occ}")
    compact_ms = cuda_ms(lambda: compact_feature_state(
        eng.state.feature_state, eng._max_day, bcfg.features), 5)
    emit({"phase": "exact_path", "part": "c_reclaim", **run_line(stats),
          "days": EXACT_RECLAIM_BATCHES, "slots_reclaimed": rec,
          "occupancy": occ, "compaction_ms": compact_ms, **card})
    del eng

    # (d) the hot tier of a 10M-card issuer: 2^22 slots per table
    big = EXACT_BIG_CAPACITY
    dcfg = _bench_cfg(cfg, customer_capacity=big, terminal_capacity=big,
                      state_hbm_budget_mb=8192.0)
    sampler = ZipfKeySampler(10_000_000, ZIPF_SKEW)
    batches = (_zipf_batches(sampler, EXACT_WARM, day_every=1, seed=7)
               + _zipf_batches(sampler, EXACT_BATCHES,
                               day_every=EXACT_DAY_EVERY, seed=2))
    reg = MetricsRegistry()
    torch.cuda.reset_peak_memory_stats()
    eng = ScoringEngine(dcfg, "forest", model.params, model.scaler,
                        device=dev, metrics=reg)
    sink = _TierSink(reg)
    stats = served(eng, _ListSource(batches), sink, "exact_path (d)")
    d = sum(x[1] for x in sink.per_batch)
    c = sum(x[2] for x in sink.per_batch)
    compact_ms = cuda_ms(lambda: compact_feature_state(
        eng.state.feature_state, eng._max_day, dcfg.features), 3)
    emit({"phase": "exact_path", "part": "d_10m_issuer",
          "n_keys": 10_000_000, "capacity": big, **run_line(stats),
          "dense_hit_rate": d / (d + c),
          "occupancy": _occupancy(eng.state.feature_state),
          "state_bytes": state_bytes(dcfg.features),
          "memory_allocated": torch.cuda.memory_allocated(),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "compaction_ms": compact_ms, **card})
    del eng
    torch.cuda.empty_cache()

    # (e) the host cold tier over 100M keys
    sampler = ZipfKeySampler(EXACT_COLD_UNIVERSE, ZIPF_SKEW)
    warm = _zipf_batches(sampler, EXACT_WARM, day_every=1, seed=7)
    main = _zipf_batches(sampler, EXACT_BATCHES, day_every=EXACT_DAY_EVERY,
                         seed=2)
    with tempfile.TemporaryDirectory() as tmp:
        ccfg = _bench_cfg(cfg, cold_store=f"{tmp}/cold",
                          cold_demote_slots=1024, cold_promote_queue=256)
        reg = MetricsRegistry()
        eng = ScoringEngine(ccfg, "forest", model.params, model.scaler,
                            device=dev, metrics=reg)
        served(eng, _ListSource(warm), MemorySink(), "exact_path (e)")
        stats = served(eng, _ListSource(main), MemorySink(),
                       "exact_path (e)")
        check(eng.drain_promotions(timeout_s=60.0),
              "exact_path (e): promotions did not drain")
        counts = {n: reg.get(n).value for n in (
            "rtfds_feature_cold_demotions_total", "rtfds_feature_cold_keys",
            "rtfds_feature_cold_promotions_total")}
        check(all(v > 0 for v in counts.values()),
              f"exact_path (e): cold tier counters {counts}")
        eng._cold.flush()
        eng.state.cold_lineage = eng._cold.lineage()
        ck = Checkpointer(f"{tmp}/ck")
        t0 = time.perf_counter()
        ck.save(eng.checkpoint_state())
        save_ms = (time.perf_counter() - t0) * 1e3
        fresh = ScoringEngine(ccfg, "forest", model.params, model.scaler,
                              device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(ck.restore(fresh.state) is not None,
              "exact_path (e): no checkpoint restored")
        fresh._sync_cold_after_restore()
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        lineage = eng.state.cold_lineage
        check(fresh.state.cold_lineage == lineage,
              "exact_path (e): the restored cold lineage differs")
        # the restored index is the listed segments' manifests: every
        # key still cold at the save, and the promoted keys whose
        # segment no gc has dropped yet (their next touch merges rows
        # the hot tier already holds, an idempotent no-op)
        for t in ("customer", "terminal"):
            check(np.isin(eng._cold.index_snapshot(t),
                          fresh._cold.index_snapshot(t)).all(),
                  f"exact_path (e): a cold {t} key was lost at restore")
        for k, v in _dir_leaves(eng.state.feature_state).items():
            check(torch.equal(_dir_leaves(fresh.state.feature_state)[k], v),
                  f"exact_path (e): restored directory leaf {k} differs")
        emit({"phase": "exact_path", "part": "e_cold_tier",
              "n_keys": EXACT_COLD_UNIVERSE, **run_line(stats), **counts,
              "exactness_degraded_keys": stats["exactness_degraded_keys"],
              "cold_segments": len(lineage["segments"]),
              "cold_bytes": lineage["total_bytes"],
              "checkpoint_save_ms": save_ms, "restore_ms": restore_ms,
              **card})
        eng.fence_cold()
        fresh.fence_cold()
        del eng, fresh

    # (f) a few batches under the profiler
    sampler = ZipfKeySampler(1 << 20, ZIPF_SKEW)
    batches = _zipf_batches(sampler, PROFILE_BATCHES + 1,
                            day_every=EXACT_DAY_EVERY, seed=5)
    eng = ScoringEngine(bcfg, "forest", model.params, model.scaler,
                        device=dev, metrics=MetricsRegistry())
    device, wall_ms, copies, _, pstats = _profiled(eng, _ListSource(batches),
                                                   PROFILE_BATCHES)
    small = _small_d2h(copies)
    # one 8-byte copy per batch: the tier counts riding the result copies
    check(all(b == 8 for _, b in small) and len(small) == PROFILE_BATCHES
          and all(name == "Memcpy DtoH (Device -> Pinned)"
                  for name, _ in small),
          f"exact_path (f): small device-to-host copies {small}")
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "exact_path", "part": "f_profile",
          "batches": PROFILE_BATCHES, "wall_ms_per_batch":
          wall_ms / PROFILE_BATCHES,
          "dispatch_p50_ms": pstats["dispatch_p50_ms"],
          "device_ms_per_batch": ({k[:80]: v / PROFILE_BATCHES
                                   for k, v in top}
                                  if device else "not measured"),
          "device_busy_ms_per_batch": busy / PROFILE_BATCHES
          if device else None,
          "device_idle_share": 1.0 - busy / wall_ms if device else None,
          # the leaf-sum kernel's device time on this path, on its own
          # (it can fall outside the top 8)
          "leaf_sum_ms_per_batch": sum(
              v for k, v in device.items() if "leaf_sum_kernel" in k)
          / PROFILE_BATCHES if device else "not measured",
          "small_d2h_copies": small, **card})
    return totals


# -- phase learning -----------------------------------------------------------

LEARN_BATCHES = 12
LEARN_LAG = 3  # a batch's labels arrive this many batches later
LEARN_LR = 1e-3
LEARN_CACHE_ROWS = 1 << 20
LEARN_PARITY_BATCHES = 4
ATOL_PARAMS = 2e-6  # tests/test_torch_online_sgd.py: the gradient's ulps


def _label_messages(batches) -> list:
    """Each batch's labels as feedback envelopes, encoded once, before any
    timed run (the producer's work, not the engine's)."""
    from real_time_fraud_detection_system_tpu_torch.runtime.feedback import (
        encode_feedback_envelopes,
    )

    return [encode_feedback_envelopes(b["tx_id"], b["label"])
            for b in batches]


class _DelayedLabels:
    """The labels of the batch polled ``LEARN_LAG`` polls earlier
    (pre-encoded, :func:`_label_messages`) go to the feedback topic as
    this poll is served; the batches themselves carry no in-band label."""

    def __init__(self, inner, broker, messages):
        from real_time_fraud_detection_system_tpu_torch.runtime.feedback \
            import FEEDBACK_TOPIC

        self.inner, self.broker, self.messages = inner, broker, messages
        self._topic, self._polls = FEEDBACK_TOPIC, 0

    def poll_batch(self):
        cols = self.inner.poll_batch()
        if cols is None:
            return None
        k = self._polls
        self._polls += 1
        if k >= LEARN_LAG:
            msgs = self.messages[k - LEARN_LAG]
            self.broker.produce_many(self._topic, [b""] * len(msgs), msgs)
        return {c: v for c, v in cols.items() if c != "label"}

    @property
    def offsets(self):
        return self.inner.offsets

    def seek(self, offsets):
        self.inner.seek(offsets)


def _labeled_batches(txs) -> list:
    """The first ``LEARN_BATCHES`` serving batches of ``txs``, with their
    fraud labels in band."""
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )

    src = ReplaySource(txs.slice(slice(0, LEARN_BATCHES * BATCH_ROWS)),
                       START_EPOCH_S, batch_rows=BATCH_ROWS,
                       with_labels=True)
    out = []
    while (cols := src.poll_batch()) is not None:
        out.append(cols)
    return out


def _copies(batches) -> list:
    return [dict(b) for b in batches]


class _Results:
    """A sink that keeps each batch's features and probabilities as the
    engine returned them."""

    def __init__(self):
        self.batches = []

    def append(self, res):
        self.batches.append(res)

    def feats(self) -> np.ndarray:
        return np.concatenate([r.features for r in self.batches])

    def probs(self) -> np.ndarray:
        return np.concatenate([r.probs for r in self.batches])


def _timed(obj, name: str, log: list):
    """Wrap ``obj.name`` to log its host milliseconds per call."""
    fn = getattr(obj, name)

    def wrapped(*a, **k):
        t0 = time.perf_counter()
        out = fn(*a, **k)
        log.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, wrapped)
    return log


def _state_feedback_ms(eng, batch: dict) -> float:
    """Device ms of one state feedback of a whole batch's labels
    (``features/online.py::apply_feedback`` on the engine's state, inputs
    already on the card), by CUDA events over 20 calls: the events around
    the engine's call would also count the host's time between them."""
    from real_time_fraud_detection_system_tpu_torch.core.batch import (
        US_PER_DAY,
        fold_key,
    )
    from real_time_fraud_detection_system_tpu_torch.features.online import (
        apply_feedback,
    )

    dev = eng.device
    key = torch.from_numpy(fold_key(batch["terminal_id"]).view(np.int32)) \
        .to(dev).view(torch.uint32)
    day = torch.from_numpy((batch["tx_datetime_us"] // US_PER_DAY)
                           .astype(np.int32)).to(dev)
    label = torch.from_numpy(batch["label"].astype(np.int32)).to(dev)
    valid = torch.ones_like(label, dtype=torch.bool)
    return cuda_ms(lambda: apply_feedback(eng.state.feature_state, key, day,
                                          label, valid, eng.cfg.features),
                   20)


def _median(xs):
    return float(np.median(xs)) if len(xs) else None


def _same_windows(card_fs, cpu_fs, what: str) -> None:
    """Bucket days, counts and fraud sums bit for bit (amount sums of
    whole dollars are exact in any order: bit for bit as well)."""
    for table in ("customer", "terminal"):
        for name in ("bucket_day", "count", "amount", "fraud"):
            check(torch.equal(getattr(getattr(card_fs, table), name).cpu(),
                              getattr(getattr(cpu_fs, table), name)),
                  f"{what}: {table}.{name} differs from the CPU engine")


def _same_features(card: "_Results", cpu: "_Results", what: str) -> None:
    """Counts, flags, amounts and risks bit for bit; averages within
    ``RTOL_FEATURE``."""
    from real_time_fraud_detection_system_tpu_torch.features.spec import (
        FEATURE_NAMES,
    )

    got, want = card.feats(), cpu.feats()
    check(got.shape == want.shape, f"{what}: feature shapes differ")
    for i, name in enumerate(FEATURE_NAMES):
        if "AVG_AMOUNT" in name:
            np.testing.assert_allclose(got[:, i], want[:, i],
                                       rtol=RTOL_FEATURE)
        else:
            check(np.array_equal(got[:, i], want[:, i]),
                  f"{what}: {name} differs from the CPU engine")


def _plain_probs(kind, params, scaler, feats: np.ndarray, dev, z_mode):
    """The plain predict (no kernel) on the card over host feature rows."""
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        transform,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        predict_fn_for,
    )

    x = transform(scaler, torch.from_numpy(feats).to(dev))
    return predict_fn_for(kind, z_mode)(params, x).cpu().numpy()


def _learning_loop(dev, card: dict, cfg, batches: list, served) -> None:
    """Phase ``learning`` (e): the traffic of ``tests/test_learn_smoke.py``
    at the serving bucket — a blind logreg champion (bias -4, raw
    features), labels ``amount > p70`` fed after each one-batch chunk,
    the streaming learner drained after every chunk, until one promotion
    and one more chunk, which a fresh engine on the promoted artifact
    serves too."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        LearnConfig,
        TrainConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
    )
    from real_time_fraud_detection_system_tpu_torch.io.registry import (
        make_model_registry,
    )
    from real_time_fraud_detection_system_tpu_torch.models.logreg import (
        LogRegParams,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
        copy_into,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.feedback import (
        FEEDBACK_TOPIC,
        FeatureCache,
        FeedbackLoop,
        encode_feedback_envelopes,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.learner import (
        LearningLoop,
        StreamingLearner,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        InProcBroker,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        get_registry,
    )

    # the champion stays blind (its feedback SGD takes steps of 0: a
    # champion that learns online as fast as the candidate leaves no
    # margin to promote on); the learner steps at LEARN_LR
    lcfg = dataclasses.replace(
        cfg, train=TrainConfig(online_learning_rate=0.0),
        learn=LearnConfig(
            publish_every_labels=128, promote_min_labels=96,
            promote_margin=0.01, precision_tolerance=0.05,
            rollback_min_labels=96, window_rows=4096, epochs=2,
            learning_rate=LEARN_LR,
            # the score cache must outlive the label lag: at the default
            # 65,536 rows, one batch overwrites it before its labels come
            shadow_cache_rows=LEARN_CACHE_ROWS))
    blind = LogRegParams(torch.as_tensor(np.random.default_rng(0).normal(
        0, 0.01, 15).astype(np.float32)), torch.tensor(-4.0))
    scaler_cpu = Scaler(torch.zeros(15), torch.ones(15))
    amounts = np.concatenate([b["tx_amount_cents"] for b in batches])
    amt_thresh = float(np.percentile(amounts, 70))
    reg = get_registry()

    def metric(name, **labels):
        m = reg.get(name, **labels)
        return float(m.value) if m is not None else 0.0

    with tempfile.TemporaryDirectory() as tmp:
        registry = make_model_registry(f"{tmp}/registry")
        learner = StreamingLearner("logreg", blind, scaler_cpu, lcfg,
                                   registry, publish_every_labels=128,
                                   window_rows=4096, epochs=2,
                                   learning_rate=LEARN_LR, device=dev)
        learning = LearningLoop(registry, lcfg, "logreg", model=TrainedModel(
            "logreg", scaler_cpu, blind), learner=learner, device=dev)
        eng = ScoringEngine(lcfg, "logreg", blind, scaler_cpu, device=dev,
                            feature_cache=FeatureCache(LEARN_CACHE_ROWS))
        broker = InProcBroker(4)
        fb = FeedbackLoop(eng, broker)
        shadow_ms = _timed(learning.shadow, "score_batch", [])
        train_ms = _timed(learner, "_train", [])
        base = {"promoted": metric("rtfds_model_promotions_total",
                                   outcome="promoted"),
                "shadow_rows": metric("rtfds_shadow_rows_total"),
                "published": metric("rtfds_learner_published_total")}
        t_learn, chunks, promoted_at, fresh_err = 0.0, 0, None, None
        try:
            for i, b in enumerate(batches):
                fresh = None
                if promoted_at is not None:
                    # the promoted artifact in a fresh engine, on a copy
                    # of the serving engine's feature state
                    m = registry.get(learning.champion_version)
                    fresh = ScoringEngine(lcfg, "logreg", m.params,
                                          m.scaler, device=dev)
                    check(copy_into(fresh.state.feature_state,
                                    eng.state.feature_state),
                          "learning (e): feature state copy")
                    for x, y in zip(eng.state.params, m.params):
                        check(torch.equal(x.cpu(), y),
                              "learning (e): served params are not the "
                              "promoted artifact's")
                sink = _Results()
                t0 = time.perf_counter()
                _, launches = served(lambda: eng.run(
                    _ListSource([{c: v for c, v in b.items()
                                  if c != "label"}]), sink, feedback=fb,
                    learning=learning), "(e)", {"fused_featurize_score": 1})
                t_learn += time.perf_counter() - t0
                chunks += 1
                y = (b["tx_amount_cents"] > amt_thresh).astype(np.int32)
                broker.produce_many(FEEDBACK_TOPIC, [b""] * len(y),
                                    encode_feedback_envelopes(
                                        b["tx_id"], y))
                check(learner.drain(300.0), "learning (e): learner stuck")
                if fresh is not None:
                    fsink = _Results()
                    served(lambda: fresh.run(_ListSource([{
                        c: v for c, v in b.items() if c != "label"}]),
                        fsink), "(e) fresh", {"fused_featurize_score": 1})
                    got, want = sink.probs(), fsink.probs()
                    check(np.array_equal(got, want),
                          "learning (e): the promoted engine differs from "
                          "a fresh engine on the promoted artifact")
                    fresh_err = float(np.abs(got - want).max())
                    break
                if promoted_at is None and metric(
                        "rtfds_model_promotions_total",
                        outcome="promoted") > base["promoted"]:
                    promoted_at = i + 1
        finally:
            learning.close()
        promotions = metric("rtfds_model_promotions_total",
                            outcome="promoted") - base["promoted"]
        published = metric("rtfds_learner_published_total") \
            - base["published"]
        shadow_rows = metric("rtfds_shadow_rows_total") - base["shadow_rows"]
        versions = registry.versions()
    check(promotions == 1, f"learning (e): {promotions} promotions")
    check(published >= 2 and len(versions) >= 3,
          f"learning (e): {published} published, versions {versions}")
    check(shadow_rows > 0, "learning (e): no shadow rows")
    check(fresh_err == 0.0, "learning (e): no comparison after promotion")
    # the control: the same chunks with feedback, without the loop
    ctl = ScoringEngine(lcfg, "logreg", blind, scaler_cpu, device=dev,
                        feature_cache=FeatureCache(LEARN_CACHE_ROWS))
    cbroker = InProcBroker(4)
    cfb = FeedbackLoop(ctl, cbroker)
    t_ctl = 0.0
    for b in batches[:chunks]:
        t0 = time.perf_counter()
        served(lambda: ctl.run(_ListSource([{
            c: v for c, v in b.items() if c != "label"}]), _Results(),
            feedback=cfb), "(e) control", {"fused_featurize_score": 1})
        t_ctl += time.perf_counter() - t0
        cbroker.produce_many(FEEDBACK_TOPIC, [b""] * len(b["tx_id"]),
                             encode_feedback_envelopes(
                                 b["tx_id"], (b["tx_amount_cents"]
                                              > amt_thresh).astype(
                                     np.int32)))
    rows = chunks * BATCH_ROWS
    emit({"phase": "learning", "part": "e_learning_loop",
          "chunks": chunks, "promoted_after_chunk": promoted_at,
          "promotions": promotions, "published": published,
          "registry_versions": versions, "shadow_rows": shadow_rows,
          "shadow_ms_p50": _median(shadow_ms),
          "learner_ms_per_chunk_p50": _median(train_ms),
          "rows_per_s": rows / t_learn,
          "rows_per_s_without_the_loop": rows / t_ctl,
          "fresh_engine_max_abs_err": fresh_err, **card})
    del eng, ctl



def phase_learning(dev, device_info, data: dict) -> dict:
    """The learning loop on the card; see the module docstring, phase 10."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        LearnConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.data.generator import (
        ZipfKeySampler,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
    )
    from real_time_fraud_detection_system_tpu_torch.io.registry import (
        make_model_registry,
    )
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        synthetic_ensemble,
        to_gemm,
    )
    from real_time_fraud_detection_system_tpu_torch.models.logreg import (
        LogRegParams,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime import engine \
        as engine_mod
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
        copy_into,
        device_params_for,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.feedback import (
        FEEDBACK_TOPIC,
        FeatureCache,
        FeedbackLoop,
        encode_feedback_envelopes,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.learner import (
        LearningLoop,
        StreamingLearner,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        InProcBroker,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
        get_registry,
    )

    cfg = data["cfg"]
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    totals = {name: 0 for name in KERNELS}
    batches = _labeled_batches(data["txs_whole_dollars"])

    def served(run, what: str, own: dict) -> tuple:
        """``drive`` the run; each kernel launches ``own[name]`` times
        (0 when absent)."""
        stats, launches = drive(run)
        for name, n in launches.items():
            want = own.get(name, 0)
            check(n == want, f"learning {what}: {n} launches of {name} "
                             f"(want {want})")
            totals[name] += n
        return stats, launches

    def line(stats) -> dict:
        return {k: stats[k] for k in ("rows", "batches", "rows_per_s",
                                      "latency_p50_ms", "stage_ms_p50")}

    # (a) in-step SGD, logreg with in-band labels, depth 1 and 2
    lmodel, lcpu, _ = data["models"]["logreg"]
    runs = {}
    for depth in (1, 2):
        dcfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, pipeline_depth=depth))
        for lr in (LEARN_LR, 0.0):
            eng = ScoringEngine(dcfg, "logreg", lmodel.params, lmodel.scaler,
                                device=dev, online_lr=lr)
            ptr = eng.state.params.w.data_ptr()
            sink = _Results()
            n = len(batches)
            stats, launches = served(
                lambda: eng.run(_ListSource(_copies(batches)), sink),
                f"(a) depth {depth} lr {lr}", {"fused_featurize_score": n})
            check(eng.state.params.w.data_ptr() == ptr,
                  "learning (a): the SGD rebound w")
            runs[(depth, lr)] = (eng, sink.probs(), stats, launches)
    a1, a2 = runs[(1, LEARN_LR)], runs[(2, LEARN_LR)]
    for x, y in zip(a1[0].state.params, a2[0].state.params):
        check(torch.equal(x, y), "learning (a): params differ at depth 1/2")
    check(np.array_equal(a1[1], a2[1]),
          "learning (a): probabilities differ at depth 1 and 2")
    check(not torch.equal(a2[0].state.params.w, lmodel.params.w),
          "learning (a): the in-step SGD never moved w")
    # parity: LEARN_PARITY_BATCHES batches against a CPU-device engine
    par = {}
    for d, m in ((dev, lmodel), ("cpu", lcpu)):
        eng = ScoringEngine(cfg, "logreg", m.params, m.scaler, device=d,
                            online_lr=LEARN_LR)
        sink = _Results()
        stats, _ = served(lambda: eng.run(
            _ListSource(_copies(batches[:LEARN_PARITY_BATCHES])), sink),
            "(a) parity", {"fused_featurize_score": LEARN_PARITY_BATCHES}
            if d == dev else {})
        par[str(d)] = (eng, sink.probs())
    gpu, cpu = par[str(dev)], par["cpu"]
    perr = max(float((x.cpu() - y).abs().max())
               for x, y in zip(gpu[0].state.params, cpu[0].state.params))
    check(perr <= ATOL_PARAMS, f"learning (a): params {perr} from the CPU")
    np.testing.assert_allclose(gpu[1], cpu[1], rtol=0.0, atol=ATOL_SIGMOID)
    emit({"phase": "learning", "part": "a_in_step_sgd", **line(a2[2]),
          "online_lr": LEARN_LR,
          "rows_per_s": {f"depth{d}": runs[(d, LEARN_LR)][2]["rows_per_s"]
                         for d in (1, 2)},
          "rows_per_s_online_lr_0": {f"depth{d}": runs[(d, 0.0)][2][
              "rows_per_s"] for d in (1, 2)},
          "dispatch_p50_ms": {f"depth{d}": runs[(d, LEARN_LR)][2][
              "dispatch_p50_ms"] for d in (1, 2)},
          "dispatch_p50_ms_online_lr_0": {f"depth{d}": runs[(d, 0.0)][2][
              "dispatch_p50_ms"] for d in (1, 2)},
          "kernel_launches": a2[3], "depth1_equals_depth2": True,
          "max_abs_param_err_vs_cpu": perr,
          "max_abs_prob_err_vs_cpu": float(np.abs(gpu[1] - cpu[1]).max()),
          **card})
    del runs, par

    messages = {}

    def feedback_run(kind, model, bcfg, blist, d, **eng_kw):
        """One engine on ``d`` over ``blist`` with the delayed labels."""
        eng = ScoringEngine(bcfg, kind, model.params, model.scaler,
                            device=d, feature_cache=FeatureCache(
                                LEARN_CACHE_ROWS), **eng_kw)
        broker = InProcBroker(4)
        loop = FeedbackLoop(eng, broker)
        if id(blist) not in messages:
            messages[id(blist)] = _label_messages(blist)
        msgs = messages[id(blist)]
        src = _DelayedLabels(_ListSource(_copies(blist)), broker, msgs)
        sink = _Results()
        return eng, loop, src, sink

    # (b) delayed labels on the direct forest (fused forest kernel)
    fmodel, _, _ = data["models"]["forest"]
    n = len(batches)
    eng, loop, src, sink = feedback_run("forest", fmodel, cfg, batches, dev)
    sf_host = _timed(eng, "apply_state_feedback", [])
    poll_ms = _timed(loop, "poll_and_apply", [])
    stats, launches = served(lambda: eng.run(src, sink, feedback=loop),
                             "(b)", {"fused_forest_leaf_sum": n})
    ref, rloop, rsrc, rsink = feedback_run("logreg", lcpu, cfg, batches,
                                           "cpu")
    ref.run(rsrc, rsink, feedback=rloop)
    check(loop.stats == rloop.stats,
          f"learning (b): loop stats {loop.stats} != {rloop.stats}")
    check(loop.stats["applied"] > 0, "learning (b): no label applied")
    _same_windows(eng.state.feature_state, ref.state.feature_state, "(b)")
    _same_features(sink, rsink, "(b)")
    want = np.concatenate([_plain_probs(
        "forest", eng.state.params, eng.state.scaler, r.features, dev,
        eng.z_mode) for r in rsink.batches])
    np.testing.assert_allclose(sink.probs(), want, rtol=0.0,
                               atol=ATOL_LEAF / 100)
    ctl = ScoringEngine(cfg, "forest", fmodel.params, fmodel.scaler,
                        device=dev)
    cstats, _ = served(lambda: ctl.run(_ListSource(_copies(batches)),
                                       _Results()),
                       "(b) control", {"fused_forest_leaf_sum": n})
    emit({"phase": "learning", "part": "b_delayed_labels_direct_forest",
          "lag_batches": LEARN_LAG, "feature_cache_rows": LEARN_CACHE_ROWS,
          "feedback": loop.stats, "kernel_launches": launches,
          "feedback_poll_ms_p50": _median(poll_ms),
          "state_feedback_host_ms_p50": _median(sf_host),
          "state_feedback_device_ms": _state_feedback_ms(eng, batches[0]),
          "state_feedback_calls": len(sf_host),
          "terminal_fraud_sum": float(
              eng.state.feature_state.terminal.fraud.sum()),
          "rows_per_s_without_feedback": cstats["rows_per_s"],
          "max_abs_prob_err_vs_plain": float(np.abs(
              sink.probs() - want).max()),
          **line(stats), **card})
    del eng, ref, ctl

    # (c) the same traffic shape on the tiered store (1M keys, the JAX
    # bench's state_scale deployment): hits to the dense rows, misses to
    # the terminal sketch's fraud column
    bcfg = _bench_cfg(cfg)
    zb = _zipf_batches(ZipfKeySampler(1 << 20, ZIPF_SKEW), LEARN_BATCHES,
                       day_every=EXACT_DAY_EVERY, seed=11, rows=BATCH_ROWS)
    rng = np.random.default_rng(11)
    for b in zb:
        b["label"] = (rng.random(len(b["tx_id"])) < 0.05).astype(np.int32)
    eng, loop, src, sink = feedback_run("forest", fmodel, bcfg, zb, dev,
                                        metrics=MetricsRegistry())
    sf_host = _timed(eng, "apply_state_feedback", [])
    poll_ms = _timed(loop, "poll_and_apply", [])
    stats, launches = served(lambda: eng.run(src, sink, feedback=loop),
                             "(c)", {"leaf_sum": n})
    ref, rloop, rsrc, rsink = feedback_run("logreg", lcpu, bcfg, zb, "cpu",
                                           metrics=MetricsRegistry())
    ref.run(rsrc, rsink, feedback=rloop)
    check(loop.stats == rloop.stats,
          f"learning (c): loop stats {loop.stats} != {rloop.stats}")
    fs, rfs = eng.state.feature_state, ref.state.feature_state
    for k, v in _dir_leaves(rfs).items():
        check(torch.equal(_dir_leaves(fs)[k], v),
              f"learning (c): directory leaf {k} differs from the CPU")
    check(torch.equal(fs.terminal.fraud.cpu(), rfs.terminal.fraud),
          "learning (c): the dense terminal fraud sums differ")
    check(torch.equal(fs.terminal_cms.fraud.cpu(), rfs.terminal_cms.fraud),
          "learning (c): the sketch's fraud column differs")
    dense_fraud = float(fs.terminal.fraud.sum())
    sketch_fraud = float(fs.terminal_cms.fraud.sum())
    # the stream carries no in-band label: every fraud unit is feedback
    check(dense_fraud > 0 and sketch_fraud > 0,
          f"learning (c): dense {dense_fraud}, sketch {sketch_fraud}")
    _same_features(sink, rsink, "(c)")
    emit({"phase": "learning", "part": "c_delayed_labels_exact_forest",
          "n_keys": 1 << 20, "feedback": loop.stats,
          "kernel_launches": launches,
          "dense_fraud_sum": dense_fraud, "sketch_fraud_sum": sketch_fraud,
          "feedback_poll_ms_p50": _median(poll_ms),
          "state_feedback_host_ms_p50": _median(sf_host),
          "state_feedback_device_ms": _state_feedback_ms(eng, zb[0]),
          **line(stats), **card})
    del eng, ref

    # (d) feedback SGD on logreg (no in-step SGD: cfg.train's step size)
    tries = []
    step = engine_mod.feedback_step

    def counted(*a, **k):
        out = step(*a, **k)
        tries.append(out)
        return out

    engine_mod.feedback_step = counted
    try:
        eng, loop, src, sink = feedback_run("logreg", lmodel, cfg, batches,
                                            dev)
        fb_ms = _timed(eng, "apply_feedback", [])
        stats, launches = served(lambda: eng.run(src, sink, feedback=loop),
                                 "(d)", {"fused_featurize_score": n})
        card_tries = len(tries)
        accepted = sum(bool(t[2] <= t[1]) for t in tries)
        ref, rloop, rsrc, rsink = feedback_run("logreg", lcpu, cfg, batches,
                                               "cpu")
        ref.run(rsrc, rsink, feedback=rloop)
    finally:
        engine_mod.feedback_step = step
    check(loop.stats == rloop.stats, "learning (d): loop stats differ")
    perr = max(float((x.cpu() - y).abs().max())
               for x, y in zip(eng.state.params, ref.state.params))
    check(perr <= ATOL_PARAMS, f"learning (d): params {perr} from the CPU")
    check(not torch.equal(eng.state.params.w, lmodel.params.w),
          "learning (d): the feedback SGD never moved w")
    emit({"phase": "learning", "part": "d_feedback_sgd",
          "feedback": loop.stats, "kernel_launches": launches,
          "apply_feedback_ms_p50": _median(fb_ms),
          "apply_feedback_calls": len(fb_ms),
          "sgd_tries": card_tries, "sgd_steps_accepted": accepted,
          "halvings": card_tries - accepted,
          "max_abs_param_err_vs_cpu": perr, **line(stats), **card})
    del eng, ref

    # (e) the learning loop
    _learning_loop(dev, card, cfg, batches, served)

    # (f) hot reload of a second forest mid-stream, and an externally
    # published forest candidate shadow-scored through the leaf sum
    f2 = synthetic_ensemble(100, 8, 15, seed=1, device="cpu")
    f3 = synthetic_ensemble(100, 8, 15, seed=2, device="cpu")
    reload_at = LEARN_BATCHES // 2
    fsc = data["models"]["forest"][1].scaler
    fcfg = dataclasses.replace(cfg, learn=LearnConfig(
        external_poll_batches=1, promote_min_labels=10 ** 9))
    with tempfile.TemporaryDirectory() as tmp:
        registry = make_model_registry(f"{tmp}/registry")
        f1 = synthetic_ensemble(100, 8, 15, seed=0, device="cpu")
        learning = LearningLoop(registry, fcfg, "forest", model=TrainedModel(
            "forest", fsc, f1), device=dev)
        registry.publish(TrainedModel("forest", fsc, f3), parent=1,
                         source="cli")
        eng = ScoringEngine(fcfg, "forest", fmodel.params, fmodel.scaler,
                            device=dev)
        epoch0 = eng.state.params_epoch
        seen = {}
        orig_step = eng._step

        def step(packed):
            out = orig_step(packed)
            # the tables are re-derived into the same tensors (the graphs
            # read them by pointer): keep each epoch's contents
            seen.setdefault(eng.state.params_epoch,
                            eng.tables.nodes.clone())
            return out

        eng._step = step
        last = {}
        score = learning.shadow.score_batch

        def keep_last(tx, feats, champ):
            score(tx, feats, champ)
            last["feats"] = np.array(feats)
            last["cand"] = learning.shadow._cand_p[
                np.asarray(tx) % learning.shadow.capacity].copy()

        learning.shadow.score_batch = keep_last

        def reload():
            if eng.state.batches_done == reload_at:
                return f2, None
            return None

        sink = _Results()
        try:
            stats, launches = served(lambda: eng.run(
                _ListSource(_copies(batches)), sink, model_reload=reload,
                learning=learning), "(f)",
                {"fused_forest_leaf_sum": n, "leaf_sum": n - 1})
        finally:
            learning.close()
    check(eng.state.params_epoch == epoch0 + 1,
          f"learning (f): params_epoch {eng.state.params_epoch}")
    check(len(seen) == 2 and not torch.equal(seen[epoch0],
                                              seen[epoch0 + 1]),
          "learning (f): the kernel tables were not re-derived")
    check(learning.shadow.candidate_version == 2,
          "learning (f): the external candidate was not installed")
    cand = to_gemm(f3, 15).to(dev)
    want = _plain_probs("forest", cand, eng.state.scaler, last["feats"],
                        dev, eng.z_mode)
    check(np.array_equal(last["cand"], want.astype(np.float32)),
          "learning (f): the shadow's leaf sum differs from the plain "
          "predict")
    ref = ScoringEngine(cfg, "logreg", lcpu.params, lcpu.scaler,
                        device="cpu")
    rsink = _Results()
    ref.run(_ListSource(_copies(batches)), rsink)
    _same_features(sink, rsink, "(f)")
    ferr = 0.0
    old, new = (device_params_for("forest", p.to(dev))
                for p in (fmodel.params, f2))
    # at depth 2 the batch after the reload was already launched on the
    # old tables (eventual swap, as in the JAX engine)
    for i, (res, ref_res) in enumerate(zip(sink.batches, rsink.batches)):
        want = _plain_probs("forest", new if i > reload_at else old,
                            eng.state.scaler, ref_res.features, dev,
                            eng.z_mode)
        np.testing.assert_allclose(res.probs, want, rtol=0.0,
                                   atol=ATOL_LEAF / 100)
        ferr = max(ferr, float(np.abs(res.probs - want).max()))
    emit({"phase": "learning", "part": "f_reload_and_tree_candidate",
          "reload_after_batch": reload_at,
          "params_epoch": eng.state.params_epoch,
          "kernel_launches": launches,
          "shadow_candidate_version": 2,
          "max_abs_prob_err_vs_plain": ferr, **line(stats), **card})
    return totals


ZOO_BATCHES = 8  # (a): card batches of each run
ZOO_PARITY_BATCHES = 2  # (a), (b): batches held against a CPU engine
ATOL_ZOO_PROB = 1e-5  # tests/test_torch_zoo.py, test_torch_history.py
ATOL_SEQ_ORACLE = 3e-4  # tests/test_history.py: f64 oracle, f32 state
SEQ_BATCHES = 8  # (b), (d)
SEQ_ORACLE_ROWS = 48
SEQ_LONG_K = 256  # (c): past seq_attn_block, so blockwise
SEQ_LONG_ROWS = 8192
SEQ_LONG_BATCHES = 16
SEQ_LONG_CUSTOMERS = 256  # 512 events each: the ring wraps twice
SEQ_BIG_CAPACITY = 1 << 20  # (d)
SEQ_SUPERVISED_BATCHES = 24  # (e)
SEQ_SUPERVISED_EVERY = 8
SEQ_CRASH_POLL = 13


def _zoo_models(scaler, dev) -> dict:
    """The mlp (hidden 64, 32) and autoencoder (hidden 32, 8) from seed 0
    and the sequence transformer at the bench's widths (d_model 32, 2
    heads, 2 layers, d_ff 64) — ``ModelConfig``'s defaults — each written
    and read back through the port's artifact format: kind → (model on
    ``dev``, model on the CPU). The autoencoder's ``err_scale`` is the
    median reconstruction error of standard-normal rows (the scaler
    standardizes the stream)."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        ModelConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
        dump_model_bytes,
        load_model_bytes,
    )
    from real_time_fraud_detection_system_tpu_torch.models.autoencoder \
        import init_autoencoder, reconstruction_error
    from real_time_fraud_detection_system_tpu_torch.models.mlp import (
        init_mlp,
    )
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        init_transformer,
    )

    mc = ModelConfig()
    ae = init_autoencoder(15, mc.autoencoder_hidden, seed=0, device="cpu")
    x = torch.randn(4096, 15, generator=torch.Generator().manual_seed(0))
    ae = ae._replace(err_scale=torch.median(reconstruction_error(ae, x)))
    params = {"mlp": init_mlp(15, mc.mlp_hidden, seed=0, device="cpu"),
              "autoencoder": ae,
              "sequence": init_transformer(
                  mc.seq_d_model, mc.seq_n_heads, mc.seq_n_layers,
                  mc.seq_d_ff, seed=0, device="cpu")}
    out = {}
    for kind, p in params.items():
        data = dump_model_bytes(TrainedModel(kind, scaler, p))
        out[kind] = (load_model_bytes(data, device=dev),
                     load_model_bytes(data, device="cpu"))
    return out


def _column_batches(txs, n: int, rows: int = BATCH_ROWS) -> list:
    """The first ``n`` serving batches of ``txs`` (labels in band)."""
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )

    src = ReplaySource(txs.slice(slice(0, n * rows)), START_EPOCH_S,
                       batch_rows=rows, with_labels=True)
    out = []
    while (cols := src.poll_batch()) is not None:
        out.append(cols)
    return out


def _unlabeled(batches) -> list:
    return [{c: v for c, v in b.items() if c != "label"} for b in batches]


def _long_history_batches() -> list:
    """(c)'s stream: ``SEQ_LONG_BATCHES`` batches of ``SEQ_LONG_ROWS``
    rows over ``SEQ_LONG_CUSTOMERS`` customers, seeded numpy, times
    strictly increasing."""
    rng = np.random.default_rng(21)
    n = SEQ_LONG_BATCHES * SEQ_LONG_ROWS
    t_s = START_EPOCH_S + np.cumsum(rng.integers(1, 30, n)).astype(np.int64)
    cust = rng.integers(0, SEQ_LONG_CUSTOMERS, n).astype(np.int64)
    amount = rng.integers(100, 50_000, n).astype(np.int64)
    out = []
    for b in range(SEQ_LONG_BATCHES):
        sl = slice(b * SEQ_LONG_ROWS, (b + 1) * SEQ_LONG_ROWS)
        us = t_s[sl] * 1_000_000
        out.append({"tx_id": np.arange(sl.start, sl.stop, dtype=np.int64),
                    "tx_datetime_us": us, "customer_id": cust[sl],
                    "terminal_id": cust[sl] % 97,
                    "tx_amount_cents": amount[sl],
                    "kafka_ts_ms": us // 1000})
    return out


def _seq_oracle(params, batches, sink, k: int, attn, dev) -> float:
    """Max |streamed − offline| over ``SEQ_ORACLE_ROWS`` rows of the last
    batch: each row's window (its customer's last ``k`` events up to
    itself, in stream order) through ``event_features`` on the host and
    the full ``transformer_logits`` on the card, at the row's position."""
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        event_features,
        transformer_logits,
    )

    cust = np.concatenate([b["customer_id"] for b in batches])
    t_s = np.concatenate([b["tx_datetime_us"] for b in batches]) \
        // 1_000_000
    amount = np.concatenate([b["tx_amount_cents"] for b in batches]) / 100.0
    check(bool(np.all(np.diff(t_s) >= 0)), "zoo: the stream is not "
          "chronological (the oracle's order would differ)")
    probs = np.concatenate([r.probs for r in sink.batches])
    n_last = len(batches[-1]["tx_id"])
    rows = np.random.default_rng(k).choice(
        np.arange(len(cust) - n_last, len(cust)), SEQ_ORACLE_ROWS,
        replace=False)
    x = np.zeros((len(rows), k, 8), np.float32)
    qpos = np.zeros(len(rows), np.int64)
    for r, i in enumerate(rows):
        sel = np.flatnonzero(cust[:i + 1] == cust[i])[-k:]
        f = event_features(amount[sel], t_s[sel])
        x[r, :len(f)] = f
        qpos[r] = len(f) - 1
    logits = transformer_logits(params, torch.from_numpy(x).to(dev), attn)
    want = torch.sigmoid(logits[torch.arange(len(rows)),
                                torch.from_numpy(qpos).to(dev)])
    err = float(np.abs(probs[rows] - want.cpu().numpy()).max())
    check(err <= ATOL_SEQ_ORACLE,
          f"zoo: streamed probabilities {err} from the offline oracle")
    check(int(qpos.max()) == k - 1, "zoo: no oracle window was full")
    return err


def _seq_step_ms(eng, batch: dict) -> float:
    """Device ms of one ``update_and_score`` (a copy of the engine's
    state, the packed batch already on the card), by CUDA events."""
    from real_time_fraud_detection_system_tpu_torch.core.batch import (
        make_batch,
        pack_batch,
        unpack_batch,
    )
    from real_time_fraud_detection_system_tpu_torch.features.history import (
        update_and_score,
    )
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    n = len(batch["tx_id"])
    packed = torch.from_numpy(pack_batch(make_batch(
        customer_id=batch["customer_id"], terminal_id=batch["terminal_id"],
        tx_datetime_us=batch["tx_datetime_us"],
        amount_cents=batch["tx_amount_cents"], pad_to=n))).to(eng.device)
    tb = unpack_batch(packed)
    state = tree.clone(eng.state.feature_state)
    return cuda_ms(lambda: update_and_score(state, eng.state.params, tb,
                                            eng.cfg.features), 10)


def _seq_cfg(cfg, rows: int = BATCH_ROWS, **features):
    return dataclasses.replace(
        cfg, features=dataclasses.replace(cfg.features, **features),
        runtime=dataclasses.replace(cfg.runtime, batch_buckets=(rows,)))


def phase_zoo(dev, device_info, data: dict) -> dict:
    """The rest of the model zoo on the card; see the module docstring,
    phase 11."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        LearnConfig,
        TrainConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.data.generator import (
        ZipfKeySampler,
    )
    from real_time_fraud_detection_system_tpu_torch.features.history import (
        _attn_fn_for,
        history_bytes,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
    )
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        Checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.io.registry import (
        make_model_registry,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        transform,
    )
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        transformer_flops,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
        predict_fn_for,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
        FlakySource,
        run_with_recovery,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.feedback import (
        FeatureCache,
        FeedbackLoop,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.learner import (
        LearningLoop,
        StreamingLearner,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        InProcBroker,
    )
    from real_time_fraud_detection_system_tpu_torch.utils import tree
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        get_registry,
    )

    cfg = data["cfg"]
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    totals = {name: 0 for name in KERNELS}
    models = _zoo_models(data["models"]["forest"][1].scaler, dev)
    batches = _column_batches(data["txs_whole_dollars"], LEARN_BATCHES)

    def served(run, what: str, own=None) -> dict:
        """``drive`` the run: ``own`` (the sequence kernel, on the naive
        attention's paths) launches at least once a batch (a supervised
        run replays batches), no other kernel launches."""
        stats, launches = drive(run)
        for name, n in launches.items():
            if name == own:
                check(n >= stats["batches"] > 0,
                      f"zoo {what}: {n} launches of {name} for "
                      f"{stats['batches']} batches")
            else:
                check(n == 0, f"zoo {what}: {n} launches of {name}")
        return stats

    def line(stats) -> dict:
        return {k: stats[k] for k in ("rows", "batches", "rows_per_s",
                                      "latency_p50_ms", "stage_ms_p50")}

    def params_err(a, b) -> float:
        return max(float((x.cpu() - y).abs().max())
                   for x, y in zip(tree.leaves(a), tree.leaves(b)))

    # (a) mlp and autoencoder: serving, then the in-step SGD
    for kind in ("mlp", "autoencoder"):
        mdev, mcpu = models[kind]
        out = {}
        for lr, n in ((0.0, ZOO_BATCHES), (LEARN_LR, ZOO_BATCHES)):
            src = _copies(batches[:n]) if lr else _unlabeled(batches[:n])
            eng = ScoringEngine(cfg, kind, mdev.params, mdev.scaler,
                                device=dev, online_lr=lr)
            ptrs = [t.data_ptr() for t in tree.leaves(eng.state.params)]
            sink = _Results()
            stats = served(lambda: eng.run(_ListSource(src), sink),
                           f"(a) {kind} lr {lr}")
            check(ptrs == [t.data_ptr() for t in
                           tree.leaves(eng.state.params)],
                  f"zoo (a) {kind}: the SGD rebound a leaf")
            nref = n if lr else ZOO_PARITY_BATCHES
            ref = ScoringEngine(cfg, kind, mcpu.params, mcpu.scaler,
                                device="cpu", online_lr=lr)
            rsink = _Results()
            ref.run(_ListSource(src[:nref]), rsink)
            head = _Results()
            head.batches = sink.batches[:nref]
            _same_features(head, rsink, f"(a) {kind} lr {lr}")
            perr = float(np.abs(head.probs() - rsink.probs()).max())
            check(perr <= ATOL_ZOO_PROB,
                  f"zoo (a) {kind} lr {lr}: probabilities {perr} from CPU")
            check(sink.probs().std() > 0, f"zoo (a) {kind}: flat scores")
            out[lr] = (eng, stats, perr, ref)
        eng, stats, perr, ref = out[LEARN_LR]
        prm = params_err(eng.state.params, ref.state.params)
        check(prm <= ATOL_PARAMS, f"zoo (a) {kind}: params {prm} from CPU")
        check(params_err(eng.state.params, mcpu.params) > 1e-5,
              f"zoo (a) {kind}: the in-step SGD never moved the params")
        emit({"phase": "zoo", "part": f"a_{kind}", **line(out[0.0][1]),
              "rows_per_s_online_lr": stats["rows_per_s"],
              "online_lr": LEARN_LR,
              "max_abs_prob_err_vs_cpu": out[0.0][2],
              "max_abs_prob_err_vs_cpu_online_lr": perr,
              "max_abs_param_err_vs_cpu_online_lr": prm, **card})
        del out, eng, ref

    # (a) the mlp with feedback SGD (labels LEARN_LAG batches late), and
    # its candidate through the streaming learner and the shadow
    mdev, mcpu = models["mlp"]
    lcfg = dataclasses.replace(
        cfg, train=TrainConfig(online_learning_rate=LEARN_LR),
        learn=LearnConfig(publish_every_labels=2 * BATCH_ROWS,
                          promote_min_labels=10 ** 9, window_rows=4096,
                          epochs=2, learning_rate=LEARN_LR,
                          shadow_cache_rows=LEARN_CACHE_ROWS))
    msgs = _label_messages(batches)
    reg = get_registry()

    def metric(name):
        m = reg.get(name)
        return float(m.value) if m is not None else 0.0

    runs, last = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for d, m in ((dev, mdev), ("cpu", mcpu)):
            eng = ScoringEngine(lcfg, "mlp", m.params, m.scaler, device=d,
                                feature_cache=FeatureCache(
                                    LEARN_CACHE_ROWS))
            broker = InProcBroker(4)
            loop = FeedbackLoop(eng, broker)
            src = _DelayedLabels(_ListSource(_copies(batches)), broker,
                                 msgs)
            learning = None
            if d == dev:
                registry = make_model_registry(f"{tmp}/registry")
                learner = StreamingLearner(
                    "mlp", mcpu.params, mcpu.scaler, lcfg, registry,
                    publish_every_labels=2 * BATCH_ROWS, window_rows=4096,
                    epochs=2, learning_rate=LEARN_LR, device=dev)
                learning = LearningLoop(registry, lcfg, "mlp",
                                        model=TrainedModel(
                                            "mlp", mcpu.scaler,
                                            mcpu.params),
                                        learner=learner, device=dev)
                score = learning.shadow.score_batch

                def keep_last(tx, feats, champ, score=score, last=last,
                              learning=learning):
                    score(tx, feats, champ)
                    sh = learning.shadow
                    if sh._cand_params is not None:
                        last.update(feats=np.array(feats),
                                    params=sh._cand_params,
                                    scaler=sh._cand_scaler,
                                    cand=sh._cand_p[np.asarray(tx)
                                                    % sh.capacity].copy())

                learning.shadow.score_batch = keep_last
                base = {n: metric(n) for n in (
                    "rtfds_learner_published_total",
                    "rtfds_shadow_rows_total")}
                fb_ms = _timed(eng, "apply_feedback", [])
            sink = _Results()
            try:
                if d == dev:
                    stats = served(lambda: eng.run(
                        src, sink, feedback=loop, learning=learning),
                        "(a) mlp feedback")
                    check(learner.drain(300.0), "zoo (a): learner stuck")
                else:
                    eng.run(src, sink, feedback=loop)
            finally:
                if learning is not None:
                    learning.close()
            runs[str(d)] = (eng, loop, sink)
        published = metric("rtfds_learner_published_total") \
            - base["rtfds_learner_published_total"]
        shadow_rows = metric("rtfds_shadow_rows_total") \
            - base["rtfds_shadow_rows_total"]
    (eng, loop, sink), (ref, rloop, rsink) = runs[str(dev)], runs["cpu"]
    check(loop.stats == rloop.stats and loop.stats["applied"] > 0,
          f"zoo (a) mlp feedback: loop stats {loop.stats} "
          f"!= {rloop.stats}")
    prm = params_err(eng.state.params, ref.state.params)
    check(prm <= ATOL_PARAMS, f"zoo (a) mlp feedback: params {prm}")
    check(params_err(eng.state.params, mcpu.params) > 1e-5,
          "zoo (a) mlp feedback: the feedback SGD never moved the params")
    _same_features(sink, rsink, "(a) mlp feedback")
    perr = float(np.abs(sink.probs() - rsink.probs()).max())
    check(perr <= ATOL_ZOO_PROB, f"zoo (a) mlp feedback: probs {perr}")
    check(published >= 1 and shadow_rows > 0 and "cand" in last,
          f"zoo (a) mlp learner: {published} published, {shadow_rows} "
          "shadow rows")
    want = predict_fn_for("mlp")(last["params"], transform(
        last["scaler"], torch.from_numpy(last["feats"]).to(dev)))
    want = want.cpu().numpy()
    serr = float(np.abs(last["cand"] - want).max())
    check(serr <= ATOL_ZOO_PROB,
          f"zoo (a) mlp shadow: {serr} from the plain predict")
    emit({"phase": "zoo", "part": "a_mlp_feedback_learner_shadow",
          "lag_batches": LEARN_LAG, "feedback": loop.stats,
          "apply_feedback_ms_p50": _median(fb_ms),
          "apply_feedback_calls": len(fb_ms), "published": published,
          "shadow_rows": shadow_rows,
          "max_abs_param_err_vs_cpu": prm,
          "max_abs_prob_err_vs_cpu": perr,
          "shadow_max_abs_err_vs_plain": serr, **line(stats), **card})
    del runs, eng, ref

    # (b) sequence, K=32, naive attention, 65,536-row batches
    sdev, scpu = models["sequence"]
    scfg = _seq_cfg(cfg, history_len=32)
    check(_attn_fn_for(scfg.features, 32) is None, "zoo (b): not naive")
    sb = _unlabeled(batches[:SEQ_BATCHES])
    eng = ScoringEngine(scfg, "sequence", sdev.params, sdev.scaler,
                        device=dev)
    sink = _Results()
    stats = served(lambda: eng.run(_ListSource(_copies(sb)), sink),
                   "(b) sequence", "fused_last_logit")
    check(not any(r.features.any() for r in sink.batches),
          "zoo (b): a feature column is not zero")
    ref = ScoringEngine(scfg, "sequence", scpu.params, scpu.scaler,
                        device="cpu")
    rsink = _Results()
    ref.run(_ListSource(_copies(sb[:ZOO_PARITY_BATCHES])), rsink)
    head = np.concatenate([r.probs for r in sink.batches[
        :ZOO_PARITY_BATCHES]])
    cerr = float(np.abs(head - rsink.probs()).max())
    check(cerr <= ATOL_ZOO_PROB, f"zoo (b): probabilities {cerr} from CPU")
    oerr = _seq_oracle(sdev.params, sb, sink, 32, None, dev)
    step_ms = _seq_step_ms(eng, sb[-1])
    flops = transformer_flops(sdev.params, BATCH_ROWS, 32)
    hs = eng.state.feature_state
    check(int(hs.count[:-1].sum()) == SEQ_BATCHES * BATCH_ROWS,
          "zoo (b): the rings did not count every row")
    emit({"phase": "zoo", "part": "b_sequence_k32_naive",
          "history_len": 32, "attn": "naive",
          "customer_capacity": scfg.features.customer_capacity,
          "step_device_ms": step_ms, "flops_per_batch": flops,
          "flops_per_row": flops // BATCH_ROWS,
          "achieved_tflops": flops / step_ms / 1e9,
          "max_abs_prob_err_vs_cpu": cerr,
          "max_abs_prob_err_vs_oracle": oerr, **line(stats), **card})
    del eng, ref

    # (c) sequence, K=256: blockwise attention at 8,192-row batches
    ccfg = _seq_cfg(cfg, SEQ_LONG_ROWS, history_len=SEQ_LONG_K)
    attn = _attn_fn_for(ccfg.features, SEQ_LONG_K)
    check(attn is not None, "zoo (c): auto did not choose blockwise")
    lb = _long_history_batches()
    eng = ScoringEngine(ccfg, "sequence", sdev.params, sdev.scaler,
                        device=dev)
    sink = _Results()
    stats = served(lambda: eng.run(_ListSource(_copies(lb)), sink),
                   "(c) sequence long")
    oerr = _seq_oracle(sdev.params, lb, sink, SEQ_LONG_K, attn, dev)
    step_ms = _seq_step_ms(eng, lb[-1])
    flops = transformer_flops(sdev.params, SEQ_LONG_ROWS, SEQ_LONG_K)
    emit({"phase": "zoo", "part": "c_sequence_k256_blockwise",
          "history_len": SEQ_LONG_K, "attn": "blockwise",
          "attn_block": ccfg.features.seq_attn_block,
          "step_device_ms": step_ms, "flops_per_batch": flops,
          "flops_per_row": flops // SEQ_LONG_ROWS,
          "achieved_tflops": flops / step_ms / 1e9,
          "max_abs_prob_err_vs_oracle": oerr, **line(stats), **card})
    del eng

    # (d) sequence at a real state size: 2^20 slots under Zipf(1.1) keys
    dcfg = _seq_cfg(cfg, history_len=32, customer_capacity=SEQ_BIG_CAPACITY)
    zb = _zipf_batches(ZipfKeySampler(SEQ_BIG_CAPACITY, ZIPF_SKEW),
                       SEQ_BATCHES, day_every=EXACT_DAY_EVERY, seed=13)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ScoringEngine(dcfg, "sequence", sdev.params, sdev.scaler,
                        device=dev)
    stats = served(lambda: eng.run(_ListSource(_copies(zb)), _Results()),
                   "(d) sequence 2^20", "fused_last_logit")
    peak = torch.cuda.max_memory_allocated()
    hs = eng.state.feature_state
    check(int(hs.count[:-1].sum()) == SEQ_BATCHES * BATCH_ROWS,
          "zoo (d): the rings did not count every row")
    flops = transformer_flops(sdev.params, BATCH_ROWS, 32)
    emit({"phase": "zoo", "part": "d_sequence_capacity_2p20",
          "customer_capacity": SEQ_BIG_CAPACITY, "zipf_skew": ZIPF_SKEW,
          "history_len": 32,
          "state_bytes": history_bytes(dcfg.features),
          "events_bytes": hs.events.numel() * 4,
          "pos_bytes": hs.pos.numel() * 4,
          "peak_memory_bytes": peak,
          "slots_touched": int((hs.count[:-1] > 0).sum()),
          "step_device_ms": _seq_step_ms(eng, zb[-1]),
          "flops_per_batch": flops, **line(stats), **card})
    del eng, hs

    # (e) sequence under the supervisor: a crash, a restore, a replay
    ecfg = dataclasses.replace(scfg, runtime=dataclasses.replace(
        scfg.runtime, checkpoint_every_batches=SEQ_SUPERVISED_EVERY))
    eb = _unlabeled(_column_batches(data["txs_whole_dollars"],
                                    SEQ_SUPERVISED_BATCHES))
    engines = []

    def make_engine():
        engines.append(ScoringEngine(ecfg, "sequence", sdev.params,
                                     sdev.scaler, device=dev))
        return engines[-1]

    clean = make_engine()
    want = IndexedSink()
    served(lambda: clean.run(_ListSource(_copies(eb)), want),
           "(e) clean", "fused_last_logit")
    got = IndexedSink()
    with tempfile.TemporaryDirectory() as tmp:
        rstats = served(lambda: run_with_recovery(
            make_engine, FlakySource(_ListSource(_copies(eb)),
                                     fail_at=(SEQ_CRASH_POLL,)),
            Checkpointer(f"{tmp}/ck"), sink=got, max_restarts=2),
            "(e) supervised", "fused_last_logit")
    check(rstats["restarts"] == 1, f"zoo (e): {rstats['restarts']} restarts")
    _same_batches(got.batches, want.batches, "zoo (e)")
    for (path, x), (_, y) in zip(
            tree.leaves_with_path(engines[-1].state.feature_state),
            tree.leaves_with_path(clean.state.feature_state)):
        # row C is the sink, written in no fixed order
        check(torch.equal(x[:-1], y[:-1]),
              f"zoo (e): history state {path} differs from the clean run")
    emit({"phase": "zoo", "part": "e_sequence_supervised",
          "batches": SEQ_SUPERVISED_BATCHES,
          "checkpoint_every": SEQ_SUPERVISED_EVERY,
          "crash_poll": SEQ_CRASH_POLL, "restarts": rstats["restarts"],
          "engines": len(engines) - 1, "equal_to_clean_run": True, **card})
    return totals


PRECOMPILE_BATCHES = 8  # the same batches through eager and graph engines
LADDER_POLLS = 24  # the overload cycle: tests/test_torch_overload.py's
LADDER_ROWS = 256  # script, a backlog of 24 polls of 256 rows against
LADDER_LAG_HIGH = 4000  # lag_high_rows 4000


def _state_snapshot(eng) -> list:
    """Clones of every tensor the step writes (the history state's sink
    row ``C``, written in no fixed order, left out)."""
    from real_time_fraud_detection_system_tpu_torch.utils.tree import (
        leaves_with_path,
    )

    out = []
    for tr in (eng.state.feature_state, eng.state.params):
        for path, leaf in leaves_with_path(tr):
            if isinstance(leaf, torch.Tensor):
                if eng.kind == "sequence" and tr is eng.state.feature_state:
                    leaf = leaf[:-1]
                out.append((path, leaf.clone()))
    return out


def _same_snapshot(a: list, b: list, what: str) -> None:
    check(len(a) == len(b), f"{what}: state leaves differ in number")
    for (path, x), (_, y) in zip(a, b):
        check(torch.equal(x, y), f"{what}: state {path} differs")


class _Copies:
    """A sink that keeps copies of each batch's probabilities and
    features, as a sink that writes the rows out does: the result's own
    arrays (pinned host blocks) go back to PyTorch's host cache."""

    def __init__(self):
        self.batches = []

    def append(self, res):
        self.batches.append((res.batch_index, np.array(res.probs),
                             np.array(res.features)))


def _same_results(got, want, what: str) -> None:
    check(len(got.batches) == len(want.batches), f"{what}: batch count")
    for (i, gp, gf), (_, wp, wf) in zip(got.batches, want.batches):
        check(np.array_equal(gp, wp) and np.array_equal(gf, wf),
              f"{what}: batch {i} differs")


def phase_precompile(dev, device_info, data: dict) -> dict:
    """The precompiled step: see the module docstring, phase 12."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        OverloadConfig,
        RuntimeConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.data.generator import (
        ZipfKeySampler,
    )
    from real_time_fraud_detection_system_tpu_torch.io.sink import (
        DeadLetterSink,
        MemorySink,
    )
    from real_time_fraud_detection_system_tpu_torch.models.logreg import (
        LogRegParams,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )

    cfg = data["cfg"]
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    totals = {name: 0 for name in KERNELS}
    t_phase = time.perf_counter()
    models = data["models"]
    zoo = _zoo_models(models["forest"][1].scaler, dev)
    whole = _column_batches(data["txs_whole_dollars"],
                            PRECOMPILE_BATCHES + 1)
    sampler = ZipfKeySampler(1 << 20, ZIPF_SKEW)
    zipf = _zipf_batches(sampler, PRECOMPILE_BATCHES + 1,
                         day_every=EXACT_DAY_EVERY, seed=2)
    seq_cfg = _seq_cfg(cfg, history_len=32, seq_attn="naive")
    cms_cfg = dataclasses.replace(cfg, features=dataclasses.replace(
        cfg.features, customer_source="cms"))
    # path -> (kind, config, model, online_lr, batches, own kernel)
    paths = {
        "forest": ("forest", cfg, models["forest"][0], 0.0,
                   _unlabeled(whole), "fused_forest_leaf_sum"),
        "logreg": ("logreg", cfg, models["logreg"][0], 0.0,
                   _unlabeled(whole), "fused_featurize_score"),
        "logreg_online_lr": ("logreg", cfg, models["logreg"][0], LEARN_LR,
                             whole, "fused_featurize_score"),
        "gbt": ("gbt", cfg, models["gbt"][0], 0.0, _unlabeled(whole),
                "leaf_sum"),
        "cms_forest": ("forest", cms_cfg, models["forest"][0], 0.0,
                       _unlabeled(whole), "leaf_sum"),
        "exact_1m_keys": ("forest", _bench_cfg(cfg), models["forest"][0],
                          0.0, zipf, "leaf_sum"),
        "mlp": ("mlp", cfg, zoo["mlp"][0], 0.0, _unlabeled(whole), None),
        "sequence_k32": ("sequence", seq_cfg, zoo["sequence"][0], 0.0,
                         _unlabeled(whole), "fused_last_logit"),
    }

    def served(eng, batches, sink, what: str, own):
        stats, launches = drive(lambda: eng.run(_ListSource(batches), sink))
        for name, n in launches.items():
            want = stats["batches"] if name == own else 0
            check(n == want, f"precompile {what}: {n} launches of {name} "
                             f"for {stats['batches']} batches (want {want})")
            totals[name] += n
        return stats

    for name, (kind, pcfg, model, lr, batches, own) in paths.items():
        engines = {}
        for mode in ("eager", "graphs"):
            reg = MetricsRegistry()
            eng = ScoringEngine(pcfg, kind, model.params, model.scaler,
                                device=dev, online_lr=lr, metrics=reg)
            # one batch eagerly first: the state precompile must keep is
            # not empty
            eng.process_batch(dict(batches[0]))
            engines[mode] = (eng, reg)
        # the capture empties PyTorch's caches (device and pinned host):
        # it comes before both timed runs, so they start alike
        eng = engines["graphs"][0]
        torch.cuda.synchronize()
        before = _state_snapshot(eng)
        counts = (eng.state.batches_done, eng.state.rows_done,
                  eng.state.params_epoch)
        man = eng.precompile()
        torch.cuda.synchronize()
        _same_snapshot(before, _state_snapshot(eng),
                       f"precompile {name}: precompile")
        check(counts == (eng.state.batches_done, eng.state.rows_done,
                         eng.state.params_epoch),
              f"precompile {name}: counters moved")
        check(man["graphs"] == len(eng.dispatch_inventory()),
              f"precompile {name}: {man['graphs']} graphs")
        del before
        runs = {}
        for mode, (eng, reg) in engines.items():
            sink = _Copies()
            stats = served(eng, batches[1:], sink, f"{name} {mode}", own)
            runs[mode] = (eng, stats, sink, man, reg)
        del engines
        (ee, es, esink, _, _), (ge, gs, gsink, man, greg) = \
            runs["eager"], runs["graphs"]
        _same_results(gsink, esink, f"precompile {name}")
        _same_snapshot(_state_snapshot(ge), _state_snapshot(ee),
                       f"precompile {name}: final state")
        recaptures = greg.get("cuda_graph_recaptures_total").value
        check(recaptures == 0, f"precompile {name}: {recaptures} "
                               "recaptures after warmup")
        emit({"phase": "precompile", "path": name, "kind": kind,
              "key_mode": pcfg.features.key_mode,
              "customer_source": pcfg.features.customer_source,
              "online_lr": lr, "batches": gs["batches"],
              "rows": gs["rows"],
              "precompile_s": man["seconds"],
              "capture_s": ge._captures.seconds,
              "graphs": man["graphs"], "pool_bytes": man["pool_bytes"],
              "signatures": [list(s.key) for s in ge.dispatch_inventory()],
              "dispatch_ms_p50": {"eager": es["dispatch_p50_ms"],
                                  "graphs": gs["dispatch_p50_ms"]},
              "rows_per_s": {"eager": es["rows_per_s"],
                             "graphs": gs["rows_per_s"]},
              "latency_p50_ms": {"eager": es["latency_p50_ms"],
                                 "graphs": gs["latency_p50_ms"]},
              "stage_ms_p50": {"eager": es["stage_ms_p50"],
                               "graphs": gs["stage_ms_p50"]},
              "outputs_and_state_bit_identical": True,
              "recaptures": recaptures, **card})
        del runs, ee, ge, esink, gsink
        torch.cuda.empty_cache()

    # every bucket of the default ladder, captured once and replayed
    bcfg = dataclasses.replace(cfg, runtime=RuntimeConfig(precompile=True))
    reg = MetricsRegistry()
    eng = ScoringEngine(bcfg, "forest", models["forest"][0].params,
                        models["forest"][0].scaler, device=dev, metrics=reg)
    # the warmup's launches (on scratch copies) stay out of the count
    eng.precompile()
    sizes = (100, 1000, 4000, 16000, 65000, 300, 60000)
    sweep = [{k: v[:n] for k, v in b.items()}
             for n, b in zip(sizes, whole[1:] + whole[1:])]
    stats = served(eng, _unlabeled(sweep), None, "bucket sweep",
                   "fused_forest_leaf_sum")
    keys = sorted(s.key for s in eng.dispatch_inventory())
    check(sorted(eng._graphs) == keys and len(keys) == 5,
          f"precompile bucket sweep: graphs {sorted(eng._graphs)}")
    check(reg.get("cuda_graph_recaptures_total").value == 0
          and reg.get("cuda_graph_captures_total").value == len(keys),
          "precompile bucket sweep: a graph was captured twice")
    # the device-memory gauges the sweep's batches sampled, and what one
    # sample costs the loop thread
    mem = {k: reg.get("rtfds_device_memory_bytes", device=str(dev.index),
                      kind=k).value for k in ("in_use", "peak")}
    check(0 < mem["in_use"] <= mem["peak"]
          <= torch.cuda.max_memory_allocated(dev),
          f"precompile bucket sweep: device memory gauges {mem}")
    t = time.perf_counter()
    for _ in range(200):
        eng._devmem.sample()
    sample_us = (time.perf_counter() - t) / 200 * 1e6
    emit({"phase": "precompile", "part": "bucket_sweep",
          "buckets": [k[2] for k in keys], "batches": stats["batches"],
          "captures": reg.get("cuda_graph_captures_total").value,
          "recaptures": 0, "pool_bytes": eng.graph_pool_bytes(),
          "device_memory_bytes": mem, "memory_sample_us": sample_us,
          "memory_sample_every": eng._devmem.EVERY, **card})
    del eng

    # selective and bf16 emission on the forest's graphs, against full
    forest = models["forest"][0]
    emitted = {}
    for mode, rt in (("full", {}), ("selective", None),
                     ("bf16", {"emit_dtype": "bfloat16"})):
        if rt is None:
            probs = emitted["full"][1].probs()
            # at most 1% of the rows flagged, the alert rate selective
            # emission is for: just above the 99th percentile's value, as
            # the forest's probabilities sit on atoms
            rt = {"emit_threshold": float(np.nextafter(
                np.float32(np.quantile(probs, 0.99)), np.float32(1)))}
        mcfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, precompile=True, **rt))
        eng = ScoringEngine(mcfg, "forest", forest.params, forest.scaler,
                            device=dev)
        eng.precompile()
        results = _Results()

        class _Both:
            def __init__(self):
                self.mem = MemorySink()

            def append(self, res):
                results.append(res)
                self.mem.append(res)

        stats = served(eng, _unlabeled(whole[1:]), _Both(), f"emit {mode}",
                       "fused_forest_leaf_sum")
        emitted[mode] = (eng, results, stats, rt)
    full, sel, bf = emitted["full"][1], emitted["selective"][1], \
        emitted["bf16"][1]
    thresh = emitted["selective"][3]["emit_threshold"]
    check(np.array_equal(sel.probs(), full.probs()),
          "precompile selective: probabilities differ from full emission")
    flagged = full.probs() >= thresh
    check(np.array_equal(sel.feats()[flagged], full.feats()[flagged])
          and not sel.feats()[~flagged].any(),
          "precompile selective: flagged rows differ from full emission")
    check(emitted["selective"][0].selective_overflows == 0,
          "precompile selective: a batch overflowed the cap")
    want_bf = torch.from_numpy(full.feats()).to(torch.bfloat16).to(
        torch.float32).numpy()
    check(np.array_equal(bf.probs(), full.probs())
          and np.array_equal(bf.feats(), want_bf),
          "precompile bf16: not the float32 features rounded to bf16")
    pad = BATCH_ROWS
    cap = max(8, int(pad * cfg.runtime.emit_cap_fraction))
    d2h = {"full": pad * 4 * (1 + 15), "selective": (pad + 1 + cap * 16) * 4,
           "bf16": pad * (4 + 15 * 2)}
    for mode, (_, _, stats, _) in emitted.items():
        emit({"phase": "precompile", "part": f"emission_{mode}",
              "d2h_bytes_per_batch": d2h[mode],
              "flagged_share": float(flagged.mean())
              if mode == "selective" else None,
              "sink_ms_p50": stats["sink_write_p50_ms"],
              "result_wait_ms_p50": stats["result_wait_p50_ms"],
              "dispatch_ms_p50": stats["dispatch_p50_ms"],
              "rows_per_s": stats["rows_per_s"], **card})
    del emitted, full, sel, bf

    # the non-finite guard: tests/test_faults.py's degenerate scaler
    H = 3_600_000_000
    rows = [[(1, 1 * H, 5, 9, 1000), (2, 2 * H, 6, 9, 2500)],
            [(3, 3 * H, 5, 9, 66600), (4, 4 * H, 6, 8, 1234)],
            [(5, 5 * H, 5, 9, 2000), (6, 6 * H, 6, 8, 700)]]
    guard_batches = []
    for r in rows:
        tx, ts, cust, term, cents = (np.array(c, np.int64) for c in zip(*r))
        guard_batches.append({"tx_id": tx, "tx_datetime_us": ts,
                              "customer_id": cust, "terminal_id": term,
                              "tx_amount_cents": cents,
                              "kafka_ts_ms": ts // 1000})
    mean = np.zeros(15, np.float32)
    scale = np.ones(15, np.float32)
    mean[0], scale[0] = 666.0, 0.0
    outs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for guard in (True, False):
            gcfg = dataclasses.replace(cfg, runtime=RuntimeConfig(
                batch_buckets=(64,), max_batch_rows=64, nan_guard=guard,
                precompile=True))
            dlq = DeadLetterSink(f"{tmp}/dlq.jsonl") if guard else None
            eng = ScoringEngine(
                gcfg, "logreg",
                LogRegParams(torch.full((15,), 0.01, device=dev),
                             torch.tensor(0.0, device=dev)),
                Scaler(torch.from_numpy(mean).to(dev),
                       torch.from_numpy(scale).to(dev)),
                device=dev, dead_letter=dlq)
            src = guard_batches if guard else [
                {k: v[b["tx_id"] != 3] for k, v in b.items()}
                for b in guard_batches]
            eng.precompile()
            sink = MemorySink()
            stats, launches = drive(lambda: eng.run(_ListSource(src), sink))
            # the guard re-scores the poisoned batch: one step more
            check(launches["fused_featurize_score"]
                  == stats["batches"] + int(guard),
                  f"precompile nan-guard {guard}: launches {launches}")
            for k in totals:
                totals[k] += launches[k]
            outs[guard] = (sink.concat(), dlq.read_all() if dlq else None)
    (out, dl), (clean, _) = outs[True], outs[False]
    check([r["tx_id"] for r in dl] == [3]
          and dl[0]["reason"] == "nonfinite",
          f"precompile nan-guard: dead letters {dl}")
    for col in clean:
        if col != "processed_at_us":
            check(np.array_equal(out[col], clean[col]),
                  f"precompile nan-guard: {col} differs from the clean run")
    emit({"phase": "precompile", "part": "nan_guard",
          "dead_letters": [r["tx_id"] for r in dl],
          "reason": dl[0]["reason"], "equals_clean_run": True, **card})

    # an overload cycle: climb, defer, replay, descend, nothing captured
    ladder = _column_batches(data["txs_whole_dollars"], LADDER_POLLS,
                             rows=LADDER_ROWS)
    ladder = _unlabeled(ladder)
    lcfg = dataclasses.replace(cfg, runtime=RuntimeConfig(
        batch_buckets=(LADDER_ROWS,), precompile=True, autobatch=True,
        overload=OverloadConfig(enabled=True, spill_path="",
                                lag_high_rows=LADDER_LAG_HIGH,
                                climb_dwell_batches=2,
                                descend_dwell_batches=2)))
    ladder_out = {}
    for enabled in (True, False):
        reg = MetricsRegistry()
        rcfg = lcfg if enabled else dataclasses.replace(
            lcfg, runtime=dataclasses.replace(
                lcfg.runtime, overload=OverloadConfig()))
        eng = ScoringEngine(rcfg, "forest", forest.params, forest.scaler,
                            device=dev, metrics=reg)
        eng.precompile()
        lag = reg.gauge("rtfds_source_lag_rows")
        src = _ListSource(ladder)
        poll = src.poll_batch

        def poll_with_lag(poll=poll, src=src, lag=lag):
            cols = poll()
            lag.set(LADDER_ROWS * (len(ladder) - src.i))
            return cols

        src.poll_batch = poll_with_lag
        sink = _Results()
        stats, launches = drive(lambda: eng.run(src, sink))
        check(launches["fused_forest_leaf_sum"] == stats["batches"],
              "precompile overload: launches differ from batches")
        for k in totals:
            totals[k] += launches[k]
        ladder_out[enabled] = (reg, stats, sink)
    reg, stats, sink = ladder_out[True]
    _, _, ctrl = ladder_out[False]
    trans = {d: reg.get("rtfds_overload_transitions_total",
                        direction=d).value for d in ("climb", "descend")}
    shed = reg.get("rtfds_shed_rows_total").value
    check(trans == {"climb": 3, "descend": 3} and shed > 0
          and shed == reg.get("rtfds_shed_replayed_rows_total").value
          and reg.get("rtfds_rows_total").value
          == LADDER_POLLS * LADDER_ROWS,
          f"precompile overload: transitions {trans}, shed {shed}")
    check(reg.get("cuda_graph_recaptures_total").value == 0,
          "precompile overload: a graph was captured again")
    tx = np.concatenate([r.tx_id for r in sink.batches])
    ctx = np.concatenate([r.tx_id for r in ctrl.batches])
    o, co = np.argsort(tx), np.argsort(ctx)
    check(np.array_equal(tx[o], ctx[co])
          and np.array_equal(sink.probs()[o], ctrl.probs()[co]),
          "precompile overload: scores differ from the unthrottled run")
    emit({"phase": "precompile", "part": "overload_cycle",
          "transitions": trans, "shed_rows": shed,
          "batches": stats["batches"], "recaptures": 0,
          "scores_equal_unthrottled": True, **card})
    emit({"phase": "precompile", "part": "total",
          "seconds": time.perf_counter() - t_phase,
          "kernel_launches": totals, **card})
    return totals


INGEST_BATCHES = 8  # (a), (d): 65,536-row batches of the default dataset
INGEST_DECODE_WORKERS = 8
INGEST_PREFETCH = (2, 4)
INGEST_PROFILE_BATCHES = 3
INGEST_SINK_QUEUE = 4  # (c): sink_queue_batches
INGEST_SLOW_APPENDS = 6  # (c): the sink's writer is slow for these
INGEST_SLOW_S = 0.15
INGEST_LADDER_BATCHES = 24
INGEST_QUIET_AFTER = 12  # (c): the poll after which the stream lulls


SPAN_COST_REPS = 20000


def _span_costs() -> dict:
    """Host µs per span of a private tracer, ``SPAN_COST_REPS`` spans
    each: disabled, enabled, enabled with an NVTX range and the profiler
    annotation (what the engine opens on the card), and the two halves of
    the last alone."""
    from real_time_fraud_detection_system_tpu_torch.utils.trace import (
        Tracer,
    )

    tr = Tracer()

    def per_span(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(SPAN_COST_REPS):
            fn()
        return (time.perf_counter() - t0) / SPAN_COST_REPS * 1e6

    def span(nvtx=False):
        with tr.span("dispatch", nvtx=nvtx):
            pass

    def nvtx_only():
        torch.cuda.nvtx.range_push("rtfds.dispatch#0")
        torch.cuda.nvtx.range_pop()

    def annotation_only():
        with torch.profiler.record_function("rtfds.dispatch#0"):
            pass

    out = {"disabled": per_span(span)}
    tr.configure(enabled=True)
    out["enabled"] = per_span(span)
    out["enabled_nvtx_and_annotation"] = per_span(lambda: span(True))
    out["nvtx_push_pop_only"] = per_span(nvtx_only)
    out["profiler_annotation_only"] = per_span(annotation_only)
    return out


class _QuietSpell:
    """A source that lulls after ``after`` polls: zero-row polls until
    ``caught_up()`` holds, then one more, then the rest of the stream.
    The ladder judges pressure on its idle ticks while rung 3 defers every
    batch, so a lull is how a deferring stream comes back down."""

    def __init__(self, inner, after: int, caught_up, timeout_s: float = 60.0):
        self.inner, self.after, self.caught_up = inner, after, caught_up
        self.timeout_s = timeout_s
        self.polls, self.quiet, self.idle_polls, self.t0 = 0, 0, 0, None
        self._last = None

    def poll_batch(self):
        self.polls += 1
        if self.polls > self.after and self.quiet < 2:
            self.t0 = self.t0 or time.perf_counter()
            check(time.perf_counter() - self.t0 < self.timeout_s,
                  "ingest (c): the sink never caught up")
            self.quiet += bool(self.caught_up())
            self.idle_polls += 1
            time.sleep(0.005)  # a quiet topic's poll waits, then is empty
            return {k: v[:0] for k, v in self._last.items()}
        self._last = self.inner.poll_batch()
        return self._last

    @property
    def offsets(self):
        return self.inner.offsets

    def seek(self, offsets):
        self.inner.seek(offsets)


def phase_ingest(dev, device_info, data: dict) -> dict:
    """Ingest and observability on the forest path at 65,536-row batches
    and depth 2 (see the module docstring, phase 13): (a) envelope ingest
    plain and prefetched, (b) exactly-once under prefetch, (c) the
    overload ladder on the live sink and lag series, (d) observability on
    against off, (e) the sources the card machine cannot run."""
    import importlib.util
    import urllib.request

    from real_time_fraud_detection_system_tpu_torch.config import (
        OverloadConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        Checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.io.sink import (
        AsyncSink,
        DeadLetterSink,
        MemorySink,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
        FlakySource,
        PoisonSource,
        run_with_recovery,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.prefetch import (
        PrefetchSource,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        FlightRecorder,
        MetricsRegistry,
        MetricsServer,
        get_registry,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.trace import (
        get_tracer,
    )

    t_phase = time.perf_counter()
    cfg, txs = data["cfg"], data["txs_whole_dollars"]
    model = data["models"]["forest"][0]
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    totals = {name: 0 for name in KERNELS}
    reg = get_registry()

    def engine(c=cfg, **kw):
        eng = ScoringEngine(c, "forest", model.params, model.scaler,
                            device=dev, **kw)
        check(eng.tables is not None, "ingest: the fused forest branch")
        return eng

    def driven(run, what: str, batches=None):
        out, launches = drive(run)
        n = batches if batches is not None else out["batches"]
        check(launches["fused_forest_leaf_sum"] == n
              and launches["leaf_sum"] == launches["fused_featurize_score"]
              == 0, f"ingest {what}: {launches} for {n} batches")
        for k in totals:
            totals[k] += launches[k]
        return out

    def columns(sink) -> dict:
        out = sink.concat()
        out.pop("processed_at_us")  # the wall clock at the sink
        return out

    def same(a: dict, b: dict, what: str) -> None:
        for k in a:
            check(a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]),
                  f"ingest {what}: column {k} differs")

    def idle_share(eng, src) -> float:
        device, wall_ms, _, _, _ = _profiled(eng, src,
                                             INGEST_PROFILE_BATCHES)
        return 1.0 - sum(device.values()) / wall_ms if device else None

    # (a) envelope ingest, plain and prefetched
    rows = INGEST_BATCHES * BATCH_ROWS
    t0 = time.perf_counter()
    env = ReplaySource(txs.slice(slice(0, rows)), START_EPOCH_S,
                       batch_rows=BATCH_ROWS, mode="envelope",
                       decode_workers=INGEST_DECODE_WORKERS)
    encode_s = time.perf_counter() - t0
    m_wait = reg.counter("rtfds_prefetch_wait_seconds_total")
    m_depth = reg.gauge("rtfds_prefetch_queue_depth")
    base = None
    for depth in (0,) + INGEST_PREFETCH:
        env.seek([0] * env.n_partitions)
        src = PrefetchSource(env, max_batches=depth) if depth else env
        depths = []

        class _Sampled(MemorySink):
            def append(self, res):
                depths.append(m_depth.value)
                super().append(res)

        sink = _Sampled()
        wait0 = m_wait.value
        try:
            stats = driven(lambda: engine().run(src, sink),
                           f"(a) prefetch {depth}")
            check(stats["rows"] == rows, f"ingest (a): {stats['rows']} rows")
            out = columns(sink)
            if base is None:
                base = out
            else:
                same(base, out, f"(a) prefetch {depth} against plain")
            env.seek([0] * env.n_partitions)
            src = PrefetchSource(env, max_batches=depth) if depth else env
            idle = idle_share(engine(), src)
        finally:
            if depth:
                src.close()
        emit({"phase": "ingest", "part": "a", "mode": "envelope",
              "prefetch_batches": depth, "rows": rows,
              "batches": stats["batches"], "rows_per_s": stats["rows_per_s"],
              "source_poll_p50_ms": stats["stage_ms_p50"]["source_poll"],
              "host_prep_p50_ms": stats["stage_ms_p50"]["host_prep"],
              "stage_ms_p50": stats["stage_ms_p50"],
              "prefetch_wait_s": m_wait.value - wait0 if depth else None,
              "prefetch_queue_depth_mean":
                  float(np.mean(depths)) if depth else None,
              "device_idle_share": idle,
              "idle_share_batches": INGEST_PROFILE_BATCHES,
              "decode_workers": INGEST_DECODE_WORKERS,
              "envelopes_encoded_s": encode_s,
              "bit_identical_to_plain": True, **card})
    del base, env

    # (b) exactly-once under prefetch: a crash, then poisoned rows
    rcfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, checkpoint_every_batches=RECOVERY_EVERY))
    lo = (RECOVERY_POISON_BATCH - 1) * BATCH_ROWS
    poison = [int(txs.tx_id[lo + k])
              for k in (11, BATCH_ROWS // 2 - 1, BATCH_ROWS - 7)]

    def plain():
        return ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS)

    clean = IndexedSink()
    stats_clean = driven(lambda: engine(rcfg).run(_WithoutRows(plain(),
                                                               poison),
                                                  clean), "(b) clean")
    steps = {"n": 0}

    def make_engine():
        eng = engine(rcfg)
        step = eng._step

        def counted(packed):
            steps["n"] += 1
            return step(packed)

        eng._step = counted
        return eng

    tmp = tempfile.mkdtemp(prefix="ingest-")
    try:
        src = PrefetchSource(FlakySource(PoisonSource(plain(), poison),
                                         fail_at=(RECOVERY_CRASH_POLL,)),
                             max_batches=INGEST_PREFETCH[0])
        ckpt = Checkpointer(f"{tmp}/ck", full_every=RECOVERY_FULL_EVERY)
        saves = []
        save = ckpt.save

        def watched_save(state):
            # what a save records against what was consumed and read ahead
            saves.append((list(state.offsets), state.batches_done,
                          list(src.offsets), list(src.inner.offsets)))
            return save(state)

        ckpt.save = watched_save
        syncs = []
        set_sync = src.set_sync

        def noted(flag):
            syncs.append(bool(flag))
            set_sync(flag)

        src.set_sync = noted
        dlq = DeadLetterSink(f"{tmp}/dlq.jsonl")
        supervised = IndexedSink()
        try:
            stats_b, launches = drive(lambda: run_with_recovery(
                make_engine, src, ckpt, sink=supervised, max_restarts=4,
                crash_loop_k=2, dead_letter=dlq))
        finally:
            src.close()
        # every step ran the fused kernel once, replays and probes included
        check(launches["fused_forest_leaf_sum"] == steps["n"]
              and launches["leaf_sum"] == launches["fused_featurize_score"]
              == 0, f"ingest (b): {launches} for {steps['n']} steps")
        for k in totals:
            totals[k] += launches[k]
        check(dlq.tx_ids() == sorted(poison)
              and all(r["batch_index"] == RECOVERY_POISON_BATCH
                      for r in dlq.read_all()),
              f"ingest (b): dead letters {dlq.tx_ids()}")
        dlq.close()
        _same_batches(supervised.batches, clean.batches, "ingest (b)")
        for saved, done, consumed, ahead in saves:
            check(saved[0] == min(done * BATCH_ROWS, txs.n)
                  and saved[0] <= consumed[0] <= ahead[0],
                  f"ingest (b): a save at batch {done} recorded {saved} "
                  f"with {consumed} consumed, {ahead} read")
        check(syncs == [True, False] and stats_b["restarts"] >= 3,
              f"ingest (b): set_sync {syncs}, {stats_b['restarts']} "
              "restarts")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "ingest", "part": "b", "prefetch_batches":
          INGEST_PREFETCH[0], "batches": stats_b["batches"],
          "restarts": stats_b["restarts"], "steps_run": steps["n"],
          "dead_letter_rows": len(poison), "saves": len(saves),
          "save_offsets_consumed_read": [(s[0], c[0], a[0])
                                         for s, _, c, a in saves],
          "set_sync": syncs, "equals_clean_run": True,
          "clean_batches": stats_clean["batches"], **card})

    # (c) the ladder on live signals: a slow async sink and the lag
    lcfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, precompile=True, sink_queue_batches=INGEST_SINK_QUEUE,
        overload=OverloadConfig(enabled=True, spill_path="",
                                lag_high_rows=64 * BATCH_ROWS,
                                climb_dwell_batches=1,
                                descend_dwell_batches=1)))
    ladder_txs = txs.slice(slice(0, INGEST_LADDER_BATCHES * BATCH_ROWS))
    outs = {}
    for slow in (True, False):
        eng = engine(lcfg if slow else dataclasses.replace(
            lcfg, runtime=dataclasses.replace(
                lcfg.runtime, overload=OverloadConfig())))
        eng.precompile()  # before the counters reset: warmup launches
        recaptures0 = reg.get("cuda_graph_recaptures_total").value
        tmp = tempfile.mkdtemp(prefix="ladder-")
        eng.recorder = FlightRecorder(f"{tmp}/fr.jsonl")

        class _Inner(_Results):
            def append(self, res):
                if slow and len(self.batches) < INGEST_SLOW_APPENDS:
                    time.sleep(INGEST_SLOW_S)
                super().append(res)

        inner = _Inner()
        sink = AsyncSink(inner, max_queue=INGEST_SINK_QUEUE)
        src = _QuietSpell(ReplaySource(ladder_txs, START_EPOCH_S,
                                       batch_rows=BATCH_ROWS),
                          INGEST_QUIET_AFTER,
                          lambda sink=sink: sink._q.unfinished_tasks == 0)
        try:
            stats = driven(lambda: eng.run(src, sink), f"(c) slow={slow}")
        finally:
            sink.close()
            eng.recorder.close()
        events = [r for r in FlightRecorder.read(f"{tmp}/fr.jsonl")[1]
                  if r["kind"] == "event"]
        shutil.rmtree(tmp, ignore_errors=True)
        outs[slow] = (inner, stats, events,
                      reg.get("cuda_graph_recaptures_total").value
                      - recaptures0, src.idle_polls)
    inner, stats, events, recaptures, idle_polls = outs[True]
    climbs = [e for e in events if e["event"] == "overload_climb"]
    descends = [e for e in events if e["event"] == "overload_descend"]
    check(climbs and all("sink_fill" in e and "lag" in e for e in climbs),
          f"ingest (c): climbs {climbs}")
    check(len(descends) == len(climbs)
          and reg.get("rtfds_overload_rung").value == 0,
          f"ingest (c): {len(climbs)} climbs, {len(descends)} descents")
    check(recaptures == 0, "ingest (c): a graph was captured again")
    ctrl = outs[False][0]
    tx, ctx = (np.concatenate([r.tx_id for r in s.batches])
               for s in (inner, ctrl))
    o, co = np.argsort(tx), np.argsort(ctx)
    check(np.array_equal(tx[o], ctx[co])
          and np.array_equal(inner.probs()[o], ctrl.probs()[co]),
          "ingest (c): scores differ from the unthrottled run")
    emit({"phase": "ingest", "part": "c",
          "sink_queue_batches": INGEST_SINK_QUEUE,
          "slow_appends": INGEST_SLOW_APPENDS, "slow_s": INGEST_SLOW_S,
          "climbs": [{k: e[k] for k in e if k not in ("kind", "t")}
                     for e in climbs],
          "descends": len(descends), "max_rung": max(e["rung"]
                                                   for e in climbs),
          "shed_events": sum(e["event"] == "shed" for e in events),
          "idle_polls": idle_polls, "recaptures": recaptures,
          "batches": stats["batches"], "rows_per_s": stats["rows_per_s"],
          "scores_equal_unthrottled": True, **card})

    # (d) observability on against off, in turns, after a warm-up run
    tracer = get_tracer()
    obs_txs = txs.slice(slice(0, INGEST_BATCHES * BATCH_ROWS))
    driven(lambda: engine(metrics=MetricsRegistry()).run(
        ReplaySource(obs_txs, START_EPOCH_S, batch_rows=BATCH_ROWS),
        _Results()), "(d) warm-up")
    runs, seen = [], {}
    for on in (False, True, True, False):
        oreg = MetricsRegistry()
        eng = engine(metrics=oreg)
        tmp = tempfile.mkdtemp(prefix="obs-")
        server = None
        scraped = {}
        if on:
            tracer.configure(enabled=True)
            tracer.clear()
            server = MetricsServer(port=0, host="127.0.0.1",
                                   registry=oreg).start()
            eng.recorder = FlightRecorder(f"{tmp}/fr.jsonl")

        class _Scraping(_Results):
            def append(self, res):
                if server is not None and res.batch_index == 3:
                    for path in ("/metrics", "/metrics.json", "/healthz",
                                 "/trace"):
                        with urllib.request.urlopen(server.url + path,
                                                    timeout=30) as r:
                            scraped[path] = (r.status, r.read())
                super().append(res)

        try:
            stats = driven(lambda: eng.run(
                ReplaySource(obs_txs, START_EPOCH_S, batch_rows=BATCH_ROWS),
                _Scraping()), f"(d) on={on}")
            if on:
                eng.recorder.close()
                recs = [r for r in FlightRecorder.read(f"{tmp}/fr.jsonl")[1]
                        if r["kind"] == "batch"]
                trace = tracer.export_chrome()
        finally:
            if server is not None:
                server.stop()
            tracer.configure(enabled=False)
            shutil.rmtree(tmp, ignore_errors=True)
        if on:
            check(sorted(scraped) == ["/healthz", "/metrics",
                                      "/metrics.json", "/trace"]
                  and all(c == 200 for c, _ in scraped.values()),
                  f"ingest (d): endpoints {[(k, c) for k, (c, _) in scraped.items()]}")
            health = json.loads(scraped["/healthz"][1])
            check(health["status"] == "ok", f"ingest (d): /healthz {health}")
            check(b"\nrtfds_batches_total " in scraped["/metrics"][1]
                  and "rtfds_phase_seconds" in json.loads(
                      scraped["/metrics.json"][1])
                  and "traceEvents" in json.loads(scraped["/trace"][1]),
                  "ingest (d): a scrape lacks the run's series")
            check(len(recs) == stats["batches"]
                  and all(r.get("trace_id") for r in recs),
                  f"ingest (d): {len(recs)} flight records for "
                  f"{stats['batches']} batches")
            per = {}
            for e in trace["traceEvents"]:
                if e.get("ph") == "X":
                    key = (e["name"], e["args"]["trace_id"])
                    per[key] = per.get(key, 0) + 1
            for r in recs:
                for ph in ("host_prep", "dispatch", "result_wait",
                           "sink_write"):
                    check(per.get((ph, r["trace_id"])) == 1,
                          f"ingest (d): {ph} spans of {r['trace_id']}")
            seen = {"endpoints": {k: c for k, (c, _) in scraped.items()},
                    "healthz_status": health["status"],
                    "flight_records": len(recs)}
        runs.append({"observability": on,
                     "rows_per_s": stats["rows_per_s"],
                     "dispatch_p50_ms": stats["dispatch_p50_ms"],
                     "stage_ms_p50": stats["stage_ms_p50"]})
    # the spans' NVTX ranges and profiler annotations under torch.profiler
    pushed = []
    push = torch.cuda.nvtx.range_push

    def counted_push(msg):
        pushed.append(msg)
        return push(msg)

    tracer.configure(enabled=True)
    torch.cuda.nvtx.range_push = counted_push
    try:
        eng = engine()
        _, _, _, events, _ = _profiled(
            eng, ReplaySource(obs_txs, START_EPOCH_S, batch_rows=BATCH_ROWS),
            INGEST_PROFILE_BATCHES)
    finally:
        torch.cuda.nvtx.range_push = push
        tracer.configure(enabled=False)
        tracer.clear()
    ranges = sorted({e.name for e in events
                     if e.name.startswith("rtfds.dispatch#")})
    check(len(ranges) >= INGEST_PROFILE_BATCHES,
          f"ingest (d): profiler dispatch ranges {ranges}")
    check(sum(m.startswith("rtfds.dispatch#") for m in pushed)
          == 1 + INGEST_PROFILE_BATCHES,
          f"ingest (d): {len(pushed)} NVTX ranges pushed")
    emit({"phase": "ingest", "part": "d", "batches": INGEST_BATCHES,
          "runs": runs, **seen, "profiler_dispatch_ranges": ranges,
          "nvtx_ranges_pushed": len(pushed), "span_us": _span_costs(),
          **card})

    # (e) the sources the card machine cannot run
    missing = [m for m in ("pyarrow", "confluent_kafka")
               if importlib.util.find_spec(m) is None]
    emit({"phase": "ingest", "part": "e", "missing_packages": missing,
          "not_run_here": ["RawTableSource", "score --raw-table",
                           "KafkaSource"] if missing else [],
          "proof": "tests/test_torch_sources.py, "
                   "tests/test_torch_cpu_scorer.py (CPU, tier-1)",
          **card})
    emit({"phase": "ingest", "part": "total",
          "seconds": time.perf_counter() - t_phase,
          "kernel_launches": totals, **card})
    return totals


OFFLINE_CHUNK = 8192  # the replay's chunk (features/offline.py default)
OFFLINE_PARITY_CHUNKS = 4  # (a): chunks held against a CPU-device replay
OFFLINE_GBT_TREES = 2  # (b): the one cut, host time (100 in ModelConfig)
OFFLINE_ADAM_WARMUP = 3  # (b): Adam steps before the timed ones
OFFLINE_ADAM_STEPS = 20
OFFLINE_SERVE_PARITY_BATCHES = 2  # (d)
OFFLINE_PREDICT_ROWS = 65536  # (e)
OFFLINE_SELECT = ("30", "60")  # (c): --start-valid, --start-test


def _features_of(cols: dict) -> np.ndarray:
    """The 15 raw feature columns of a sink's analyzed rows, as float32
    (the sink writes counts as int32 and the rest as float64: exact)."""
    from real_time_fraud_detection_system_tpu_torch.features.spec import (
        FEATURE_NAMES,
    )

    return np.stack([cols["tx_amount"] if n == "TX_AMOUNT"
                     else cols[n.lower()] for n in FEATURE_NAMES],
                    axis=1).astype(np.float32)


def _adam_step_ms(opt, loss, *args) -> float:
    """Median device ms of one ``Adam.step`` over ``OFFLINE_ADAM_STEPS``
    steps after ``OFFLINE_ADAM_WARMUP``, each between two CUDA events."""
    for _ in range(OFFLINE_ADAM_WARMUP):
        opt.step(loss, *args)
    times = []
    for _ in range(OFFLINE_ADAM_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        opt.step(loss, *args)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def _cli_run(argv: list, logger: str) -> tuple:
    """``cli.main(argv)`` with its stdout and the named logger's records
    captured and the launch counters reset around it: (rc, its last stdout
    line parsed or None, the log text, the launches, seconds)."""
    import logging

    from real_time_fraud_detection_system_tpu_torch import cli

    out, log_text = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(log_text)
    lg = logging.getLogger(logger)
    lg.addHandler(handler)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc, launches = drive(lambda: cli.main(argv))
    finally:
        lg.removeHandler(handler)
    seconds = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, last, log_text.getvalue(), launches, seconds


def phase_offline(dev, device_info, data: dict) -> dict:
    """The offline side of the zoo on the card: (a) the feature replay,
    (b) training of every kind, (c) ``compare`` and ``select``, (d) the
    trained logreg and gbt served back through their kernels, (e) the
    trained gbt's ``predict_proba`` through the leaf-sum kernel."""
    import importlib.util

    from real_time_fraud_detection_system_tpu_torch.config import ModelConfig
    from real_time_fraud_detection_system_tpu_torch.features import (
        offline,
    )
    from real_time_fraud_detection_system_tpu_torch.features.spec import (
        FEATURE_NAMES,
    )
    from real_time_fraud_detection_system_tpu_torch.io import sink as sinks
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        load_model,
        save_model,
        save_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
    from real_time_fraud_detection_system_tpu_torch.models import (
        mlp,
        sequence,
    )
    from real_time_fraud_detection_system_tpu_torch.models.optim import Adam
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        transform,
    )
    from real_time_fraud_detection_system_tpu_torch.models.train import (
        fit_and_assess,
        fit_and_assess_sequence,
        scale_split_to_txs,
        train_delay_test_split,
    )
    from real_time_fraud_detection_system_tpu_torch.ops.forest_kernels import (
        leaf_sum_plain,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    t_phase = time.perf_counter()
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    cfg, txs, whole = data["cfg"], data["txs"], data["txs_whole_dollars"]
    totals = {name: 0 for name in KERNELS}

    def add(launches: dict) -> None:
        for k in totals:
            totals[k] += launches[k]

    # (a) the replay: the whole stream on the card, timed; the whole-dollar
    # copy's first chunks against a CPU-device replay; warm_start_state
    # against the replay's own final state (whole dollars: bit for bit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feats, launches = drive(lambda: offline.compute_features_replay(
        txs, cfg.features, chunk=OFFLINE_CHUNK, device=dev))
    replay_s = time.perf_counter() - t0
    add(launches)
    check(feats.shape == (txs.n, 15) and bool(np.isfinite(feats).all()),
          "offline (a): replayed features not finite [N, 15]")
    wfeats, wstate = offline._replay(whole, cfg.features, "2025-04-01",
                                     OFFLINE_CHUNK, False, True, dev)
    n_par = OFFLINE_PARITY_CHUNKS * OFFLINE_CHUNK
    cpu = offline.compute_features_replay(whole.slice(slice(0, n_par)),
                                          cfg.features, chunk=OFFLINE_CHUNK,
                                          device="cpu")
    counts = [i for i, n in enumerate(FEATURE_NAMES) if "_NB_TX_" in n]
    rest = [i for i in range(15) if i not in counts]
    check(np.array_equal(wfeats[:n_par, counts], cpu[:, counts]),
          "offline (a): replayed counts differ from the CPU replay")
    np.testing.assert_allclose(wfeats[:n_par, rest], cpu[:, rest],
                               rtol=RTOL_FEATURE)
    warm = offline.warm_start_state(whole, cfg.features,
                                    chunk=OFFLINE_CHUNK, device=dev)
    same_state = all(torch.equal(a, b) for a, b in
                     zip(tree.leaves(warm), tree.leaves(wstate)))
    check(same_state, "offline (a): warm_start_state differs from the "
                      "replay's final state")
    emit({"phase": "offline", "part": "a", "rows": txs.n,
          "chunk": OFFLINE_CHUNK, "replay_s": replay_s,
          "replay_rows_per_s": txs.n / replay_s,
          "parity_rows": n_par,
          "parity_bit_identical": bool(np.array_equal(wfeats[:n_par], cpu)),
          "warm_start_equals_replay_state": same_state,
          "kernel_launches": launches, **card})
    del wfeats, wstate, warm, cpu

    dtr, dde, dte = scale_split_to_txs(
        txs, cfg.train.delta_train_days, cfg.train.delta_delay_days,
        cfg.train.delta_test_days)
    check((dtr, dde, dte) == (153, 30, 30),
          f"offline: the 245-day dataset split {dtr}/{dde}/{dte}")
    train_mask, test_mask = train_delay_test_split(
        txs, delta_train=dtr, delta_delay=dde, delta_test=dte)
    collected = {}
    make_sink = sinks.make_parquet_sink

    def collecting(path):
        collected[path] = MemorySink()
        return collected[path]

    with tempfile.TemporaryDirectory() as tmp:
        save_transactions(f"{tmp}/txs.npz", txs)

        # (b) training: the train command for logreg, then every kind
        # in-process with its fit and predict seconds
        rc, logreg_line, _, launches, seconds = _cli_run(
            ["train", "--data", f"{tmp}/txs.npz", "--model", "logreg",
             "--out-model", f"{tmp}/logreg.npz"], "train")
        check(rc == 0, f"offline (b): train --model logreg exited {rc}")
        add(launches)
        emit({"phase": "offline", "part": "b", "command": "train",
              "model": "logreg", "seconds_with_replay": seconds,
              "last_line": logreg_line, "kernel_launches": launches,
              **card})
        gbt_cfg = cfg.replace(model=dataclasses.replace(
            cfg.model, forest_n_trees=OFFLINE_GBT_TREES))
        trained = {}
        for kind in ("logreg", "mlp", "autoencoder", "gbt", "sequence"):
            if kind == "sequence":
                run = lambda: fit_and_assess_sequence(  # noqa: E731
                    txs, cfg, train_mask, test_mask, device=dev)
            else:
                run = lambda: fit_and_assess(  # noqa: E731
                    txs, feats, gbt_cfg if kind == "gbt" else cfg, kind,
                    train_mask, test_mask, device=dev)
            (model, metrics, fit_s, pred_s, probs), launches = drive(run)
            add(launches)
            check(probs.shape == (int(test_mask.sum()),)
                  and bool(np.isfinite(probs).all()),
                  f"offline (b): {kind} test probabilities")
            if kind == "gbt":
                check(launches["leaf_sum"] == 1,
                      f"offline (b): gbt predict launched {launches}")
            elif kind == "sequence":
                # the serving-path evaluation's history steps
                check(launches["fused_last_logit"] > 0 and sum(
                    launches.values()) == launches["fused_last_logit"],
                      f"offline (b): sequence launched {launches}")
            else:
                check(not any(launches.values()),
                      f"offline (b): {kind} launched {launches}")
            trained[kind] = model
            emit({"phase": "offline", "part": "b", "model": kind,
                  "fit_s": fit_s, "predict_s": pred_s,
                  "train_rows": int(train_mask.sum()),
                  "test_rows": int(test_mask.sum()),
                  "auc_roc": metrics["auc_roc"],
                  "average_precision": metrics["average_precision"],
                  "card_precision_top_100": metrics["card_precision@100"],
                  "epochs": cfg.train.epochs,
                  "trees": OFFLINE_GBT_TREES if kind == "gbt" else None,
                  "kernel_launches": launches, **card})
        # device ms per Adam step: the mlp on one 4,096-row batch of the
        # scaled train features, the transformer on one 64-history batch
        xs = transform(trained["mlp"].scaler, torch.as_tensor(
            feats[train_mask][:cfg.train.batch_size], device=dev))
        ys = torch.as_tensor(txs.tx_fraud[train_mask][:cfg.train.batch_size]
                             .astype(np.float32), device=dev)
        mlp_ms = _adam_step_ms(
            Adam(mlp.init_mlp(15, tuple(cfg.model.mlp_hidden), 0, dev),
                 1e-3),
            lambda p, x, y: mlp.mlp_loss(p, x, y, None, 1.0), xs, ys)
        seqs = sequence.build_sequences(
            txs.slice(train_mask), max_len=cfg.features.history_len,
            start_epoch_s=START_EPOCH_S)
        sb = [torch.as_tensor(a[:64], device=dev)
              for a in (seqs.x, seqs.y, seqs.mask)]
        m = cfg.model
        seq_ms = _adam_step_ms(
            Adam(sequence.init_transformer(m.seq_d_model, m.seq_n_heads,
                                           m.seq_n_layers, m.seq_d_ff,
                                           device=dev), 1e-3),
            lambda p, x, y, k: sequence.transformer_loss(p, x, y, k, 1.0),
            *sb)
        emit({"phase": "offline", "part": "b", "adam_step_ms": {
            "mlp": mlp_ms, "transformer": seq_ms},
            "mlp_batch": cfg.train.batch_size, "mlp_hidden":
            list(cfg.model.mlp_hidden), "transformer_batch": 64,
            "transformer_dims": [m.seq_d_model, m.seq_n_heads,
                                 m.seq_n_layers, m.seq_d_ff],
            "history_len": cfg.features.history_len,
            "median_of": OFFLINE_ADAM_STEPS, "warmup": OFFLINE_ADAM_WARMUP,
            **card})

        # (c) compare and select, and the forest's refusal without sklearn
        rc, line, _, launches, seconds = _cli_run(
            ["compare", "--data", f"{tmp}/txs.npz", "--models", "logreg",
             "mlp", "autoencoder", "sequence", "--epochs", "1"], "compare")
        check(rc == 0 and [r["model"] for r in line["models"]]
              == ["logreg", "mlp", "autoencoder", "sequence"],
              f"offline (c): compare exited {rc}: {line}")
        add(launches)
        emit({"phase": "offline", "part": "c", "command": "compare",
              "seconds_with_replay": seconds, "last_line": line, **card})
        rc, line, _, launches, seconds = _cli_run(
            ["select", "--data", f"{tmp}/txs.npz", "--model", "logreg",
             "--grid", "learning_rate=0.01,0.001", "--folds", "2",
             "--epochs", "1", "--start-valid", OFFLINE_SELECT[0],
             "--start-test", OFFLINE_SELECT[1]], "select")
        check(rc == 0 and line["metrics"]["auc_roc"]["best_params"],
              f"offline (c): select exited {rc}: {line}")
        add(launches)
        emit({"phase": "offline", "part": "c", "command": "select",
              "seconds_with_replay": seconds, "last_line": line, **card})
        if importlib.util.find_spec("sklearn") is None:
            rc, _, log_text, _, _ = _cli_run(
                ["train", "--data", f"{tmp}/txs.npz", "--model", "forest",
                 "--out-model", f"{tmp}/forest.npz"], "train")
            check(rc == 2 and "sklearn" in log_text,
                  f"offline (c): train --model forest exited {rc}: "
                  f"{log_text!r}")
            refusal = {"rc": rc, "log": log_text.strip()}
        else:
            refusal = {"rc": None, "log": "sklearn is installed here: "
                                          "the refusal does not apply"}
        emit({"phase": "offline", "part": "c", "command": "train",
              "model": "forest", **refusal, **card})

        # (d) serve what was trained: the logreg artifact through the
        # score command (the fused logreg kernel), the gbt through the
        # engine (the leaf-sum kernel), each batch's first rows against
        # the host scorer
        sinks.make_parquet_sink = collecting
        try:
            rc, stats, _, launches, seconds = _cli_run(
                ["score", "--data", f"{tmp}/txs.npz", "--model-file",
                 f"{tmp}/logreg.npz", "--batch-rows", str(BATCH_ROWS),
                 "--out", f"{tmp}/out-logreg"], "score")
        finally:
            sinks.make_parquet_sink = make_sink
        check(rc == 0 and stats["rows"] == txs.n,
              f"offline (d): score exited {rc}")
        check(launches["fused_featurize_score"] == stats["batches"]
              and launches["leaf_sum"] == 0
              and launches["fused_forest_leaf_sum"] == 0,
              f"offline (d): logreg launches {launches} for "
              f"{stats['batches']} batches")
        add(launches)
        logreg = load_model(f"{tmp}/logreg.npz", device=dev)
        out = collected[f"{tmp}/out-logreg"]
        logreg_err = 0.0
        for cols in out.batches[:OFFLINE_SERVE_PARITY_BATCHES]:
            want = logreg.predict_proba_np(_features_of(cols))
            logreg_err = max(logreg_err, float(np.abs(
                cols["prediction"] - want).max()))
        check(logreg_err <= ATOL_SIGMOID,
              f"offline (d): served logreg vs predict_proba_np {logreg_err}")
        emit({"phase": "offline", "part": "d", "model": "logreg",
              "route": "score command", "rows": stats["rows"],
              "batches": stats["batches"], "rows_per_s": stats["rows_per_s"],
              "max_abs_err_vs_predict_proba_np": logreg_err,
              "atol": ATOL_SIGMOID, "kernel_launches": launches, **card})

        save_model(f"{tmp}/gbt.npz", trained["gbt"])
        gbt = load_model(f"{tmp}/gbt.npz", device=dev)
        check(gbt.content_sha256 is not None, "offline (d): gbt hash")
        eng = ScoringEngine(cfg, "gbt", gbt.params, gbt.scaler, device=dev)
        check(eng.leaf_tables is not None,
              "offline (d): the trained gbt is not on the leaf-sum kernel")
        sink = MemorySink()
        stats, launches = drive(lambda: eng.run(
            ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS), sink))
        check(launches["leaf_sum"] == stats["batches"]
              and launches["fused_forest_leaf_sum"] == 0
              and launches["fused_featurize_score"] == 0,
              f"offline (d): gbt launches {launches} for "
              f"{stats['batches']} batches")
        add(launches)
        gbt_err = 0.0
        for cols in sink.batches[:OFFLINE_SERVE_PARITY_BATCHES]:
            want = gbt.predict_proba_np(_features_of(cols))
            gbt_err = max(gbt_err, float(np.abs(
                cols["prediction"] - want).max()))
        check(gbt_err <= ATOL_SIGMOID,
              f"offline (d): served gbt vs predict_proba_np {gbt_err}")
        emit({"phase": "offline", "part": "d", "model": "gbt",
              "route": "ScoringEngine", "rows": stats["rows"],
              "batches": stats["batches"], "rows_per_s": stats["rows_per_s"],
              "max_abs_err_vs_predict_proba_np": gbt_err,
              "atol": ATOL_SIGMOID, "kernel_launches": launches, **card})

    # (e) the trained gbt's predict_proba on the card: one leaf-sum launch
    # on 65,536 test rows, equal to the plain version exactly
    rows = feats[test_mask][:OFFLINE_PREDICT_ROWS]
    model = trained["gbt"]
    probs, launches = drive(lambda: model.predict_proba(rows))
    add(launches)
    check(launches["leaf_sum"] == 1,
          f"offline (e): predict_proba launched {launches}")
    params, tables = model._device_route()
    x = transform(model.scaler, torch.as_tensor(rows, device=dev))
    plain = torch.sigmoid(params.base_score
                          + leaf_sum_plain(tables, x)).cpu().numpy()
    err = float(np.abs(probs - plain).max())
    check(err == 0.0, f"offline (e): predict_proba vs plain {err}")
    emit({"phase": "offline", "part": "e", "rows": len(rows),
          "max_abs_err_vs_leaf_sum_plain": err, "kernel_launches": launches,
          **card})
    emit({"phase": "offline", "part": "total",
          "seconds": time.perf_counter() - t_phase,
          "reduced": {"gbt_trees": f"{OFFLINE_GBT_TREES} of "
                                   f"{ModelConfig().forest_n_trees} "
                                   "(the NumPy booster's host time)"},
          "kernel_launches": totals, **card})
    return totals


SHARDED_BATCHES = 12
SHARDED_WIDTHS = (4, 8)
SHARDED_HOT_SHARES = (0.6, 0.0, 0.6)  # (c): the hot batches' hot share
SHARDED_HOT_ROWS_PER_SHARD = 4096
SHARDED_SPLIT = 6  # (e): batches before the checkpoint
ATOL_SHARDED = 1e-6  # the issue's bound for sharded against single


def _sliced(res: "_Results", start: int) -> "_Results":
    out = _Results()
    out.batches = res.batches[start:]
    return out


def _same_rows(got: "_Results", want: "_Results", what: str,
               atol: float = ATOL_SHARDED) -> float:
    """Features bit for bit, probabilities within ``atol``; → max |Δp|."""
    check(len(got.batches) == len(want.batches),
          f"{what}: {len(got.batches)} batches against "
          f"{len(want.batches)}")
    check(np.array_equal(got.feats(), want.feats()),
          f"{what}: features differ")
    err = float(np.abs(got.probs() - want.probs()).max())
    check(err <= atol, f"{what}: probabilities differ by {err}")
    return err


def phase_sharded(dev, device_info, data: dict) -> dict:
    """The sharded engine on one card: see the module docstring, phase
    16."""
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        Checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.ops import (
        forest_kernels,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel.step import (
        partition_batch_spill,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime import (
        engine as engine_mod,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine

    t_phase = time.perf_counter()
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    totals = {name: 0 for name in KERNELS}
    base = data["cfg"]
    cfg = dataclasses.replace(base, runtime=dataclasses.replace(
        base.runtime, z_mode="int8"))
    models = data["models"]
    labeled = _column_batches(data["txs_whole_dollars"], SHARDED_BATCHES)
    batches = _unlabeled(labeled)

    def engine(kind, n_dev=0, dev_=dev, model=None, **kw):
        model = model or models[kind][0 if dev_ == dev else 1]
        if n_dev:
            return ShardedScoringEngine(cfg, kind, model.params,
                                        model.scaler, n_devices=n_dev,
                                        device=dev_, **kw)
        return ScoringEngine(cfg, kind, model.params, model.scaler,
                             device=dev_, **kw)

    def serve(eng, bs, what, own=None):
        """Serve ``bs`` with the counts zeroed just before: ``own`` must
        launch once per chunk (once per batch on the single engine), the
        other kernels never."""
        res = _Results()
        stats, launches = drive(lambda: eng.run(_ListSource(bs), res))
        steps = stats.get("chunks", stats["batches"])
        for name, n in launches.items():
            want = steps if name == own else 0
            check(n == want, f"sharded {what}: {n} launches of {name} "
                             f"for {steps} steps (want {want})")
            totals[name] += n
        check(stats["rows"] == sum(len(b["tx_id"]) for b in bs),
              f"sharded {what}: not every row was scored")
        check(bool(np.isfinite(res.probs()).all())
              and bool(np.isfinite(res.feats()).all()),
              f"sharded {what}: non-finite outputs")
        return stats, res

    def loop_stats(stats) -> dict:
        return {k: stats[k] for k in (
            "rows", "batches", "rows_per_s", "latency_p50_ms",
            "latency_p99_ms", "stage_ms_p50")} | {
            k: stats[k] for k in ("chunks", "full_exchange_chunks")
            if k in stats}

    def idle(eng) -> dict:
        device, wall_ms, _, _, _ = _profiled(eng, _ListSource(batches),
                                             PROFILE_BATCHES)
        busy = sum(device.values())
        return {"device_busy_ms_per_batch": busy / PROFILE_BATCHES
                if device else "not measured",
                "device_idle_share": 1.0 - busy / wall_ms if device
                else "not measured"}

    # (a) 4 and 8 shards against the single engine -------------------------
    single = engine("forest")
    s_stats, s_res = serve(single, batches, "single",
                           "fused_forest_leaf_sum")
    widths = {"single": {**loop_stats(s_stats), **idle(engine("forest"))}}
    for n_dev in SHARDED_WIDTHS:
        eng = engine("forest", n_dev)
        check(eng.leaf_tables is not None and eng.tables is None,
              f"sharded {n_dev}: not on the leaf-sum path")
        stats, res = serve(eng, batches, f"{n_dev} shards", "leaf_sum")
        err = _same_rows(res, s_res, f"{n_dev} shards against single")
        widths[n_dev] = {**loop_stats(stats), "rows_per_shard":
                         eng.rows_per_shard, "max_abs_err_vs_single": err,
                         **idle(engine("forest", n_dev))}
    emit({"phase": "sharded", "part": "a_widths", "kind": "forest",
          "z_mode": single.z_mode, "rows_per_batch": BATCH_ROWS,
          "widths": {str(k): v for k, v in widths.items()}, **card})

    # (b) the leaf-sum launch inside the sharded step ----------------------
    seen = []
    proba = engine_mod.leaf_sum_proba
    leaf_sum = forest_kernels.leaf_sum

    def spy(tables, x, base=None):
        seen.append((tables, x))
        return proba(tables, x, base)

    eng = engine("forest", 4)
    engine_mod.leaf_sum_proba = spy
    try:
        eng.process_batch(dict(batches[0]))
    finally:
        engine_mod.leaf_sum_proba = proba
    check(len(seen) == 1, f"{len(seen)} leaf-sum calls for one chunk")
    tables, x = seen[0]
    chunk = 4 * eng.rows_per_shard
    check(tuple(x.shape) == (chunk, 15), f"leaf sum over {tuple(x.shape)}")
    got = leaf_sum(tables, x)
    want = forest_kernels.leaf_sum_plain(tables, x)
    err = float((got - want).abs().max())
    check(err <= ATOL_LEAF, f"sharded leaf sum differs by {err}")
    walk = _walk_ops(tables, x, tables.n_trees)
    emit({"phase": "sharded", "part": "b_leaf_sum", "rows": chunk,
          "max_abs_err": err, "bit_equal": bool(torch.equal(got, want)),
          **_time(lambda: leaf_sum(tables, x),
                  lambda: forest_kernels.leaf_sum_plain(tables, x),
                  _bound([x], [got], walk["ops"], _tree_bytes(tables))),
          **card})

    # (c) a hot customer: routed chunks and the full exchange bucket -------
    rng = np.random.default_rng(5)
    hot = []
    for b, share in zip(batches, SHARDED_HOT_SHARES):
        h = dict(b)
        h["customer_id"] = np.where(rng.random(len(b["tx_id"])) < share,
                                    7, b["customer_id"]).astype(np.int64)
        hot.append(h)
    rps = SHARDED_HOT_ROWS_PER_SHARD
    eager = engine("forest", 4, rows_per_shard=rps)
    e_stats, e_res = serve(eager, hot, "hot eager", "leaf_sum")
    check(e_stats["full_exchange_chunks"] > 0
          and e_stats["chunks"] > len(hot),
          f"hot stream: {e_stats['chunks']} chunks, "
          f"{e_stats['full_exchange_chunks']} full-bucket")
    ref = engine("forest")
    r_res = _Results()
    for b in hot:
        probs = np.zeros(len(b["tx_id"]), np.float32)
        feats = np.zeros((len(b["tx_id"]), 15), np.float32)
        for _, rows, _ in partition_batch_spill(b, 4, rps):
            out = ref.process_batch({k: v[rows] for k, v in b.items()})
            probs[rows], feats[rows] = out.probs, out.features
        r_res.batches.append(dataclasses.replace(out, probs=probs,
                                                 features=feats))
    hot_err = _same_rows(e_res, r_res, "hot stream against single chunks")
    emit({"phase": "sharded", "part": "c_hot_key", "shards": 4,
          "rows_per_shard": rps, "hot_shares": list(SHARDED_HOT_SHARES),
          **loop_stats(e_stats), "max_abs_err_vs_single": hot_err, **card})

    # (d) both signatures captured, replayed against eager -----------------
    graphs = engine("forest", 4, rows_per_shard=rps)
    man = graphs.precompile()
    check(man["graphs"] == 2 and sorted(graphs._graphs)
          == [("sharded", False), ("sharded", True)],
          f"precompile captured {sorted(graphs._graphs)}")
    replays = {key: 0 for key in graphs._graphs}
    for key, g in graphs._graphs.items():
        def counted(*a, _g=g, _replay=g.replay, _key=key):
            replays[_key] += 1
            return _replay(*a)

        g.replay = counted
    g_stats, g_res = serve(graphs, hot, "hot graphs", "leaf_sum")
    check(all(n > 0 for n in replays.values()),
          f"graph replays {replays}")
    check(g_res.probs().tobytes() == e_res.probs().tobytes()
          and g_res.feats().tobytes() == e_res.feats().tobytes(),
          "graph replay differs from eager dispatch")
    emit({"phase": "sharded", "part": "d_precompile",
          "graphs": man["graphs"], "precompile_s": man["seconds"],
          "pool_bytes": man["pool_bytes"],
          "replays": {str(k): v for k, v in replays.items()},
          "eager_chunks": g_stats["full_exchange_chunks"],
          "dispatch_p50_ms": {"graphs": g_stats["stage_ms_p50"]["dispatch"],
                              "eager": e_stats["stage_ms_p50"]["dispatch"]},
          **card})

    # (e) a checkpoint at 4 shards, restored at 8 and at 1 ---------------
    first, rest = batches[:SHARDED_SPLIT], batches[SHARDED_SPLIT:]
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        four = engine("forest", 4)
        serve(four, first, "before the checkpoint", "leaf_sum")
        t0 = time.perf_counter()
        ck.save(four.state)
        save_ms = (time.perf_counter() - t0) * 1e3
        for n_dev in (8, 0):
            eng = engine("forest", n_dev)
            t0 = time.perf_counter()
            check(ck.restore(eng.state) is not None, "no checkpoint")
            check(eng.state.layout_devices == 4,
                  f"restored layout {eng.state.layout_devices}")
            eng._ensure_layout()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check(eng.state.layout_devices == (n_dev or 1),
                  "the restore was not converted")
            _, res = serve(eng, rest, f"restored at {n_dev or 1}",
                           "leaf_sum" if n_dev else "fused_forest_leaf_sum")
            legs[n_dev or 1] = {"restore_and_convert_ms": ms,
                                "max_abs_err_vs_single": _same_rows(
                                    res, _sliced(s_res, SHARDED_SPLIT),
                                    f"restored at {n_dev or 1}")}
    emit({"phase": "sharded", "part": "e_cross_width", "saved_at": 4,
          "save_ms": save_ms, "restored": {str(k): v
                                           for k, v in legs.items()},
          **card})

    # (f) gbt and logreg with the in-step SGD ------------------------------
    g_stats, g_res = serve(engine("gbt", 4), batches[:4], "gbt",
                           "leaf_sum")
    _, gs_res = serve(engine("gbt"), batches[:4], "gbt single",
                      "leaf_sum")
    gbt_err = _same_rows(g_res, gs_res, "gbt against single",
                         atol=ATOL_SIGMOID)
    lr = 1e-3
    card_lr = engine("logreg", 4, online_lr=lr)
    l_stats, l_res = serve(card_lr, labeled[:2], "logreg sgd")
    cpu_lr = engine("logreg", 4, dev_=torch.device("cpu"), online_lr=lr)
    c_res = _Results()
    cpu_lr.run(_ListSource(labeled[:2]), c_res)
    lr_err = _same_rows(l_res, c_res, "logreg sgd against the CPU",
                        atol=ATOL_SIGMOID)
    p_err = max(float((a.cpu() - b).abs().max()) for a, b in zip(
        (card_lr.state.params.w, card_lr.state.params.b),
        (cpu_lr.state.params.w, cpu_lr.state.params.b)))
    check(p_err <= 1e-6, f"sharded sgd params differ by {p_err}")
    emit({"phase": "sharded", "part": "f_gbt_logreg", "shards": 4,
          "gbt": {**loop_stats(g_stats), "max_abs_err_vs_single": gbt_err},
          "logreg_sgd": {**loop_stats(l_stats), "online_lr": lr,
                         "max_abs_err_vs_cpu": lr_err,
                         "params_max_abs_err_vs_cpu": p_err},
          **card})
    emit({"phase": "sharded", "part": "done", "kernel_launches": totals,
          "phase_s": time.perf_counter() - t_phase, **card})
    return totals


# -- phase sharded_exact ------------------------------------------------------

# (b): tools/sharded_state_scale_bench.py's deployment of the JAX package:
# hot tiers of 2^15 slots per table, sketches 2^14 wide, compaction every
# 2 batches, 16,384-row batches, 2 warm batches then 6 with the day
# advancing every 2, at 2 and 4 shards under precompile.
SX_WIDTHS = (4, 8)  # (a)
SX_BENCH_SHARDS = (2, 4)
SX_BENCH_ROWS = 16384
SX_BENCH_BATCHES = 6
SX_BENCH_DAY_EVERY = 2
SX_BIG_BATCHES = 6  # (c), (d): 65,536-row batches after 2 warm ones
SX_COLD_BATCHES = 12
SX_LABEL_SHARE = 0.05  # (e)
SX_LABEL_BATCHES = 4


def _sx_occupancy(fs) -> dict:
    """Occupied hot-tier slots per table, per shard."""
    return {t: (kd.free.shape[-1] - kd.free_top).cpu().tolist()
            for t in ("customer", "terminal")
            if (kd := getattr(fs, f"{t}_dir")) is not None}


def _sx_shard_reads(reg, n_dev: int) -> np.ndarray:
    """[n, 2] (dense, cms) reads so far from the shard-labelled series."""
    return np.array([[reg.get("rtfds_feature_tier_rows_total", tier=t,
                              shard=str(s)).value for t in ("dense", "cms")]
                     for s in range(n_dev)])


def _sx_shard_hits(reg, n_dev: int, before=None) -> dict:
    """Per-shard dense hit rate from the shard-labelled tier series
    (since ``before``, a ``_sx_shard_reads``)."""
    reads = _sx_shard_reads(reg, n_dev)
    if before is not None:
        reads = reads - before
    return {str(s): float(d / (d + c)) if d + c else 1.0
            for s, (d, c) in enumerate(reads)}


def _sx_shard_series(reg, name: str, table: str, n_dev: int) -> list:
    return [reg.get(name, table=table, shard=str(s)).value
            for s in range(n_dev)]


def _sx_free(fs) -> list:
    """Every shard's free-stack height, per table with a directory."""
    return [int(v) for t in ("customer", "terminal")
            if (kd := getattr(fs, f"{t}_dir")) is not None
            for v in kd.free_top.cpu().tolist()]


def _sx_missed(eng, batches, n_dev: int):
    """The rows of ``batches`` whose customer or terminal key holds no
    entry in its shard's directory at the end of the run (a probe
    overflow: without compaction an admitted key stays): (row mask, the
    keys, the (row × table) reads they served from the sketch)."""
    from real_time_fraud_detection_system_tpu_torch.core.batch import (
        fold_key,
    )
    from real_time_fraud_detection_system_tpu_torch.ops.keydir import (
        lookup_slots_stacked,
    )

    fs = eng.state.feature_state
    miss = 0
    reads = 0
    keys = 0
    for table, col in (("customer", "customer_id"),
                       ("terminal", "terminal_id")):
        folded = fold_key(np.concatenate([b[col] for b in batches]))
        uniq, inv = np.unique(folded, return_inverse=True)
        owner = torch.from_numpy(uniq.astype(np.int64) % n_dev)
        dev = fs.terminal.count.device
        _, hit = lookup_slots_stacked(
            getattr(fs, f"{table}_dir"), owner.to(dev),
            torch.from_numpy(uniq).to(dev),
            torch.ones(len(uniq), dtype=torch.bool, device=dev))
        lost = ~hit.cpu().numpy()
        keys += int(lost.sum())
        reads += int(lost[inv].sum())
        miss = miss | lost[inv]
    return np.asarray(miss, dtype=bool), keys, reads


def _sx_same_admitted(got: "_Results", want: "_Results", miss, what: str,
                      atol: float = ATOL_SHARDED) -> float:
    """``_same_rows`` on the rows ``miss`` leaves out; → max |Δp|."""
    keep = ~miss
    check(np.array_equal(got.feats()[keep], want.feats()[keep]),
          f"{what}: features differ")
    err = float(np.abs(got.probs()[keep] - want.probs()[keep]).max())
    check(err <= atol, f"{what}: probabilities differ by {err}")
    return err


def phase_sharded_exact(dev, device_info, data: dict) -> dict:
    """The tiered store across shards on the card; see the module
    docstring, phase 17."""
    from real_time_fraud_detection_system_tpu_torch.core.batch import (
        US_PER_DAY,
    )
    from real_time_fraud_detection_system_tpu_torch.data.generator import (
        ZipfKeySampler,
    )
    from real_time_fraud_detection_system_tpu_torch.features.online import (
        state_bytes,
    )
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        Checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
    from real_time_fraud_detection_system_tpu_torch.ops import (
        forest_kernels,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime import (
        engine as engine_mod,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )

    t_phase = time.perf_counter()
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    totals = {name: 0 for name in KERNELS}
    base = data["cfg"]
    cfg = dataclasses.replace(base, runtime=dataclasses.replace(
        base.runtime, z_mode="int8"))
    ecfg = dataclasses.replace(cfg, features=dataclasses.replace(
        cfg.features, key_mode="exact"))
    model, cpu_model = data["models"]["forest"][:2]

    def engine(c, n_dev=0, dev_=dev, **kw):
        m = model if dev_ == dev else cpu_model
        if n_dev:
            return ShardedScoringEngine(c, "forest", m.params, m.scaler,
                                        n_devices=n_dev, device=dev_, **kw)
        return ScoringEngine(c, "forest", m.params, m.scaler, device=dev_,
                             **kw)

    def serve(eng, bs, what, own="leaf_sum", sink=None):
        """Serve ``bs`` with the counts zeroed just before: ``own`` once
        per chunk (once per batch on a single engine), the others
        never."""
        sink = _Results() if sink is None else sink
        stats, launches = drive(lambda: eng.run(_ListSource(bs), sink))
        steps = stats.get("chunks", stats["batches"])
        for name, n in launches.items():
            want = steps if name == own else 0
            check(n == want, f"sharded_exact {what}: {n} launches of "
                             f"{name} for {steps} steps (want {want})")
            totals[name] += n
        check(stats["rows"] == sum(len(b["tx_id"]) for b in bs),
              f"sharded_exact {what}: not every row was scored")
        return stats, sink

    def run_line(stats) -> dict:
        return {k: stats[k] for k in (
            "rows", "batches", "rows_per_s", "latency_p50_ms",
            "latency_p99_ms", "stage_ms_p50", "wall_s")} | {
            k: stats[k] for k in ("chunks", "full_exchange_chunks")
            if k in stats}

    # (a) the default dataset: every key fits its shard's hot tier ---------
    batches = _unlabeled(_column_batches(data["txs_whole_dollars"],
                                         SHARDED_BATCHES))
    _, direct = serve(engine(cfg), batches, "direct",
                      "fused_forest_leaf_sum")
    reg = MetricsRegistry()
    s_stats, single = serve(engine(ecfg, metrics=reg), batches,
                            "single exact")
    check(reg.get("rtfds_feature_tier_rows_total", tier="cms").value == 0,
          "sharded_exact (a): the single exact engine read the sketch")
    parity = {"single": run_line(s_stats),
              "single_max_abs_err_vs_direct": _same_rows(
                  single, direct, "single exact against direct")}
    for n_dev in SX_WIDTHS:
        reg = MetricsRegistry()
        eng = engine(ecfg, n_dev, metrics=reg)
        check(eng.leaf_tables is not None and eng.tables is None,
              f"sharded_exact (a) {n_dev}: not on the leaf-sum path")
        stats, res = serve(eng, batches, f"(a) {n_dev} shards")
        dense = reg.get("rtfds_feature_tier_rows_total", tier="dense").value
        cms = reg.get("rtfds_feature_tier_rows_total", tier="cms").value
        # Every shard's slots hold its keys, but a key whose 8 probes
        # all meet occupied entries of its shard's directory misses
        # admission (the reference's bound, identical there) and reads
        # the sketch: those rows aside, bit for bit.
        miss, n_miss_keys, misses = _sx_missed(eng, batches, n_dev)
        check(dense + cms == 2 * stats["rows"] and cms == misses,
              f"sharded_exact (a) {n_dev}: {dense} dense and {cms} sketch "
              f"reads for {stats['rows']} rows, {misses} rows' keys "
              f"not admitted")
        check(all(t > 0 for t in _sx_free(eng.state.feature_state)),
              f"sharded_exact (a) {n_dev}: a shard's free stack ran dry")
        parity[str(n_dev)] = {
            **run_line(stats),
            "probe_overflow_keys": n_miss_keys,
            "probe_overflow_rows": int(miss.sum()),
            "max_abs_err_vs_single_exact": _sx_same_admitted(
                res, single, miss, f"{n_dev} shards against single exact"),
            "max_abs_err_vs_direct": _sx_same_admitted(
                res, direct, miss, f"{n_dev} shards against direct"),
            "occupancy_per_shard": _sx_occupancy(eng.state.feature_state)}
        if n_miss_keys:
            # the rows that read the sketch: held against the same
            # shards on the CPU (directories bit for bit)
            wsink = MemorySink()
            card2 = engine(ecfg, n_dev)
            serve(card2, batches[:2], f"(a) {n_dev} shards, 2 batches",
                  sink=wsink)
            parity[str(n_dev)]["max_abs_err_vs_cpu_engine"] = (
                _vs_cpu_engine(ecfg, "forest", data, batches[:2], wsink,
                               card2.state.feature_state,
                               f"(a) {n_dev} shards", n_dev))
    emit({"phase": "sharded_exact", "part": "a_parity", "kind": "forest",
          "z_mode": "int8", "rows_per_batch": BATCH_ROWS, **parity, **card})
    del direct

    # (b) the JAX bench's sharded deployment over three universes ----------
    bcfg = _bench_cfg(cfg, cms_width=1 << 14, compact_every=2,
                      state_hbm_budget_mb=0.0)
    bcfg = dataclasses.replace(bcfg, runtime=dataclasses.replace(
        bcfg.runtime, batch_buckets=(SX_BENCH_ROWS,),
        max_batch_rows=SX_BENCH_ROWS))
    bench = {}
    samplers = {}
    for n_keys in EXACT_UNIVERSES:
        sampler = samplers[n_keys] = ZipfKeySampler(n_keys, ZIPF_SKEW)
        warm = _zipf_batches(sampler, SX_BENCH_WARM, day_every=1, seed=7,
                             rows=SX_BENCH_ROWS)
        main = _zipf_batches(sampler, SX_BENCH_BATCHES,
                             day_every=SX_BENCH_DAY_EVERY, seed=2,
                             rows=SX_BENCH_ROWS)
        cell = {}
        for n_dev in (0,) + SX_BENCH_SHARDS:
            reg = MetricsRegistry()
            torch.cuda.reset_peak_memory_stats()
            eng = engine(bcfg, n_dev, metrics=reg)
            what = f"(b) {n_dev or 1} shard(s), {n_keys} keys"
            man = eng.precompile()
            wsink = MemorySink()
            serve(eng, warm, what, sink=wsink)
            # the single engine's twin is exact_path (b)'s
            err = (_vs_cpu_engine(bcfg, "forest", data, warm, wsink,
                                  eng.state.feature_state, what, n_dev)
                   if n_dev else "see exact_path (b)")
            tsink = _TierSink(reg)
            before = _sx_shard_reads(reg, n_dev) if n_dev else None
            stats, _ = serve(eng, main, what, sink=tsink)
            for rows, dense, cms in tsink.per_batch:
                check(dense + cms == 2 * rows,
                      f"{what}: {dense} dense + {cms} sketch reads for "
                      f"{rows} rows")
            d = sum(x[1] for x in tsink.per_batch)
            c = sum(x[2] for x in tsink.per_batch)
            line = {**run_line(stats), "graphs": man["graphs"],
                    "dense_hit_rate": d / (d + c),
                    "occupancy": _sx_occupancy(eng.state.feature_state),
                    "state_bytes": state_bytes(bcfg.features,
                                               n_shards=max(n_dev, 1)),
                    "max_memory_allocated":
                        torch.cuda.max_memory_allocated(),
                    "max_abs_err_vs_cpu_engine": err}
            if n_dev:
                # both step variants and the compaction
                check(man["graphs"] == 3,
                      f"{what}: {man['graphs']} graphs captured")
                line["dense_hit_rate_per_shard"] = _sx_shard_hits(
                    reg, n_dev, before)
                line["slots_reclaimed_per_shard"] = {
                    t: _sx_shard_series(
                        reg, "rtfds_feature_slots_reclaimed_total", t,
                        n_dev) for t in ("customer", "terminal")}
            cell[str(n_dev or 1)] = line
            del eng
        bench[str(n_keys)] = cell
    emit({"phase": "sharded_exact", "part": "b_bench_deployment",
          "kind": "forest", "skew": ZIPF_SKEW, "rows_per_batch":
          SX_BENCH_ROWS, "capacity": bcfg.features.customer_capacity,
          "cms_width": bcfg.features.cms_width, "compact_every": 2,
          "by_universe": bench, **card})
    torch.cuda.empty_cache()

    # (c) the 10M universe on 2^22 slots per table at 4 shards -------------
    big = EXACT_BIG_CAPACITY
    ccfg = _bench_cfg(cfg, customer_capacity=big, terminal_capacity=big,
                      cms_width=1 << 14, compact_every=2,
                      state_hbm_budget_mb=0.0)
    sampler = samplers[EXACT_UNIVERSES[-1]]  # the 10M universe
    bs = (_zipf_batches(sampler, EXACT_WARM, day_every=1, seed=7)
          + _zipf_batches(sampler, SX_BIG_BATCHES, day_every=2, seed=2))
    reg = MetricsRegistry()
    torch.cuda.reset_peak_memory_stats()
    eng = engine(ccfg, 4, metrics=reg)
    eng.precompile()
    tsink = _TierSink(reg)
    stats, _ = serve(eng, bs, "(c) 10M keys on 2^22 slots", sink=tsink)
    d = sum(x[1] for x in tsink.per_batch)
    c = sum(x[2] for x in tsink.per_batch)
    emit({"phase": "sharded_exact", "part": "c_10m_issuer", "shards": 4,
          "n_keys": sampler.n_keys, "capacity": big, **run_line(stats),
          "dense_hit_rate": d / (d + c),
          "dense_hit_rate_per_shard": _sx_shard_hits(reg, 4),
          "occupancy": _sx_occupancy(eng.state.feature_state),
          "state_bytes": state_bytes(ccfg.features, n_shards=4),
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          **card})
    del eng
    torch.cuda.empty_cache()

    # (d) the 100M universe with the host cold tier at 4 shards ------------
    sampler = ZipfKeySampler(EXACT_COLD_UNIVERSE, ZIPF_SKEW)
    warm = _zipf_batches(sampler, EXACT_WARM, day_every=1, seed=7)
    main = _zipf_batches(sampler, SX_COLD_BATCHES, day_every=2, seed=2)
    with tempfile.TemporaryDirectory() as tmp:
        dcfg = _bench_cfg(cfg, cms_width=1 << 14, compact_every=2,
                          state_hbm_budget_mb=0.0,
                          cold_store=f"{tmp}/cold", cold_demote_slots=1024,
                          cold_promote_queue=256)
        reg = MetricsRegistry()
        eng = engine(dcfg, 4, metrics=reg)
        man = eng.precompile()
        check(man["graphs"] == 4,
              f"sharded_exact (d): {man['graphs']} graphs captured")
        # per shard (key % 4): the demoted lanes of each compaction's
        # stacked payload, and the keys each promotion landed
        demoted = np.zeros(4, np.int64)
        promoted = np.zeros(4, np.int64)
        append, mark = eng._append_demotions, eng._cold.mark_promoted

        def count_demotions(payload, _append=append):
            for pay in payload.values():
                if pay is not None:
                    keys = pay[0].cpu().view(torch.int32)
                    demoted[:] += (keys != -1).sum(dim=1).numpy()
            return _append(payload)

        def count_promotions(table, keys, _mark=mark):
            np.add.at(promoted, np.asarray(keys, np.int64) % 4, 1)
            return _mark(table, keys)

        eng._append_demotions = count_demotions
        eng._cold.mark_promoted = count_promotions
        serve(eng, warm, "(d) warm")
        stats, _ = serve(eng, main, "(d) 100M keys with the cold tier")
        check(eng.drain_promotions(timeout_s=60.0),
              "sharded_exact (d): promotions did not drain")
        counts = {n: reg.get(n).value for n in (
            "rtfds_feature_cold_demotions_total", "rtfds_feature_cold_keys",
            "rtfds_feature_cold_promotions_total")}
        check(all(v > 0 for v in counts.values())
              and (demoted > 0).all() and (promoted > 0).all(),
              f"sharded_exact (d): cold counters {counts}, demoted per "
              f"shard {demoted.tolist()}, promoted {promoted.tolist()}")
        per_shard_prom = promoted.tolist()
        eng._cold.flush()
        eng.state.cold_lineage = eng._cold.lineage()
        ck = Checkpointer(f"{tmp}/ck")
        t0 = time.perf_counter()
        ck.save(eng.checkpoint_state())
        save_ms = (time.perf_counter() - t0) * 1e3
        fresh = engine(dcfg, 4)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(ck.restore(fresh.state) is not None,
              "sharded_exact (d): no checkpoint restored")
        fresh._sync_cold_after_restore()
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        check(fresh.state.cold_lineage == eng.state.cold_lineage,
              "sharded_exact (d): the restored cold lineage differs")
        for k, v in _dir_leaves(eng.state.feature_state).items():
            check(torch.equal(_dir_leaves(fresh.state.feature_state)[k], v),
                  f"sharded_exact (d): restored directory leaf {k} differs")
        emit({"phase": "sharded_exact", "part": "d_cold_tier", "shards": 4,
              "n_keys": EXACT_COLD_UNIVERSE, **run_line(stats), **counts,
              "demoted_per_shard": demoted.tolist(),
              "promoted_per_shard": per_shard_prom,
              "exactness_degraded_keys": stats["exactness_degraded_keys"],
              "cold_segments": len(eng.state.cold_lineage["segments"]),
              "checkpoint_save_ms": save_ms, "restore_ms": restore_ms,
              **card})
        eng.fence_cold()
        fresh.fence_cold()
        del eng, fresh

    # (e) labels at 5% through apply_state_feedback, against the CPU ------
    sampler = samplers[1 << 20]
    bs = _zipf_batches(sampler, SX_LABEL_BATCHES, day_every=1, seed=11,
                       rows=SX_BENCH_ROWS)
    rng = np.random.default_rng(13)
    labels = []
    for b in bs:
        pick = rng.random(len(b["tx_id"])) < SX_LABEL_SHARE
        labels.append((b["terminal_id"][pick],
                       (b["tx_datetime_us"][pick] // US_PER_DAY)
                       .astype(np.int32),
                       rng.integers(0, 2, int(pick.sum())).astype(np.int32)))
    outs = []
    for where in (dev, torch.device("cpu")):
        eng = engine(bcfg, 4, dev_=where)
        res = _Results()
        t_fb = []
        for b, lab in zip(bs, labels):
            if where == dev:
                serve(eng, [b], "(e) labels", sink=res)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.apply_state_feedback(*lab)
                torch.cuda.synchronize()
                t_fb.append((time.perf_counter() - t0) * 1e3)
            else:
                eng.run(_ListSource([b]), res)
                eng.apply_state_feedback(*lab)
        outs.append((eng, res, t_fb))
    (ge, g_res, t_fb), (ce, c_res, _) = outs
    check(np.array_equal(g_res.feats()[:, [0, 1, 2, 3, 5, 7] + list(
        range(9, 15))], c_res.feats()[:, [0, 1, 2, 3, 5, 7] + list(
            range(9, 15))]), "sharded_exact (e): features differ from CPU")
    np.testing.assert_allclose(g_res.feats(), c_res.feats(),
                               rtol=RTOL_FEATURE)
    fb_err = float(np.abs(g_res.probs() - c_res.probs()).max())
    check(fb_err <= ATOL_LEAF / 100,
          f"sharded_exact (e): probabilities differ by {fb_err}")
    gfs, cfs = ge.state.feature_state, ce.state.feature_state
    for k, v in _dir_leaves(cfs).items():
        check(torch.equal(_dir_leaves(gfs)[k], v),
              f"sharded_exact (e): directory leaf {k} differs from CPU")
    for name, a, b in (("terminal.fraud", gfs.terminal.fraud,
                        cfs.terminal.fraud),
                       ("terminal_cms.fraud", gfs.terminal_cms.fraud,
                        cfs.terminal_cms.fraud)):
        check(torch.equal(a.cpu(), b),
              f"sharded_exact (e): {name} differs from the CPU engine")
    dense_frd = float(gfs.terminal.fraud.sum())
    sketch_frd = float(gfs.terminal_cms.fraud.sum())
    check(dense_frd > 0 and sketch_frd > 0,
          f"sharded_exact (e): labels reached dense {dense_frd}, sketch "
          f"{sketch_frd}")
    emit({"phase": "sharded_exact", "part": "e_labels", "shards": 4,
          "n_keys": 1 << 20, "label_share": SX_LABEL_SHARE,
          "labels": int(sum(len(x[2]) for x in labels)),
          "apply_state_feedback_ms": t_fb,
          "max_abs_err_vs_cpu_engine": fb_err,
          "dense_fraud_sum": dense_frd, "sketch_fraud_sum": sketch_frd,
          **card})
    del outs, ge, ce

    # (f) a checkpoint at 4 shards restored at 8 and at 1 ---------------
    first, rest = batches[:SHARDED_SPLIT], batches[SHARDED_SPLIT:]
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        ck = Checkpointer(tmp)
        four = engine(ecfg, 4)
        serve(four, first, "(f) before the checkpoint")
        t0 = time.perf_counter()
        ck.save(four.state)
        save_ms = (time.perf_counter() - t0) * 1e3
        for n_dev in (8, 0):
            refused = None
            for probes in (ecfg.features.keydir_probes, 16):
                # a key that cannot place within the probe depth of its
                # new shard's rebuilt directory is refused, naming the
                # fix (more probes); the leg then takes it
                pcfg = dataclasses.replace(ecfg, features=dataclasses.replace(
                    ecfg.features, keydir_probes=probes))
                eng = engine(pcfg, n_dev)
                t0 = time.perf_counter()
                check(ck.restore(eng.state) is not None,
                      "sharded_exact (f): no checkpoint")
                check(eng.state.layout_devices == 4,
                      f"sharded_exact (f): restored layout "
                      f"{eng.state.layout_devices}")
                try:
                    eng._ensure_layout()
                except ValueError as e:
                    check(refused is None and "keydir_probes" in str(e),
                          f"sharded_exact (f): {e}")
                    refused = str(e)
                    continue
                break
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check(eng.state.layout_devices == (n_dev or 1),
                  "sharded_exact (f): the restore was not converted")
            _, res = serve(eng, rest, f"(f) restored at {n_dev or 1}")
            legs[str(n_dev or 1)] = {
                "restore_and_convert_ms": ms, "keydir_probes": probes,
                "refused_at_default_probes": refused,
                "max_abs_err_vs_single": _same_rows(
                    res, _sliced(single, SHARDED_SPLIT),
                    f"(f) restored at {n_dev or 1}")}
    emit({"phase": "sharded_exact", "part": "f_cross_width", "saved_at": 4,
          "save_ms": save_ms, "restored": legs, **card})

    # (g) the leaf sum on the exact chunk; the idle share ------------------
    seen = []
    proba = engine_mod.leaf_sum_proba
    leaf_sum = forest_kernels.leaf_sum

    def spy(tables, x, base=None):
        seen.append((tables, x))
        return proba(tables, x, base)

    eng = engine(ecfg, 4)
    engine_mod.leaf_sum_proba = spy
    try:
        eng.process_batch(dict(batches[0]))
    finally:
        engine_mod.leaf_sum_proba = proba
    check(len(seen) == 1, f"{len(seen)} leaf-sum calls for one chunk")
    tables, x = seen[0]
    chunk = 4 * eng.rows_per_shard
    check(tuple(x.shape) == (chunk, 15), f"leaf sum over {tuple(x.shape)}")
    got = leaf_sum(tables, x)
    want = forest_kernels.leaf_sum_plain(tables, x)
    err = float((got - want).abs().max())
    check(err <= ATOL_LEAF, f"sharded_exact leaf sum differs by {err}")
    walk = _walk_ops(tables, x, tables.n_trees)
    leaf = {"rows": chunk, "max_abs_err": err,
            "bit_equal": bool(torch.equal(got, want)),
            **_time(lambda: leaf_sum(tables, x),
                    lambda: forest_kernels.leaf_sum_plain(tables, x),
                    _bound([x], [got], walk["ops"], _tree_bytes(tables)))}
    profiles = {}
    for n_keys, n_dev in ((1 << 20, 4), (1 << 20, 0)):
        pbs = _zipf_batches(samplers[n_keys], PROFILE_BATCHES + 1,
                            day_every=SX_BENCH_DAY_EVERY, seed=5,
                            rows=SX_BENCH_ROWS)
        eng = engine(bcfg, n_dev, metrics=MetricsRegistry())
        eng.precompile()
        device, wall_ms, _, _, pstats = _profiled(eng, _ListSource(pbs),
                                                  PROFILE_BATCHES)
        busy = sum(device.values())
        profiles[str(n_dev or 1)] = {
            "n_keys": n_keys,
            "wall_ms_per_batch": wall_ms / PROFILE_BATCHES,
            "dispatch_p50_ms": pstats["dispatch_p50_ms"],
            "device_busy_ms_per_batch": busy / PROFILE_BATCHES
            if device else "not measured",
            "device_idle_share": 1.0 - busy / wall_ms if device
            else "not measured",
            "leaf_sum_ms_per_batch": sum(
                v for k, v in device.items() if "leaf_sum_kernel" in k)
            / PROFILE_BATCHES if device else "not measured",
            "top_device_ms_per_batch": {
                k[:80]: v / PROFILE_BATCHES for k, v in sorted(
                    device.items(), key=lambda kv: -kv[1])[:6]}}
    emit({"phase": "sharded_exact", "part": "g_leaf_sum_and_profile",
          "leaf_sum": leaf, "profile": profiles, **card})
    emit({"phase": "sharded_exact", "part": "done",
          "kernel_launches": totals,
          "phase_s": time.perf_counter() - t_phase, **card})
    return totals


# -- phase fleet ---------------------------------------------------------------

FLEET_BATCHES = 12
FLEET_PROCS = 2
FLEET_LOCAL = 2  # shards per process: the fleet's 4 global shards
# the paced runs' sink sleep (a drain must find them mid-stream), and the
# batches each process sinks before the smoke drains it
FLEET_SINK_SLEEP_S = 0.4
FLEET_DRAIN_AFTER = 3
FLEET_SPAWN_TIMEOUT_S = 240
FLEET_COMPACT_EVERY = 4  # (d): the cold tier demotes at compaction passes
PKG_CLI = f"{PKG}.cli"
LAUNCHER = f"{PKG}.tools.multihost_launcher"
# Put on the workers' path: swaps the Parquet sink (no pyarrow on the card
# machine) for one .npz per batch, times the rendezvous, and writes the
# kernels' launch counts (after precompile and at exit) with those
# timings to FLEET_PROBE_DIR/probe-<pid>.json.
FLEET_PROBE = r"""
import atexit, importlib.util, json, os, sys, time

_PKG = "real_time_fraud_detection_system_tpu_torch"
_DIR = os.environ.get("FLEET_PROBE_DIR")
_SLEEP = float(os.environ.get("FLEET_SINK_SLEEP_S") or 0.0)
_REC = {"t_start": time.time(), "pid": os.getpid()}


def _counts():
    from real_time_fraud_detection_system_tpu_torch.ops import (
        forest_kernels, score_kernels)
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {"fused_forest_leaf_sum": forest_kernels.fused_forest_leaf_sum.launches,
            "leaf_sum": forest_kernels.leaf_sum.launches,
            "fused_featurize_score": score_kernels.fused_featurize_score.launches}


class _NpzSink:
    def __init__(self, path):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def append(self, res):
        import numpy as np
        _REC.setdefault("t_first_batch", time.time())
        name = os.path.join(self.path, "b-%08d.npz" % res.batch_index)
        with open(name + ".tmp", "wb") as f:
            np.savez(f, tx_id=res.tx_id, probs=res.probs,
                     features=res.features)
        os.replace(name + ".tmp", name)
        if _SLEEP:
            time.sleep(_SLEEP)

    def truncate_after(self, batch_index):
        for n in os.listdir(self.path):
            if n.startswith("b-") and int(n[2:10]) > batch_index:
                os.remove(os.path.join(self.path, n))


def _timed(mod, attr, key):
    orig = getattr(mod, attr)

    def run(*a, **k):
        t0 = time.perf_counter()
        out = orig(*a, **k)
        _REC[key] = (time.perf_counter() - t0) * 1e3
        return out

    setattr(mod, attr, run)


def _patch(name, mod):
    if name == _PKG + ".io.sink":
        mod.make_parquet_sink = lambda path: _NpzSink(path)
    elif name == _PKG + ".parallel.distributed":
        _timed(mod, "initialize_distributed", "barrier_ms")
    elif name == _PKG + ".runtime.engine":
        orig = mod.ScoringEngine.precompile

        def precompile(self, *a, **k):
            out = orig(self, *a, **k)
            _REC["launches_after_precompile"] = _counts()
            return out

        mod.ScoringEngine.precompile = precompile


_SEEN = set()


class _Finder:
    def find_spec(self, name, path=None, target=None):
        if not name.startswith(_PKG + ".") or name in _SEEN:
            return None
        _SEEN.add(name)
        spec = importlib.util.find_spec(name)
        if spec is not None and spec.loader is not None:
            run = spec.loader.exec_module

            def exec_module(module, _run=run, _name=name):
                _run(module)
                _patch(_name, module)

            spec.loader.exec_module = exec_module
        return spec


def _dump():
    # a score worker (the launcher imports no engine)
    if _DIR and _PKG + ".runtime.engine" in sys.modules:
        _REC["argv"] = list(sys.argv)
        _REC["launches"] = _counts()
        with open(os.path.join(_DIR, "probe-%d.json" % os.getpid()),
                  "w") as f:
            json.dump(_REC, f)


if _DIR:
    sys.meta_path.insert(0, _Finder())
    atexit.register(_dump)
"""


def _fleet_table(txs):
    """The first FLEET_BATCHES batches of the whole-dollar table, terminals
    remapped so ``terminal % 4 == customer % 4`` (every key's history in
    one residue block: the fleet's exactness contract)."""
    n = FLEET_BATCHES * BATCH_ROWS
    sub = txs.slice(slice(0, n))
    k = FLEET_PROCS * FLEET_LOCAL
    sub.terminal_id = (sub.terminal_id // k) * k + sub.customer_id % k
    return sub


def _fleet_env(probe_dir: str, sleep: float = 0.0) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{probe_dir}:{ROOT}:" + env.get("PYTHONPATH", "")
    env["FLEET_PROBE_DIR"] = probe_dir
    env["FLEET_SINK_SLEEP_S"] = str(sleep)
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _npz_rows(root) -> dict:
    """tx_id → (prob, features) over every worker's batches under
    ``root``; each directory's batch lineage without gaps or
    duplicates."""
    rows = {}
    dirs = sorted({p.parent for p in Path(root).rglob("b-*.npz")})
    check(bool(dirs), f"no batches under {root}")
    for d in dirs:
        names = sorted(d.glob("b-*.npz"))
        idx = [int(p.name[2:10]) for p in names]
        check(idx == list(range(1, len(idx) + 1)),
              f"{d}: batch lineage {idx}")
        for p in names:
            with np.load(p) as z:
                for tx, pr, f in zip(z["tx_id"].tolist(), z["probs"],
                                     z["features"]):
                    check(tx not in rows, f"tx {tx} scored twice ({d})")
                    rows[tx] = (pr, f)
    return rows


def _same_as_control(rows: dict, control: dict, what: str) -> int:
    """Every row equal to the control's (features bit for bit, the
    probability's bits); → rows compared."""
    check(set(rows) == set(control),
          f"{what}: {len(rows)} rows against the stream's {len(control)}")
    for tx, (p, f) in rows.items():
        cp, cf = control[tx]
        if p != cp or not np.array_equal(f, cf):
            check(False, f"{what}: tx {tx} differs from the control")
    return len(rows)


def _probes(probe_dir: str) -> list:
    out = []
    for p in sorted(Path(probe_dir).glob("probe-*.json")):
        rec = json.loads(p.read_text())
        argv = rec["argv"]
        rec["process_id"] = int(argv[argv.index("--process-id") + 1]) \
            if "--process-id" in argv else 0
        out.append(rec)
    return out


def _stats_line(log: str) -> dict:
    lines = [ln for ln in Path(log).read_text().splitlines()
             if ln.startswith("{") and ln.endswith("}")]
    check(bool(lines), f"no stats line in {log}")
    return json.loads(lines[-1])


def _merge_ms(log) -> float:
    """The resize merge's milliseconds, from its worker's log line."""
    import re

    for ln in Path(log).read_text().splitlines():
        m = re.search(r"resume-merge: adopted .* in ([0-9.]+) ms", ln)
        if m:
            return float(m.group(1))
    check(False, f"no resume-merge line in {log}")


def _path_launches(probe: dict) -> dict:
    """A worker's launches while serving: at exit less those through its
    precompile (the capture's warmup)."""
    base = probe.get("launches_after_precompile") or {}
    return {k: v - base.get(k, 0) for k, v in probe["launches"].items()}


def _worker(args: list, env: dict, log: str):
    f = open(log, "w")
    try:
        return subprocess.Popen([sys.executable, "-m", PKG_CLI, *args],
                                stdout=f, stderr=subprocess.STDOUT,
                                env=env, cwd=str(ROOT))
    finally:
        f.close()


def _drained_fleet(tmp: Path, name: str, common: list, extra: list,
                   env: dict) -> dict:
    """Two coordinated workers with ``--drain-on-sigterm``, paced by the
    probe's sink sleep; once each has sunk FLEET_DRAIN_AFTER batches both
    get SIGTERM. → the drain's timings and the workers' stats."""
    import signal

    port = _free_port()
    procs, logs = [], []
    for pid in range(FLEET_PROCS):
        logs.append(str(tmp / f"{name}-{pid}.log"))
        procs.append(_worker(
            ["score", *common, "--devices", str(FLEET_LOCAL),
             "--num-processes", str(FLEET_PROCS), "--process-id", str(pid),
             "--coordinator", f"127.0.0.1:{port}", "--drain-on-sigterm",
             "--out", str(tmp / name / "out"),
             "--checkpoint-dir", str(tmp / name / "ck"), *extra],
            env, logs[-1]))
    deadline = time.time() + FLEET_SPAWN_TIMEOUT_S
    out = tmp / name / "out"
    while time.time() < deadline:
        done = [len(list((out / f"proc-{p:02d}").glob("b-*.npz")))
                if (out / f"proc-{p:02d}").is_dir() else 0
                for p in range(FLEET_PROCS)]
        if min(done) >= FLEET_DRAIN_AFTER or any(
                pr.poll() is not None for pr in procs):
            break
        time.sleep(0.05)
    t_term = time.time()
    for pr in procs:
        if pr.poll() is None:
            pr.send_signal(signal.SIGTERM)
    for pr in procs:
        pr.wait(timeout=FLEET_SPAWN_TIMEOUT_S)
    t_exit = time.time()
    for pr, log in zip(procs, logs):
        check(pr.returncode == 0,
              f"{name}: worker exited {pr.returncode}: "
              f"{Path(log).read_text()[-1500:]}")
    stats = [_stats_line(log) for log in logs]
    check(all("drained_at_batch" in st for st in stats),
          f"{name}: a worker finished before the drain reached it")
    last_ck = max(os.path.getmtime(p) for p in
                  (tmp / name / "ck").rglob("ckpt-*.npz"))
    return {"stats": stats,
            "drain_to_final_checkpoint_ms": (last_ck - t_term) * 1e3,
            "drain_to_exit_ms": (t_exit - t_term) * 1e3}


def phase_fleet(dev, device_info, data: dict) -> dict:
    """The fleet of processes on the card: see the module docstring,
    phase 18."""
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        save_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        make_checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.ops import (
        forest_kernels,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime import (
        engine as engine_mod,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.distributed \
        import ProcessTopology
    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        PartitionAffineSource,
    )

    t_phase = time.perf_counter()
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    totals = {name: 0 for name in KERNELS}
    base = data["cfg"]
    cfg = dataclasses.replace(base, runtime=dataclasses.replace(
        base.runtime, z_mode="int8"))
    model = data["models"]["forest"][0]
    table = _fleet_table(data["txs_whole_dollars"])
    batches = _unlabeled(_column_batches(table, FLEET_BATCHES, BATCH_ROWS))

    def engine(n_dev, topo=None, c=cfg):
        return ShardedScoringEngine(c, "forest", model.params, model.scaler,
                                    n_devices=n_dev, device=dev,
                                    topology=topo)

    def serve(eng, src, what):
        res = _Results()
        stats, launches = drive(lambda: eng.run(src, res))
        check(launches["leaf_sum"] == stats["chunks"]
              and launches["fused_forest_leaf_sum"] == 0
              and launches["fused_featurize_score"] == 0,
              f"fleet {what}: {launches} for {stats['chunks']} chunks")
        for k, n in launches.items():
            totals[k] += n
        rows = {}
        for r in res.batches:
            rows.update(zip(r.tx_id.tolist(), zip(r.probs, r.features)))
        return stats, rows

    def rate(st) -> dict:
        return {k: st[k] for k in ("rows", "batches", "chunks", "wall_s",
                                   "rows_per_s", "latency_p50_ms",
                                   "stage_ms_p50") if k in st}

    # (a) in process: two engines of the fleet against one of 4 shards ----
    c_stats, control = serve(engine(FLEET_PROCS * FLEET_LOCAL),
                             _ListSource(batches), "control 4 shards")
    xcfg = dataclasses.replace(cfg, features=dataclasses.replace(
        cfg.features, key_mode="exact", compact_every=FLEET_COMPACT_EVERY))
    _, control_exact = serve(engine(FLEET_PROCS * FLEET_LOCAL, c=xcfg),
                             _ListSource(batches), "control exact")
    per = {}
    for pid in range(FLEET_PROCS):
        topo = ProcessTopology(FLEET_PROCS, pid, FLEET_LOCAL)
        eng = engine(FLEET_LOCAL, topo)
        # strict affinity: the engine refuses any row of another block
        st, rows = serve(eng, PartitionAffineSource(_ListSource(batches),
                                                    topo), f"process {pid}")
        for tx, (p, f) in rows.items():
            cp, cf = control[tx]
            if p != cp or not np.array_equal(f, cf):
                check(False, f"process {pid}: tx {tx} differs from the "
                             "single-process engine")
        per[pid] = {**rate(st), "labels": [
            g.labels for g in eng._m_shard_rows]}
    check(sum(v["rows"] for v in per.values()) == len(control),
          "the in-process fleet did not cover the stream")
    # the leaf-sum launch inside a fleet process's step, against its plain
    # version on that chunk
    seen = []
    proba = engine_mod.leaf_sum_proba

    def spy(tables, x, base_=None):
        seen.append((tables, x))
        return proba(tables, x, base_)

    topo0 = ProcessTopology(FLEET_PROCS, 0, FLEET_LOCAL)
    eng = engine(FLEET_LOCAL, topo0)
    engine_mod.leaf_sum_proba = spy
    try:
        eng.process_batch({k: v[topo0.owns(batches[0]["customer_id"])]
                           for k, v in batches[0].items()})
    finally:
        engine_mod.leaf_sum_proba = proba
    check(len(seen) == 1, f"{len(seen)} leaf-sum calls for one chunk")
    tables, x = seen[0]
    got = forest_kernels.leaf_sum(tables, x)
    want = forest_kernels.leaf_sum_plain(tables, x)
    check(torch.equal(got, want), "the fleet chunk's leaf sum differs")
    emit({"phase": "fleet", "part": "a_in_process", "kind": "forest",
          "z_mode": eng.z_mode, "rows": len(control),
          "processes": per, "control_4_shards": rate(c_stats),
          "leaf_sum_chunk_rows": int(x.shape[0]),
          "leaf_sum_bit_equal": True, **card})

    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        probe = tmp / "probe"
        probe.mkdir()
        (probe / "sitecustomize.py").write_text(FLEET_PROBE)
        data_path, model_path = str(tmp / "txs.npz"), str(tmp / "m.npz")
        save_transactions(data_path, table)
        with open(model_path, "wb") as f:
            f.write(data["models"]["forest"][2])
        # the workers serve on the phase's device (the card)
        common = ["--data", data_path, "--model-file", model_path,
                  "--batch-rows", str(BATCH_ROWS),
                  "--max-batch-rows", str(cfg.runtime.max_batch_rows),
                  "--z-mode", "int8", "--device", str(dev)]
        for d in ("b", "c_m"):
            (tmp / d).mkdir()

        # (b) the launcher: two coordinated workers, then one process ---
        pb = tmp / "probe_b"
        pb.mkdir()
        env = _fleet_env(str(probe), 0.0)
        env["FLEET_PROBE_DIR"] = str(pb)
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, "-m", LAUNCHER, "--processes",
             str(FLEET_PROCS), "--local-devices", str(FLEET_LOCAL),
             "--workdir", str(tmp / "wd_b"),
             "--timeout", str(FLEET_SPAWN_TIMEOUT_S), "--",
             "score", *common, "--devices", str(FLEET_LOCAL),
             "--precompile", "--out", str(tmp / "b" / "out"),
             "--checkpoint-dir", str(tmp / "b" / "ck"),
             "--cms-exchange", str(tmp / "b" / "xch"),
             "--metrics-dump", str(tmp / "b" / "m-{proc}.json")],
            capture_output=True, text=True, env=env, cwd=str(ROOT),
            timeout=FLEET_SPAWN_TIMEOUT_S + 60)
        fleet_s = time.perf_counter() - t0
        check(p.returncode == 0, f"fleet launcher exited {p.returncode}: "
                                 f"{p.stderr[-2000:]}")
        report = json.loads(p.stdout.strip().splitlines()[-1])
        check(report["coordinated"] and report["rows_total"] == len(control),
              f"fleet report {report}")
        _same_as_control(_npz_rows(tmp / "b" / "out"), control,
                         "(b) the fleet")
        workers = {}
        for rec in _probes(str(pb)):
            pid = rec["process_id"]
            st = _stats_line(str(tmp / "wd_b" / f"proc-{pid:02d}.log"))
            snap = json.loads((tmp / "b" / f"m-{pid:02d}.json").read_text())
            launches = _path_launches(rec)
            check(launches["leaf_sum"] == st["chunks"]
                  and launches["fused_forest_leaf_sum"] == 0,
                  f"worker {pid}: {launches} for {st['chunks']} chunks")
            for k, n in launches.items():
                totals[k] += n
            fams = {k: [(r.get("labels") or {}, r.get("value"))
                        for r in v.get("series", [])]
                    for k, v in snap.items()}
            # precompile captures CUDA graphs (none on a CPU rehearsal)
            check(sum(v for _, v in fams.get(
                "cuda_graph_recaptures_total", [])) == 0
                  and (sum(v for _, v in fams.get(
                      "rtfds_precompiled_steps_total", [])) > 0
                       or dev.type != "cuda"),
                  f"worker {pid}: recaptures or no precompiled steps")
            labels = [lab for lab, _ in fams["rtfds_shard_rows"]]
            check(labels == [{"shard": str(FLEET_LOCAL * pid + s),
                              "process": str(pid)}
                             for s in range(FLEET_LOCAL)],
                  f"worker {pid} shard labels {labels}")
            workers[pid] = {**rate(st), "leaf_sum_launches":
                            launches["leaf_sum"],
                            "barrier_ms": rec.get("barrier_ms"),
                            "start_to_first_batch_ms":
                            (rec["t_first_batch"] - rec["t_start"]) * 1e3}
        check(sorted(workers) == list(range(FLEET_PROCS)),
              f"probes of workers {sorted(workers)}")
        single_log = str(tmp / "single.log")
        env_s = _fleet_env(str(probe), 0.0)
        env_s["FLEET_PROBE_DIR"] = str(tmp / "probe_s")
        (tmp / "probe_s").mkdir()
        sp = _worker(["score", *common, "--devices",
                      str(FLEET_PROCS * FLEET_LOCAL), "--precompile",
                      "--out", str(tmp / "single")], env_s, single_log)
        check(sp.wait(timeout=FLEET_SPAWN_TIMEOUT_S) == 0,
              f"single process: {Path(single_log).read_text()[-1500:]}")
        single = _stats_line(single_log)
        (srec,) = _probes(str(tmp / "probe_s"))
        for k, n in _path_launches(srec).items():
            totals[k] += n
        _same_as_control(_npz_rows(tmp / "single"), control,
                         "(b) the single process")
        fleet_wall = max(w["wall_s"] for w in workers.values())
        emit({"phase": "fleet", "part": "b_launcher",
              "processes": FLEET_PROCS, "local_devices": FLEET_LOCAL,
              "workers": workers,
              "fleet_rows_per_s": report["rows_total"] / fleet_wall,
              "fleet_wall_s": fleet_wall,
              "launcher_wall_s_with_startup": fleet_s,
              "single_process_4_shards": rate(single), **card})

        # (c) drain the fleet, merge into one, grow back to two ---------
        pc = tmp / "probe_c"
        pc.mkdir()
        env_c = _fleet_env(str(probe), FLEET_SINK_SLEEP_S)
        env_c["FLEET_PROBE_DIR"] = str(pc)
        drained = _drained_fleet(tmp, "c0", common + ["--precompile"], [],
                                 env_c)
        for rec in _probes(str(pc)):
            for k, n in _path_launches(rec).items():
                totals[k] += n
        pc2 = tmp / "probe_c2"
        pc2.mkdir()
        env_c["FLEET_PROBE_DIR"] = str(pc2)
        p = subprocess.run(
            [sys.executable, "-m", LAUNCHER, "--processes", "1",
             "--local-devices", str(FLEET_LOCAL), "--no-coordinator",
             "--autoscale", "--autoscale-min", "1", "--autoscale-max",
             str(FLEET_PROCS), "--autoscale-grow-rung", "1",
             "--autoscale-grow-dwell", "0.2",
             "--autoscale-shrink-dwell", "600",
             "--autoscale-cooldown", "600", "--autoscale-interval", "0.1",
             "--max-resizes", "1", "--worker-metrics-base",
             str(_free_port()), "--workdir", str(tmp / "wd_c"),
             "--timeout", str(FLEET_SPAWN_TIMEOUT_S), "--",
             "score", *common, "--devices", str(FLEET_LOCAL),
             "--precompile", "--resume", "--resume-merge",
             f"{tmp / 'c0' / 'ck'}:{FLEET_PROCS}:{FLEET_LOCAL}:shrink",
             "--out", str(tmp / "c" / "{gen}"),
             "--checkpoint-dir", str(tmp / "ck_c" / "{gen}"),
             "--metrics-dump", str(tmp / "c_m" / "m-{gen}-{proc}.json"),
             "--overload", "--overload-lag-high", str(BATCH_ROWS),
             "--overload-climb-dwell", "4", "--overload-spill", ""],
            capture_output=True, text=True, env=env_c, cwd=str(ROOT),
            timeout=FLEET_SPAWN_TIMEOUT_S + 60)
        check(p.returncode == 0, f"autoscale launcher exited "
                                 f"{p.returncode}: {p.stderr[-2000:]}")
        auto = json.loads(p.stdout.strip().splitlines()[-1])["autoscale"]
        check(auto["completed"] == 1 and auto["current"] == FLEET_PROCS
              and auto["last_resize"]["direction"] == "grow",
              f"autoscale {auto}")
        rows = _npz_rows(tmp / "c0" / "out")
        gen_rows = _npz_rows(tmp / "c")
        check(not set(rows) & set(gen_rows), "a row scored twice")
        rows.update(gen_rows)
        n_c = _same_as_control(rows, control, "(c) drain, merge, grow")
        relaunch = []
        for rec in _probes(str(pc2)):
            for k, n in _path_launches(rec).items():
                totals[k] += n
            if "gen-001" in " ".join(rec["argv"]):
                relaunch.append((rec["t_first_batch"] - rec["t_start"])
                                * 1e3 if "t_first_batch" in rec else None)
        merge_ms = _merge_ms(tmp / "wd_c" / "gen-000-proc-00.log")
        check(len(relaunch) == FLEET_PROCS, f"(c): relaunched {relaunch}")
        emit({"phase": "fleet", "part": "c_resize", "rows": n_c,
              "drained_at_batch": [st["drained_at_batch"]
                                   for st in drained["stats"]],
              "drain_to_final_checkpoint_ms":
              drained["drain_to_final_checkpoint_ms"],
              "drain_to_exit_ms": drained["drain_to_exit_ms"],
              "merge_ms": merge_ms,
              "relaunch_to_first_batch_ms": relaunch,
              "autoscale": {k: auto[k] for k in (
                  "completed", "rolled_back", "current", "generations")},
              "resize_seconds": auto["last_resize"].get("seconds"),
              **card})

        # (d) the same shrink on the tiered store with the cold tier ----
        pd = tmp / "probe_d"
        pd.mkdir()
        env_d = _fleet_env(str(probe), FLEET_SINK_SLEEP_S)
        env_d["FLEET_PROBE_DIR"] = str(pd)
        exact = ["--key-mode", "exact", "--state-compact-every",
                 str(FLEET_COMPACT_EVERY), "--cold-store",
                 str(tmp / "d0" / "cold")]
        drained_d = _drained_fleet(tmp, "d0", common, exact, env_d)
        old = []
        for pid in range(FLEET_PROCS):
            ck = make_checkpointer(str(tmp / "d0" / "ck" / f"proc-{pid:02d}"))
            old.append(ck.manifest(ck.latest())["meta"])
        env_d["FLEET_SINK_SLEEP_S"] = "0"
        log = str(tmp / "d1.log")
        cold_srcs = ",".join(str(tmp / "d0" / "cold" / f"proc-{p:02d}")
                             for p in range(FLEET_PROCS))
        w = _worker(["score", *common, "--devices", str(FLEET_LOCAL),
                     "--key-mode", "exact", "--state-compact-every",
                     str(FLEET_COMPACT_EVERY), "--cold-store",
                     str(tmp / "d1" / "cold"), "--resume", "--resume-merge",
                     f"{tmp / 'd0' / 'ck'}:{FLEET_PROCS}:{FLEET_LOCAL}:"
                     "shrink", "--resume-merge-cold", cold_srcs,
                     "--drain-on-sigterm", "--out", str(tmp / "d1" / "out"),
                     "--checkpoint-dir", str(tmp / "d1" / "ck")], env_d, log)
        check(w.wait(timeout=FLEET_SPAWN_TIMEOUT_S) == 0,
              f"(d) merged worker: {Path(log).read_text()[-1500:]}")
        ck = make_checkpointer(str(tmp / "d1" / "ck"))
        merged = ck.manifest(ck.list_checkpoints()[0])["meta"]
        epoch = merged["resize_epochs"][-1]
        check(epoch["from_processes"] == FLEET_PROCS
              and epoch["to_processes"] == 1
              and len(epoch["floors"]) == FLEET_PROCS, f"(d) {epoch}")
        occ = {t: sum(sum(m["feature_state_occupancy"][t]) for m in old)
               for t in ("customer", "terminal")}
        got = {t: sum(merged["feature_state_occupancy"][t])
               for t in ("customer", "terminal")}
        check(got == occ, f"(d) merged directories hold {got}, the old "
                          f"processes' held {occ}")
        for rec in _probes(str(pd)):
            for k, n in _path_launches(rec).items():
                totals[k] += n
        rows = _npz_rows(tmp / "d0" / "out")
        more = _npz_rows(tmp / "d1" / "out")
        check(not set(rows) & set(more), "(d) a row scored twice")
        rows.update(more)
        n_d = _same_as_control(rows, control_exact, "(d) exact shrink")
        emit({"phase": "fleet", "part": "d_exact_shrink", "rows": n_d,
              "drained_at_batch": [st["drained_at_batch"]
                                   for st in drained_d["stats"]],
              "drain_to_final_checkpoint_ms":
              drained_d["drain_to_final_checkpoint_ms"],
              "directory_entries_rehomed": got,
              "floors": epoch["floors"],
              "merged_worker": rate(_stats_line(log)), **card})
    emit({"phase": "fleet", "part": "done", "kernel_launches": totals,
          "phase_s": time.perf_counter() - t_phase, **card})
    return totals


SSEQ_BATCHES = 6  # (a): Zipf batches through single, 4 and 8 shards
SSEQ_WIDTHS = (4, 8)
SSEQ_CAPACITY = 1 << 20  # (a): 2^18 and 2^17 slots a shard, powers of two
ATOL_SSEQ = 1e-5  # tests/test_sharded_sequence.py:79 (sharded vs single)
SP_T = 4096  # (b): the long history, 512 events a shard over 8
SP_ROWS = 4
SP_HEADS = 8  # (b): Ulysses splits heads over the 8 shards
SP_HEAD_DIM = 16
ATOL_SP = 1e-5  # (b): ring / Ulysses against blockwise, float32
PAR_ROWS = 65536  # (c)
ATOL_PAR = 1e-5  # (c): a sharded form against its unsharded one


def phase_sharded_sequence(dev, device_info, data: dict) -> dict:
    """The sequence kind over shards and the parallel library on the
    card; see the module docstring, phase 19."""
    import torch.nn.functional as F

    from real_time_fraud_detection_system_tpu_torch.data.generator import (
        ZipfKeySampler,
    )
    from real_time_fraud_detection_system_tpu_torch.features.history import (
        _attn_fn_for,
        history_bytes,
    )
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        Checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.models.mlp import (
        init_mlp,
        mlp_logits,
    )
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        init_transformer,
        make_sp_logits_fn,
        transformer_logits,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        expert_parallel as ep,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        pipeline_parallel as pp,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        ring_attention as ra,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        tensor_parallel as tp,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    t_phase = time.perf_counter()
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    cfg = _seq_cfg(data["cfg"], history_len=32,
                   customer_capacity=SSEQ_CAPACITY)
    check(_attn_fn_for(cfg.features, 32) is None, "sharded_sequence: "
          "not naive attention")
    model = _zoo_models(data["models"]["forest"][1].scaler,
                        dev)["sequence"][0]
    # each batch in time order, as a Kafka partition delivers a card's
    # rows: a hot card's spill chunk then holds its later rows, and the
    # chunks, consecutive steps, keep the single engine's history order
    zb = [{c: v[np.argsort(b["tx_datetime_us"], kind="stable")]
           for c, v in b.items()}
          for b in _zipf_batches(ZipfKeySampler(SSEQ_CAPACITY, ZIPF_SKEW),
                                 SSEQ_BATCHES + 1, day_every=EXACT_DAY_EVERY,
                                 seed=17)]
    batches, extra = zb[:SSEQ_BATCHES], zb[SSEQ_BATCHES]

    def engine(n_dev=0, **kw):
        if n_dev:
            # the balanced share a shard: any skew spills into routed
            # chunks
            return ShardedScoringEngine(
                cfg, "sequence", model.params, model.scaler,
                n_devices=n_dev, device=dev,
                rows_per_shard=BATCH_ROWS // n_dev, **kw)
        return ScoringEngine(cfg, "sequence", model.params, model.scaler,
                             device=dev, **kw)

    def served(eng, bs, what):
        """``drive`` the run: the sequence kernel launches at least once a
        batch (once a shard and chunk), no other kernel launches."""
        res = _Results()
        stats, launches = drive(lambda: eng.run(_ListSource(_copies(bs)),
                                                res))
        for name, n in launches.items():
            check(n >= stats["batches"] if name == "fused_last_logit"
                  else n == 0,
                  f"sharded_sequence {what}: {n} launches of {name}")
        check(stats["rows"] == sum(len(b["tx_id"]) for b in bs)
              and bool(np.isfinite(res.probs()).all()),
              f"sharded_sequence {what}: rows or probabilities")
        return stats, res

    def by_tx(res) -> np.ndarray:
        tx = np.concatenate([r.tx_id for r in res.batches])
        return res.probs()[np.argsort(tx, kind="stable")]

    def loop(stats) -> dict:
        return {k: stats[k] for k in (
            "rows", "batches", "rows_per_s", "latency_p50_ms",
            "latency_p99_ms", "stage_ms_p50") if k in stats}

    # (a) the sequence kind at the zoo's widths over 4 and 8 shards ------
    served(engine(), batches[:1], "warm-up")  # the library's first calls
    single = engine()
    s_stats, s_res = served(single, batches, "single")
    want = by_tx(s_res)
    check(want.std() > 0, "sharded_sequence: flat scores")
    widths = {"single": loop(s_stats)}
    engines = {}
    for n_dev in SSEQ_WIDTHS:
        eng = engine(n_dev)
        stats, res = served(eng, batches, f"{n_dev} shards")
        err = float(np.abs(by_tx(res) - want).max())
        check(err <= ATOL_SSEQ, f"sharded_sequence (a) {n_dev} shards: "
                                f"{err} from the single engine")
        routed = stats["chunks"] - stats["batches"]
        check(routed > 0, f"sharded_sequence (a) {n_dev}: no spill chunk")
        widths[n_dev] = {**loop(stats), "chunks": stats["chunks"],
                         "routed_spill_chunks": routed,
                         "max_abs_prob_err_vs_single": err}
        engines[n_dev] = eng
    prof = engine(8)
    device, wall_ms, _, _, _ = _profiled(prof, _ListSource(_copies(
        batches)), PROFILE_BATCHES - 2)
    busy = sum(device.values())
    del prof
    emit({"phase": "sharded_sequence", "part": "a_widths",
          "history_len": 32, "attn": "naive",
          "customer_capacity": SSEQ_CAPACITY, "zipf_skew": ZIPF_SKEW,
          "state_bytes": history_bytes(cfg.features),
          "rows_per_shard": {n: BATCH_ROWS // n for n in SSEQ_WIDTHS},
          "widths": widths,
          "device_busy_ms_per_batch_8": busy / (PROFILE_BATCHES - 2)
          if device else "not measured",
          "device_idle_share_8": 1.0 - busy / wall_ms if device
          else "not measured", **card})

    # (a) restores at another width, each with its conversion -----------
    legs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, src, n_old, n_new in (("1to8", single, 1, 8),
                                        ("8to4", engines[8], 8, 4)):
            ck = Checkpointer(f"{tmp}/{name}")
            t0 = time.perf_counter()
            ck.save(src.state)
            t1 = time.perf_counter()
            fresh = engine(n_old) if n_old > 1 else engine()
            check(ck.restore(fresh.state) is not None,
                  f"sharded_sequence {name}: no checkpoint")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            conv = engine(n_new, feature_state=fresh.state.feature_state,
                          feature_state_n_old=n_old)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            legs[name] = {"save_ms": (t1 - t0) * 1e3,
                          "restore_ms": (t2 - t1) * 1e3,
                          "convert_ms": (t3 - t2) * 1e3,
                          "restore_and_convert_ms": (t3 - t1) * 1e3,
                          "engine": conv}
            del fresh
    ref = by_tx(served(single, [extra], "single, the extra batch")[1])
    for name, leg in legs.items():
        got = by_tx(served(leg.pop("engine"), [extra], name)[1])
        leg["max_abs_prob_err_vs_single"] = err = float(
            np.abs(got - ref).max())
        check(err <= ATOL_SSEQ, f"sharded_sequence {name}: {err}")
    emit({"phase": "sharded_sequence", "part": "a_restores",
          "state_bytes": history_bytes(cfg.features), "legs": legs, **card})
    del single, engines, legs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # (b) sequence-parallel attention at a long history ------------------
    mesh = make_mesh(8, devices=[dev] * 8)
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((SP_ROWS, SP_T, SP_HEADS, SP_HEAD_DIM),
                           generator=g, device=dev) for _ in range(3))
    forms = {"ring": ra.make_ring_attention_sharded(mesh),
             "ulysses": ra.make_ulysses_attention_sharded(mesh),
             "blockwise": lambda a, b, c: ra.blockwise_attention(a, b, c)}
    outs = {f: fn(q, k, v) for f, fn in forms.items()}
    attn = {f: {"ms": cuda_ms(lambda fn=fn: fn(q, k, v), 3)}
            for f, fn in forms.items()}
    for f in ("ring", "ulysses"):
        attn[f]["max_abs_err_vs_blockwise"] = err = float(
            (outs[f] - outs["blockwise"]).abs().max())
        check(err <= ATOL_SP, f"sharded_sequence (b) {f}: {err}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    attn["sdpa_yardstick"] = {"ms": cuda_ms(
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        3)}
    x = torch.randn((SP_ROWS, SP_T, 8), generator=g, device=dev)
    sp = make_sp_logits_fn(mesh)
    got = sp(model.params, x)
    want = transformer_logits(model.params, x, lambda a, b, c:
                              ra.blockwise_attention(a, b, c))
    lerr = float((got - want).abs().max())
    check(lerr <= ATOL_SP, f"sharded_sequence (b) sp logits: {lerr}")
    emit({"phase": "sharded_sequence", "part": "b_sequence_parallel",
          "rows": SP_ROWS, "history": SP_T, "shards": 8,
          "heads": SP_HEADS, "head_dim": SP_HEAD_DIM, "attention": attn,
          "sp_logits_ms": cuda_ms(lambda: sp(model.params, x), 3),
          "blockwise_logits_ms": cuda_ms(lambda: transformer_logits(
              model.params, x, lambda a, b, c:
              ra.blockwise_attention(a, b, c)), 3),
          "sp_logits_max_abs_err_vs_blockwise": lerr, **card})
    del q, k, v, qt, kt, vt, outs, x, got, want

    # (c) tensor, expert and pipeline parallel against unsharded ---------
    gen = torch.Generator(device=dev).manual_seed(5)
    xm = torch.randn((PAR_ROWS, 15), generator=gen, device=dev)
    ym = (torch.rand(PAR_ROWS, generator=gen, device=dev) < 0.3).int()
    mlp = init_mlp(15, (64, 32), seed=1, device=dev)
    sh, step = tp.make_tp_step(mesh, mlp, lr=0.5)
    new, loss = step(sh, xm, ym)

    def plain_step():
        p = tree.map(lambda t: t.clone().requires_grad_(), mlp)
        z = mlp_logits(p, xm)
        yf = ym.float()
        per = -yf * F.logsigmoid(z) - (1 - yf) * F.logsigmoid(-z)
        grads = torch.autograd.grad(per.mean(), tree.leaves(p))
        return tree.unflatten(p, [w.detach() - 0.5 * d for w, d in
                                  zip(tree.leaves(p), grads)])

    ref = plain_step()
    tp_err = max(float((a - b).abs().max())
                 for a, b in zip(tree.leaves(new), tree.leaves(ref)))
    check(tp_err <= ATOL_PAR, f"sharded_sequence (c) tp: {tp_err}")
    moe = ep.init_moe(32, 64, 8, seed=2, device=dev)
    xe = torch.randn((PAR_ROWS, 32), generator=gen, device=dev)
    sh_e, apply_fn = ep.make_ep_apply(mesh, moe)
    ep_err = float((apply_fn(sh_e, xe) - ep.moe_apply_dense(moe, xe))
                   .abs().max())
    check(ep_err <= ATOL_PAR, f"sharded_sequence (c) ep: {ep_err}")
    stack = pp.init_stack(64, 8, seed=3, device=dev)
    xp = torch.randn((PAR_ROWS, 64), generator=gen, device=dev)
    sh_p, run = pp.make_pipeline(mesh, stack, n_micro=8)
    pref = pp.stack_apply(stack, xp)
    pp_err = float((run(sh_p, xp) - pref).abs().max())
    pp_scale = float(pref.abs().max())
    check(pp_err <= ATOL_PAR * max(pp_scale, 1.0),
          f"sharded_sequence (c) pp: {pp_err} at scale {pp_scale}")
    emit({"phase": "sharded_sequence", "part": "c_tp_ep_pp",
          "rows": PAR_ROWS, "shards": 8,
          "tp_step_ms": cuda_ms(lambda: step(sh, xm, ym), 3),
          "tp_plain_step_ms": cuda_ms(plain_step, 3),
          "tp_max_abs_param_err_vs_plain": tp_err, "tp_loss": float(loss),
          "ep_apply_ms": cuda_ms(lambda: apply_fn(sh_e, xe), 3),
          "ep_dense_ms": cuda_ms(lambda: ep.moe_apply_dense(moe, xe), 3),
          "ep_max_abs_err_vs_dense": ep_err,
          "pp_pass_ms": cuda_ms(lambda: run(sh_p, xp), 3),
          "pp_sequential_ms": cuda_ms(lambda: pp.stack_apply(stack, xp), 3),
          "pp_max_abs_err_vs_sequential": pp_err,
          "pp_output_max_abs": pp_scale, **card})
    emit({"phase": "sharded_sequence", "part": "seconds",
          "seconds": time.perf_counter() - t_phase})
    return {name: 0 for name in KERNELS}


# (a): the reference's data scale (DataConfig's defaults) and split
OPERATOR_REFERENCE = {"customers": 5000, "terminals": 10000, "days": 245,
                      "seed": 0, "delta-train": 153, "delta-delay": 30,
                      "delta-test": 30}
OPERATOR_SMALL = ["--customers", "500", "--terminals", "1000", "--days",
                  "90", "--delta-train", "45", "--delta-delay", "10"]
OPERATOR_SHARDS = 4
# (b): the sharded pair's max_batch_rows. At the CLI's width (65,536) each
# 4,096-row batch pads to a 131,072-row chunk, which the CPU reference's
# plain leaf sum (a GEMM over T=100 trees of depth 8) takes seconds for.
OPERATOR_SHARDED_MAX_ROWS = 4096
OPERATOR_SCORE_BATCHES = 4  # (c): the score run's 65,536-row batches
OPERATOR_POISON = (70000, 70001, 90000)  # (c): rows of its second batch
ATOL_DEMO_AUC = 1e-6


@contextlib.contextmanager
def _recorded_runs():
    """Every ``run`` of a single or sharded engine inside the block, as
    (its stats, the sink it was given), outermost calls only."""
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine

    runs = []
    originals = {cls: cls.__dict__["run"]
                 for cls in (ScoringEngine, ShardedScoringEngine)}

    def wrap(cls, orig):
        def run(self, source, sink=None, *args, **kw):
            stats = orig(self, source, sink, *args, **kw)
            if type(self) is cls:
                runs.append((stats, sink))
            return stats
        return run

    for cls, orig in originals.items():
        setattr(cls, "run", wrap(cls, orig))
    try:
        yield runs
    finally:
        for cls, orig in originals.items():
            setattr(cls, "run", orig)


def _operator_cli(argv: list) -> dict:
    """``cli.main(argv)`` with its stdout and log captured and the launch
    counters reset around it: rc, JSON lines, the log's text, launches."""
    import logging

    from real_time_fraud_detection_system_tpu_torch import cli

    class Keep(logging.Handler):
        def __init__(self):
            super().__init__(logging.INFO)
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    keep = Keep()
    root = logging.getLogger()
    root.addHandler(keep)
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc, launches = drive(lambda: cli.main(argv))
    finally:
        root.removeHandler(keep)
    lines = []
    for ln in out.getvalue().strip().splitlines():
        try:
            lines.append(json.loads(ln))
        except json.JSONDecodeError:
            lines.append(ln)
    return {"rc": rc, "lines": lines, "stdout": out.getvalue(),
            "log": "\n".join(keep.lines), "launches": launches,
            "seconds": time.perf_counter() - t0}


def _demo_batches(runs) -> tuple:
    """(batches, chunks) over the recorded runs (chunks: sharded only)."""
    return (sum(int(s["batches"]) for s, _ in runs),
            sum(int(s.get("chunks", 0)) for s, _ in runs))


def phase_operator(dev, device_info, data: dict) -> dict:
    """The operator surface: (a) ``demo`` at the reference's data scale,
    (b) small demos on the card against the CPU device, (c) the operator
    commands over a short checkpointed ``score`` run."""
    from real_time_fraud_detection_system_tpu_torch import cli, cli_ops
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        save_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.io.sink import (
        DeadLetterSink,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.pipeline import (
        run_demo,
    )

    t_phase = time.perf_counter()
    card = {"card": device_info["smi_name"],
            "power_limit": device_info["power_limit"]}
    totals = {name: 0 for name in KERNELS}

    def add(launches: dict) -> None:
        for name, n in launches.items():
            totals[name] += n

    with tempfile.TemporaryDirectory() as tmp:
        model = f"{tmp}/forest.npz"
        with open(model, "wb") as f:
            f.write(data["models"]["forest"][2])

        # (a) the demo at the reference's scale ---------------------------
        txs, ref = data["txs"], OPERATOR_REFERENCE
        stream_rows = int((txs.tx_time_days >= ref["delta-train"]
                           + ref["delta-delay"]).sum())
        with _recorded_runs() as runs:
            r = _operator_cli([
                "demo", *(x for k, v in ref.items() for x in (f"--{k}",
                                                             str(v))),
                "--model-file", model, "--batch-rows", str(BATCH_ROWS)])
        check(r["rc"] == 0, f"operator (a) demo exited {r['rc']}")
        s = r["lines"][-1]
        batches, _ = _demo_batches(runs)
        check(s["customers"] == ref["customers"]
              and s["terminals"] == ref["terminals"],
              f"operator (a): {s['customers']} customers, "
              f"{s['terminals']} terminals")
        check(s["streamed_rows"] == stream_rows
              and s["warm_rows"] == txs.n - stream_rows,
              f"operator (a): streamed {s['streamed_rows']} of "
              f"{stream_rows}")
        check(len(runs) == 2 and r["launches"] == {
            **{k: 0 for k in KERNELS}, "fused_forest_leaf_sum": batches},
            f"operator (a): {r['launches']} for {batches} batches")
        probs = runs[1][1].sinks[0].concat()["prediction"]
        check(probs.shape == (stream_rows,) and bool(np.isfinite(probs).all())
              and probs.min() >= 0.0 and probs.max() <= 1.0,
              "operator (a): probabilities not finite in [0, 1]")
        add(r["launches"])
        emit({"phase": "operator", "part": "a_demo_reference_scale",
              "customers": s["customers"], "terminals": s["terminals"],
              "warm_rows": s["warm_rows"], "streamed_rows": s["streamed_rows"],
              "warm_batches": int(runs[0][0]["batches"]),
              "stream_batches": int(runs[1][0]["batches"]),
              "kernel_launches": r["launches"],
              "rows_per_s": s["rows_per_s"],
              "latency_p50_ms": s["latency_p50_ms"],
              "latency_p99_ms": s["latency_p99_ms"],
              "stream_stage_ms_p50": runs[1][0]["stage_ms_p50"],
              "stream_auc": s["stream_auc"],
              "flagged_at_0.5": s["flagged_at_0.5"], "wall_s": s["wall_s"],
              "command_s": r["seconds"], **card})

        # (b) the card against the CPU device, end to end -----------------
        # where the card machine has pyarrow, the card's forest demo also
        # writes its output, which (c) reads with query, sql, dashboard
        arrow = importlib.util.find_spec("pyarrow") is not None
        out_dir = f"{tmp}/demo-out"
        args = cli.build_parser().parse_args(["demo", *OPERATOR_SMALL])
        shard_cfg = cli_ops.demo_config(args)
        shard_cfg = shard_cfg.replace(runtime=dataclasses.replace(
            shard_cfg.runtime, max_batch_rows=OPERATOR_SHARDED_MAX_ROWS))
        legs = (
            ("forest", "fused_forest_leaf_sum",
             lambda d: _operator_cli([
                 "demo", *OPERATOR_SMALL, "--model-file", model, "--device",
                 str(d), *(["--out", out_dir] if arrow and d == dev
                           else [])])),
            ("logreg", "fused_featurize_score",
             lambda d: _operator_cli(["demo", *OPERATOR_SMALL, "--model",
                                      "logreg", "--device", str(d)])),
            (f"forest_{OPERATOR_SHARDS}_shards", "leaf_sum",
             lambda d: _run_demo_driven(run_demo, shard_cfg, d, data)),
        )
        streamed = {}
        for leg, own, run in legs:
            res = {}
            for d in (dev, "cpu"):
                with _recorded_runs() as runs:
                    res[str(d)] = (run(d), runs)
            got, card_runs = res[str(dev)]
            want = res["cpu"][0]
            check(got["rc"] == want["rc"] == 0,
                  f"operator (b) {leg}: rc {got['rc']}, {want['rc']}")
            g, w = got["lines"][-1], want["lines"][-1]
            for k in ("customers", "terminals", "warm_rows",
                      "streamed_rows", "flagged_at_0.5"):
                check(g[k] == w[k], f"operator (b) {leg}: {k} {g[k]} on the "
                                    f"card, {w[k]} on the CPU")
            auc_err = abs(g["stream_auc"] - w["stream_auc"])
            check(auc_err <= ATOL_DEMO_AUC,
                  f"operator (b) {leg}: stream AUC differs by {auc_err}")
            batches, chunks = _demo_batches(card_runs)
            steps = chunks if own == "leaf_sum" else batches
            check(got["launches"] == {**{k: 0 for k in KERNELS},
                                      own: steps},
                  f"operator (b) {leg}: {got['launches']} for {steps} "
                  "steps")
            add(got["launches"])
            streamed[leg] = g["streamed_rows"]
            emit({"phase": "operator", "part": "b_card_vs_cpu", "leg": leg,
                  "customers": g["customers"], "warm_rows": g["warm_rows"],
                  "streamed_rows": g["streamed_rows"], "steps": steps,
                  "kernel_launches": got["launches"],
                  "stream_auc": g["stream_auc"],
                  "stream_auc_abs_err_vs_cpu": auc_err,
                  "flagged_at_0.5": g["flagged_at_0.5"],
                  "rows_per_s": g["rows_per_s"],
                  "cpu_rows_per_s": w["rows_per_s"],
                  "latency_p50_ms": g["latency_p50_ms"],
                  "wall_s": g["wall_s"], "cpu_wall_s": w["wall_s"], **card})

        # (c) the operator tools over a short score run ---------------------
        part = txs.slice(slice(0, OPERATOR_SCORE_BATCHES * BATCH_ROWS))
        part.amount_cents = np.array(part.amount_cents, copy=True)
        part.amount_cents[list(OPERATOR_POISON)] *= -1
        save_transactions(f"{tmp}/poisoned.npz", part)
        ck, dlq = f"{tmp}/ck", f"{tmp}/dlq.jsonl"
        r = _operator_cli([
            "score", "--data", f"{tmp}/poisoned.npz", "--model-file", model,
            "--batch-rows", str(BATCH_ROWS), "--checkpoint-dir", ck,
            "--max-restarts", "8", "--dead-letter", dlq, "--flight-record",
            f"{tmp}/flight.jsonl", "--trace-out", f"{tmp}/trace.json"])
        stats = r["lines"][-1]
        check(r["rc"] == 0 and stats["dead_letter_rows"] == 3
              and stats["rows"] == part.n - 3,
              f"operator (c) score: rc {r['rc']}, {stats}")
        add(r["launches"])
        out = {"score": {"rows": stats["rows"], "batches": stats["batches"],
                         "restarts": stats["restarts"],
                         "dead_letter_rows": stats["dead_letter_rows"],
                         "kernel_launches": r["launches"]}}

        def ok(name, argv, rc=0):
            res = _operator_cli(argv)
            check(res["rc"] == rc, f"operator (c) {name}: rc {res['rc']} "
                                   f"(want {rc}): {res['log'][-300:]}")
            add(res["launches"])
            out[name] = {"rc": res["rc"], "seconds": res["seconds"]}
            return res

        lst = ok("ckpt", ["ckpt", "--path", ck])["lines"]
        check(lst[0]["checkpoints"] >= 1 and lst[0]["corrupt"] == 0,
              f"operator (c) ckpt: {lst[0]}")
        ver = ok("ckpt_verify", ["ckpt", "--path", ck, "--verify"])["lines"]
        latest = os.path.basename(ver[0]["latest"])
        man = ok("ckpt_inspect", ["ckpt", "--path", ck, "--inspect",
                                  latest])["lines"][-1]
        check(man["topology"]["process_count"] == 1
              and man["feature_state"]["leaves"],
              "operator (c) ckpt --inspect: no topology or leaves")
        shutil.copytree(ck, f"{tmp}/ck-bad")
        with open(f"{tmp}/ck-bad/{latest}", "r+b") as f:
            f.seek(os.path.getsize(f"{tmp}/ck-bad/{latest}") // 2)
            byte = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([byte[0] ^ 0xFF]))
        bad = ok("ckpt_verify_flipped", ["ckpt", "--path", f"{tmp}/ck-bad",
                                         "--verify"], rc=1)["lines"]
        check(bad[0]["corrupt"] == 1, f"operator (c) flipped: {bad[0]}")
        tr = ok("trace", ["trace", "--trace", f"{tmp}/trace.json",
                          "--json"])["lines"][-1]
        check(len(tr["batches"]) >= stats["batches"],
              f"operator (c) trace: {len(tr['batches'])} batches")
        dash = ok("dashboard_ops", ["dashboard", "--flight-record",
                                    f"{tmp}/flight.jsonl", "--out",
                                    f"{tmp}/ops.html"])["lines"][-1]
        # the record's last segment: the incarnation that finished the run
        check(dash["batches"] >= 1 and dash["events"] >= 1
              and dash["bytes"] > 0, f"operator (c) dashboard: {dash}")
        reg = f"{tmp}/registry"
        pub = ok("registry_publish", ["registry", "--path", reg,
                                      "--publish", model])["lines"][-1]
        ok("registry_promote", ["registry", "--path", reg, "--promote",
                                str(pub["published"])])
        rv = ok("registry_verify", ["registry", "--path", reg,
                                    "--verify"])["lines"][0]
        check(rv["versions"] == 1 and rv["corrupt"] == 0
              and rv["champion"] == pub["published"],
              f"operator (c) registry --verify: {rv}")
        insp = ok("dlq", ["dlq", "--path", dlq])["lines"][0]
        check(insp["rows"] == 3, f"operator (c) dlq: {insp}")
        # a row quarantined for a fault since fixed: it scores on replay
        # (through the artifact's kernel); the poisoned rows stay poison
        clean = {k: np.asarray([v], np.int64) for k, v in {
            "tx_id": 10 ** 12, "tx_datetime_us": int(
                START_EPOCH_S * 10 ** 6 + part.tx_time_seconds[0] * 10 ** 6),
            "customer_id": int(part.customer_id[0]),
            "terminal_id": int(part.terminal_id[0]),
            "tx_amount_cents": 4200, "kafka_ts_ms": 0}.items()}
        sink = DeadLetterSink(dlq)
        sink.put_rows(clean, reason="crash", error="RuntimeError: fixed",
                      batch_index=1)
        sink.close()
        rep = ok("dlq_replay", ["dlq", "--path", dlq, "--replay",
                                "--model-file", model])
        verdicts = {v["tx_id"]: v for v in rep["lines"][1:]}
        check(rep["lines"][0]["replayed"] == 4
              and 0.0 <= verdicts[10 ** 12]["prediction"] <= 1.0
              and sum(bool(v.get("still_poison"))
                      for v in verdicts.values()) == 3,
              f"operator (c) dlq --replay: {rep['lines']}")
        check(rep["launches"] == {**{k: 0 for k in KERNELS},
                                  "fused_forest_leaf_sum": 1},
              f"operator (c) dlq --replay launches {rep['launches']}")
        out["dlq_replay"]["kernel_launches"] = rep["launches"]
        wu = ok("warmup", ["warmup", "--model-file", model])["lines"][-1]
        check(wu["buckets"] == [256, 1024, 4096, 16384, 65536],
              f"operator (c) warmup: {wu}")
        out["warmup"].update(compile_seconds=wu["compile_seconds"],
                             total_seconds=wu["total_seconds"])
        vd = ok("verify_device", ["verify-device", "--json"])
        report = json.loads(vd["stdout"])
        check(report["summary"]["gate_failures"] == 0
              and report["checks"]["capture"]["captured"]
              == report["signatures_verified"],
              f"operator (c) verify-device: {report['summary']}")
        out["verify_device"].update(
            targets=len(report["targets"]),
            signatures_captured=report["checks"]["capture"]["captured"])

        if arrow:
            # the analysis side over the card's demo output
            n = streamed["forest"]
            q = ok("query", ["query", "--data", out_dir])["lines"][-1]
            sq = ok("sql", ["sql", "--data", out_dir, "SELECT COUNT(*) AS n"
                            " FROM analyzed"])["lines"][-1]
            dd = ok("dashboard_data", ["dashboard", "--data", out_dir,
                                       "--out", f"{tmp}/d.html"])["lines"][-1]
            raw = ok("query_transactions", [
                "query", "--data", f"{out_dir}/transactions", "--report",
                "transactions"])["lines"][-1]
            check(q["transactions"] == sq["n"] == dd["transactions"]
                  == raw["transactions"] == n,
                  f"operator (c) analysis of the demo output: {q}, {sq}, "
                  f"{dd}, {raw} for {n} streamed rows")
        # the commands whose packages the card machine may lack
        os.makedirs(f"{tmp}/parts")
        with open(f"{tmp}/parts/part-00000000.parquet", "wb") as f:
            f.write(b"PAR1")
        with open(f"{tmp}/model.pkl", "wb") as f:
            f.write(b"csklearn.ensemble._forest\nRandomForestClassifier\n.")
        missing = {}
        for name, pkg, argv in (
                ("import_model", "sklearn",
                 ["import-model", "--model-pkl", f"{tmp}/model.pkl",
                  "--out-model", f"{tmp}/imported.npz"]),
                ("demo_train_forest", "sklearn",
                 ["demo", *OPERATOR_SMALL, "--model", "forest"]),
                ("query", "pyarrow", ["query", "--data", f"{tmp}/parts"]),
                ("sql", "pyarrow", ["sql", "--data", f"{tmp}/parts",
                                    "SELECT 1"]),
                ("dashboard_data", "pyarrow",
                 ["dashboard", "--data", f"{tmp}/parts", "--out",
                  f"{tmp}/d.html"])):
            if importlib.util.find_spec(pkg) is not None:
                missing[name] = f"{pkg} is installed"
                continue
            res = _operator_cli(argv)
            text = res["log"] + json.dumps(res["lines"])
            check(res["rc"] == 2 and pkg in text,
                  f"operator (c) {name}: rc {res['rc']}, {text[-300:]}")
            missing[name] = {"rc": res["rc"], "names": pkg}
        emit({"phase": "operator", "part": "c_tools", **out,
              "without_package": missing, **card})
    emit({"phase": "operator", "part": "seconds",
          "seconds": time.perf_counter() - t_phase})
    return totals


def _run_demo_driven(run_demo, cfg, device, data) -> dict:
    """``run_demo`` on ``device`` with the forest artifact on
    ``OPERATOR_SHARDS`` shards, in ``_operator_cli``'s result form."""
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        load_model_bytes,
    )

    model = load_model_bytes(data["models"]["forest"][2], device=device)
    t0 = time.perf_counter()
    summary, launches = drive(lambda: run_demo(
        cfg, model=model, n_devices=OPERATOR_SHARDS, device=device))
    return {"rc": 0, "lines": [summary], "log": "", "launches": launches,
            "seconds": time.perf_counter() - t0}


def _dsv2_batches(n: int, rows: int, n_cust: int, seed: int = 0) -> list:
    """``n`` column batches of ``rows`` rows: cards drawn from ``n_cust``,
    times over 20 days in stream order, amounts in cents."""
    rng = np.random.default_rng(seed)
    total = n * rows
    cust = rng.integers(0, n_cust, total).astype(np.int64)
    t_s = np.sort(rng.integers(0, 20 * 86400, total)).astype(np.int64) \
        + START_EPOCH_S
    amount = rng.integers(100, 50_000, total).astype(np.int64)
    return [{"tx_id": np.arange(s, s + rows, dtype=np.int64),
             "tx_datetime_us": t_s[s:s + rows] * 1_000_000,
             "customer_id": cust[s:s + rows],
             "terminal_id": cust[s:s + rows] % 977,
             "tx_amount_cents": amount[s:s + rows],
             "kafka_ts_ms": np.zeros(rows, np.int64),
             "label": np.full(rows, -1, np.int32)}
            for s in range(0, total, rows)]


def phase_dsv2_path(dev, device_info, data: dict) -> dict:
    """DeepSeek-V2's block on the serving path; see the module
    docstring, phase 21."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        Config,
        FeatureConfig,
        RuntimeConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
    from real_time_fraud_detection_system_tpu_torch.models import (
        deepseek_v2 as dsv2,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        EXPERT_SLOTS,
        SEQUENCE_ROWS,
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.utils import trace
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )

    mcfg = dsv2.DSV2Config.from_dict(DSV2_SMOKE)
    leaves = dsv2.init_leaves(mcfg, torch.Generator(device=dev)
                              .manual_seed(0), dev)
    params = dsv2.params_from_leaves(mcfg, leaves, torch.bfloat16)
    del leaves
    per_step = dsv2.n_stamps(params)
    check(per_step == 18, f"dsv2_path: {per_step} stamps a step")
    cfg = Config(features=FeatureConfig(customer_capacity=4096,
                                        terminal_capacity=1024,
                                        history_len=32),
                 runtime=RuntimeConfig(batch_buckets=(DSV2_ROWS,),
                                       max_batch_rows=DSV2_ROWS,
                                       pipeline_depth=2))
    reg = MetricsRegistry()
    eng = ScoringEngine(cfg, "sequence", params,
                        Scaler(torch.zeros(15, device=dev),
                               torch.ones(15, device=dev)),
                        device=dev, metrics=reg)
    check(eng._seq_path == "dsv2", f"dsv2_path: path {eng._seq_path}")
    batches = _dsv2_batches(DSV2_BATCHES, DSV2_ROWS, 4096)
    man = eng.precompile()
    check(man["graphs"] == 1, f"dsv2_path: {man['graphs']} graphs")
    sink = MemorySink()
    tr = trace.get_tracer()
    tr.reset()
    tr.configure(enabled=True)
    try:
        stats, launches = drive(lambda: eng.run(_ListSource(batches),
                                                sink))
    finally:
        tr.reset()
    n = stats["batches"]
    check(n == DSV2_BATCHES and stats["rows"] == n * DSV2_ROWS,
          f"dsv2_path: {n} batches, {stats['rows']} rows")
    for name, got in launches.items():
        want = per_step * n if name == "stamp" else 0
        check(got == want, f"dsv2_path: {got} launches of {name} for {n} "
                           f"steps (want {want})")
    check(reg.get(SEQUENCE_ROWS, path="dsv2").value == n * DSV2_ROWS,
          "dsv2_path: rows scored by path")
    probs = np.concatenate([b["prediction"] for b in sink.batches])
    check(bool(np.isfinite(probs).all()) and probs.std() > 0,
          "dsv2_path: probabilities not finite or all alike")
    dev_spans = stats["trace"]["device"]
    for name in ("device/mla", "device/experts"):
        check(dev_spans.get(name, {}).get("count") == n,
              f"dsv2_path: {name} {dev_spans.get(name)}")
    step_ms = dev_spans["device/step"]["median_ms"]
    mla_ms = dev_spans["device/mla"]["median_ms"]
    exp_ms = dev_spans["device/experts"]["median_ms"]
    check(0 < mla_ms and 0 < exp_ms and mla_ms + exp_ms < step_ms,
          f"dsv2_path: spans {mla_ms} + {exp_ms} of a {step_ms} ms step")
    slots = stats["trace"]["counters"]["expert_slots"]
    check(sum(slots["4"]) == DSV2_SMOKE["num_experts_per_tok"] * n
          * DSV2_ROWS, "dsv2_path: the last layer's slots")
    check(reg.family_total(EXPERT_SLOTS) == sum(map(sum, slots.values())),
          "dsv2_path: the slot counter")
    emit({"phase": "dsv2_path", "batches": n, "rows": stats["rows"],
          "kernel_launches": launches, "stamps_per_step": per_step,
          "rows_per_s": stats["rows_per_s"],
          "latency_p50_ms": stats["latency_p50_ms"],
          "step_device_ms": step_ms, "mla_device_ms": mla_ms,
          "expert_device_ms": exp_ms,
          "expert_slots_peak_over_mean": max(
              max(v) * len(v) / sum(v) for v in slots.values() if sum(v)),
          "card": device_info["smi_name"],
          "power_limit": device_info["power_limit"]})
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import real_time_fraud_detection_system_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    info = phase_device()
    phase_build()
    k = phase_kernel(dev)
    data = phase_data(dev)
    launches = {name: 0 for name in KERNELS}
    seconds = {}

    def add(counts: dict, name: str, t0: float) -> None:
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        for kernel, n in counts.items():
            launches[kernel] += n

    for kind in PATHS:
        t0 = time.perf_counter()
        add(phase_main_path(dev, info, data, kind), "main_path", t0)
    t0 = time.perf_counter()
    add(phase_serving_loop(dev, info, data), "serving_loop", t0)
    cfg = data["cfg"]
    for phase, features, kinds in (
            ("hash_path", {"key_mode": "hash"}, PATHS),
            ("cms_path", {"customer_source": "cms"}, ("forest", "gbt"))):
        pcfg = dataclasses.replace(cfg, features=dataclasses.replace(
            cfg.features, **features))
        for kind in kinds:
            t0 = time.perf_counter()
            add(phase_main_path(dev, info, data, kind, phase, pcfg), phase,
                t0)
    for name, fn in (("cli", phase_cli), ("recovery", phase_recovery),
                     ("exact_path", phase_exact_path),
                     ("learning", phase_learning), ("zoo", phase_zoo),
                     ("precompile", phase_precompile),
                     ("ingest", phase_ingest), ("offline", phase_offline)):
        t0 = time.perf_counter()
        add(fn(dev, info, data), name, t0)
    t0 = time.perf_counter()
    for kind in PATHS:
        phase_profile(dev, data, kind)
    phase_profile(dev, data, "forest", dataclasses.replace(
        cfg, features=dataclasses.replace(cfg.features,
                                          customer_source="cms")))
    add({}, "profile", t0)
    for name, fn in (("sharded", phase_sharded),
                     ("sharded_exact", phase_sharded_exact),
                     ("fleet", phase_fleet),
                     ("sharded_sequence", phase_sharded_sequence),
                     ("operator", phase_operator),
                     ("dsv2_path", phase_dsv2_path)):
        t0 = time.perf_counter()
        add(fn(dev, info, data), name, t0)
    emit({"phase": "total", "seconds": time.perf_counter() - t_start,
          "phase_seconds": seconds})
    emit({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": k[name]["max_abs_err"],
        "ms": k[name]["ms"],
        "plain_ms": k[name]["plain_ms"],
        "bound_ms": k[name]["bound_ms"],
        "bound_by": k[name]["bound_by"],
        "library_ms": None,
    } for name, (source, replaces) in KERNELS.items()]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
