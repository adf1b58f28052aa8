"""End-to-end demo pipeline — port of the JAX package's
``runtime/pipeline.py``: the reference's docker-compose flow, in one
process.

The reference demo (README.md:31-43 + ``datagen/data_gen.py``) is:
datagen INSERTs → Postgres WAL → Debezium → Kafka topics
``debezium.payment.{customers,terminals,transactions}`` → three Spark sink
jobs MERGE into Iceberg → the ``fraud_detection.py`` scorer streams the
transaction table and appends ``analyzed_transactions``.

:func:`run_demo` plays the same flow:

1. generate profiles and transactions (``data/generator.py``);
2. train a model on the early window (``models/train.py``) unless one is
   given;
3. encode the profiles as Debezium envelopes into an
   :class:`~.sources.InProcBroker` (the Kafka role) as a snapshot;
4. job1/job2 (:func:`sink_dimension_topic`): decode the profile envelopes
   and MERGE them into :class:`~..io.tables.UpsertTable` dimension tables;
5. warm the engine's feature state by replaying the training horizon
   columnar (65,536-row batches, scores discarded);
6. job3 and the scorer in one: the engine consumes the post-horizon
   transactions as envelopes (decode → latest-wins dedup → stateful
   features → the kernel) into a :class:`~..io.sink.FanoutSink` of a
   :class:`~..io.sink.MemorySink`, and with ``out_dir`` a
   :class:`~..io.sink.ParquetSink` and the raw-transactions table.

The summary has the tables' sizes, the stream's stats and the AUC of the
streamed scores against the generator's labels, joined on ``tx_id``.
``device`` is the engine's and the trainer's (None = CUDA, raising
without a card); ``n_devices > 1`` serves on the sharded engine.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

from real_time_fraud_detection_system_tpu_torch.config import Config
from real_time_fraud_detection_system_tpu_torch.core.envelope import (
    decode_profile_envelopes,
    encode_profile_envelopes,
)
from real_time_fraud_detection_system_tpu_torch.core.schema import (
    CUSTOMERS,
    TERMINALS,
)
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    TrainedModel,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    FanoutSink,
    MemorySink,
)
from real_time_fraud_detection_system_tpu_torch.io.tables import UpsertTable
from real_time_fraud_detection_system_tpu_torch.models.metrics import roc_auc
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    InProcBroker,
    ReplaySource,
)
from real_time_fraud_detection_system_tpu_torch.utils.logging import (
    get_logger,
)
from real_time_fraud_detection_system_tpu_torch.utils.timing import (
    date_to_epoch_s,
)

log = get_logger("pipeline")

WARM_BATCH_ROWS = 65536  # the columnar warm-up's batches


def sink_dimension_topic(
    broker: InProcBroker,
    topic: str,
    schema,
    table: Optional[UpsertTable] = None,
    batch_rows: int = 4096,
) -> UpsertTable:
    """job1/job2: drain a profile topic into an UpsertTable by MERGE."""
    if table is None:
        table = UpsertTable(schema)
    offsets = [0] * broker.n_partitions
    while True:
        msgs, ts = [], []
        for p in range(broker.n_partitions):
            recs = broker.poll(topic, p, offsets[p], batch_rows)
            offsets[p] += len(recs)
            msgs += [r.value for r in recs]
            ts += [r.ts_ms for r in recs]
        if not msgs:
            break
        cols, invalid = decode_profile_envelopes(msgs, schema.fields, ts)
        table.merge(cols, valid=~invalid)
    return table


def _snapshot_dimensions(broker, customers, terminals, ts_ms: int) -> None:
    """The profiles as one snapshot of envelopes per topic, keyed by id."""
    for topic, cols, keycol in (
        ("debezium.payment.customers",
         {"customer_id": customers.customer_id,
          "x_location": customers.x, "y_location": customers.y},
         "customer_id"),
        ("debezium.payment.terminals",
         {"terminal_id": terminals.terminal_id,
          "x_location": terminals.x, "y_location": terminals.y},
         "terminal_id"),
    ):
        msgs = encode_profile_envelopes(topic.rsplit(".", 1)[1], cols,
                                        ts_ms=ts_ms)
        keys = [str(int(k)).encode() for k in cols[keycol]]
        broker.produce_many(topic, keys, msgs, ts_ms=[ts_ms] * len(msgs))


def _stream_auc(out: dict, stream) -> tuple:
    """(AUC of the streamed scores against the stream's labels joined on
    ``tx_id``, the scores in ``tx_id`` order)."""
    order = np.argsort(out["tx_id"], kind="mergesort")
    out_ids = out["tx_id"][order]
    probs = out["prediction"][order]
    sid = np.argsort(stream.tx_id, kind="mergesort")
    stream_ids = stream.tx_id[sid]
    stream_labels = stream.tx_fraud[sid]
    pos = np.searchsorted(stream_ids, out_ids)
    pos_c = np.clip(pos, 0, max(len(stream_ids) - 1, 0))
    ok = (pos < len(stream_ids)) & (stream_ids[pos_c] == out_ids)
    return roc_auc(stream_labels[pos_c[ok]], probs[ok]), probs


def run_demo(
    cfg: Config,
    model: Optional[TrainedModel] = None,
    model_kind: str = "forest",
    out_dir: Optional[str] = None,
    stream_days: Optional[int] = None,
    batch_rows: int = 4096,
    n_devices: int = 1,
    device=None,
) -> dict:
    """Generate → CDC → dimension MERGE → warm-up → score; returns the
    summary dict of the JAX package's ``run_demo``."""
    from real_time_fraud_detection_system_tpu_torch.data.generator import (
        generate_dataset,
    )
    from real_time_fraud_detection_system_tpu_torch.device import (
        resolve_device,
    )

    device = resolve_device(device)
    t0 = time.perf_counter()
    customers, terminals, txs = generate_dataset(cfg.data)
    log.info("generated %d txs, %d customers, %d terminals",
             txs.n, customers.n, terminals.n)

    if model is None:
        from real_time_fraud_detection_system_tpu_torch.models.train import (
            train_model,
        )

        model, train_metrics = train_model(txs, cfg, kind=model_kind,
                                           device=device)
        log.info("trained %s: %s", model_kind, train_metrics)
    else:
        train_metrics = {}
        model_kind = model.kind

    broker = InProcBroker(cfg.runtime.n_partitions)
    epoch0 = date_to_epoch_s(cfg.data.start_date)
    _snapshot_dimensions(broker, customers, terminals, epoch0 * 1000)
    customer_table = sink_dimension_topic(
        broker, "debezium.payment.customers", CUSTOMERS)
    terminal_table = sink_dimension_topic(
        broker, "debezium.payment.terminals", TERMINALS)
    log.info("dimension tables: %d customers, %d terminals",
             len(customer_table), len(terminal_table))

    # The live stream is everything after the training horizon; the
    # engine's feature state warms up by replaying the horizon itself.
    horizon = cfg.train.delta_train_days + cfg.train.delta_delay_days
    if stream_days is not None:
        horizon = max(cfg.data.n_days - stream_days, 0)
    stream_mask = txs.tx_time_days >= horizon
    stream = txs.slice(np.flatnonzero(stream_mask))
    warm = txs.slice(np.flatnonzero(~stream_mask))

    if n_devices > 1:
        from real_time_fraud_detection_system_tpu_torch.runtime.\
            sharded_engine import ShardedScoringEngine

        engine = ShardedScoringEngine(
            cfg, kind=model_kind, params=model.params, scaler=model.scaler,
            n_devices=n_devices, device=device)
    else:
        from real_time_fraud_detection_system_tpu_torch.runtime.engine \
            import ScoringEngine

        engine = ScoringEngine(cfg, kind=model_kind, params=model.params,
                               scaler=model.scaler, device=device)
    if warm.n:
        engine.run(ReplaySource(warm, epoch0, batch_rows=WARM_BATCH_ROWS))

    sink = raw_table = None
    if out_dir is not None:
        from real_time_fraud_detection_system_tpu_torch.io.sink import (
            ParquetSink,
        )
        from real_time_fraud_detection_system_tpu_torch.io.tables import (
            RawTransactionsTable,
        )

        sink = ParquetSink(out_dir)
        # the day-partitioned raw table (the reference's
        # nessie.payment.transactions) lands beside the analyzed parts
        raw_table = RawTransactionsTable(os.path.join(out_dir,
                                                      "transactions"))
    mem = MemorySink()
    tee = FanoutSink(mem, sink, raw_table)
    stats = engine.run(ReplaySource(
        stream, epoch0, batch_rows=batch_rows, mode="envelope",
        n_partitions=cfg.runtime.n_partitions), sink=tee)
    streamed_rows = int(stats["rows"])
    rows_per_s = (streamed_rows / stats["wall_s"] if stats["wall_s"] > 0
                  else 0.0)

    out = mem.concat()
    if not out:  # the horizon covered the whole dataset
        log.warning("no rows streamed (train+delay horizon %d >= %d days); "
                    "nothing to assess", horizon, cfg.data.n_days)
        out = {"tx_id": np.zeros(0, np.int64),
               "prediction": np.zeros(0, np.float64)}
    auc, probs = _stream_auc(out, stream)
    tee.flush()

    summary = {
        "customers": len(customer_table),
        "terminals": len(terminal_table),
        "raw_tx_rows": len(raw_table) if raw_table is not None else 0,
        "warm_rows": int(warm.n),
        "streamed_rows": streamed_rows,
        "rows_per_s": float(rows_per_s),
        "latency_p50_ms": float(stats["latency_p50_ms"]),
        "latency_p99_ms": float(stats["latency_p99_ms"]),
        "stream_auc": float(auc),
        "flagged_at_0.5": int((probs >= 0.5).sum()),
        "train_metrics": train_metrics,
        "wall_s": time.perf_counter() - t0,
    }
    log.info("demo summary: %s", summary)
    return summary
