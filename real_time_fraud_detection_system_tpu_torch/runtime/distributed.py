"""The fleet's topology: process bootstrap and shard ownership — port of
the JAX package's ``runtime/distributed.py``.

The unit of scale-out is an OS process (one per GPU), each serving a
:class:`~.sharded_engine.ShardedScoringEngine` over its own shards. The
host plane is made embarrassingly parallel:

- **Residue-block ownership**: the global shard space has
  ``n_shards_total = num_processes × local_devices`` shards; process p
  owns the contiguous residue block ``key % n_total ∈ [p·L, (p+1)·L)``.
  Because ``p·L ≡ 0 (mod L)``, a key in p's block satisfies ``key % L ==
  (key % n_total) − p·L``: the per-process engine's own ``key % L``
  placement lands each key on the shard the global layout would, so the
  fleet's layout is the single engine's cut into process blocks and the
  engine runs unchanged.
- **Partition-affine ingest**: each process polls only the traffic its
  residues own (:class:`~.sources.PartitionAffineSource`, or a block of
  broker partitions for Kafka), so no row crosses a process on the host,
  and no device collective crosses one on the serving path.

:func:`bootstrap_distributed` initializes a ``torch.distributed`` process
group (gloo: it carries only the rendezvous and barriers) from
:class:`~..config.DistributedConfig` (``--coordinator``,
``--num-processes``, ``--process-id``) and returns the
:class:`ProcessTopology` that every layer threads: the engine labels its
shards globally, sources slice their polls, checkpoints stamp the writer's
topology.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from real_time_fraud_detection_system_tpu_torch.config import (
    DistributedConfig,
)


def _fold_u32(ids: np.ndarray) -> np.ndarray:
    """The uint32 key fold (``core/batch.py::fold_key``, kept here so the
    launcher imports nothing heavy): the identity for ids < 2**32, so the
    residues match the host partitioner's raw modulo."""
    v = np.asarray(ids).astype(np.uint64)
    return ((v ^ (v >> np.uint64(32)))
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@dataclass(frozen=True)
class ProcessTopology:
    """One process's place in the fleet: the residue-block ownership that
    ingest, the engine, checkpoints and telemetry share.

    ``strict_affinity``: the engine refuses polled rows whose customer
    residue it does not own (a mis-wired launcher fails at once instead of
    splitting a key's history across processes)."""

    n_processes: int
    process_id: int
    local_devices: int
    coordinated: bool = False  # a process group was initialized
    strict_affinity: bool = True

    def __post_init__(self):
        if self.n_processes < 1:
            raise ValueError(
                f"n_processes must be >= 1, got {self.n_processes}")
        if not 0 <= self.process_id < self.n_processes:
            raise ValueError(
                f"process_id {self.process_id} out of range for "
                f"{self.n_processes} process(es)")
        if self.local_devices < 1:
            raise ValueError(
                f"local_devices must be >= 1, got {self.local_devices}")

    @property
    def n_shards_total(self) -> int:
        return self.n_processes * self.local_devices

    @property
    def shard_offset(self) -> int:
        """Global id of this process's first shard: local shard j serves
        global shard ``shard_offset + j``, the keys the single
        (n_total)-shard engine routes there."""
        return self.process_id * self.local_devices

    @property
    def owned_shards(self) -> range:
        return range(self.shard_offset,
                     self.shard_offset + self.local_devices)

    def owner_process(self, ids: np.ndarray) -> np.ndarray:
        """The owning process per key (uint32-folded, as the device's
        keys)."""
        res = _fold_u32(ids) % np.uint32(self.n_shards_total)
        return (res // np.uint32(self.local_devices)).astype(np.int64)

    def owns(self, ids: np.ndarray) -> np.ndarray:
        """Which rows' customer keys this process owns."""
        return self.owner_process(ids) == self.process_id

    def kafka_partitions(self, n_partitions: int) -> List[int]:
        """The broker partitions this process consumes: contiguous blocks,
        every partition owned by exactly one process, remainders to the
        low process ids."""
        if n_partitions < self.n_processes:
            raise ValueError(
                f"{n_partitions} Kafka partition(s) cannot feed "
                f"{self.n_processes} processes — repartition the topic "
                "(>= one partition per process) or shrink the fleet")
        per, rem = divmod(n_partitions, self.n_processes)
        start = self.process_id * per + min(self.process_id, rem)
        width = per + (1 if self.process_id < rem else 0)
        return list(range(start, start + width))

    def describe(self) -> dict:
        return {
            "num_processes": self.n_processes,
            "process_id": self.process_id,
            "local_devices": self.local_devices,
            "n_shards_total": self.n_shards_total,
            "owned_shards": [self.owned_shards.start,
                             self.owned_shards.stop],
            "coordinated": self.coordinated,
        }


def bootstrap_distributed(dcfg: DistributedConfig, local_devices: int = 0
                          ) -> Optional[ProcessTopology]:
    """This process's place in the fleet.

    A single-process config (``num_processes == 1``, no coordinator)
    returns None: the same program serves one process and a fleet. With a
    coordinator, the gloo process group is initialized first (a barrier
    over every process, bounded by ``init_timeout_s``: a mislaunched fleet
    fails instead of hanging). Without one (``coordinator == ""``) the
    topology comes from the config alone: an uncoordinated fleet, no
    state shared across processes, so one worker may restart alone.

    A fleet member's id is never defaulted: without ``process_id`` it is
    read from ``RANK``, and with neither a fleet raises (two workers both
    claiming process 0 would serve one residue block twice).

    ``local_devices``: the shards this process serves (``--devices``); 0
    = one per visible CUDA device, at least 1."""
    n_proc = dcfg.num_processes
    pid = dcfg.process_id
    if pid < 0:
        env_pid = os.environ.get("RANK")
        if env_pid is None and n_proc > 1:
            raise ValueError(
                "the fleet's bootstrap needs this process's identity: "
                "pass --process-id (or set RANK) — "
                f"num_processes={n_proc} with no id would silently "
                "serve residue block 0 on every worker")
        pid = int(env_pid or "0")
    if n_proc <= 1 and not dcfg.coordinator:
        return None
    coordinated = False
    if dcfg.coordinator:
        from real_time_fraud_detection_system_tpu_torch.parallel.distributed \
            import initialize_distributed, process_count, process_index

        coordinated = initialize_distributed(
            dcfg.coordinator, n_proc, pid,
            init_timeout_s=dcfg.init_timeout_s)
        if coordinated:
            got = process_count()
            if got != n_proc:
                raise ValueError(
                    f"torch.distributed reports {got} process(es), config "
                    f"says {n_proc} — launcher/flag mismatch")
            pid = process_index()
    if local_devices <= 0:
        import torch

        local_devices = max(torch.cuda.device_count(), 1)
    return ProcessTopology(
        n_processes=n_proc,
        process_id=pid,
        local_devices=local_devices,
        coordinated=coordinated,
        strict_affinity=dcfg.strict_affinity,
    )
