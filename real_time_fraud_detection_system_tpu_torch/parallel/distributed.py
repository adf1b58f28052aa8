"""Process groups and the 2-axis mesh — port of the JAX package's
``parallel/distributed.py``.

- :func:`initialize_distributed` starts a ``torch.distributed`` process
  group over gloo from explicit arguments or torch's environment
  (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``), a no-op in
  a single process. The group carries the fleet's rendezvous only: the
  serving path has no collective across processes.
- :func:`make_hybrid_mesh` builds the 2-axis ``(dcn, ici)`` mesh as a grid
  ``[n_hosts, devices_per_host]`` of shards (:class:`HybridMesh`). In the
  port a mesh's shards share one device (``parallel/mesh.py``), so the
  grid is that many co-located shards; the sharded step
  (``parallel/step.py::make_sharded_step``) takes it with the axis pair
  and flattens it, as the JAX step treats ``("dcn", "ici")`` as one
  flattened axis.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence, Tuple

import numpy as np

_INITIALIZED = False


def _dist():
    import torch.distributed as dist

    return dist


def process_count() -> int:
    """Processes in the group (1 without one)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_world_size())
    return 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    init_timeout_s: Optional[float] = None,
) -> bool:
    """Start the gloo process group if configured; True when one is up.

    Resolution: explicit arguments, then torch's environment
    (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). Nothing
    configured is a single process: a no-op returning False.
    ``init_timeout_s`` bounds the rendezvous of every process (and any
    later collective), so a mislaunched fleet fails instead of hanging."""
    global _INITIALIZED
    if _INITIALIZED:
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and num_processes is None:
        return False  # single process
    if not coordinator_address or num_processes is None \
            or process_id is None:
        raise ValueError(
            "a process group needs the coordinator address, the process "
            f"count and this process's id (got {coordinator_address!r}, "
            f"{num_processes}, {process_id})")
    timeout = datetime.timedelta(seconds=max(init_timeout_s or 120.0, 1.0))
    _dist().init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
        timeout=timeout)
    _INITIALIZED = True
    return True


def shutdown_distributed() -> None:
    """Destroy the process group (every exit path of a fleet worker calls
    this: the group's store lives in process 0)."""
    global _INITIALIZED
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _INITIALIZED = False


class HybridMesh(tuple):
    """A ``[n_hosts, devices_per_host]`` grid of shards: the tuple of its
    devices in row-major order (what the sharded step and
    ``shard_feature_state`` read), with the grid's ``shape``, ``devices``
    (an object array of that shape) and ``axis_names``."""

    def __new__(cls, grid: np.ndarray, axis_names: Tuple[str, str]):
        obj = super().__new__(cls, tuple(grid.reshape(-1)))
        obj.devices = grid
        obj.axis_names = tuple(axis_names)
        return obj

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.devices.shape)


def make_hybrid_mesh(
    n_hosts: int = 0,
    devices_per_host: int = 0,
    dcn_axis: str = "dcn",
    ici_axis: str = "ici",
    devices: Optional[Sequence] = None,
) -> HybridMesh:
    """The 2-axis ``(dcn, ici)`` mesh: hosts × local shards.

    ``devices`` lists one device per shard (``[d] * n`` co-locates them,
    as everywhere in the port); default every visible CUDA device. As in
    the JAX function, the grid defaults to 2 rows when the count is even
    and above 1, and a grid larger than the devices given raises. Across
    processes the port serves one mesh per process (the fleet), never a
    spanning one, so a process group of several processes raises."""
    from real_time_fraud_detection_system_tpu_torch.device import (
        resolve_device,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
        _check_colocated,
        _visible_devices,
    )

    if process_count() > 1:
        raise ValueError(
            "a mesh spanning processes has no collective on the port's "
            "serving path: each fleet process serves its own mesh "
            "(runtime/distributed.py residue blocks)")
    devs = ([resolve_device(d) for d in devices] if devices is not None
            else _visible_devices())
    if n_hosts == 0 and devices_per_host == 0:
        n_hosts = 2 if len(devs) % 2 == 0 and len(devs) > 1 else 1
    if n_hosts == 0:
        n_hosts = len(devs) // devices_per_host
    if devices_per_host == 0:
        devices_per_host = len(devs) // n_hosts if n_hosts else 0
    need = n_hosts * devices_per_host
    if need == 0 or need > len(devs):
        raise ValueError(
            f"mesh {n_hosts}x{devices_per_host} needs {need or 'at least 1'}"
            f" device(s), {len(devs)} given")
    _check_colocated(tuple(devs[:need]))
    grid = np.empty((n_hosts, devices_per_host), dtype=object)
    for i, d in enumerate(devs[:need]):
        grid[i // devices_per_host, i % devices_per_host] = d
    return HybridMesh(grid, (dcn_axis, ici_axis))


def mesh_axes(mesh) -> Tuple[str, ...]:
    """The mesh's axis names in flattening order, for ``axis=`` of
    ``make_sharded_step`` (a flat mesh is the 1-tuple ``("data",)``)."""
    return tuple(getattr(mesh, "axis_names", ("data",)))


def process_local_batch_slice(n_rows_global: int, mesh) -> slice:
    """Which rows of the globally partitioned batch this process feeds:
    with rows laid out ``[n_shards × rows_per_shard]``, process p's block
    of ``len(mesh) // P`` shards."""
    n_dev = len(mesh)
    per = n_rows_global // n_dev
    local = n_dev // process_count()
    start = process_index() * local * per
    return slice(start, start + local * per)
