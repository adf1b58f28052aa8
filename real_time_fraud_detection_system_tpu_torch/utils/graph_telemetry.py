"""CUDA-graph and device-memory telemetry — the port's counterpart of the
JAX package's ``utils/xla_telemetry.py``.

The JAX engine counts XLA compiles and alarms on a compile after warmup
(``RecompileDetector``, ``rtfds_xla_recompiles_total``). The port's
counterpart of a compiled step is a captured CUDA graph
(``runtime/engine.py::ScoringEngine.precompile``), so:

- :class:`CaptureTelemetry` counts every capture
  (``cuda_graph_captures_total``) and every capture after the engine's
  first precompile (``cuda_graph_recaptures_total``): a params swap that
  changed the shape family, as a JAX reload drops its AOT executables.
  Steady-state serving holds the recaptures at 0. The names carry no
  ``rtfds_`` prefix: no JAX series means a graph capture.
- :class:`DeviceMemoryTelemetry` samples the caching allocator's counters
  into ``rtfds_device_memory_bytes{device, kind=in_use|peak}`` every
  16th batch, the JAX series of the same meaning (bytes in use, peak
  bytes in use; the JAX engine samples each batch). On the CPU it is
  off.
"""

from __future__ import annotations

from typing import Optional

import torch

from real_time_fraud_detection_system_tpu_torch.utils.logging import (
    get_logger,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
    get_registry,
)

log = get_logger("engine")


class CaptureTelemetry:
    """Captures and recaptures of an engine's CUDA graphs."""

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        reg = registry if registry is not None else get_registry()
        self._m_captures = reg.counter(
            "cuda_graph_captures_total",
            "CUDA graphs captured (one per dispatch signature at "
            "precompile, and again on a recapture)")
        self._m_recaptures = reg.counter(
            "cuda_graph_recaptures_total",
            "CUDA graphs captured after the engine's first precompile "
            "(steady-state serving should hold this at 0)")
        self.warm = False  # True once the first precompile finished
        # this engine's own counts (the registry's may be shared) and its
        # captures' wall seconds (warmup excluded)
        self.captures = 0
        self.recaptures = 0
        self.seconds = 0.0

    def note(self, key: tuple, seconds: float) -> None:
        """One capture of the signature ``key``, ``seconds`` long."""
        self._m_captures.inc()
        self.captures += 1
        self.seconds += seconds
        if self.warm:
            self._m_recaptures.inc()
            self.recaptures += 1
            log.warning("CUDA graph for %s recaptured after warmup", key)


class DeviceMemoryTelemetry:
    """``rtfds_device_memory_bytes{device, kind}`` gauges from the caching
    allocator's ``allocated_bytes`` (current and peak), sampled at the
    first batch and every ``EVERY``-th after it. One sample builds the
    allocator's whole statistics dict on the host, so the loop pays it
    once per ``EVERY`` batches; the peak is a high-water mark and misses
    nothing between samples."""

    _KINDS = (("current", "in_use"), ("peak", "peak"))
    EVERY = 16

    def __init__(self, device: torch.device,
                 registry: Optional[MetricsRegistry] = None):
        self._device = device
        self._dead = device.type != "cuda"
        self._ticks = 0
        self.samples = 0
        reg = registry if registry is not None else get_registry()
        self._gauges = {} if self._dead else {
            stat: reg.gauge(
                "rtfds_device_memory_bytes",
                f"device memory from memory_stats(), sampled every "
                f"{self.EVERY} batches", device=str(device.index or 0),
                kind=kind)
            for stat, kind in self._KINDS}

    def tick(self) -> None:
        """One finished batch: sample when the cadence comes round."""
        if self._dead:
            return
        self._ticks += 1
        if (self._ticks - 1) % self.EVERY == 0:
            self.sample()

    def sample(self) -> None:
        if self._dead:
            return
        stats = torch.cuda.memory_stats_as_nested_dict(self._device)
        alloc = stats.get("allocated_bytes", {}).get("all", {})
        for stat, gauge in self._gauges.items():
            gauge.set(float(alloc.get(stat, 0)))
        self.samples += 1
