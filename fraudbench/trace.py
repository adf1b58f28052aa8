"""Reduce a ``torch.profiler`` trace of the timed window to what the
per-layer readers and the result's ``breakdown`` read:

- the device's busy seconds: the union of every operation the card ran
  (kernels, copies, fills) inside the window, over the window's length;
- each device operation's seconds and count, by name;
- the window's idle gaps on the device, each credited to what the host
  was doing across most of it: the span of the program (its
  ``rtfds.<phase>`` annotations) or of the benchmark (``fraudbench.*``)
  that covers the most of the gap, else ``other``.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

WINDOW_LABEL = "fraudbench.window"


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[list] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _host_label(name: str) -> str:
    return name.split("#", 1)[0]


def profiler_events(prof) -> List[tuple]:
    """``(name, on_device, start µs, end µs)`` of every event a stopped
    ``torch.profiler.profile`` recorded, read from its Kineto results
    (building the profiler's ``events()`` tree costs ~70 µs an event)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-3
        out.append((e.name(), e.device_type() == DeviceType.CUDA, s,
                    s + e.duration_ns() * 1e-3))
    return out


def reduce_events(events: List[tuple],
                  window: Tuple[float, float] = None) -> dict:
    """``events`` as :func:`profiler_events` gives them. The window is the
    ``fraudbench.window`` range (or ``window`` in µs)."""
    dev, host = [], []
    for name, on_device, a, b in events:
        if on_device:
            dev.append((name, a, b))
        elif name == WINDOW_LABEL and window is None:
            window = (a, b)
        elif name.startswith(("rtfds.", "fraudbench.")):
            host.append((_host_label(name), a, b))
    if window is None:
        raise ValueError("the trace holds no window range")
    w0, w1 = window
    ops: Dict[str, list] = defaultdict(lambda: [0.0, 0])
    iv = []
    for name, a, b in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ops[name][0] += (b - a) * 1e-6
        ops[name][1] += 1
        iv.append((a, b))
    busy = _union(iv)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < w1:
        gaps.append((t, w1))
    names = sorted({h[0] for h in host})
    code = {n: i for i, n in enumerate(names)}
    hs = np.array([h[1] for h in host], dtype=np.float64)
    he = np.array([h[2] for h in host], dtype=np.float64)
    hc = np.array([code[h[0]] for h in host], dtype=np.int64)
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        cover = np.clip(np.minimum(he, b) - np.maximum(hs, a), 0.0, None)
        per = np.bincount(hc, weights=cover, minlength=len(names))
        top = names[int(per.argmax())] if per.size and per.max() > 0 \
            else "other"
        idle[top] += (b - a) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy_s,
        "ops": {k: {"s": v[0], "n": v[1]} for k, v in ops.items()},
        "idle_by_host": dict(idle),
    }


_WHAT = re.compile(
    r"(masked_fill|index_put|index_fill|index_kernel|scatter_gather|"
    r"scatter_add|Reduce[A-Za-z]+|[A-Za-z]+Functor[A-Za-z_]*|[A-Za-z]+Ops\b|"
    r"direct_copy|pow_tensor_scalar|sort[A-Za-z_]*|cum[a-z]+|radix[A-Za-z_]*)")


_GENERIC = {"BinaryFunctor", "ReduceOp", "index_kernel"}


def short_name(name: str) -> str:
    """A device operation's name without its template arguments: the
    function, and the first operator named inside them."""
    base = name[5:] if name.startswith("void ") else name
    base = base.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", base, 1)[0].strip()
    found = [m.group(1) for m in _WHAT.finditer(base[len(head):])]
    what = next((w for w in found if w not in _GENERIC), None) or next(
        iter(found), None)
    return (f"{head}[{what}]" if what else head)[:120]


def breakdown(red: dict, top: int = 10) -> dict:
    agg: Dict[str, float] = defaultdict(float)
    for k, v in red["ops"].items():
        agg[short_name(k)] += v["s"]
    ops = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(red["idle_by_host"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
