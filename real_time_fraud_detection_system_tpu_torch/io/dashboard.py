"""Static-HTML fraud-ops dashboard over the analyzed output — the port's
own copy of the JAX package's ``io/dashboard.py``: the same pages, byte
for byte, from the same inputs.

The reference ships Superset pre-wired to Trino over
``nessie.payment.analyzed_transactions`` (``superset/entrypoint.sh:19``,
``docker-compose.yml:141-161``) as its L5 visualization layer. This module
is the in-process equivalent: it renders the canned aggregations from
:mod:`.query` into ONE self-contained HTML file — no server, no JS/CSS
dependencies, works offline and over ``file://`` — so a deployment without
the Trino/Superset stack still gets the dashboard, and one WITH the stack
can keep using Superset on the unchanged Parquet output.

Views (mirroring the reference dashboard's charts over
``analyzed_transactions``):

- headline stat tiles (volume, flags, amounts, score tail)
- transactions-per-bucket and flag-rate-per-bucket time series
  (two charts, one y-axis each — never dual-axis)
- top risky terminals / customers (the scenario-2 / scenario-3 detection
  surfaces, ``data_generator.ipynb · cell 42``) as bar charts
- the recent-alerts work queue as a table

Every chart carries a hover tooltip layer, a ``<details>`` table-view twin
(values are never color- or hover-gated), and light/dark theming driven by
``prefers-color-scheme``.
"""

from __future__ import annotations

import html
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from real_time_fraud_detection_system_tpu_torch.io.query import (
    drift_report,
    fraud_rate_over_time,
    load_analyzed,
    recent_alerts,
    summary_stats,
    top_risky_customers,
    top_risky_terminals,
)

_US = 1_000_000

# Chart geometry (CSS px). Bars stay <= 24px thick per the mark spec.
_W, _H = 640, 200
_PAD_L, _PAD_R, _PAD_T, _PAD_B = 46, 14, 10, 22
_BAR_H = 18


def _esc(v) -> str:
    return html.escape(str(v), quote=True)


def _compact(v: float, money: bool = False) -> str:
    """1,284 / 12.9K / $4.2M — stat-tile value formatting."""
    sign = "-" if v < 0 else ""
    a = abs(float(v))
    pre = "$" if money else ""
    if a >= 1e9:
        s = f"{a / 1e9:.1f}B"
    elif a >= 1e6:
        s = f"{a / 1e6:.1f}M"
    elif a >= 10_000:
        s = f"{a / 1e3:.1f}K"
    elif money:
        s = f"{a:,.2f}"
    elif a == int(a):
        s = f"{int(a):,}"
    else:
        s = f"{a:,.3g}"
    return f"{sign}{pre}{s}"


def _nice_max(v: float) -> float:
    """Round up to a clean axis maximum (1/2/2.5/5 × 10^k)."""
    if v <= 0:
        return 1.0
    exp = np.floor(np.log10(v))
    for m in (1.0, 2.0, 2.5, 5.0, 10.0):
        top = m * 10.0 ** exp
        if v <= top:
            return float(top)
    return float(10.0 ** (exp + 1))


def _day_label(us: int) -> str:
    t = time.gmtime(int(us) // _US)
    return f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d}"


def _hour_label(us: int) -> str:
    t = time.gmtime(int(us) // _US)
    return (f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d} "
            f"{t.tm_hour:02d}:00")


def _ts_label(us: int) -> str:
    """Full minute-resolution timestamp (alert rows, not bucket labels)."""
    t = time.gmtime(int(us) // _US)
    return (f"{t.tm_year:04d}-{t.tm_mon:02d}-{t.tm_mday:02d} "
            f"{t.tm_hour:02d}:{t.tm_min:02d}")


def _table_twin(headers: Sequence[str], rows: Sequence[Sequence[str]]) -> str:
    """The <details> table view — the WCAG-clean twin of every chart."""
    head = "".join(f"<th>{_esc(h)}</th>" for h in headers)
    body = "".join(
        "<tr>" + "".join(f"<td>{_esc(c)}</td>" for c in r) + "</tr>"
        for r in rows
    )
    return ("<details class='twin'><summary>Table view</summary>"
            f"<table><thead><tr>{head}</tr></thead>"
            f"<tbody>{body}</tbody></table></details>")


def _grid_and_yticks(vmax: float, fmt=lambda v: _compact(v)) -> str:
    """4 hairline gridlines + clean tick labels along the left edge."""
    out = []
    ph = _H - _PAD_T - _PAD_B
    for i in range(5):
        frac = i / 4
        y = _PAD_T + ph * (1 - frac)
        out.append(
            f"<line class='grid' x1='{_PAD_L}' y1='{y:.1f}' "
            f"x2='{_W - _PAD_R}' y2='{y:.1f}'/>"
        )
        out.append(
            f"<text class='tick' x='{_PAD_L - 6}' y='{y + 3:.1f}' "
            f"text-anchor='end'>{_esc(fmt(vmax * frac))}</text>"
        )
    return "".join(out)


def _line_chart(
    xs_label: List[str],
    ys: np.ndarray,
    *,
    unit: str = "",
    percent: bool = False,
) -> str:
    """Single-series line with area wash, end marker, hover layer.

    One series → no legend box (the card title names it); the endpoint
    value is the one direct label.
    """
    n = len(ys)
    if n == 0:
        return "<p class='empty'>no data</p>"
    pw = _W - _PAD_L - _PAD_R
    ph = _H - _PAD_T - _PAD_B
    vmax = _nice_max(float(np.max(ys)) if n else 1.0)
    if percent:
        vmax = max(vmax, 0.05)

    def px(i: int) -> float:
        return _PAD_L + (pw * (i + 0.5) / n)

    def py(v: float) -> float:
        return _PAD_T + ph * (1.0 - float(v) / vmax)

    fmt = (lambda v: f"{100 * v:.3g}%") if percent else _compact
    pts = " ".join(f"{px(i):.1f},{py(ys[i]):.1f}" for i in range(n))
    area = (f"{_PAD_L + pw * 0.5 / n:.1f},{_PAD_T + ph} {pts} "
            f"{px(n - 1):.1f},{_PAD_T + ph}")
    ex, ey = px(n - 1), py(ys[n - 1])
    # keep the one direct label inside the plot even at the axis maximum
    label_y = max(ey - 8.0, _PAD_T + 10.0)
    # Full-band transparent hit columns: targets far bigger than the mark.
    hits = "".join(
        f"<rect class='hit' x='{_PAD_L + pw * i / n:.1f}' y='{_PAD_T}' "
        f"width='{pw / n:.2f}' height='{ph}' tabindex='0' "
        f"data-tip='{_esc(xs_label[i])}: {_esc(fmt(ys[i]))}{_esc(unit)}'>"
        "</rect>"
        for i in range(n)
    )
    x_first, x_last = _esc(xs_label[0]), _esc(xs_label[-1])
    return f"""<svg viewBox='0 0 {_W} {_H}' role='img'>
{_grid_and_yticks(vmax, fmt)}
<line class='axis' x1='{_PAD_L}' y1='{_PAD_T + ph}' x2='{_W - _PAD_R}' y2='{_PAD_T + ph}'/>
<polygon class='wash' points='{area}'/>
<polyline class='line' points='{pts}'/>
<circle class='dot' cx='{ex:.1f}' cy='{ey:.1f}' r='4'/>
<text class='endlabel' x='{ex - 6:.1f}' y='{label_y:.1f}' text-anchor='end'>{_esc(fmt(ys[-1]))}</text>
<text class='tick' x='{_PAD_L}' y='{_H - 6}'>{x_first}</text>
<text class='tick' x='{_W - _PAD_R}' y='{_H - 6}' text-anchor='end'>{x_last}</text>
{hits}
</svg>"""


def _bar_path(x: float, y: float, w: float, h: float, r: float = 4.0) -> str:
    """Horizontal bar: square at the baseline (left), 4px rounded data-end."""
    r = min(r, w / 2, h / 2)
    return (f"M{x:.1f},{y:.1f} h{w - r:.1f} "
            f"a{r},{r} 0 0 1 {r},{r} v{h - 2 * r:.1f} "
            f"a{r},{r} 0 0 1 -{r},{r} h-{w - r:.1f} z")


def _hbar_chart(labels: List[str], values: np.ndarray, counts: np.ndarray,
                *, vmax: float = 1.0, key_name: str = "key") -> str:
    """Horizontal single-series bars (mean score 0..vmax), value at the tip."""
    n = len(labels)
    if n == 0:
        return "<p class='empty'>no data</p>"
    label_w = 90
    pw = _W - label_w - 60
    h = n * (_BAR_H + 8) + 8
    rows = []
    for i in range(n):
        y = 4 + i * (_BAR_H + 8)
        w = max(2.0, pw * float(values[i]) / vmax)
        tip = (f"{key_name} {labels[i]}: score {values[i]:.3f} "
               f"over {int(counts[i])} txs")
        rows.append(
            f"<text class='lab' x='{label_w - 8}' y='{y + _BAR_H - 5}' "
            f"text-anchor='end'>{_esc(labels[i])}</text>"
            f"<path class='bar' d='{_bar_path(label_w, y, w, _BAR_H)}'/>"
            f"<text class='val' x='{label_w + w + 6:.1f}' "
            f"y='{y + _BAR_H - 5}'>{values[i]:.3f}</text>"
            f"<rect class='hit' x='0' y='{y - 4}' width='{_W}' "
            f"height='{_BAR_H + 8}' tabindex='0' data-tip='{_esc(tip)}'>"
            "</rect>"
        )
    return (f"<svg viewBox='0 0 {_W} {h}' role='img'>"
            f"<line class='axis' x1='{label_w}' y1='0' x2='{label_w}' "
            f"y2='{h}'/>" + "".join(rows) + "</svg>")


def _tiles(s: dict, drift: Optional[dict] = None) -> str:
    if s.get("transactions", 0) == 0:
        return "<p class='empty'>no analyzed transactions</p>"
    thr = s["threshold"]
    tiles = [
        ("Transactions", _compact(s["transactions"]), ""),
        ("Flagged", _compact(s["flagged"]),
         f"{100 * s['flagged_rate']:.2f}% at threshold {thr:g}"),
        ("Flagged amount", _compact(s["flagged_amount"], money=True),
         f"of {_compact(s['total_amount'], money=True)} total"),
        ("Customers", _compact(s["customers"]), ""),
        ("Terminals", _compact(s["terminals"]), ""),
        ("Score p99", f"{s['score_p99']:.3f}",
         f"median {s['score_p50']:.3f}"),
    ]
    out = []
    for label, value, sub in tiles:
        subdiv = f"<div class='sub'>{_esc(sub)}</div>" if sub else ""
        out.append(f"<div class='tile'><div class='lbl'>{_esc(label)}</div>"
                   f"<div class='num'>{_esc(value)}</div>{subdiv}</div>")
    if drift and drift.get("valid"):
        # the documented PSI bands (_psi docstring): <0.1 stable,
        # 0.1–0.25 drifting (early warning), >0.25 shifted. Status color
        # rides ONLY the icon glyph; the word stays in text ink (status
        # colors are sub-contrast for text on the light surface).
        psi = drift["prediction_psi"]
        if psi > 0.25:
            badge = "<span class='ico serious'>▲</span> shifted"
        elif psi > 0.1:
            badge = "<span class='ico warning'>▲</span> drifting"
        else:
            badge = "<span class='ico good'>●</span> stable"
        out.append(
            "<div class='tile'><div class='lbl'>Score drift (PSI)</div>"
            f"<div class='num'>{psi:.3f}</div>"
            f"<div class='sub'>{badge} vs first half · amount PSI "
            f"{drift['amount_psi']:.3f}</div></div>")
    return "<div class='tiles'>" + "".join(out) + "</div>"


_CSS = """
:root { color-scheme: light dark; }
.viz {
  --surface: #fcfcfb; --plane: #f9f9f7;
  --ink: #0b0b0b; --ink2: #52514e; --muted: #898781;
  --grid: #e1e0d9; --axis: #c3c2b7;
  --s1: #2a78d6; --border: rgba(11,11,11,0.10);
  --st-good: #0ca30c; --st-warn: #fab219; --st-serious: #ec835a;
  font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
  color: var(--ink); background: var(--plane);
  margin: 0; padding: 24px; min-height: 100vh; box-sizing: border-box;
}
@media (prefers-color-scheme: dark) { .viz {
  --surface: #1a1a19; --plane: #0d0d0d;
  --ink: #ffffff; --ink2: #c3c2b7;
  --grid: #2c2c2a; --axis: #383835;
  --s1: #3987e5; --border: rgba(255,255,255,0.10);
}}
.viz h1 { font-size: 20px; margin: 0 0 2px; }
.viz .meta { color: var(--ink2); margin-bottom: 20px; }
.tiles { display: flex; flex-wrap: wrap; gap: 12px; margin-bottom: 20px; }
.tile { background: var(--surface); border: 1px solid var(--border);
  border-radius: 8px; padding: 12px 16px; min-width: 132px; }
.tile .lbl { color: var(--ink2); font-size: 12px; }
.tile .num { font-size: 26px; font-weight: 600; }
.tile .sub { color: var(--muted); font-size: 12px; }
.ico.good { color: var(--st-good); }
.ico.warning { color: var(--st-warn); }
.ico.serious { color: var(--st-serious); }
.cards { display: grid; gap: 16px;
  grid-template-columns: repeat(auto-fit, minmax(360px, 1fr)); }
.card { background: var(--surface); border: 1px solid var(--border);
  border-radius: 8px; padding: 14px 16px; overflow: hidden; }
.card h2 { font-size: 14px; font-weight: 600; margin: 0 0 10px; }
.card svg { width: 100%; height: auto; display: block; }
.grid { stroke: var(--grid); stroke-width: 1; }
.axis { stroke: var(--axis); stroke-width: 1; }
.line { fill: none; stroke: var(--s1); stroke-width: 2;
  stroke-linejoin: round; stroke-linecap: round; }
.wash { fill: var(--s1); opacity: 0.1; }
.dot { fill: var(--s1); stroke: var(--surface); stroke-width: 2; }
.bar { fill: var(--s1); }
.tick, .lab, .val, .endlabel { font-size: 11px; fill: var(--muted); }
.tick { font-variant-numeric: tabular-nums; }
.lab { fill: var(--ink2); }
.val, .endlabel { fill: var(--ink2); font-variant-numeric: tabular-nums; }
.hit { fill: transparent; outline: none; }
.hit:focus-visible { stroke: var(--s1); stroke-width: 1; }
.empty { color: var(--muted); }
.twin summary { color: var(--ink2); font-size: 12px; cursor: pointer;
  margin-top: 8px; }
.twin table { border-collapse: collapse; margin-top: 6px; width: 100%;
  font-size: 12px; font-variant-numeric: tabular-nums; }
.twin th, .twin td, .alerts th, .alerts td {
  text-align: left; padding: 3px 10px 3px 0;
  border-bottom: 1px solid var(--grid); }
.twin th, .alerts th { color: var(--ink2); font-weight: 600; }
.alerts table { border-collapse: collapse; width: 100%; font-size: 13px;
  font-variant-numeric: tabular-nums; }
#tip { position: fixed; display: none; pointer-events: none;
  background: var(--ink); color: var(--surface); padding: 4px 8px;
  border-radius: 4px; font-size: 12px; z-index: 10; max-width: 320px; }
"""

_JS = """
var tip = document.getElementById('tip');
function show(el, x, y) {
  tip.textContent = el.getAttribute('data-tip');
  tip.style.display = 'block';
  var w = tip.offsetWidth, vw = window.innerWidth;
  tip.style.left = Math.min(x + 12, vw - w - 8) + 'px';
  tip.style.top = (y + 14) + 'px';
}
document.querySelectorAll('[data-tip]').forEach(function (el) {
  el.addEventListener('mousemove', function (e) { show(el, e.clientX, e.clientY); });
  el.addEventListener('mouseleave', function () { tip.style.display = 'none'; });
  el.addEventListener('focus', function () {
    var r = el.getBoundingClientRect(); show(el, r.left, r.top + r.height / 2);
  });
  el.addEventListener('blur', function () { tip.style.display = 'none'; });
});
"""


def render_dashboard_html(
    cols: Dict[str, np.ndarray],
    *,
    threshold: float = 0.5,
    top_k: int = 10,
    bucket: str = "day",
    title: str = "Fraud detection — analyzed transactions",
) -> str:
    """Render the full dashboard for an analyzed column dict."""
    s = summary_stats(cols, threshold)
    n = s.get("transactions", 0)
    drift = drift_report(cols, threshold=threshold) if n else None
    gen = time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime())
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_esc(title)}</title>",
        "<meta name='viewport' content='width=device-width, initial-scale=1'>",
        f"<style>{_CSS}</style></head><body class='viz'>",
        f"<h1>{_esc(title)}</h1>",
        f"<div class='meta'>generated {gen} · threshold "
        f"{threshold:g} · bucket {_esc(bucket)}</div>",
        _tiles(s, drift),
    ]
    if n:
        lab = _day_label if bucket == "day" else _hour_label
        ts = fraud_rate_over_time(cols, bucket, threshold)
        xs = [lab(u) for u in ts["bucket_start_us"]]
        vol_twin = _table_twin(
            (bucket, "transactions", "amount"),
            [(xs[i], int(ts["transactions"][i]), f"{ts['amount'][i]:,.2f}")
             for i in range(len(xs))])
        rate_twin = _table_twin(
            (bucket, "flagged", "flag rate"),
            [(xs[i], int(ts["flagged"][i]),
              f"{100 * ts['flag_rate'][i]:.2f}%")
             for i in range(len(xs))])
        def top_card(title: str, key_name: str, top: dict) -> str:
            key_col = f"{key_name}_id"
            chart = _hbar_chart([str(k) for k in top[key_col]],
                                top["mean_score"], top["transactions"],
                                key_name=key_name)
            twin = _table_twin(
                (key_name, "txs", "mean score", "flagged", "amount"),
                [(int(top[key_col][i]), int(top["transactions"][i]),
                  f"{top['mean_score'][i]:.3f}", int(top["flagged"][i]),
                  f"{top['amount'][i]:,.2f}")
                 for i in range(len(top[key_col]))])
            return (f"<div class='card'><h2>{_esc(title)}</h2>"
                    f"{chart}{twin}</div>")

        term = top_risky_terminals(cols, top_k, threshold)
        cust = top_risky_customers(cols, top_k, threshold)
        alerts = recent_alerts(cols, threshold, limit=top_k)
        alert_rows = "".join(
            "<tr>"
            f"<td>{int(alerts['tx_id'][i])}</td>"
            f"<td>{_esc(_ts_label(alerts['tx_datetime_us'][i]))}</td>"
            f"<td>{int(alerts['customer_id'][i])}</td>"
            f"<td>{int(alerts['terminal_id'][i])}</td>"
            f"<td>{alerts['tx_amount'][i]:,.2f}</td>"
            f"<td>{alerts['prediction'][i]:.3f}</td></tr>"
            for i in range(len(alerts["tx_id"]))
        ) or "<tr><td colspan='6'>none</td></tr>"
        parts += [
            "<div class='cards'>",
            "<div class='card'><h2>Transactions per "
            f"{_esc(bucket)}</h2>",
            _line_chart(xs, ts["transactions"].astype(np.float64)),
            vol_twin, "</div>",
            "<div class='card'><h2>Flag rate per "
            f"{_esc(bucket)}</h2>",
            _line_chart(xs, ts["flag_rate"], percent=True),
            rate_twin, "</div>",
            top_card("Top risky terminals (mean score)", "terminal", term),
            top_card("Top risky customers (mean score)", "customer", cust),
            "<div class='card alerts'><h2>Recent alerts</h2>",
            "<table><thead><tr><th>tx</th><th>time</th><th>customer</th>"
            "<th>terminal</th><th>amount</th><th>score</th></tr></thead>"
            f"<tbody>{alert_rows}</tbody></table></div>",
            "</div>",
        ]
    parts += [f"<div id='tip'></div><script>{_JS}</script></body></html>"]
    return "".join(parts)


# ---------------------------------------------------------------------------
# Ops-health view: the flight-record twin of the analyzed-output dashboard
# ---------------------------------------------------------------------------

# Engine loop-time decomposition, in pipeline order (matches
# runtime.engine.PHASES; duplicated here so the io layer renders flight
# records from any producer without importing the runtime).
_OPS_PHASES = ("source_poll", "host_prep", "dispatch", "result_wait",
               "sink_write")

_EVENT_CLASS = {"fault": "serious", "restart": "serious",
                "poison": "serious", "dead_letter": "serious",
                "gave_up": "serious", "checkpoint_fallback": "serious",
                "checkpoint": "info", "feedback": "good",
                # overload ladder (runtime/overload.py): climbs and
                # rung-3 deferral are warnings (degraded, surviving);
                # descents and in-order replays are recovery
                "overload_climb": "warning", "shed": "warning",
                "overload_descend": "good", "replay": "good",
                # continuous-learning plane (runtime/learner.py)
                "model_published": "info", "model_candidate": "info",
                "model_reload": "info", "model_promoted": "good",
                "model_canary_passed": "good",
                "model_rollback": "serious",
                "model_promote_refused": "serious",
                "model_artifact_corrupt": "serious"}


def _downsample_max(ys: np.ndarray, limit: int = 240):
    """Aggregate to <= limit points by windowed MAX (spikes — the thing
    an ops view exists to show — survive; means would flatten them).
    Returns (values, window) where window is the batches-per-point."""
    n = len(ys)
    if n <= limit:
        return ys, 1
    w = -(-n // limit)
    pad = (-n) % w
    padded = np.concatenate([ys, np.full(pad, -np.inf)]) if pad else ys
    return padded.reshape(-1, w).max(axis=1), w


def _event_strip(events: List[dict], t0: float, t1: float) -> str:
    """Fault/feedback/checkpoint/restart markers on the run's time axis."""
    if not events:
        return "<p class='empty'>no events</p>"
    h = 46
    span = max(t1 - t0, 1e-9)
    marks = []
    for ev in events:
        # clamp: events outside the batch span (e.g. a checkpoint
        # restore before the first batch finished) stay on-axis
        frac = min(max((float(ev.get("t", t0)) - t0) / span, 0.0), 1.0)
        x = _PAD_L + (_W - _PAD_L - _PAD_R) * frac
        kind = str(ev.get("event", "?"))
        cls = _EVENT_CLASS.get(kind, "info")
        detail = ", ".join(
            f"{k}={v}" for k, v in ev.items()
            if k not in ("kind", "t", "event"))
        tip = f"{kind}" + (f" ({detail})" if detail else "")
        marks.append(
            f"<line class='ev {cls}' x1='{x:.1f}' y1='8' x2='{x:.1f}' "
            f"y2='{h - 16}'/>"
            f"<rect class='hit' x='{x - 5:.1f}' y='0' width='10' "
            f"height='{h}' tabindex='0' data-tip='{_esc(tip)}'></rect>"
        )
    axis = (f"<line class='axis' x1='{_PAD_L}' y1='{h - 14}' "
            f"x2='{_W - _PAD_R}' y2='{h - 14}'/>")
    return (f"<svg viewBox='0 0 {_W} {h}' role='img'>{axis}"
            + "".join(marks) + "</svg>")


def _cluster_tile(events: List[dict], man: dict):
    """Cluster tile (multi-host fleets): worst process leads, mirroring
    the worst-shard convention — the slowest/most-restarted process is
    the one gating fleet throughput. None unless the record carries
    cluster events (the launcher's flight record), so single-process
    runs keep a clean tile row. Shared by the full ops view and the
    no-batch-records path: the launcher's own record has no batch lines
    by construction, and a fleet that died before serving is exactly
    when the tile matters."""
    cl_workers = [e for e in events
                  if e.get("event") == "cluster_worker"]
    fleet_restarts = [e for e in events
                      if e.get("event") == "fleet_restart"]
    worker_restarts = [e for e in events
                       if e.get("event") == "cluster_worker_restart"]
    if not (cl_workers or fleet_restarts or worker_restarts):
        return None
    # last exit record per process (a restarted worker reports twice)
    by_proc = {}
    for e in cl_workers:
        by_proc[e.get("process")] = e
    n_proc = (man.get("multihost") or {}).get("processes", len(by_proc))
    sub_bits = []
    failed = [p for p, e in by_proc.items()
              if e.get("rc") not in (0, None)]
    if by_proc:
        worst_p, worst_e = min(
            by_proc.items(),
            key=lambda kv: float(kv[1].get("rows_per_s", 0.0) or 0.0))
        sub_bits.append(
            f"worst p{worst_p}: "
            f"{_compact(float(worst_e.get('rows_per_s', 0.0) or 0.0))}"
            "/s")
    if failed:
        sub_bits.insert(0, f"{len(failed)} worker(s) FAILED "
                           f"{sorted(failed)[:4]}")
    if fleet_restarts:
        sub_bits.append(f"{len(fleet_restarts)} fleet restart(s)")
    if worker_restarts:
        sub_bits.append(f"{len(worker_restarts)} worker restart(s)")
    return ("Cluster", f"{n_proc} proc", " · ".join(sub_bits))


def _elasticity_tile(events: List[dict], man: dict):
    """Elasticity tile (autoscaled fleets): every resize the launcher
    walked — completed, rolled back (and at which phase), the last
    topology change and how long it took. None unless the record
    carries resize events or the manifest says the run was autoscaled,
    so fixed fleets keep a clean tile row."""
    begins = [e for e in events if e.get("event") == "resize_begin"]
    completes = [e for e in events
                 if e.get("event") == "resize_complete"]
    rollbacks = [e for e in events
                 if e.get("event") == "resize_rollback"]
    autoscaled = bool((man.get("multihost") or {}).get("autoscale"))
    if not (begins or completes or rollbacks or autoscaled):
        return None
    sub_bits = []
    if rollbacks:
        stages = sorted({str(e.get("stage", "?")) for e in rollbacks})
        sub_bits.append(f"{len(rollbacks)} rolled back "
                        f"at {'/'.join(stages)}")
    if completes:
        last = completes[-1]
        sub_bits.append(
            f"last {last.get('direction', '?')} -> "
            f"{last.get('processes', '?')} proc in "
            f"{float(last.get('seconds', 0.0) or 0.0):.1f}s "
            f"(gen {last.get('generation', '?')})")
    elif begins:
        last = begins[-1]
        sub_bits.append(f"last attempt {last.get('current', '?')} -> "
                        f"{last.get('target', '?')}")
    if not sub_bits:
        sub_bits.append("no resizes: pressure never held a dwell")
    value = (f"{len(completes)} resize(s)" if not rollbacks
             else f"{len(completes)} ok / {len(rollbacks)} back")
    return ("Elasticity", value, " · ".join(sub_bits))


def render_ops_html(
    manifest: Optional[dict],
    records: List[dict],
    *,
    title: str = "Fraud detection — ops health",
) -> str:
    """Render the flight-record ops view: run manifest tiles, per-phase
    latency time series (one chart per phase, batch-indexed), and the
    fault/feedback/checkpoint/restart event strip."""
    batches = [r for r in records if r.get("kind") == "batch"]
    events = [r for r in records if r.get("kind") == "event"]
    gen = time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime())
    man = manifest or {}
    meta_bits = [f"generated {gen}"]
    for k in ("backend", "model_kind", "n_devices", "config_hash"):
        if man.get(k) not in (None, ""):
            meta_bits.append(f"{k} {man[k]}")
    parts = [
        "<!doctype html><html><head><meta charset='utf-8'>",
        f"<title>{_esc(title)}</title>",
        "<meta name='viewport' content='width=device-width, "
        "initial-scale=1'>",
        f"<style>{_CSS}"
        ".ev { stroke-width: 2; }"
        ".ev.serious { stroke: var(--st-serious); }"
        ".ev.warning { stroke: var(--st-warn); }"
        ".ev.good { stroke: var(--st-good); }"
        ".ev.info { stroke: var(--s1); }"
        "</style></head><body class='viz'>",
        f"<h1>{_esc(title)}</h1>",
        f"<div class='meta'>{_esc(' · '.join(meta_bits))}</div>",
    ]
    if not batches:
        # A run that died before its first batch completed is exactly
        # where the event strip matters most (the fault/restart events
        # explain the death) — render them even with no batch records.
        # A launcher flight record is batch-less by construction: its
        # Cluster tile still renders.
        lead_tiles = [t for t in (_cluster_tile(events, man),
                                  _elasticity_tile(events, man))
                      if t is not None]
        if lead_tiles:
            cells = []
            for label, value, sub in lead_tiles:
                subdiv = (f"<div class='sub'>{_esc(sub)}</div>"
                          if sub else "")
                cells.append(
                    "<div class='tile'>"
                    f"<div class='lbl'>{_esc(label)}</div>"
                    f"<div class='num'>{_esc(value)}</div>{subdiv}"
                    "</div>")
            parts.append(f"<div class='tiles'>{''.join(cells)}</div>")
        parts.append("<p class='empty'>no batch records</p>")
        if events:
            t0 = float(events[0].get("t", 0.0))
            t1 = float(events[-1].get("t", t0))
            ev_twin = _table_twin(
                ("time", "event", "detail"),
                [(_ts_label(int(float(e.get("t", t0)) * _US)),
                  str(e.get("event", "?")),
                  ", ".join(f"{k}={v}" for k, v in e.items()
                            if k not in ("kind", "t", "event")))
                 for e in events])
            parts += [
                "<div class='cards'><div class='card'><h2>Events"
                "</h2>", _event_strip(events, t0, t1), ev_twin,
                "</div></div>",
            ]
        parts += [f"<div id='tip'></div><script>{_JS}</script>"
                  "</body></html>"]
        return "".join(parts)

    rows_total = sum(int(b.get("rows", 0)) for b in batches)
    lat = np.asarray([float(b.get("latency_s", 0.0)) for b in batches])
    t_first = float(batches[0].get("t", 0.0))
    t_last = float(batches[-1].get("t", t_first))
    span_s = t_last - t_first
    if span_s <= 0:
        # single-batch record: timestamps carry no span — fall back to
        # the batches' own latency rather than headline nonsense
        span_s = float(lat.sum())
    throughput = (f"{_compact(rows_total / span_s)}/s" if span_s > 0
                  else "—")
    n_faults = sum(1 for e in events if e.get("event") == "fault")
    n_restarts = sum(1 for e in events if e.get("event") == "restart")
    n_dlq = sum(int(e.get("rows", 0)) for e in events
                if e.get("event") == "dead_letter")
    n_poison = sum(1 for e in events if e.get("event") == "poison"
                   and e.get("phase") == "detected")
    tiles = [
        ("Batches", _compact(len(batches)), ""),
        ("Rows", _compact(rows_total), ""),
        ("Throughput", throughput, "rows over the record span"),
        ("Batch p50", f"{np.percentile(lat, 50) * 1e3:.2f} ms",
         f"p99 {np.percentile(lat, 99) * 1e3:.2f} ms"),
        ("Faults injected", _compact(n_faults),
         f"{n_restarts} restarts" if n_restarts else ""),
        ("Dead-letter rows", _compact(n_dlq),
         f"{n_poison} crash loop(s)" if n_poison else
         "quarantined (crash + nonfinite)"),
        ("Checkpoints", _compact(sum(
            1 for e in events if e.get("event") == "checkpoint"
            and e.get("op") == "save")), ""),
    ]
    # Durable-state tile: corrupt checkpoints stepped over on restore.
    # A clean run earns a quiet "verified" tile; any fallback paints the
    # count of quarantined entries plus what finally served.
    ck_fallbacks = [e for e in events
                    if e.get("event") == "checkpoint_fallback"]
    n_quarantined = sum(1 for e in ck_fallbacks if e.get("path"))
    restored = [e for e in ck_fallbacks if e.get("restored")]
    if ck_fallbacks:
        sub = (f"restored {restored[-1]['restored']}"
               if restored else "no valid checkpoint survived")
        tiles.append(("Durable state",
                      f"{_compact(n_quarantined)} corrupt", sub))
    else:
        tiles.append(("Durable state", "verified",
                      "restores re-checksummed, no fallback"))
    # Overload tile: did the run degrade, how far, and did everything
    # deferred come back? Only rendered when the ladder actually moved
    # (any overload_* / shed / replay event), so steady runs keep a
    # clean tile row. Replay deficit (shed > replayed) is the headline
    # problem state: deferred rows never re-entered the stream.
    climbs = [e for e in events if e.get("event") == "overload_climb"]
    descends = [e for e in events
                if e.get("event") == "overload_descend"]
    shed_rows = sum(int(e.get("rows", 0)) for e in events
                    if e.get("event") == "shed")
    replayed_rows = sum(int(e.get("rows", 0)) for e in events
                        if e.get("event") == "replay")
    if climbs or descends or shed_rows or replayed_rows:
        top_rung = max([int(e.get("rung", 0)) for e in climbs],
                       default=0)
        # chronological last transition (the events list is in record
        # order): climbs+descends concatenated would misreport any run
        # whose second overload episode climbed after a full recovery
        moves = [e for e in events
                 if e.get("event") in ("overload_climb",
                                       "overload_descend")]
        final_rung = int(moves[-1].get("rung", 0)) if moves else 0
        if shed_rows > replayed_rows:
            sub = (f"{_compact(shed_rows - replayed_rows)} shed rows "
                   "NEVER replayed")
        elif final_rung > 0:
            sub = f"ended degraded at rung {final_rung}"
        else:
            sub = (f"{len(climbs)} climb(s) · "
                   f"{_compact(shed_rows)} shed, all replayed"
                   if shed_rows else
                   f"{len(climbs)} climb(s), fully recovered")
        tiles.append(("Overload", f"rung {top_rung} peak", sub))
    # Feature-store tile (tiered exact mode): hot-tier occupancy at the
    # last compaction, total reclaimed slots, and the dense-tier hit
    # rate. Only rendered when the run compacted (any feature_state
    # event), so direct/hash runs keep a clean tile row.
    fs_events = [e for e in events if e.get("event") == "feature_state"]
    if fs_events:
        last = fs_events[-1]
        occ = int(last.get("occupied", 0))
        cap = int(last.get("capacity", 0))
        reclaimed = sum(int(e.get("reclaimed", 0)) for e in fs_events)
        dense = float(last.get("dense_rows", 0.0))
        cms_r = float(last.get("cms_rows", 0.0))
        served = dense + cms_r
        sub_bits = [f"{_compact(reclaimed)} slot(s) reclaimed"]
        if served:
            sub_bits.append(f"{dense / served:.1%} dense")
        per_shard = last.get("occupied_per_shard")
        if per_shard:
            # sharded exact serving: skew is the failure mode the modulo
            # ownership hides — lead with the WORST shard's occupancy
            # (its hot tier overflows to the sketch first)
            worst = int(max(range(len(per_shard)),
                            key=lambda s: per_shard[s]))
            cap_shard = cap // max(len(per_shard), 1)
            sub_bits.insert(0, (
                f"worst shard {worst}: "
                f"{_compact(int(per_shard[worst]))}/"
                f"{_compact(cap_shard)}"))
        if last.get("cold_keys") is not None:
            # host cold tier armed: depth of the demoted key set and the
            # promotion backlog at the last compaction — a growing
            # backlog means returning keys are being served from the
            # sketch longer than the promoter can land them
            cold_bits = f"cold {_compact(int(last['cold_keys']))} key(s)"
            backlog = int(last.get("promote_backlog", 0))
            if backlog:
                cold_bits += f", {_compact(backlog)} promoting"
            sub_bits.append(cold_bits)
        tiles.append((
            "Feature store",
            f"{_compact(occ)}/{_compact(cap)} slots" if cap
            else _compact(occ),
            " · ".join(sub_bits)))
    # Learning tile: which model versions served/shadowed and how the
    # canary ended. Only rendered when the run had a learning loop (any
    # model_* event), so plain serving runs keep a clean tile row.
    promos = [e for e in events if e.get("event") == "model_promoted"]
    rollbacks = [e for e in events if e.get("event") == "model_rollback"]
    cands = [e for e in events if e.get("event") == "model_candidate"]
    pubs = [e for e in events if e.get("event") == "model_published"]
    # refusals by cause: "corrupt" sends the operator hunting bit-rot,
    # which is wrong advice for a kind-mismatched or vanished artifact
    refusals = [e for e in events
                if e.get("event") == "model_promote_refused"]
    refused_corrupt = sum(1 for e in refusals
                          if e.get("reason") in ("checksum", "truncated"))
    refused_other = len(refusals) - refused_corrupt
    refused = len(refusals)
    if promos or rollbacks or cands or pubs or refused:
        if rollbacks and (not promos
                          or rollbacks[-1].get("t", 0.0)
                          >= promos[-1].get("t", 0.0)):
            champ = rollbacks[-1].get("version", "?")
            verdict = f"rolled back from v{rollbacks[-1].get('regressed')}"
        elif promos:
            champ = promos[-1].get("version", "?")
            verdict = f"promoted over v{promos[-1].get('previous')}"
        else:
            champ = man.get("model_kind", "champion")
            verdict = f"{len(pubs)} candidate(s) published"
        sub_bits = [verdict]
        if cands:
            sub_bits.append(f"shadow v{cands[-1].get('version')}")
        if refused_corrupt:
            sub_bits.append(f"{refused_corrupt} corrupt refused")
        if refused_other:
            sub_bits.append(f"{refused_other} refused "
                            "(kind/missing)")
        tiles.append(("Learning", f"v{champ}" if promos or rollbacks
                      else str(champ), " · ".join(sub_bits)))
    cluster = _cluster_tile(events, man)
    if cluster is not None:
        tiles.append(cluster)
    elasticity = _elasticity_tile(events, man)
    if elasticity is not None:
        tiles.append(elasticity)
    tile_html = []
    for label, value, sub in tiles:
        subdiv = f"<div class='sub'>{_esc(sub)}</div>" if sub else ""
        tile_html.append(
            f"<div class='tile'><div class='lbl'>{_esc(label)}</div>"
            f"<div class='num'>{_esc(value)}</div>{subdiv}</div>")
    parts.append("<div class='tiles'>" + "".join(tile_html) + "</div>")

    parts.append("<div class='cards'>")
    idx = [str(int(b.get("batch", i))) for i, b in enumerate(batches)]
    for phase in _OPS_PHASES:
        ys_ms = np.asarray([
            1e3 * float(b.get("phases", {}).get(phase, 0.0))
            for b in batches
        ])
        if not ys_ms.any():
            continue  # e.g. sink_write with no sink attached
        ds, w = _downsample_max(ys_ms)
        labels = [idx[min(i * w, len(idx) - 1)] for i in range(len(ds))]
        note = f" (max per {w} batches)" if w > 1 else ""
        twin = _table_twin(
            ("batch", f"{phase} ms"),
            [(labels[i], f"{ds[i]:.3f}") for i in range(len(ds))])
        parts += [
            f"<div class='card'><h2>{_esc(phase)} per batch{_esc(note)}"
            "</h2>",
            _line_chart(labels, ds, unit=" ms"),
            twin, "</div>",
        ]
    # event strip + table twin (values never color-gated)
    ev_twin = _table_twin(
        ("time", "event", "detail"),
        [(_ts_label(int(float(e.get("t", t_first)) * _US)),
          str(e.get("event", "?")),
          ", ".join(f"{k}={v}" for k, v in e.items()
                    if k not in ("kind", "t", "event")))
         for e in events]) if events else ""
    parts += [
        "<div class='card'><h2>Events (faults · feedback · checkpoints "
        "· restarts)</h2>",
        _event_strip(events, t_first, t_last),
        ev_twin, "</div>",
        "</div>",
        f"<div id='tip'></div><script>{_JS}</script></body></html>",
    ]
    return "".join(parts)


def write_ops_dashboard(
    flight_path: str,
    out_path: str,
    *,
    title: Optional[str] = None,
) -> dict:
    """Load a flight-record JSONL and write the ops-health dashboard."""
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        FlightRecorder,
    )

    manifest, records = FlightRecorder.read(flight_path)
    htm = render_ops_html(
        manifest, records,
        title=title or "Fraud detection — ops health")
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(htm)
    return {
        "dashboard": out_path,
        "batches": sum(1 for r in records if r.get("kind") == "batch"),
        "events": sum(1 for r in records if r.get("kind") == "event"),
        "bytes": len(htm.encode()),
    }


# ---------------------------------------------------------------------------
# ASCII span waterfall: the terminal twin of the Perfetto timeline
# ---------------------------------------------------------------------------

def render_trace_waterfall(trace: dict, trace_id: Optional[str] = None,
                           width: int = 56) -> str:
    """Render one batch's span waterfall from a Chrome-trace JSON object
    (as exported by ``utils/trace.py``) as plain ASCII — the
    no-browser view `rtfds trace` prints.

    ``trace_id`` picks the batch; default is the batch with the largest
    total span time (the one an operator is hunting). Spans render in
    start order, each bar positioned on the batch's time extent::

        trace b00000003 — 3 spans, 12.42 ms span extent
        source_poll    |##....................|    0.18 ms
        host_prep      |..####................|    4.73 ms
        dispatch       |......############....|    7.51 ms
    """
    events = [e for e in trace.get("traceEvents", [])
              if e.get("ph") == "X"
              and (e.get("args") or {}).get("trace_id")]
    if not events:
        return "no spans in trace"
    by_id: Dict[str, List[dict]] = {}
    for e in events:
        by_id.setdefault(str(e["args"]["trace_id"]), []).append(e)
    if trace_id is None:
        trace_id = max(
            by_id,
            key=lambda t: sum(float(e.get("dur", 0.0)) for e in by_id[t]))
    evs = by_id.get(str(trace_id))
    if not evs:
        known = ", ".join(sorted(by_id)[:8])
        return (f"trace id {trace_id!r} not in trace "
                f"(known ids: {known}{'…' if len(by_id) > 8 else ''})")
    evs = sorted(evs, key=lambda e: float(e.get("ts", 0.0)))
    t0 = min(float(e["ts"]) for e in evs)
    t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in evs)
    span_us = max(t1 - t0, 1e-9)
    name_w = max(len(str(e["name"])) for e in evs)
    lines = [
        f"trace {trace_id} — {len(evs)} spans, "
        f"{span_us / 1e3:.2f} ms span extent"
    ]
    for e in evs:
        s = int(width * (float(e["ts"]) - t0) / span_us)
        w = max(1, int(round(width * float(e.get("dur", 0.0)) / span_us)))
        s = min(s, width - 1)
        w = min(w, width - s)
        bar = "." * s + "#" * w + "." * (width - s - w)
        lines.append(
            f"{str(e['name']):<{name_w}} |{bar}| "
            f"{float(e.get('dur', 0.0)) / 1e3:>9.3f} ms")
    return "\n".join(lines)


def write_dashboard(
    analyzed_dir: str,
    out_path: str,
    *,
    threshold: float = 0.5,
    top_k: int = 10,
    bucket: str = "day",
    title: Optional[str] = None,
) -> dict:
    """Load an analyzed output directory and write the dashboard HTML.

    Returns a small manifest (path, transaction count) for CLI printing.
    """
    cols = load_analyzed(analyzed_dir)
    htm = render_dashboard_html(
        cols, threshold=threshold, top_k=top_k, bucket=bucket,
        title=title or "Fraud detection — analyzed transactions")
    with open(out_path, "w", encoding="utf-8") as f:
        f.write(htm)
    return {
        "dashboard": out_path,
        "transactions": int(len(cols.get("tx_id", ()))),
        "bytes": len(htm.encode()),
    }
