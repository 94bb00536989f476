"""Exporters: rotating JSONL event log, Prometheus text snapshot,
console summary (a copy of ``repro.obs.export``, which imports no jax).

All three render the same :meth:`MetricsRegistry.snapshot` schema —
they know nothing about any metric's meaning, so a new instrumented
subsystem shows up in every export format for free.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from .metrics import MetricsRegistry

__all__ = ["JsonlWriter", "prometheus_text", "console_summary"]


class JsonlWriter:
    """Append-only JSONL event log with size-based rotation.

    Each :meth:`write` appends one JSON object per line, stamped with
    ``t`` (unix seconds) unless the record carries its own. When the
    file would exceed ``max_bytes`` it is rotated to ``<path>.1``
    (single generation — the previous ``.1`` is overwritten), so a
    long-running serve process keeps at most ~2x ``max_bytes`` on
    disk.
    """

    def __init__(self, path: str, max_bytes: int = 64 * 1024 * 1024):
        self.path = path
        self.max_bytes = max_bytes
        self.n_written = 0
        self.n_rotations = 0
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a")

    def write(self, record: Dict[str, Any]) -> None:
        if "t" not in record:
            record = {"t": round(time.time(), 3), **record}
        line = json.dumps(record, default=_json_default)
        if self._f.tell() + len(line) + 1 > self.max_bytes:
            self._rotate()
        self._f.write(line + "\n")
        self.n_written += 1

    def _rotate(self) -> None:
        self._f.close()
        os.replace(self.path, self.path + ".1")
        self._f = open(self.path, "a")
        self.n_rotations += 1

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _json_default(o):
    # numpy / torch scalars reach the writer from drained taps
    try:
        return float(o)
    except Exception:
        return repr(o)


def _fmt_labels(labels: Dict[str, str], extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in sorted(labels.items())]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt_num(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render the registry in the Prometheus text exposition format
    (``# HELP`` / ``# TYPE`` headers; histograms as cumulative
    ``_bucket{le=...}`` series plus ``_sum`` / ``_count``)."""
    lines: List[str] = []
    for snap in registry.snapshot():
        name, kind = snap["name"], snap["type"]
        if snap["help"]:
            lines.append(f"# HELP {name} {snap['help']}")
        lines.append(f"# TYPE {name} {kind}")
        for row in snap["samples"]:
            if kind == "histogram":
                for edge, cum in row["buckets"].items():
                    le = edge if edge == "+Inf" else _fmt_num(float(edge))
                    lines.append(
                        f'{name}_bucket{_fmt_labels(row["labels"], f"le={json.dumps(le)}")}'
                        f" {cum}")
                lines.append(
                    f"{name}_sum{_fmt_labels(row['labels'])} "
                    f"{_fmt_num(row['sum'])}")
                lines.append(
                    f"{name}_count{_fmt_labels(row['labels'])} "
                    f"{row['count']}")
            else:
                lines.append(
                    f"{name}{_fmt_labels(row['labels'])} "
                    f"{_fmt_num(row['value'])}")
    return "\n".join(lines) + "\n"


def console_summary(registry: MetricsRegistry,
                    title: str = "obs summary") -> str:
    """Human-oriented fixed-width rendering: counters/gauges as single
    rows, histograms as count/mean/p50/p99 — the end-of-run block both
    launchers print."""
    rows: List[str] = [f"== {title} =="]
    for snap in registry.snapshot():
        name, kind = snap["name"], snap["type"]
        for row in snap["samples"]:
            lbl = _fmt_labels(row["labels"])
            if kind == "histogram":
                n = row["count"]
                if n == 0:
                    continue
                mean = row["sum"] / n
                from .metrics import Histogram
                m = registry._metrics[name]
                assert isinstance(m, Histogram)
                labels = row["labels"]
                p50 = m.quantile(0.5, **labels)
                p99 = m.quantile(0.99, **labels)
                rows.append(
                    f"  {name}{lbl:<24} n={n:<8} mean={mean:.6g} "
                    f"p50={p50:.6g} p99={p99:.6g}")
            else:
                rows.append(
                    f"  {name}{lbl:<24} {_fmt_num(row['value'])}")
    return "\n".join(rows)
