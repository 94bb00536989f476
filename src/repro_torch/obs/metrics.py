"""Structured metrics registry: counters, gauges, fixed-bucket
histograms, each with label sets (a copy of ``repro.obs.metrics``,
which imports no jax).

Design constraints:

* **dependency-free** — stdlib only; no prometheus_client, no torch (the
  device side lives in :mod:`repro_torch.obs.taps`);
* **cheap enough for per-token serve paths** — a metric handle is
  looked up once and held; ``inc``/``set``/``observe`` on the held
  handle are a dict write plus (for histograms) one ``bisect``. No
  locks on the hot path: the repo is single-process and CPython dict
  ops are atomic under the GIL; the only background threads
  (checkpoint saver, watchdog timer) never touch the registry.
* **stable export schema** — :meth:`MetricsRegistry.snapshot` returns
  plain dicts the exporters (:mod:`repro_torch.obs.export`) render without
  knowing any metric's meaning.

Labels are passed as keyword arguments at observation time and keyed
by their sorted item tuple, so ``inc(phase="wu")`` and the snapshot
both see one stable identity per label set::

    reg = MetricsRegistry()
    toks = reg.counter("serve_tokens_total", "generated tokens")
    toks.inc(8)
    lat = reg.histogram("serve_ttft_s", help="submit -> first token")
    lat.observe(0.012)
    phase = reg.histogram("train_phase_s", help="per-phase wall")
    phase.observe(0.5, phase="wu")
"""

from __future__ import annotations

import bisect
import math
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "LATENCY_BUCKETS_S",
]

#: Default histogram edges for latency-in-seconds metrics: 100us..60s,
#: roughly 1-2.5-5 per decade — wide enough for CPU-smoke prefills and
#: real-hardware decode chunks to land in interior buckets.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)


def _label_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help

    def _sample_rows(self) -> List[Dict[str, Any]]:  # pragma: no cover
        raise NotImplementedError

    def snapshot(self) -> Dict[str, Any]:
        return {"name": self.name, "type": self.kind, "help": self.help,
                "samples": self._sample_rows()}


class Counter(_Metric):
    """Monotonically non-decreasing per label set."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[Tuple, float] = {}
        self._labels: Dict[Tuple, Dict[str, str]] = {}

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(
                f"counter {self.name}: negative increment {amount} "
                "(counters are monotonic; use a gauge)")
        key = _label_key(labels)
        if key not in self._values:
            self._values[key] = 0.0
            self._labels[key] = {k: v for k, v in key}
        self._values[key] += amount

    def value(self, **labels) -> float:
        return self._values.get(_label_key(labels), 0.0)

    def _sample_rows(self):
        if not self._values:
            return [{"labels": {}, "value": 0.0}]
        return [{"labels": self._labels[k], "value": v}
                for k, v in self._values.items()]


class Gauge(_Metric):
    """Last-write-wins scalar per label set."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        super().__init__(name, help)
        self._values: Dict[Tuple, float] = {}
        self._labels: Dict[Tuple, Dict[str, str]] = {}

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        if key not in self._labels:
            self._labels[key] = {k: v for k, v in key}
        self._values[key] = float(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(labels)
        if key not in self._labels:
            self._labels[key] = {k: v for k, v in key}
        self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> Optional[float]:
        return self._values.get(_label_key(labels))

    def _sample_rows(self):
        return [{"labels": self._labels[k], "value": v}
                for k, v in self._values.items()]


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus ``le`` semantics: a value
    lands in the first bucket whose upper edge is ``>= v``; values
    above the last edge land in ``+Inf``). Per label set it keeps
    ``len(edges) + 1`` bucket counts plus sum and count — enough for
    rates, means and bucket-interpolated quantiles, with O(log
    n_buckets) per observation."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        super().__init__(name, help)
        edges = tuple(sorted(float(b) for b in buckets))
        if not edges:
            raise ValueError(f"histogram {name}: need >= 1 bucket edge")
        if len(set(edges)) != len(edges):
            raise ValueError(f"histogram {name}: duplicate bucket edges")
        self.edges = edges
        self._counts: Dict[Tuple, List[int]] = {}
        self._sum: Dict[Tuple, float] = {}
        self._n: Dict[Tuple, int] = {}
        self._labels: Dict[Tuple, Dict[str, str]] = {}

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        counts = self._counts.get(key)
        if counts is None:
            counts = self._counts[key] = [0] * (len(self.edges) + 1)
            self._sum[key] = 0.0
            self._n[key] = 0
            self._labels[key] = {k: v for k, v in key}
        counts[bisect.bisect_left(self.edges, value)] += 1
        self._sum[key] += value
        self._n[key] += 1

    def count(self, **labels) -> int:
        return self._n.get(_label_key(labels), 0)

    def sum(self, **labels) -> float:
        return self._sum.get(_label_key(labels), 0.0)

    def quantile(self, q: float, **labels) -> float:
        """Bucket-interpolated quantile estimate (the Prometheus
        ``histogram_quantile`` rule: linear within the landing bucket,
        last finite edge for the +Inf bucket). NaN when empty."""
        key = _label_key(labels)
        n = self._n.get(key, 0)
        if n == 0:
            return math.nan
        rank = q * n
        seen = 0
        for i, c in enumerate(self._counts[key]):
            if c == 0:
                continue
            if seen + c >= rank:
                if i >= len(self.edges):       # +Inf bucket
                    return self.edges[-1]
                lo = self.edges[i - 1] if i > 0 else 0.0
                hi = self.edges[i]
                return lo + (hi - lo) * max(rank - seen, 0.0) / c
            seen += c
        return self.edges[-1]

    def _sample_rows(self):
        out = []
        for key, counts in self._counts.items():
            cum, cum_counts = 0, []
            for c in counts:
                cum += c
                cum_counts.append(cum)
            out.append({
                "labels": self._labels[key],
                "buckets": {
                    **{repr(e): cum_counts[i]
                       for i, e in enumerate(self.edges)},
                    "+Inf": cum_counts[-1],
                },
                "sum": self._sum[key],
                "count": self._n[key],
            })
        return out


class MetricsRegistry:
    """Name -> metric map with get-or-create semantics: asking for an
    existing name with the same kind returns the existing handle (so
    call sites can re-derive handles cheaply); a kind mismatch or — for
    histograms — a bucket-edge mismatch raises instead of silently
    forking the series."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_make(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}")
            if cls is Histogram and "buckets" in kw and \
                    tuple(sorted(float(b) for b in kw["buckets"])) \
                    != m.edges:
                raise ValueError(
                    f"histogram {name!r} already registered with "
                    f"different bucket edges")
            return m
        m = cls(name, help, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_make(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_make(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S
                  ) -> Histogram:
        return self._get_or_make(Histogram, name, help, buckets=buckets)

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def __len__(self) -> int:
        return len(self._metrics)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def collect(self) -> Iterable[_Metric]:
        for name in sorted(self._metrics):
            yield self._metrics[name]

    def snapshot(self) -> List[Dict[str, Any]]:
        """Plain-dict export of every registered metric (stable order:
        sorted by name) — the schema the exporters render."""
        return [m.snapshot() for m in self.collect()]
