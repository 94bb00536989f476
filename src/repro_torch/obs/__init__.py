"""repro_torch.obs — the unified telemetry spine (counterpart of
``repro.obs``).

One :class:`Observability` object per process ties the three pillars
together:

* metrics   — :mod:`repro_torch.obs.metrics` (counters / gauges /
  histograms)
* tracing   — :mod:`repro_torch.obs.trace` (fenced nestable spans,
  Chrome JSON)
* taps      — :mod:`repro_torch.obs.taps` (batched device readback)
* exporters — :mod:`repro_torch.obs.export` (JSONL / Prometheus text /
  console)

Call sites receive an ``Observability`` (default: the disabled
:data:`NULL` singleton, whose spans are no-op context managers and
whose exporters never touch disk) and hold metric handles::

    obs = Observability(out_dir="obs_out")
    ttft = obs.histogram("serve_ttft_s", "submit -> first token")
    with obs.span("prefill", fence=lambda: pool):   # synchronizes pool's card
        ...
    ttft.observe(dt)
    obs.event("recovery", step=12, lost=1)
    paths = obs.flush(summary={"kind": "train_summary", ...})

Hot paths gate their ``time.perf_counter`` bookkeeping on
``obs.enabled`` so the disabled singleton costs one attribute read.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Callable, Dict, Optional, Union

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      LATENCY_BUCKETS_S)
from .taps import TapBuffer, with_taps
from .trace import Tracer
from .export import JsonlWriter, console_summary, prometheus_text

__all__ = [
    "Observability", "NULL", "from_args",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "LATENCY_BUCKETS_S",
    "TapBuffer", "with_taps", "Tracer",
    "JsonlWriter", "console_summary", "prometheus_text",
]

#: Artifact file names under ``out_dir`` (stable — CI globs them).
JSONL_NAME = "events.jsonl"
PROM_NAME = "metrics.prom"
TRACE_NAME = "trace.json"


class Observability:
    """Facade over registry + tracer + tap buffer + exporters.

    ``enabled=False`` (or the :data:`NULL` singleton) keeps every
    operation a cheap no-op and never creates files; ``out_dir=None``
    with ``enabled=True`` records in memory (tests inspect the
    registry/tracer directly) but :meth:`flush` writes nothing.
    """

    def __init__(self, enabled: bool = True,
                 out_dir: Optional[str] = None,
                 trace: bool = True, annotate: bool = False,
                 max_trace_events: int = 200_000,
                 jsonl_max_bytes: int = 64 * 1024 * 1024):
        self.enabled = enabled
        self.out_dir = out_dir if enabled else None
        self.registry = MetricsRegistry()
        self.tracer = Tracer(enabled=enabled and trace, annotate=annotate,
                             max_events=max_trace_events)
        self.taps = TapBuffer()
        self._jsonl: Optional[JsonlWriter] = None
        if self.out_dir is not None:
            os.makedirs(self.out_dir, exist_ok=True)
            self._jsonl = JsonlWriter(
                os.path.join(self.out_dir, JSONL_NAME),
                max_bytes=jsonl_max_bytes)

    # -- metrics -----------------------------------------------------------

    def counter(self, name: str, help: str = "") -> Counter:
        return self.registry.counter(name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self.registry.gauge(name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self.registry.histogram(name, help, buckets=buckets)

    # -- spans / events ----------------------------------------------------

    def span(self, name: str, cat: Optional[str] = None,
             args: Optional[Dict[str, Any]] = None,
             fence: Union[None, Any, Callable[[], Any]] = None):
        if not self.enabled:
            return contextlib.nullcontext(self)
        return self.tracer.span(name, cat=cat, args=args, fence=fence)

    def event(self, kind: str, **fields) -> None:
        """A discrete occurrence (recovery, preemption, fallback):
        one JSONL line + one instant trace marker."""
        if not self.enabled:
            return
        self.tracer.instant(kind, args=fields)
        if self._jsonl is not None:
            self._jsonl.write({"kind": kind, **fields})

    def write(self, record: Dict[str, Any]) -> None:
        """Raw JSONL record (per-step metric rows use this — no trace
        marker, they'd swamp the trace)."""
        if self._jsonl is not None:
            self._jsonl.write(record)

    # -- export ------------------------------------------------------------

    def console(self, title: str = "obs summary") -> str:
        return console_summary(self.registry, title=title)

    def flush(self, summary: Optional[Dict[str, Any]] = None
              ) -> Dict[str, str]:
        """Write the Prometheus snapshot and Chrome trace under
        ``out_dir`` (optionally recording ``summary`` as a final JSONL
        event) and return the artifact paths."""
        if summary is not None and self._jsonl is not None:
            self._jsonl.write({"kind": summary.get("kind", "summary"),
                               "schema": 1, **summary})
        if self.out_dir is None:
            return {}
        paths = {}
        if self._jsonl is not None:
            self._jsonl.flush()
            paths["jsonl"] = self._jsonl.path
        prom = os.path.join(self.out_dir, PROM_NAME)
        with open(prom, "w") as f:
            f.write(prometheus_text(self.registry))
        paths["prom"] = prom
        if self.tracer.enabled:
            paths["trace"] = self.tracer.save(
                os.path.join(self.out_dir, TRACE_NAME))
        return paths

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()


#: Shared disabled instance — the default ``obs`` everywhere.
NULL = Observability(enabled=False)


def from_args(args) -> Observability:
    """Build from the standard CLI surface: ``--obs`` (bool),
    ``--obs-dir`` (path, implies enabled) and ``--obs-annotate``
    (``torch.profiler.record_function`` around every span)."""
    obs_dir = getattr(args, "obs_dir", None)
    enabled = bool(getattr(args, "obs", False) or obs_dir)
    if not enabled:
        return NULL
    return Observability(enabled=True, out_dir=obs_dir,
                         annotate=bool(getattr(args, "obs_annotate", False)))
