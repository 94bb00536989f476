"""Host-side span tracing with explicit async-dispatch fencing
(counterpart of ``repro.obs.trace``).

CUDA dispatch is asynchronous: the wall time between entering and
leaving a ``step_fn`` call is *enqueue* time, not compute time. A span
that just brackets the call therefore measures dispatch — which is the
honest number when the caller deliberately overlaps work (the async
inverse refresh exists to NOT serialize), and a lie when the caller
wants compute attribution. The tracer makes the choice explicit:

* ``span(name)`` — dispatch span. Records how long the host was busy
  issuing the work. ``cat`` defaults to ``"dispatch"``.
* ``span(name, fence=target_or_thunk)`` — fenced span.
  ``torch.cuda.synchronize`` runs at span exit (inside the timed
  region) on every CUDA device the target lives on — a tensor, a
  ``torch.device``, or dicts, lists, tuples and dataclasses of them —
  so the span covers dispatch + device completion: honest compute
  attribution, at the price of a sync. A ``torch.cuda.Stream`` target
  waits for that stream alone (what ``TrainLoop`` passes when the
  program overlaps a side stream). A target on the CPU needs no
  fence. ``cat`` defaults to ``"compute"``. A thunk fence
  (``fence=lambda: state``) resolves at exit, for state rebound
  during the span.

Spans nest (re-entrant on one thread); events are emitted in Chrome
trace-event format (``ph: "X"`` complete events, microsecond ``ts`` /
``dur``) so ``chrome://tracing`` / Perfetto load the file directly.
``annotate=True`` additionally enters ``torch.profiler.record_function``
for each span, so a ``torch.profiler`` trace collected around the run
carries the same span names.

A bounded event buffer (default 200k events) makes the tracer safe to
leave on for long runs: past the cap, events are counted-and-dropped
rather than growing without bound, and the Chrome export records the
drop count in ``otherData``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Union

import torch

__all__ = ["Tracer", "wait_for"]


def _cuda_devices(target: Any, out: set) -> set:
    """The CUDA devices ``target`` (a tensor, a device, or containers
    of them) lives on."""
    if isinstance(target, torch.Tensor):
        if target.is_cuda:
            out.add(target.device)
    elif isinstance(target, torch.device):
        if target.type == "cuda":
            out.add(target)
    elif isinstance(target, dict):
        for v in target.values():
            _cuda_devices(v, out)
    elif isinstance(target, (list, tuple)):
        for v in target:
            _cuda_devices(v, out)
    elif dataclasses.is_dataclass(target) and not isinstance(target, type):
        for f in dataclasses.fields(target):
            _cuda_devices(getattr(target, f.name), out)
    return out


def wait_for(target: Any) -> None:
    """Wait for ``target``: a ``torch.cuda.Stream`` alone (work on other
    streams, such as an asynchronous inverse refresh, runs on), else
    every CUDA device the target lives on."""
    if isinstance(target, torch.cuda.Stream):
        target.synchronize()
        return
    for dev in _cuda_devices(target, set()):
        torch.cuda.synchronize(dev)


class Tracer:
    def __init__(self, enabled: bool = True, annotate: bool = False,
                 max_events: int = 200_000):
        self.enabled = enabled
        self.annotate = annotate
        self.max_events = max_events
        self.n_dropped = 0
        self._events: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._pid = os.getpid()

    # -- recording ---------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _emit(self, ev: Dict[str, Any]) -> None:
        if len(self._events) >= self.max_events:
            self.n_dropped += 1
            return
        self._events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, cat: Optional[str] = None,
             args: Optional[Dict[str, Any]] = None,
             fence: Union[None, Any, Callable[[], Any]] = None):
        """Time a region as one Chrome ``X`` event. See module
        docstring for fence semantics; on an exception inside the body
        the span is still recorded (tagged ``error``) and the fence is
        skipped — blocking on arrays poisoned by the failure would
        raise a second time and mask the original error."""
        if not self.enabled:
            yield self
            return
        t0 = self._now_us()
        annot = None
        if self.annotate:
            annot = torch.profiler.record_function(name)
            annot.__enter__()
        err = None
        try:
            yield self
        except BaseException as e:
            err = e
            raise
        finally:
            if err is None and fence is not None:
                wait_for(fence() if callable(fence) else fence)
            if annot is not None:
                annot.__exit__(None, None, None)
            ev_args = dict(args or {})
            if err is not None:
                ev_args["error"] = type(err).__name__
            self._emit({
                "name": name,
                "cat": cat or ("compute" if fence is not None
                               else "dispatch"),
                "ph": "X",
                "ts": t0,
                "dur": self._now_us() - t0,
                "pid": self._pid,
                "tid": threading.get_ident() & 0x7FFFFFFF,
                "args": ev_args,
            })

    def instant(self, name: str, cat: str = "event",
                args: Optional[Dict[str, Any]] = None) -> None:
        """A zero-duration marker (Chrome ``i`` event) — recoveries,
        preemptions, fallbacks."""
        if not self.enabled:
            return
        self._emit({
            "name": name, "cat": cat, "ph": "i", "s": "t",
            "ts": self._now_us(), "pid": self._pid,
            "tid": threading.get_ident() & 0x7FFFFFFF,
            "args": dict(args or {}),
        })

    # -- export ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._events)

    def to_chrome(self) -> Dict[str, Any]:
        """The Chrome trace-event JSON object (array-with-metadata
        form: ``traceEvents`` + ``displayTimeUnit``)."""
        return {
            "traceEvents": list(self._events),
            "displayTimeUnit": "ms",
            "otherData": {
                "generated_by": "repro_torch.obs.trace",
                "n_events": len(self._events),
                "n_dropped": self.n_dropped,
            },
        }

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path
