"""Step watchdog: straggler detection + hang deadline (a copy of
``repro.runtime.watchdog``, which imports no jax, with one addition:
``hang_factor=None`` drops the median-relative deadline).

At 1000+ nodes the common failure is not a crash but a *slow* or *hung*
step (one bad host, a flaky link, a thermally-throttled chip). The
watchdog keeps a rolling median of healthy step times and

* flags a step as a **straggler** when it exceeds
  ``straggler_factor x median`` (logged; counted; the train loop may
  respond by re-balancing or excluding the slow host),
* raises :class:`StepDeadlineExceeded` from a daemon timer when a step
  exceeds ``hang_factor x median`` (or ``hard_deadline_s``), which the
  retrying loop treats like a device failure: checkpoint-restore and
  replay (``runtime.loop``).

Used as a context manager around each step::

    with watchdog.step():
        loss = train_step(...)
"""

from __future__ import annotations

import contextlib
import statistics
import threading
import time
from typing import Any, List, Optional


class StepDeadlineExceeded(RuntimeError):
    pass


class StepWatchdog:
    def __init__(
        self,
        straggler_factor: float = 2.0,
        hang_factor: Optional[float] = 10.0,
        hard_deadline_s: Optional[float] = None,
        window: int = 32,
        warmup_steps: int = 3,
        obs: Any = None,
    ):
        self.straggler_factor = straggler_factor
        self.hang_factor = hang_factor
        self.hard_deadline_s = hard_deadline_s
        self.window = window
        self.warmup_steps = warmup_steps
        self.times: List[float] = []
        self.n_steps = 0
        self.n_stragglers = 0
        self.last_was_straggler = False
        # observability taps (repro_torch.obs): step-wall histogram +
        # straggler counter; handles held once, observed per step
        self._h_wall = self._c_straggler = None
        if obs is not None and getattr(obs, "enabled", False):
            self._h_wall = obs.histogram(
                "train_step_wall_s",
                "fenced per-step wall time (watchdog clock)")
            self._c_straggler = obs.counter(
                "train_stragglers_total",
                "steps exceeding straggler_factor x median")

    def median(self) -> Optional[float]:
        if len(self.times) < max(self.warmup_steps, 1):
            return None
        return statistics.median(self.times)

    def reset_window(self) -> None:
        """Clear the healthy-time window (e.g. after a recovery, where
        the first step recompiles and must not trip the hang deadline)
        while keeping the cumulative ``n_steps``/``n_stragglers``
        counters — the train loop's final report sums over the whole
        run, recoveries included."""
        self.times.clear()
        self.last_was_straggler = False

    def _deadline(self) -> Optional[float]:
        med = self.median()
        cands = []
        if med is not None and self.hang_factor is not None:
            cands.append(self.hang_factor * med)
        if self.hard_deadline_s is not None:
            cands.append(self.hard_deadline_s)
        return min(cands) if cands else None

    @contextlib.contextmanager
    def step(self):
        deadline = self._deadline()
        fired = threading.Event()
        timer = None
        if deadline is not None:
            # The timer cannot interrupt a blocked CUDA call portably; it
            # marks the event, and we raise on exit. Real deployments
            # pair this with a preemption/health service that kills the
            # process; the loop-level behavior (restore and replay) is
            # identical and is what we test.
            timer = threading.Timer(deadline, fired.set)
            timer.daemon = True
            timer.start()
        t0 = time.monotonic()
        try:
            yield self
        finally:
            if timer is not None:
                timer.cancel()
        dt = time.monotonic() - t0
        self.n_steps += 1
        if self._h_wall is not None:
            self._h_wall.observe(dt)
        med = self.median()
        self.last_was_straggler = bool(
            med is not None and dt > self.straggler_factor * med)
        if self.last_was_straggler:
            self.n_stragglers += 1
            if self._c_straggler is not None:
                self._c_straggler.inc()
        else:
            # stragglers do not pollute the healthy-time window
            self.times.append(dt)
            if len(self.times) > self.window:
                self.times.pop(0)
        if fired.is_set() or (deadline is not None and dt > deadline):
            raise StepDeadlineExceeded(
                f"step took {dt:.3f}s > deadline {deadline:.3f}s")
