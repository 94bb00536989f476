"""Host-side refresh gates (counterpart of ``repro.solve.async_refresh``).

:class:`SMWRefresher` gates the every-step incremental (SMW) refresh
with a lagged drift readback and a full re-inversion fallback. The
reference's ``AsyncInverseRefresher`` (double-buffered refresh for
``--async-inv``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable


class SMWRefresher:
    """Every-step incremental (SMW) refresh with a drift-gated fallback.

    ``smw_step(state, batch) -> (state, metrics)`` updates the factors
    and inverses and carries a probe residual in
    ``metrics["smw_drift"]`` (a device scalar). When a drift exceeds
    ``drift_budget`` the host re-inverts every factor through
    ``refresh(factors) -> inverses``. Two rules, as in the reference:

    * the readback is one step lagged: the drift of step N is read at
      step N+1, so the host never waits on the program it just queued;
    * the first step always falls back: it seeds real inverses over the
      identities of ``kfac.init`` (an SMW update of an identity tracks
      nothing).

    A drift that is NaN also falls back, and a drift measured on
    inverses that a fallback just replaced is discarded. ``peek``,
    ``flush`` and ``reset`` keep the reference's hook surface. With an
    enabled ``obs`` (``repro_torch.obs``) the gate reports the drift it
    read (gauge ``solve_smw_drift``) and every fallback (counter
    ``solve_smw_fallback_total`` and an ``smw_fallback`` event)."""

    def __init__(self, smw_step: Callable[[Any, Any], Any],
                 refresh: Callable[[Any], Any], drift_budget: float,
                 obs: Any = None):
        self.smw_step = smw_step
        self.refresh = refresh
        self.drift_budget = float(drift_budget)
        self._drift: Any = None          # drift queued by the last step
        self.n_steps = 0
        self.n_fallbacks = 0
        self.last_drift = float("nan")
        self._obs = obs
        self._g_drift = self._c_fallback = None
        if obs is not None and obs.enabled:
            self._g_drift = obs.gauge(
                "solve_smw_drift", "lagged SMW probe residual (gate input)")
            self._c_fallback = obs.counter(
                "solve_smw_fallback_total",
                "full re-inversions triggered by the drift gate "
                "(incl. the seeding step-0 fallback)")

    def step(self, state, batch):
        """One step's refresh: the SMW program, then the lagged gate.
        Returns ``(state, metrics)`` with ``metrics["smw_fallback"]``."""
        state, metrics = self.smw_step(state, batch)
        fallback = self.n_steps == 0
        if self._drift is not None:
            d = float(self._drift)       # waits on the last step only
            self.last_drift = d
            if self._g_drift is not None:
                self._g_drift.set(d)
            if not d <= self.drift_budget:     # NaN must trigger
                fallback = True
        self._drift = metrics.get("smw_drift")
        self.n_steps += 1
        if fallback:
            kst = state.kfac
            state = dataclasses.replace(state, kfac=dataclasses.replace(
                kst, inverses=self.refresh(kst.factors)))
            self.n_fallbacks += 1
            if self._c_fallback is not None:
                self._c_fallback.inc()
                self._obs.event("smw_fallback", step=self.n_steps - 1,
                                drift=self.last_drift)
            # this drift was measured on the inverses just replaced
            self._drift = None
        metrics["smw_fallback"] = 1.0 if fallback else 0.0
        return state, metrics

    def peek(self, kstate):
        """Nothing is ever in flight on this path."""
        return kstate

    def flush(self, kstate):
        return kstate

    def reset(self) -> None:
        """Forget the queued drift and force the next step to fall
        back (after a restore the inverse tree is un-probed)."""
        self._drift = None
        self.n_steps = 0
