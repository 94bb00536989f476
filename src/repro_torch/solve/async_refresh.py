"""Host-side refresh gates (counterpart of ``repro.solve.async_refresh``).

:class:`AsyncInverseRefresher` is RePAST's INV crossbar groups running
concurrently with FP/BP/WU (Sec. IV-B, Fig. 8): at each ``inv_every``
trigger it swaps in the refresh dispatched at the *previous* trigger, so
step N preconditions with the inverses of the factors as of step
N - inv_every, and dispatches the next refresh from the current factors.
The reference gets the overlap from JAX's asynchronous dispatch and
reuses the retired inverse tree by buffer donation. On a GPU the refresh
runs on a side CUDA stream of its own, writes into the retired tree
(``refresh_into(factors, buffers)``), and CUDA events order it against
the main stream (:meth:`AsyncInverseRefresher.step` says how).

:class:`SMWRefresher` gates the every-step incremental (SMW) refresh
with a lagged drift readback and a full re-inversion fallback.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator, Optional

import torch


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _cuda_device(tree: Any) -> Optional[torch.device]:
    for t in _tensors(tree):
        return t.device if t.is_cuda else None
    return None


def lowest_stream_priority() -> int:
    """The lowest priority a CUDA stream can have (CUDA numbers
    priorities downwards: the lowest is the largest number)."""
    return max(torch.cuda.Stream.priority_range())


class AsyncInverseRefresher:
    """Drives ``state.inverses`` from lagged, overlapped refreshes.

    ``refresh_fn(factors) -> inverses`` computes a new inverse tree;
    ``refresh_into(factors, buffers) -> inverses`` writes it into
    ``buffers`` (the tree being retired) and returns them. At least one
    must be given. ``spare_buffers`` (an inverse tree of scratch
    tensors) seeds the double buffer, so that the first dispatch already
    goes through ``refresh_into`` and the steady state rotates two
    inverse trees; without a spare and without ``refresh_fn`` a dispatch
    is an error, never a fallback to another program.

    Exactly one refresh is in flight at a time. With factors on the
    CPU the refresh runs inline, with the same lag. With factors on a
    GPU it runs on the refresher's side stream (:attr:`stream`, made at
    the first dispatch, at the lowest priority):

    * at dispatch the side stream waits for the main (current) stream,
      which orders the refresh after the stats step that wrote the
      factors and after the last readers of the retired buffers; every
      factor tensor, and every buffer it writes, is marked as in use by
      the side stream (``record_stream``), so the caching allocator
      cannot hand their memory to the main stream while the refresh
      still uses it; the
      damping, the pooling and the kernel all run on the side stream;
      an event recorded there marks the refresh's end;
    * before the main stream reads the pending tree (the swap, and
      :meth:`peek` and :meth:`flush`) it waits for that event;
    * :meth:`reset` waits on the host for the event before the dropped
      tree becomes the spare.

    With an enabled ``obs`` the refresher counts dispatches
    (``solve_inv_dispatch_total``) and swaps (``solve_inv_swap_total``)
    and records each dispatch as an ``inv_refresh_dispatch`` span (host
    time only: the refresh is meant to overlap what follows)."""

    def __init__(self, refresh_fn: Optional[Callable[[Any], Any]] = None,
                 refresh_into: Optional[Callable[[Any, Any], Any]] = None,
                 spare_buffers: Any = None, obs: Any = None):
        if refresh_fn is None and refresh_into is None:
            raise ValueError(
                "need refresh_fn and/or refresh_into(+spare_buffers)")
        self.refresh_fn = refresh_fn
        self.refresh_into = refresh_into
        self.stream: Optional[torch.cuda.Stream] = None
        self._spare = spare_buffers
        self._pending: Any = None
        self._done: Optional[torch.cuda.Event] = None
        self.n_dispatched = 0
        self.n_swapped = 0
        self._obs = obs
        self._c_dispatch = self._c_swap = None
        if obs is not None and obs.enabled:
            self._c_dispatch = obs.counter(
                "solve_inv_dispatch_total",
                "async inverse refreshes dispatched")
            self._c_swap = obs.counter(
                "solve_inv_swap_total",
                "lagged inverse trees swapped into the live state")

    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if self.stream is None or self.stream.device != device:
            self.stream = torch.cuda.Stream(
                device=device, priority=lowest_stream_priority())
        return self.stream

    def _take_pending(self) -> Any:
        """The pending tree, safe for the current stream to read."""
        pending, done = self._pending, self._done
        self._pending = self._done = None
        if done is not None:
            main = torch.cuda.current_stream(self.stream.device)
            main.wait_event(done)
            for t in _tensors(pending):
                t.record_stream(main)
        return pending

    def _dispatch(self, factors: Any, retired: Any) -> None:
        if retired is not None and self.refresh_into is not None:
            run = lambda: self.refresh_into(factors, retired)  # noqa: E731
            written = retired
        elif self.refresh_fn is None:
            # a refresh_into-only refresher never falls back to another
            # program mid-training
            raise RuntimeError(
                "refresh_into has no retired/spare buffers and no "
                "refresh_fn fallback was provided")
        else:
            run = lambda: self.refresh_fn(factors)  # noqa: E731
            written = None
        dev = _cuda_device(factors)
        if dev is None:
            self._pending = run()
            return
        side = self._side_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        for t in _tensors((factors, written)):
            t.record_stream(side)
        with torch.cuda.stream(side):
            self._pending = run()
            self._done = torch.cuda.Event()
            self._done.record(side)

    def step(self, kstate):
        """One inv-cadence trigger: swap in the previous refresh (if
        any), dispatch the next one. Returns the updated state; does not
        wait for the dispatched refresh."""
        retired = None
        if self._pending is not None:
            retired = kstate.inverses
            kstate = dataclasses.replace(kstate,
                                         inverses=self._take_pending())
            self.n_swapped += 1
            if self._c_swap is not None:
                self._c_swap.inc()
        if retired is None:
            retired, self._spare = self._spare, None
        span = (self._obs.span("inv_refresh_dispatch")
                if self._c_dispatch is not None
                else contextlib.nullcontext())
        with span:
            self._dispatch(kstate.factors, retired)
        self.n_dispatched += 1
        if self._c_dispatch is not None:
            self._c_dispatch.inc()
        return kstate

    def peek(self, kstate):
        """The state with the in-flight refresh folded in, without
        consuming it (for a checkpoint: the pending swap still happens
        at its own trigger, so the checkpoint cadence never changes the
        trajectory). The main stream waits for the refresh."""
        if self._pending is None:
            return kstate
        if self._done is not None:
            torch.cuda.current_stream(self.stream.device).wait_event(
                self._done)
        return dataclasses.replace(kstate, inverses=self._pending)

    def flush(self, kstate):
        """Fold the in-flight refresh into the state, leaving nothing
        pending. The displaced tree becomes the spare if there is none,
        so a later :meth:`step` still writes into retired buffers."""
        if self._pending is not None:
            if self._spare is None:
                self._spare = kstate.inverses
            kstate = dataclasses.replace(kstate,
                                         inverses=self._take_pending())
            self.n_swapped += 1
        return kstate

    def reset(self) -> None:
        """Drop the in-flight refresh (recovery: the restored state's
        factors no longer match what was dispatched). Waits for it to
        end, then keeps the dropped tree as the spare."""
        if self._done is not None:
            self._done.synchronize()
        if self._pending is not None and self._spare is None:
            self._spare = self._pending
        self._pending = self._done = None


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
