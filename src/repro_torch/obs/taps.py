"""Non-blocking device-side metric taps (counterpart of
``repro.obs.taps``).

Two pieces, both built on the same observation: a step already
*returns* its scalar metrics as device tensors, and the expensive part
is not producing them but reading them back — each ``float(t)`` of a
CUDA tensor is a full device sync and a transfer.

* :class:`TapBuffer` — the host side. ``push`` stores the step's
  device metrics without touching them (the queued work keeps
  running); ``drain`` reads **everything buffered in ONE transfer**:
  the buffered 0-d tensors are stacked on their device and copied to
  the host with one ``.cpu()``. Every step's scalars are
  retained, not just the logged cadence.

* :func:`with_taps` — the device side. Wraps a step function so extra
  scalar taps are computed from the step's output state and metrics
  and merged into the metrics. The wrapped step's state output is the
  original step's state output by construction (the taps only read
  it), so a tapped step is bitwise-identical to the untapped one.

Values that are not tensors (host floats, or dicts of them such as the
port's per-phase seconds ``phase_s``) pass through a drain unchanged.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

__all__ = ["TapBuffer", "with_taps"]


class TapBuffer:
    """Buffer of (tag, device-metrics) pairs drained in one batch.

    ``tag`` is caller-defined (the train loop uses the step index).
    ``push`` must never block — it only appends references. ``drain``
    stacks the buffered tensors (all on one device) and copies them to
    the host with one ``.cpu()``, and returns ``[(tag, {name: float |
    host value})]`` in push order. ``clear`` drops buffered references
    *without* reading them.
    """

    def __init__(self):
        self._buf: List[Tuple[Any, Dict[str, Any]]] = []
        self.n_drains = 0

    def __len__(self) -> int:
        return len(self._buf)

    def push(self, tag: Any, metrics: Dict[str, Any]) -> None:
        self._buf.append((tag, metrics))

    def clear(self) -> None:
        self._buf.clear()

    def drain(self) -> List[Tuple[Any, Dict[str, Any]]]:
        if not self._buf:
            return []
        where = [(i, k) for i, (_, m) in enumerate(self._buf)
                 for k, v in m.items() if isinstance(v, torch.Tensor)]
        rows = [dict(m) for _, m in self._buf]
        if where:
            host = torch.stack([rows[i][k].detach().reshape(()).float()
                                for i, k in where]).cpu().tolist()
            for (i, k), x in zip(where, host):      # ONE transfer above
                rows[i][k] = x
        tags = [t for t, _ in self._buf]
        self._buf.clear()
        self.n_drains += 1
        return list(zip(tags, rows))


def with_taps(step_fn: Callable,
              tap_fns: Optional[Dict[str, Callable]] = None) -> Callable:
    """Wrap ``step_fn(state, batch) -> (state, metrics)`` so each
    ``tap_fns[name](state, metrics)`` scalar is computed after the step
    and merged into the returned metrics.

    The taps receive the *output* state (read-only); the state returned
    to the caller is exactly ``step_fn``'s — tapped and untapped steps
    are bitwise-identical in state. A tap name colliding with an
    existing metric key raises (silent overwrite would corrupt the
    history schema).
    """
    tap_fns = dict(tap_fns or {})

    def tapped(state, batch):
        state2, metrics = step_fn(state, batch)
        out = dict(metrics)
        for name, fn in tap_fns.items():
            if name in out:
                raise ValueError(
                    f"tap {name!r} collides with an existing metric key")
            out[name] = fn(state2, metrics)
        return state2, out

    return tapped
