"""K-FAC x pipeline glue: stage-local second-order state + SOI refresh
scheduled into the pipeline bubbles (counterpart of
``repro.pipeline.kfac_glue``).

Two facts make second-order training compose cleanly with the stage
axis:

* **Factor locality.** Every factored linear lives in exactly one
  stage's layer slice, and each stage rank holds the factors (and
  inverses, and WU tiles) of its own atoms only
  (``dist.sharding.StageShards``) — so the factors a stage's K-FAC taps
  feed are resident on that stage's ranks, and the SU/INV work adds no
  cross-stage factor traffic.
  :func:`stage_specs` is the host-side map of which linears each stage
  owns (the per-stage ``(K, ...)`` restriction of ``kfac_specs``).

* **Bubbles pay for INV.** A synchronous S-stage pipeline idles each
  device for ``2(S-1)`` of its ``2(M+S-1)`` ticks (fill + drain).
  RePAST runs its INV crossbar groups concurrently with the VMM
  pipelines (Fig. 8); the TPU image is the async double-buffered SOI
  refresher (``solve.async_refresh``) dispatched *at the step
  boundary*, right before the pipeline step: on the card its refresh
  runs on a side stream while the pipeline's own critical path is
  stalled in fill/drain, so — whenever the INV work fits the bubble
  budget (:func:`inv_fits_bubbles`) — the refresh rides for free.
  :func:`bubble_refresh` is that dispatch policy (the training CLI's
  ``--async-inv`` under ``--pp``, ``launch.train.KFACProgram``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple

from repro_torch.core.soi import LinearSpec
from repro_torch.pipeline.schedule import Schedule
from repro_torch.pipeline.stages import StagePartition


def stage_specs(specs: Mapping[str, LinearSpec],
                part: StagePartition) -> Tuple[Dict[str, LinearSpec], ...]:
    """Per-stage restriction of the K-FAC spec registry.

    Every scanned-stack spec (``layers/``, hybrid ``units/``, whisper
    ``enc/``/``dec/`` — leading stack dim = atom count) appears in
    each owning stage with its stack dim cut to that stage's atom
    count — the shapes of the stage-resident factor slices; stages
    owning zero atoms of a stack (a pure-encoder stage's ``dec/``
    specs) skip it. Hybrid ``tail/`` specs are unstacked and pinned to
    the last stage, where the executor runs the ragged tail sublayers.
    """
    out = []
    for s in range(part.n_stages):
        if part.atom == "encdec":
            ne, nd = part.enc_dec_counts(s)
            counts = {"enc": ne, "dec": nd}
        else:
            counts = {"layers": len(part.layers_of(s)),
                      "units": len(part.layers_of(s))}
        d = {}
        for name, spec in specs.items():
            stack_key = name.split("/", 1)[0]
            if stack_key == "tail":
                if s == part.n_stages - 1:
                    d[name] = spec
                continue
            if stack_key not in counts:
                raise ValueError(
                    f"spec {name!r} is not part of a scanned atom "
                    f"stack; this family cannot be stage-partitioned")
            k = counts[stack_key]
            if k == 0:
                continue
            d[name] = dataclasses.replace(
                spec, stack=(k,) + spec.stack[1:])
        out.append(d)
    return tuple(out)


def bubble_ticks(sched: Schedule) -> int:
    """Idle ticks per device of one pipelined step (fill + drain)."""
    return min(sched.idle_ticks(s) for s in range(sched.n_stages))


def inv_fits_bubbles(sched: Schedule, inv_flops: float,
                     tick_flops: float) -> bool:
    """Does one SOI inverse refresh fit the per-step bubble budget?

    ``inv_flops``: per-device inversion work (the block-parallel
    solver's plan divides it ~1/ndev — ``Plan.device_flops``);
    ``tick_flops``: one pipeline tick's compute (a stage forward or
    backward). Amortize over ``inv_every`` externally if the refresh
    cadence is slower than every step.
    """
    return inv_flops <= bubble_ticks(sched) * tick_flops


def bubble_refresh(refresher, kstate, sched: Schedule):
    """One inv-cadence trigger under a pipelined step.

    Swaps in the previously-dispatched inverse tree and dispatches the
    next refresh (``solve.AsyncInverseRefresher`` semantics), returning
    ``(kstate, info)``. Dispatch happens *before* the pipeline step
    is enqueued, so the refresh executes concurrently with the
    pipeline's fill/drain bubbles rather than serializing after the
    step — the paper's "INV rides beside the VMM pipeline" (Fig. 8)
    mapped onto a side stream. ``info`` carries the bubble budget for
    the metrics stream.
    """
    kstate = refresher.step(kstate)
    info = {
        "pp_bubble_ticks": float(bubble_ticks(sched)),
        "pp_bubble_fraction": sched.bubble_fraction,
    }
    return kstate, info
