"""Microbatch splitter shared by gradient accumulation and the pipeline
(counterpart of ``repro.pipeline.microbatch``).

One batch dict -> every leaf reshaped to a leading ``(n_micro, mb,
...)`` layout.  Microbatch ``m`` holds the contiguous row block
``[m * B/n_micro, (m+1) * B/n_micro)`` of the batch — the split
``launch.steps`` gradient accumulation uses, so a pipelined step over
``n_micro`` microbatches reduces the same per-microbatch losses and
gradients as the accumulation loop it replaces.

The batch dim is axis 0 for every leaf except M-RoPE ``positions``
(coordinate planes lead: ``(3, B, T)`` for qwen2-vl — the plane count
is read from the tensor, not hardcoded), whose microbatch layout is
``(n_micro, planes, mb, T)``.
"""

from __future__ import annotations

from typing import Dict


def batch_axis(key: str, ndim: int) -> int:
    """Batch-dim position of a batch leaf (pre-split layout)."""
    return 1 if (key == "positions" and ndim >= 3) else 0


def split_microbatches(batch: Dict, n_micro: int) -> Dict:
    """Reshape every leaf of ``batch`` to ``(n_micro, mb, ...)`` (views
    of the leaves where the layout allows).

    Raises a ``ValueError`` naming the offending leaf, its batch size
    and the microbatch count when the split doesn't divide.
    """
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    out = {}
    for k, v in batch.items():
        ax = batch_axis(k, v.ndim)
        b = v.shape[ax]
        if b % n_micro:
            raise ValueError(
                f"batch leaf {k!r} has batch size {b}, not divisible "
                f"into {n_micro} microbatches (accum/pipeline "
                f"microbatching needs batch % n_micro == 0)")
        mb = b // n_micro
        r = v.reshape(*v.shape[:ax], n_micro, mb, *v.shape[ax + 1:])
        out[k] = r.movedim(ax, 0)
    return out
