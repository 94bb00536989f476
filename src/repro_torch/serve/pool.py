"""Slot pool for continuous-batching serving (counterpart of
``repro.serve.pool``).

The pool is an ordinary decode cache (``models.lm.init_cache``,
``models.whisper.init_cache``) whose batch dim is read as *slots*, with a
(max_slots,) tensor of per-slot lengths at ``idx``. The models already
mask attention by each row's cached positions (unwritten columns carry
``UNWRITTEN_POS``), so slots of different lengths share one cache.

* :func:`init_pool`  allocates it;
* :func:`write_slot` copies a single-request prefill cache (batch 1,
  the same columns) into one slot, re-masking the padded prompt columns;
* :func:`reset_slot` returns a slot to the empty state.

The writes are in place on the pool's tensors (the reference donates
its pool); each function returns the pool.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import UNWRITTEN_POS

__all__ = ["UNWRITTEN_POS", "slot_dim", "init_pool", "empty_row_like",
           "write_slot", "reset_slot"]


def slot_dim(key: str) -> int:
    """The slot (batch) dim of the pool leaf ``key``. The port's caches
    are flat dicts keyed by path: a leaf under a layer stack
    (``layers/...``, ``units/...``) leads with the stack dim, so its slot
    dim is 1; the hybrid's unstacked ``tail/...`` leaves and the
    per-slot lengths ``idx`` have it first. (The reference reads it off
    its pytree paths: ``k``/``v`` at ndim - 4, ``pos`` at ndim - 2,
    recurrent states at 1 under a stack.)"""
    return 1 if key.startswith(("layers/", "units/")) else 0


def init_pool(cfg, max_slots: int, max_len: int,
              enc_len: Optional[int] = None, *, device) -> dict:
    """A decode cache of ``max_slots`` slots and ``max_len`` columns
    (whisper's: ``enc_len`` frames, default ``max_len``) with a per-slot
    length tensor at ``idx``."""
    from repro_torch.launch import steps as steps_mod

    mod = steps_mod.model_module(cfg)
    if cfg.family == "audio":
        cache = mod.init_cache(cfg, max_slots, max_len, enc_len or max_len,
                               device=device)
    else:
        cache = mod.init_cache(cfg, max_slots, max_len, device=device)
    cache["idx"] = torch.zeros((max_slots,), dtype=torch.int32,
                               device=device)
    return cache


def empty_row_like(pool: dict) -> dict:
    """A one-slot empty cache shaped like ``pool``'s rows: zeros, the
    ``pos`` tracks at the far-future sentinel, ``idx`` 0 (a fresh
    ``init_cache`` row)."""
    out = {}
    for key, leaf in pool.items():
        if key == "idx":
            out[key] = 0
            continue
        shape = list(leaf.shape)
        shape[slot_dim(key)] = 1
        fill = UNWRITTEN_POS if key.rsplit("/", 1)[-1] == "pos" else 0
        out[key] = torch.full(shape, fill, dtype=leaf.dtype,
                              device=leaf.device)
    return out


def write_slot(pool: dict, slot: int, row: dict, length: int) -> dict:
    """Copy the one-slot cache ``row`` into slot ``slot`` of ``pool``.

    ``length`` is the request's real prompt length: ``pos`` columns at
    or past it are re-masked to the sentinel, so the bucket padding a
    prefill wrote is never attended, and the slot's ``idx`` becomes
    ``length`` (the row's own ``idx`` is the padded length). Recurrent
    states are copied as they are: the prefill took them at
    ``length - 1``."""
    for key, dst in pool.items():
        if key == "idx":
            dst[slot] = length
            continue
        src = row[key]
        if key.rsplit("/", 1)[-1] == "pos":
            cols = torch.arange(src.shape[-1], device=src.device)
            src = torch.where(cols < length, src,
                              torch.full_like(src, UNWRITTEN_POS))
        d = slot_dim(key)
        dst.select(d, slot).copy_(src.select(d, 0))
    return pool


def reset_slot(pool: dict, slot: int, empty_row: Optional[dict] = None
               ) -> dict:
    """Free slot ``slot``: the empty row (length 0, positions at the
    sentinel, states 0). Pass :func:`empty_row_like` of the pool to
    build it once."""
    if empty_row is None:
        empty_row = empty_row_like(pool)
    return write_slot(pool, slot, empty_row, 0)
