"""Carry parameters and K-FAC state between the reference's trees and
the port's tensors, through numpy.

The reference keeps parameters as nested dicts whose leaf paths
(``dist.api.path_key``) are names like ``layers/attn/wq`` with shape
(L, d, h*hd), ``layers/moe/wg`` (L, e, d, f), ``units/sub0/rec/w_a``
(n_units, lw, lw) or ``tail/sub0/mlp/wd`` (f, d); the port keeps the
same arrays in a flat dict under those names, for every family
(whisper's ``enc/attn/wq``, ``enc/ln1/b``, ``dec/cross/bv``,
``enc_ln_f/w`` ... too). Factors and inverses are
``{name: {"A"|"G": ...}}`` and ``{name: {"A_inv"|"G_inv": ...}}`` in
both. The reference allocates its
optimizer moments as trees shaped like the parameters with zero-size
placeholders on the unused path; the port keeps only the used side.
Weights cross this way because torch cannot reproduce ``jax.random``.

Decode caches cross to the reference's layout for comparison: its
recurrent states are ``(h, conv)`` tuples, which the port keys
``.../h`` and ``.../conv``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _nest(flat: Mapping[str, Any]) -> dict:
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def to_tensor(x, *, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def params_from_jax(tree: Mapping, *, device) -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays -> the port's flat ``{path: tensor}``."""
    return {k: to_tensor(v, device=device)
            for k, v in _flatten(tree).items()}


def params_to_jax(params: Mapping[str, torch.Tensor]) -> dict:
    """The port's flat parameters -> nested dicts of numpy arrays."""
    return _nest({k: to_numpy(v) for k, v in params.items()})


def blocks_from_jax(tree: Mapping, *, device) -> dict:
    """Factor or inverse tree ``{name: {side: array}}`` -> tensors."""
    return {name: {side: to_tensor(v, device=device)
                   for side, v in d.items()}
            for name, d in tree.items()}


def blocks_to_jax(tree: Mapping) -> dict:
    return {name: {side: to_numpy(v) for side, v in d.items()}
            for name, d in tree.items()}


def moments_from_jax(tree: Mapping, *, device) -> Dict[str, torch.Tensor]:
    """A params-shaped moment tree -> ``{path: tensor}`` without the
    zero-size placeholders of the unused update path."""
    return {k: to_tensor(v, device=device)
            for k, v in _flatten(tree).items()
            if np.size(v) or np.ndim(v) == 0}


def moments_to_jax(moments: Mapping[str, torch.Tensor],
                   params: Mapping[str, torch.Tensor]) -> dict:
    """``{path: tensor}`` -> a params-shaped tree, with ``(0,)`` fp32
    placeholders where the port keeps no moment."""
    return _nest({k: (to_numpy(moments[k]) if k in moments
                      else np.zeros((0,), np.float32))
                  for k in params})


_STATE = ("h", "conv")


def cache_to_jax(cache: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """The port's flat cache -> ``{reference path: numpy array}``, the
    reference's tree flattened as ``dist.api.path_key`` spells it (state
    tuples by position: ``.../0`` is ``h``, ``.../1`` is ``conv``)."""
    out = {}
    for k, v in cache.items():
        base = k.rsplit("/", 1)
        if len(base) == 2 and base[1] in _STATE:
            k = f"{base[0]}/{_STATE.index(base[1])}"
        out[k] = (to_numpy(v.float() if v.dtype == torch.bfloat16 else v)
                  if torch.is_tensor(v) else np.asarray(v))
    return out
