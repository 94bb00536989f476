"""Int8 serving quantization: weights and KV cache as int8 codes with fp32
scales (counterpart of ``repro.lowp.serve_quant``).

The engine's resident state, the weight dict and the KV pool, is held
as int8 codes with fp32 scales and dequantized in fp32 by each prefill
and each decode chunk (as the reference's jitted programs do; eager
PyTorch materialises the dequantized tensors for the call).

Layout
------
* Weights: every leaf with ``ndim >= 2`` becomes a :class:`QTensor`:
  ``q`` int8 codes and ``scale`` the fp32 per-channel amax over axis -2
  / 127 (one scale a column: an output channel of the port's
  ``(..., d_in, d_out)`` leaves, stacks included). Vectors (biases,
  norm gains) stay fp32, and so does every leaf whose key contains
  ``embed`` (the tied embedding: its error would land on the logits).
* KV cache: the pool's ``.../k`` and ``.../v`` leaves become int8 codes
  with sibling ``.../k_scale`` and ``.../v_scale`` leaves, per-position
  scales (amax over the head dim): the shape of the kv leaf without its
  last axis. The port's pools are flat dicts keyed by path, so a
  sibling sits under the same prefix (``layers/k_scale``) and the pool
  machinery (``serve.pool.slot_dim``) gives it the slot axis of its
  parent.

Codes clip to +-127 (``-128`` is never used). ``torch.round`` rounds
half to even, as ``jnp.round`` does; a zero amax takes the scale 1/127.
Requantization is code-stable: the entry at the amax maps to +-127
exactly, so a dequantize -> requantize round trip gives the same codes.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch

__all__ = [
    "QTensor",
    "quantize_params",
    "dequantize_params",
    "quantize_kv",
    "dequantize_kv",
    "requantize_kv",
    "tree_bytes",
]

_QMAX = 127.0  # int8 symmetric grid: codes in [-127, 127]


class QTensor(NamedTuple):
    """Int8 codes and an fp32 scale; ``q * scale`` dequantizes."""

    q: torch.Tensor
    scale: torch.Tensor


def _encode(x: torch.Tensor, axis: int) -> QTensor:
    x = x.to(torch.float32)
    amax = torch.amax(torch.abs(x), dim=axis, keepdim=True)
    scale = torch.where(amax == 0, torch.ones_like(amax), amax) / _QMAX
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(torch.int8)
    return QTensor(q, scale)


def quantize_params(params: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's flat parameters -> matmul leaves as :class:`QTensor`,
    the vectors and the embedding tables as they were."""
    return {k: p if p.ndim < 2 or "embed" in k else _encode(p, axis=-2)
            for k, p in params.items()}


def dequantize_params(qparams: Dict[str, Any],
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_params`."""
    return {k: (p.q.to(torch.float32) * p.scale).to(dtype)
            if isinstance(p, QTensor) else p for k, p in qparams.items()}


def _is_kv(key: str) -> bool:
    return key.rsplit("/", 1)[-1] in ("k", "v")


def quantize_kv(pool: Dict[str, Any]) -> Dict[str, Any]:
    """KV leaves -> int8 codes and ``*_scale`` siblings (per-position
    amax over the head dim). Other entries (``pos``, ``idx``, recurrent
    states, the paged pool's bookkeeping) pass through."""
    out = {}
    for key, val in pool.items():
        if key.endswith("_scale"):
            continue
        if _is_kv(key):
            qt = _encode(val, axis=-1)
            out[key], out[key + "_scale"] = qt.q, qt.scale[..., 0]
        else:
            out[key] = val
    return out


def dequantize_kv(pool: Dict[str, Any], dtype=torch.float32
                  ) -> Dict[str, Any]:
    """Codes and scales -> float KV leaves, the scale entries removed:
    the layout ``decode_step`` takes. fp32 by default, so that a
    dequantize -> requantize round trip is exact. A KV leaf without a
    scale sibling (an unquantized pool) passes through as it is."""
    out = {}
    for key, val in pool.items():
        if key.endswith("_scale"):
            continue
        scale = pool.get(key + "_scale") if _is_kv(key) else None
        out[key] = val if scale is None else \
            (val.to(torch.float32) * scale[..., None]).to(dtype)
    return out


def requantize_kv(new_pool: Dict[str, Any], like: Dict[str, Any],
                  dirty=None) -> Dict[str, Any]:
    """Float KV leaves (from the decode steps) -> the resident int8
    layout of ``like``, the previous resident pool, which names the
    leaves to encode (those with a scale sibling); other entries pass
    through (the port's decode keeps their dtypes).

    ``dirty`` (optional bool (n,) tensor) marks the written entries of
    axis 1 of the KV leaves: the slot axis of the slot pool's
    ``(L, B, S, ...)`` leaves, the block axis of the paged pool's
    ``(L, n_blocks, bl, ...)``. Clean entries keep their codes and
    scales bitwise from ``like``."""
    out = {}
    for key, val in new_pool.items():
        if key.endswith("_scale"):
            continue
        if _is_kv(key) and key + "_scale" in like:
            qt = _encode(val, axis=-1)
            q, s = qt.q, qt.scale[..., 0]
            if dirty is not None:
                mq = dirty.reshape((1, -1) + (1,) * (q.ndim - 2))
                ms = dirty.reshape((1, -1) + (1,) * (s.ndim - 2))
                q = torch.where(mq, q, like[key])
                s = torch.where(ms, s, like[key + "_scale"])
            out[key], out[key + "_scale"] = q, s
        else:
            out[key] = val
    return out


def tree_bytes(tree: Dict[str, Any]) -> int:
    """Resident bytes of a flat dict's tensors (a :class:`QTensor`
    counts its codes and its scales)."""
    n = 0
    for leaf in tree.values():
        for t in (leaf if isinstance(leaf, QTensor) else (leaf,)):
            if torch.is_tensor(t):
                n += t.numel() * t.element_size()
    return n
