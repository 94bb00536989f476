"""int8 error-feedback gradient compression for the data-parallel
all-reduce (counterpart of ``repro.dist.compression``).

Each step quantizes ``g + e`` to int8 and carries the quantization
residual ``e`` into the next step, so the error never accumulates: over
T steps the sum of the compressed means differs from the true sum by at
most one quantization step.

Codec: symmetric linear, one scale ``s = max over ranks of max|g + e|``
(an ``all_reduce`` MAX of one scalar), round to nearest even into [-127,
127]. The round trip's error is at most ``s / 254`` an element (the
tests assert the looser ``s / 127``).

Wire format: each rank's int8 codes are all-gathered and the mean is
formed locally in fp32 (an all-reduce cannot sum int8 codes in flight
without overflow; gather and a local reduce keep every wire byte int8).

Unlike the reference's wrapper, which replicates one logical value per
leaf into a ``shard_map``, each rank here holds its own partial gradient
(real data parallelism): :func:`compressed_psum` is the reference's
in-``shard_map`` function, run by every rank of the group.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch

from repro_torch.dist.api import all_gather_rows, all_reduce, mesh_axes


def quantize_code(x: torch.Tensor, scale) -> torch.Tensor:
    """fp32 -> int8 code with symmetric scale ``scale`` (clip at 127)."""
    s = torch.clamp_min(torch.as_tensor(scale, dtype=torch.float32,
                                        device=x.device), 1e-30)
    q = torch.round(x.to(torch.float32) * (127.0 / s))
    return torch.clamp(q, -127.0, 127.0).to(torch.int8)


def dequantize_code(q: torch.Tensor, scale) -> torch.Tensor:
    """int8 code -> fp32."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    return q.to(torch.float32) * (s / 127.0)


def init_error_buffers(grads: Any) -> Any:
    """Persistent fp32 residual buffers, one per gradient leaf."""
    if isinstance(grads, dict):
        return {k: init_error_buffers(v) for k, v in grads.items()}
    return torch.zeros(grads.shape, dtype=torch.float32,
                       device=grads.device)


def compressed_psum(g: torch.Tensor, err: torch.Tensor, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compressed mean of ``g`` over the ranks of ``mesh`` with error
    feedback: ``(mean, new_err)``, where ``new_err`` is this rank's
    quantization residual (feed it back as ``err`` next step). Every rank
    of ``mesh`` calls it. Without a mesh it is the local quantize round
    trip (the one-rank case)."""
    c = g.to(torch.float32) + err
    s = c.abs().max().reshape(1)
    if mesh is not None:
        all_reduce(s, mesh, "max")             # one scalar on the wire
    s = torch.clamp_min(s[0], 1e-30)
    q = quantize_code(c, s)
    new_err = c - dequantize_code(q, s)
    if mesh is None:
        return dequantize_code(q, s), new_err
    gathered = all_gather_rows(q[None], mesh)  # int8 on the wire
    return dequantize_code(gathered, s).mean(dim=0), new_err


def _reduce_mesh(mesh, axis_names: Sequence[str]):
    """The (sub)mesh whose ranks reduce together over ``axis_names``
    (filtered to the axes ``mesh`` has), or None when none is left: the
    mesh itself, a one-axis submesh (``data`` of a ``(data, model)``
    mesh), or several axes' submesh flattened into one axis (its group
    made by every rank of the mesh at the first such call)."""
    if mesh is None:
        return None
    axes = tuple(a for a in mesh_axes(mesh) if a in axis_names)
    if not axes:
        return None
    if len(axes) == len(mesh_axes(mesh)):
        return mesh
    if len(axes) == 1:
        return mesh[axes[0]]
    return mesh[axes]._flatten()


def compressed_allreduce_tree(grads: Any, errors: Any, mesh,
                              axis_names: Sequence[str]
                              ) -> Tuple[Any, Any]:
    """Every leaf of a gradient tree (nested dicts of tensors) through
    :func:`compressed_psum` over ``axis_names`` of ``mesh`` (filtered to
    the axes the mesh has; none left, or no mesh, is the local round
    trip, which keeps the error-feedback invariant). Returns ``(means,
    new_errors)`` in the input's structure."""
    sub = _reduce_mesh(mesh, axis_names)

    def walk(g, e):
        if isinstance(g, dict):
            pairs = {k: walk(g[k], e[k]) for k in g}
            return ({k: p[0] for k, p in pairs.items()},
                    {k: p[1] for k, p in pairs.items()})
        return compressed_psum(g, e, sub)

    return walk(grads, errors)
