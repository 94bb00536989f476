"""Second-order information (SOI) factor layout (counterpart of
``repro.core.soi``, without the shard hints).

K-FAC factors each linear layer's Fisher block into ``A = E[a a^T]``
(input side) and ``G = E[g g^T]`` (output side), stored block-diagonally
with block size ``bs``. A linear with weight ``(*stack, d_in, d_out)``
owns ``A (*stack, nb_in, bs, bs)`` and ``G (*stack, nb_out, bs, bs)``,
and its gradient is preconditioned per tile:
``dW[i, j] = A_inv[i] @ g[i, j] @ G_inv[j]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import quantize


@dataclasses.dataclass(frozen=True)
class LinearSpec:
    """A K-FAC-factored linear layer registered by a model; ``name`` is
    the weight's '/'-joined parameter path."""

    d_in: int
    d_out: int
    stack: Tuple[int, ...] = ()
    share_a_with: str | None = None
    cap_tokens: bool = False


@dataclasses.dataclass(frozen=True)
class SlicedSpec(LinearSpec):
    """A model rank's slice of a factored linear (tensor parallelism):
    ``bs_in``/``bs_out`` fix the block size of a side whose width is a
    slice to that of the full leaf's width, which the slice's own width
    may not give, so the rank holds whole blocks of the full factor (0:
    :func:`block_size_for` of the side's width)."""

    bs_in: int = 0
    bs_out: int = 0


def spec_blocks(spec, cap: int) -> Tuple[int, int]:
    """The (A, G) block sizes of ``spec`` (any object with ``d_in`` and
    ``d_out``; a :class:`SlicedSpec`'s fixed ones) at block cap
    ``cap``."""
    return (getattr(spec, "bs_in", 0) or block_size_for(spec.d_in, cap),
            getattr(spec, "bs_out", 0) or block_size_for(spec.d_out, cap))


def n_blocks(d: int, bs: int) -> int:
    return -(-d // bs)


def leaf_block_count(shape: Tuple[int, ...]) -> int:
    """Diagonal blocks in one factor leaf ``(*stack, nb, bs, bs)``."""
    return math.prod(int(d) for d in shape[:-2])


def block_size_for(d: int, cap: int, align: int = 16) -> int:
    """Block size for a feature dimension ``d``: the whole dimension when
    ``d <= cap``, else the largest size >= 128 dividing both ``d`` and
    ``d / align``, else an exact divisor >= 128, else ``cap`` (padded).
    Identical to the reference, so both packages block alike."""
    if d <= cap:
        return d
    if d % align == 0:
        shard = d // align
        for bs in range(min(cap, shard), 127, -1):
            if shard % bs == 0 and d % bs == 0:
                return bs
    for bs in range(min(cap, d), 127, -1):
        if d % bs == 0:
            return bs
    return cap


def pad_to_blocks(x: torch.Tensor, axis: int, bs: int) -> torch.Tensor:
    d = x.shape[axis]
    pad = n_blocks(d, bs) * bs - d
    if pad == 0:
        return x
    axis = axis % x.ndim
    widths = [0, 0] * (x.ndim - 1 - axis) + [0, pad]
    return F.pad(x, widths)


def blocked_gram(a: torch.Tensor, cap: int, block: int = 0) -> torch.Tensor:
    """(..., T, d) activations -> (..., nb, bs, bs) diagonal-block Gram
    ``a_i^T a_i / T`` (fp32). Computed as the Gram of
    :func:`blocked_tokens`, so the cols-collecting SMW stats path gets
    the same factors bitwise."""
    return gram_from_tokens(blocked_tokens(a, cap, block))


def blocked_tokens(a: torch.Tensor, cap: int, block: int = 0) -> torch.Tensor:
    """(..., T, d) activations -> (..., T, nb, bs) fp32 blocked token
    columns, the rank-T square root of :func:`blocked_gram` that the
    SMW incremental refresh (``repro_torch.solve.smw``) consumes.
    ``block``: the block size itself (a model slice's, that of its full
    width); 0 takes :func:`block_size_for` of ``d`` at ``cap``."""
    bs = block or block_size_for(a.shape[-1], cap)
    a = pad_to_blocks(a.to(torch.float32), -1, bs)
    nb = a.shape[-1] // bs
    return a.reshape(a.shape[:-1] + (nb, bs))


def gram_from_tokens(bt: torch.Tensor) -> torch.Tensor:
    """(..., T, nb, bs) blocked tokens -> (..., nb, bs, bs) Gram
    ``cols^T cols / T``."""
    t = bt.shape[-3]
    gram = torch.einsum("...tib,...tic->...ibc", bt, bt)
    return gram / t


def cols_from_tokens(bt: torch.Tensor) -> torch.Tensor:
    """(..., T, nb, bs) blocked tokens -> (..., nb, T, bs) per-block
    column factors ``V`` with Gram contribution ``V^T V / T`` (a view)."""
    return torch.movedim(bt, -3, -2)


def factor_shapes(spec: LinearSpec, cap: int) -> dict:
    shapes = {}
    bi, bo = spec_blocks(spec, cap)
    if spec.share_a_with is None:
        shapes["A"] = spec.stack + (n_blocks(spec.d_in, bi), bi, bi)
    shapes["G"] = spec.stack + (n_blocks(spec.d_out, bo), bo, bo)
    return shapes


def init_factors(specs: Mapping[str, LinearSpec], bs: int, *,
                 device) -> dict:
    return {name: {k: torch.zeros(v, dtype=torch.float32, device=device)
                   for k, v in factor_shapes(spec, bs).items()}
            for name, spec in specs.items()}


def init_inverses(specs: Mapping[str, LinearSpec], bs: int, *,
                  device) -> dict:
    """Identity blocks: the first steps are plain momentum SGD."""
    out = {}
    for name, spec in specs.items():
        out[name] = {
            k + "_inv": torch.eye(shp[-1], dtype=torch.float32,
                                  device=device).expand(shp).contiguous()
            for k, shp in factor_shapes(spec, bs).items()}
    return out


def two_sided_block_vmm(a_inv: torch.Tensor, gp: torch.Tensor,
                        g_inv: torch.Tensor, *,
                        precision: str = "fp32") -> torch.Tensor:
    """``A_inv[i] @ g[i, j] @ G_inv[j]`` on blocked tiles
    ``(..., nb_i, bi, nb_o, bo)``, association pinned left-first."""
    tmp = quantize.lowp_einsum("...iab,...ibjc->...iajc", a_inv, gp,
                               precision=precision)
    return quantize.lowp_einsum("...iajc,...jcd->...iajd", tmp, g_inv,
                                precision=precision)


def gather_grad_tiles(g: torch.Tensor, stack: Tuple[int, ...], bi: int,
                      bo: int) -> torch.Tensor:
    """``(*stack, d_in, d_out)`` -> ``(prod(stack)*nb_i*nb_o, bi, bo)``
    tiles, C-order over (stack..., i, j); pads are zero."""
    gp = pad_to_blocks(pad_to_blocks(g, -2, bi), -1, bo)
    nb_i, nb_o = gp.shape[-2] // bi, gp.shape[-1] // bo
    gp = gp.reshape(stack + (nb_i, bi, nb_o, bo))
    ls = len(stack)
    gp = gp.permute(tuple(range(ls)) + (ls, ls + 2, ls + 1, ls + 3))
    return gp.reshape((-1, bi, bo))


def scatter_grad_tiles(tiles: torch.Tensor, stack: Tuple[int, ...],
                       nb_i: int, nb_o: int, d_in: int,
                       d_out: int) -> torch.Tensor:
    """Inverse of :func:`gather_grad_tiles`."""
    bi, bo = tiles.shape[-2], tiles.shape[-1]
    out = tiles.reshape(stack + (nb_i, nb_o, bi, bo))
    ls = len(stack)
    out = out.permute(tuple(range(ls)) + (ls, ls + 2, ls + 1, ls + 3))
    out = out.reshape(stack + (nb_i * bi, nb_o * bo))
    return out[..., :d_in, :d_out]


def block_precondition(g: torch.Tensor, a_inv: torch.Tensor,
                       g_inv: torch.Tensor, *,
                       precision: str = "fp32") -> torch.Tensor:
    """``blockdiag(A_inv) @ g @ blockdiag(G_inv)`` for one leaf
    ``g (*stack, d_in, d_out)`` — the per-leaf WU path."""
    bi, bo = a_inv.shape[-1], g_inv.shape[-1]
    d_in, d_out = g.shape[-2], g.shape[-1]
    stack = tuple(g.shape[:-2])
    gp = pad_to_blocks(pad_to_blocks(g, -2, bi), -1, bo)
    nb_i, nb_o = gp.shape[-2] // bi, gp.shape[-1] // bo
    gp = gp.reshape(stack + (nb_i, bi, nb_o, bo))
    out = two_sided_block_vmm(a_inv, gp, g_inv, precision=precision)
    out = out.reshape(stack + (nb_i * bi, nb_o * bo))
    return out[..., :d_in, :d_out]


def tikhonov_damping(f: torch.Tensor, rel: float) -> torch.Tensor:
    """Per-block Tikhonov level ``rel * tr(block)/bs + 1e-8``."""
    bs = f.shape[-1]
    tr = torch.diagonal(f, dim1=-2, dim2=-1).sum(-1) / bs
    return rel * tr + 1e-8
