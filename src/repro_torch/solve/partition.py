"""Pooled block layouts for INV and WU on one device (counterpart of
``repro.solve.partition`` at ``ndev=1``; no device assignment, no pdiv).

Built host-side from factor shapes only. The INV :class:`Plan` pools
every same-``bs`` factor block of the network; the :class:`WUPlan`
enumerates every factored gradient tile and, per ``(bi, bo)`` group,
indexes each tile's ``A_inv``/``G_inv`` block inside those pools
(``a_src``/``g_src``) — the layout the ``fused_precond`` kernel consumes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Tuple

import numpy as np
import torch

from repro_torch.core.soi import LinearSpec, leaf_block_count


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """All same-``bs`` blocks of the factor tree, in concatenation order
    of ``leaves`` ((name, side) pairs, sorted)."""

    bs: int
    leaves: Tuple[Tuple[str, str], ...]
    leaf_counts: Tuple[int, ...]

    @property
    def n_blocks(self) -> int:
        return int(sum(self.leaf_counts))


@dataclasses.dataclass(frozen=True)
class Plan:
    groups: Tuple[GroupPlan, ...]

    @property
    def total_blocks(self) -> int:
        return int(sum(g.n_blocks for g in self.groups))


def make_plan(factors: Mapping[str, Mapping[str, Any]]) -> Plan:
    """Pool the factor tree's blocks by block size, largest (costliest)
    first — the reference's group order on one device."""
    by_bs: dict = {}
    for name in sorted(factors):
        for side in sorted(factors[name]):
            shape = tuple(factors[name][side].shape)
            if len(shape) < 3 or shape[-1] != shape[-2]:
                raise ValueError(f"factor {name}/{side} is not "
                                 f"(*stack, nb, bs, bs): {shape}")
            by_bs.setdefault(int(shape[-1]), []).append(
                ((name, side), leaf_block_count(shape)))
    return Plan(groups=tuple(
        GroupPlan(bs=bs, leaves=tuple(k for k, _ in by_bs[bs]),
                  leaf_counts=tuple(c for _, c in by_bs[bs]))
        for bs in sorted(by_bs, reverse=True)))


@dataclasses.dataclass(frozen=True)
class WULeaf:
    """Blocked-gradient geometry of one factored weight: its
    ``prod(stack)*nb_i*nb_o`` tiles enumerate C-order over
    (stack..., i, j); ``a_owner`` owns the input-side inverse."""

    name: str
    a_owner: str
    stack: Tuple[int, ...]
    nb_i: int
    nb_o: int
    d_in: int
    d_out: int

    @property
    def n_stack(self) -> int:
        return math.prod(self.stack) if self.stack else 1

    @property
    def n_tiles(self) -> int:
        return self.n_stack * self.nb_i * self.nb_o


@dataclasses.dataclass(frozen=True)
class WUGroupPlan:
    """All same-``(bi, bo)`` gradient tiles; ``a_src``/``g_src`` index
    each tile's inverse blocks in the ``bi``/``bo`` pools."""

    bi: int
    bo: int
    leaves: Tuple[WULeaf, ...]
    a_src: np.ndarray
    g_src: np.ndarray
    _on_device: dict = dataclasses.field(default_factory=dict, compare=False,
                                         repr=False)

    @property
    def n_tiles(self) -> int:
        return int(sum(l.n_tiles for l in self.leaves))

    def src_on(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(a_src, g_src)`` as int32 tensors on ``device``, copied once
        per device: a copy from the host each step would stall the
        stream's work behind a synchronise."""
        key = str(torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = (torch.as_tensor(self.a_src, device=device),
                                    torch.as_tensor(self.g_src, device=device))
        return self._on_device[key]


@dataclasses.dataclass(frozen=True)
class WUPlan:
    inv_plan: Plan
    groups: Tuple[WUGroupPlan, ...]

    @property
    def total_tiles(self) -> int:
        return int(sum(g.n_tiles for g in self.groups))


def make_wu_plan(specs: Mapping[str, LinearSpec],
                 factors: Mapping[str, Mapping[str, Any]],
                 inv_plan: Plan | None = None) -> WUPlan:
    """Pool every factored gradient's tiles across layers (shapes only)."""
    plan = inv_plan or make_plan(factors)
    offsets: dict = {}
    for g in plan.groups:
        ofs = 0
        for leaf, cnt in zip(g.leaves, g.leaf_counts):
            offsets[leaf] = (g.bs, ofs)
            ofs += cnt

    pools: dict = {}
    for name in sorted(specs):
        spec = specs[name]
        a_owner = spec.share_a_with or name
        if (a_owner, "A") not in offsets or (name, "G") not in offsets:
            raise ValueError(f"factor tree is missing A/G leaves for "
                             f"{name!r} (A owner {a_owner!r})")
        a_shape = tuple(factors[a_owner]["A"].shape)
        g_shape = tuple(factors[name]["G"].shape)
        stack = a_shape[:-3]
        if g_shape[:-3] != stack:
            raise ValueError(f"{name!r}: A/G stack dims disagree "
                             f"({a_shape} vs {g_shape})")
        bi, nb_i = a_shape[-1], a_shape[-3]
        bo, nb_o = g_shape[-1], g_shape[-3]
        leaf = WULeaf(name=name, a_owner=a_owner, stack=stack, nb_i=nb_i,
                      nb_o=nb_o, d_in=spec.d_in, d_out=spec.d_out)
        _, a_off = offsets[(a_owner, "A")]
        _, g_off = offsets[(name, "G")]
        s_count = leaf.n_stack
        s_ix = np.repeat(np.arange(s_count), nb_i * nb_o)
        i_ix = np.tile(np.repeat(np.arange(nb_i), nb_o), s_count)
        j_ix = np.tile(np.arange(nb_o), s_count * nb_i)
        entry = pools.setdefault((bi, bo), {"leaves": [], "a": [], "g": []})
        entry["leaves"].append(leaf)
        entry["a"].append((a_off + s_ix * nb_i + i_ix).astype(np.int32))
        entry["g"].append((g_off + s_ix * nb_o + j_ix).astype(np.int32))

    groups = tuple(
        WUGroupPlan(bi=int(bi), bo=int(bo),
                    leaves=tuple(pools[(bi, bo)]["leaves"]),
                    a_src=np.concatenate(pools[(bi, bo)]["a"]),
                    g_src=np.concatenate(pools[(bi, bo)]["g"]))
        for bi, bo in sorted(pools))
    # the fused_precond kernel reads the pools by these indices unchecked
    # on the card (a check there would sync); hold them in range here
    sizes = {g.bs: g.n_blocks for g in plan.groups}
    for grp in groups:
        for src, bs in ((grp.a_src, grp.bi), (grp.g_src, grp.bo)):
            if src.size and (src.min() < 0 or src.max() >= sizes[bs]):
                raise ValueError(f"WU plan indexes outside the {bs}-block "
                                 f"pool of {sizes[bs]} blocks")
    return WUPlan(inv_plan=plan, groups=groups)
