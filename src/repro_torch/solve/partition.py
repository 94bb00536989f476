"""Block layouts for INV and WU (counterpart of
``repro.solve.partition``).

Built host-side from factor shapes only (tensors, meta tensors, or
anything with a ``.shape``). The INV :class:`Plan` pools every
same-``bs`` factor block of the network and assigns each block to one
of ``ndev`` devices by FLOP cost (greedy LPT, the reference's
``make_plan``); on one device every block goes to device 0 and the pools
are the concatenation order of the groups' leaves. Leaves whose blocks
exceed ``pdiv_cap_bs`` leave the pools for the plan's pdiv sub-schedule
(``solve.pdiv``). The :class:`WUPlan` enumerates every factored gradient
tile and, per ``(bi, bo)`` group, indexes each tile's ``A_inv``/``G_inv``
block inside those pools (``a_src``/``g_src``) — the layout the
``fused_precond`` kernel consumes — and routes each tile to the devices
owning its blocks (the distributed ``solve.fused_wu``); ``stacked``
groups the leaves by blocked geometry, as the reference's local fused
program does.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.kfac import KFACConfig
from repro_torch.core.soi import LinearSpec, leaf_block_count


def inverse_block_flops(bs: int, cfg: KFACConfig) -> float:
    """Cost model for one composed-precision block inverse: each hi/lo
    product is 3 bf16 partials of ``2 bs^3`` (2 when one operand is
    exactly bf16). Newton-Schulz is 5 partials an iteration, each Neumann
    term 5, each refinement 6; the "exact" method ``(8/3) bs^3``. Only
    the ordering matters to the partitioner: every method is monotone in
    ``bs``."""
    if cfg.inv_method == "exact":
        return (8.0 / 3.0) * bs ** 3
    taylor = 1 if cfg.inv_method == "composed_fast" else cfg.taylor_terms
    products = (5 * cfg.ns_iters + 5 * max(taylor - 1, 0)
                + 6 * cfg.refine_steps)
    return 2.0 * products * bs ** 3


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """All same-``bs`` blocks of the factor tree, pooled and assigned.

    ``leaves``       (name, side) pairs in concatenation order (sorted).
    ``leaf_counts``  blocks contributed by each leaf.
    ``slots``        (ndev, m) indices into the concatenated block list;
                     -1 marks a padding slot (an identity block).
    ``gather_back``  (N,) position of concatenated block ``j`` inside the
                     flattened (ndev*m,) pooled output.
    """

    bs: int
    leaves: Tuple[Tuple[str, str], ...]
    leaf_counts: Tuple[int, ...]
    slots: np.ndarray
    gather_back: np.ndarray

    @property
    def n_blocks(self) -> int:
        return int(sum(self.leaf_counts))

    @property
    def per_device(self) -> int:
        return int(self.slots.shape[1])


@dataclasses.dataclass(frozen=True)
class PdivEntry:
    """One factor leaf whose blocks exceed the pool cap: the solver
    inverts its blocks by recursive block-Schur (``solve.pdiv_invert``)
    at ``depth`` levels, so that every sub-inversion is of size
    ``bs / 2^depth``."""

    name: str
    side: str
    bs: int
    depth: int


@dataclasses.dataclass(frozen=True)
class Plan:
    """Static block->device assignment for one factor-tree geometry."""

    groups: Tuple[GroupPlan, ...]
    ndev: int = 1
    device_blocks: Tuple[int, ...] = ()    # real (non-pad) blocks per dev
    device_flops: Tuple[float, ...] = ()
    pdiv: Tuple[PdivEntry, ...] = ()       # oversized leaves, cap-diverted

    @property
    def total_blocks(self) -> int:
        return int(sum(g.n_blocks for g in self.groups))

    @property
    def max_device_blocks(self) -> int:
        return int(max(self.device_blocks))

    def summary(self) -> dict:
        return {
            "ndev": self.ndev,
            "total_blocks": self.total_blocks,
            "device_blocks": list(self.device_blocks),
            "device_gflops": [round(f / 1e9, 3) for f in self.device_flops],
            "groups": [{"bs": g.bs, "n_blocks": g.n_blocks,
                        "per_device": g.per_device} for g in self.groups],
            "pdiv": [{"leaf": f"{e.name}/{e.side}", "bs": e.bs,
                      "depth": e.depth} for e in self.pdiv],
        }


def pdiv_depth(bs: int, cap: int) -> int:
    """Smallest split depth bringing a ``bs`` block under ``cap``; each
    level halves the block and needs an even size, so the depth stops at
    the first odd size."""
    depth = 0
    while bs > cap and bs % 2 == 0:
        bs //= 2
        depth += 1
    return depth


def _devmajor(assign: np.ndarray, ndev: int):
    """Device-major layout of an item->device assignment: ``slots``
    (ndev, m) item indices (-1 pads) and ``gather_back`` (N,) undoing
    it."""
    n = assign.shape[0]
    m = int(max(np.bincount(assign, minlength=ndev).max(), 1)) if n else 1
    slots = np.full((ndev, m), -1, np.int32)
    gather_back = np.empty(n, np.int32)
    fill = [0] * ndev
    for t in range(n):
        d = int(assign[t])
        slots[d, fill[d]] = t
        gather_back[t] = d * m + fill[d]
        fill[d] += 1
    return slots, gather_back


def make_plan(factors: Mapping[str, Mapping[str, Any]], ndev: int = 1,
              cfg: Optional[KFACConfig] = None, *,
              pdiv_cap_bs: Optional[int] = None) -> Plan:
    """Assign every factor block to one of ``ndev`` devices.

    ``factors``: ``{name: {"A"|"G": tensor-or-shape-holder}}`` (the
    ``KFACState.factors`` layout; G-only Gauss-Newton trees too).
    ``cfg`` prices a block (:func:`inverse_block_flops`; default
    ``KFACConfig()``). Greedy LPT: groups are visited in descending
    per-block cost and each block goes to the device with the least
    accumulated FLOPs (ties on block count, then device index), so equal
    costs round-robin. ``pdiv_cap_bs``: leaves of even ``bs`` above it
    are not pooled but become :class:`PdivEntry` sub-schedules at the
    depth that brings their sub-inversions under the cap."""
    if ndev < 1:
        raise ValueError(f"ndev must be >= 1, got {ndev}")
    cfg = cfg or KFACConfig()
    by_bs: dict = {}
    pdiv_entries = []
    for name in sorted(factors):
        for side in sorted(factors[name]):
            shape = tuple(factors[name][side].shape)
            if len(shape) < 3 or shape[-1] != shape[-2]:
                raise ValueError(f"factor {name}/{side} is not "
                                 f"(*stack, nb, bs, bs): {shape}")
            bs = int(shape[-1])
            if pdiv_cap_bs is not None and bs > pdiv_cap_bs \
                    and bs % 2 == 0:
                pdiv_entries.append(PdivEntry(
                    name=name, side=side, bs=bs,
                    depth=pdiv_depth(bs, pdiv_cap_bs)))
                continue
            by_bs.setdefault(bs, []).append(
                ((name, side), leaf_block_count(shape)))

    loads = [0.0] * ndev
    counts = [0] * ndev
    groups = []
    for bs in sorted(by_bs, key=lambda b: -inverse_block_flops(b, cfg)):
        entries = by_bs[bs]
        cost = inverse_block_flops(bs, cfg)
        n = sum(c for _, c in entries)
        owners = np.empty(n, np.int32)
        for j in range(n):
            d = min(range(ndev), key=lambda i: (loads[i], counts[i], i))
            owners[j] = d
            loads[d] += cost
            counts[d] += 1
        slots, gather_back = _devmajor(owners, ndev)
        groups.append(GroupPlan(
            bs=bs, leaves=tuple(k for k, _ in entries),
            leaf_counts=tuple(c for _, c in entries),
            slots=slots, gather_back=gather_back))
    return Plan(groups=tuple(groups), ndev=ndev,
                device_blocks=tuple(counts), device_flops=tuple(loads),
                pdiv=tuple(pdiv_entries))


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


def _owner_table(group: GroupPlan) -> np.ndarray:
    """Device owning each concatenated block of an INV group."""
    return (group.gather_back // group.per_device).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class WUGroupPlan:
    """All same-``(bi, bo)`` gradient tiles; ``a_src``/``g_src`` index
    each tile's inverse blocks in the ``bi``/``bo`` pools.

    The owner routing of the distributed fused INV->VMM program
    (``solve.fused_wu``): ``slots``/``gather_back`` lay the tiles
    device-major by the owner of their A block (the left product's
    placement), ``g_slots``/``g_gather_back`` by the owner of their G
    block (the right product's); ``a_slot``/``g_slot`` are each tile's
    block position within its owner's row of the device-major inverse
    pool (``Plan.groups[...].slots``)."""

    bi: int
    bo: int
    leaves: Tuple[WULeaf, ...]
    a_src: np.ndarray
    g_src: np.ndarray
    slots: np.ndarray
    gather_back: np.ndarray
    a_slot: np.ndarray
    g_slots: np.ndarray
    g_gather_back: np.ndarray
    g_slot: np.ndarray
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
class StackedGroup:
    """Leaves sharing one blocked geometry ``(nb_i, bi, nb_o, bo)``: the
    reference's local fused WU program concatenates them along the
    flattened stack axis and runs one two-sided block product for the
    group. ``pooled`` is False for a single leaf or when the group's
    gradient bytes exceed the pooling cap (then the members run per
    leaf)."""

    nb_i: int
    bi: int
    nb_o: int
    bo: int
    members: Tuple[WULeaf, ...]
    pooled: bool


@dataclasses.dataclass(frozen=True)
class WUPlan:
    """The pooled layout of the whole WU graph, in two views of one tile
    set: ``groups`` (tile-indexed pools, what ``fused_precond`` reads)
    and ``stacked`` (concat-pooled geometry groups)."""

    inv_plan: Plan
    groups: Tuple[WUGroupPlan, ...]
    stacked: Tuple[StackedGroup, ...] = ()
    ndev: int = 1

    @property
    def total_tiles(self) -> int:
        return int(sum(g.n_tiles for g in self.groups))

    def summary(self) -> dict:
        return {
            "ndev": self.ndev,
            "total_tiles": self.total_tiles,
            "groups": [{"bi": g.bi, "bo": g.bo, "n_tiles": g.n_tiles,
                        "n_leaves": len(g.leaves)} for g in self.groups],
            "stacked": [{"geom": (s.nb_i, s.bi, s.nb_o, s.bo),
                         "n_members": len(s.members), "pooled": s.pooled}
                        for s in self.stacked],
        }


#: multi-member stacked groups above this many gradient bytes run per
#: leaf instead of concat-pooled (the reference's cap)
POOL_BYTES_CAP = 4 << 20


def make_wu_plan(specs: Mapping[str, LinearSpec],
                 factors: Mapping[str, Mapping[str, Any]],
                 cfg: Optional[KFACConfig] = None, *, ndev: int = 1,
                 inv_plan: Plan | None = None,
                 pool_bytes_cap: int = POOL_BYTES_CAP) -> WUPlan:
    """Pool every factored gradient's tiles across layers (shapes only).

    The tiles address the per-``bs`` pools of the INV :class:`Plan`
    (``inv_plan``, or one built for ``ndev`` devices). A plan with pdiv
    entries is refused: its diverted leaves are not in the pools."""
    plan = inv_plan or make_plan(factors, ndev, cfg)
    if plan.ndev != ndev:
        raise ValueError(
            f"inv_plan was built for {plan.ndev} devices, not {ndev}")
    if plan.pdiv:
        raise ValueError(
            "the WU plan addresses the pooled inverse layout, which "
            "cap-diverted (pdiv) leaves are not part of; build the "
            "inv_plan without pdiv_cap_bs for make_wu_plan (diverted: "
            f"{[e.name + '/' + e.side for e in plan.pdiv]})")
    offsets: dict = {}
    for g in plan.groups:
        ofs = 0
        for leaf, cnt in zip(g.leaves, g.leaf_counts):
            offsets[leaf] = (g.bs, ofs)
            ofs += cnt

    pools: dict = {}
    by_geom: dict = {}
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
        bs_a, a_off = offsets[(a_owner, "A")]
        bs_g, g_off = offsets[(name, "G")]
        if (bs_a, bs_g) != (bi, bo):
            raise ValueError(
                f"{name!r}: inv_plan pools its factors at block sizes "
                f"({bs_a}, {bs_g}) but the factor shapes say ({bi}, {bo})")
        s_count = leaf.n_stack
        s_ix = np.repeat(np.arange(s_count), nb_i * nb_o)
        i_ix = np.tile(np.repeat(np.arange(nb_i), nb_o), s_count)
        j_ix = np.tile(np.arange(nb_o), s_count * nb_i)
        entry = pools.setdefault((bi, bo), {"leaves": [], "a": [], "g": []})
        entry["leaves"].append(leaf)
        entry["a"].append((a_off + s_ix * nb_i + i_ix).astype(np.int32))
        entry["g"].append((g_off + s_ix * nb_o + j_ix).astype(np.int32))
        by_geom.setdefault((nb_i, bi, nb_o, bo), []).append(leaf)

    groups = []
    for bi, bo in sorted(pools):
        a_src = np.concatenate(pools[(bi, bo)]["a"])
        g_src = np.concatenate(pools[(bi, bo)]["g"])
        a_group = next(g for g in plan.groups if g.bs == bi)
        g_group = next(g for g in plan.groups if g.bs == bo)
        slots, gather_back = _devmajor(_owner_table(a_group)[a_src],
                                       plan.ndev)
        g_slots, g_gather_back = _devmajor(_owner_table(g_group)[g_src],
                                           plan.ndev)
        groups.append(WUGroupPlan(
            bi=int(bi), bo=int(bo), leaves=tuple(pools[(bi, bo)]["leaves"]),
            a_src=a_src, g_src=g_src, slots=slots, gather_back=gather_back,
            a_slot=(a_group.gather_back[a_src]
                    % a_group.per_device).astype(np.int32),
            g_slots=g_slots, g_gather_back=g_gather_back,
            g_slot=(g_group.gather_back[g_src]
                    % g_group.per_device).astype(np.int32)))
    # the fused_precond kernel reads the pools by these indices unchecked
    # on the card (a check there would sync); hold them in range here
    sizes = {g.bs: g.n_blocks for g in plan.groups}
    for grp in groups:
        for src, bs in ((grp.a_src, grp.bi), (grp.g_src, grp.bo)):
            if src.size and (src.min() < 0 or src.max() >= sizes[bs]):
                raise ValueError(f"WU plan indexes outside the {bs}-block "
                                 f"pool of {sizes[bs]} blocks")
    stacked = []
    for geom in sorted(by_geom):
        members = tuple(by_geom[geom])
        nb_i, bi, nb_o, bo = geom
        group_bytes = 4 * sum(m.n_tiles for m in members) * bi * bo
        stacked.append(StackedGroup(
            nb_i=int(nb_i), bi=int(bi), nb_o=int(nb_o), bo=int(bo),
            members=members,
            pooled=len(members) > 1 and group_bytes <= pool_bytes_cap))
    return WUPlan(inv_plan=plan, groups=tuple(groups),
                  stacked=tuple(stacked), ndev=plan.ndev)
