"""Fused INV->VMM: the distributed refresh and the pooled
preconditioning in one program (counterpart of ``repro.solve.fused_wu``).

The paper's mapping scheme wires INV crossbar groups straight into the
weight-update VMM crossbars (Sec. V): an SOI inverse feeds its VMMs as
soon as it settles. The block-parallel refresh (``block_solver``)
all-gathers every inverse shard before a single WU product runs. In the
``owner`` mode each rank, having inverted its plan-owned blocks (the
``neumann_inv`` kernel on the card, one grouped call),

  1. runs the left (A-side) product on the gradient tiles whose A blocks
     it owns (the WU plan lays the tiles device-major by A owner);
  2. all-gathers the ``A^-1 g`` intermediates once, which routes them to
     the owners of the G blocks;
  3. runs the right (G-side) product on the tiles whose G blocks it
     owns, against its local inverses;
  4. gathers the outputs, and the inverse shards for the optimizer state.

``mode="gather"`` is the staged baseline: the block solver's gathered
refresh, then the replicated pooled product
(``kfac.precondition_pooled``). Both products are
``quantize.lowp_einsum`` at ``cfg.precision``, as in the reference, whose
products here sit outside any Pallas kernel. Per tile the arithmetic is
the same left-first association in every mode and a collective only
moves bits, so on the CPU both modes are bitwise the local ``mesh=None``
call. (On the card the batched fp32 product may take another kernel for
another batch count.) The trainer does not call this module: its
data-parallel step runs the gathered refresh and then its own WU on the
``fused_precond`` kernel. It serves the library, the tests and
``benchmarks.wu_fusion --dist``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import quantize
from repro_torch.core.kfac import (KFACConfig, group_tiles,
                                   precondition_pooled, scatter_group_tiles)
from repro_torch.dist.api import all_gather_rows, mesh_position
from repro_torch.solve.block_solver import (_scatter_group, check_plan_mesh,
                                            invert_factor_tree, invert_pools)
from repro_torch.solve.partition import WUPlan

__all__ = ["refresh_and_precondition", "DEFAULT_DIST_MODE"]

#: the reference's default: the owner-routed program, the paper's dataflow
DEFAULT_DIST_MODE = "owner"


def _take(per_tile: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """``per_tile`` at each live slot of a (m,) device-major row, 0 at its
    padding slots (whose tiles are zero and whose outputs are dropped)."""
    out = np.zeros(slots.shape, np.int64)
    live = slots >= 0
    out[live] = per_tile[slots[live]]
    return out


def _owner_group(grp, tiles, local_inv, row, mesh, precision):
    """The owner-routed products of one WU group on this rank: its tiles
    in concat order -> this group's preconditioned tiles, concat order."""
    dev = tiles.device

    def ix(a):
        return torch.as_tensor(a, dtype=torch.long, device=dev)

    mine = grp.slots[row]
    ext = torch.cat([tiles, torch.zeros_like(tiles[:1])])
    pad = mine.copy()
    pad[pad < 0] = tiles.shape[0]               # -> the zero pad tile
    tmp = quantize.lowp_einsum(
        "nab,nbc->nac", local_inv[grp.bi][ix(_take(grp.a_slot, mine))],
        ext[ix(pad)], precision=precision)
    tmp_all = all_gather_rows(tmp, mesh)        # (ndev*mt, bi, bo)
    g_row = grp.g_slots[row]
    o = quantize.lowp_einsum(
        "nac,ncd->nad", tmp_all[ix(_take(grp.gather_back, g_row))],
        local_inv[grp.bo][ix(_take(grp.g_slot, g_row))],
        precision=precision)
    return all_gather_rows(o, mesh)[ix(grp.g_gather_back)]


def refresh_and_precondition(
    factors: Mapping[str, Mapping[str, Any]],
    grads_by_name: Mapping[str, torch.Tensor],
    cfg: KFACConfig,
    wu_plan: WUPlan,
    *,
    mesh=None,
    mode: Optional[str] = None,
):
    """Invert every SOI block and precondition every factored gradient in
    one program: ``(inverses_tree, pre_by_name)``.

    ``mesh``: a DeviceMesh of ``wu_plan.ndev`` ranks, every rank calling
    with the same factors and gradients (a plan built for another count
    raises ``ValueError``). Without one (or on a one-device plan) it is
    the replicated refresh and the pooled product, the single-process
    image of the same program."""
    mode = mode or DEFAULT_DIST_MODE
    if mode not in ("gather", "owner"):
        raise ValueError(f"unknown dist mode {mode!r}")
    plan = wu_plan.inv_plan
    distributed = check_plan_mesh(plan, mesh, "wu_plan")
    if not distributed or mode == "gather":
        inv = invert_factor_tree(factors, cfg, mesh=mesh,
                                 plan=plan if distributed else None)
        return inv, precondition_pooled(grads_by_name, inv, wu_plan,
                                        precision=cfg.precision)

    row = mesh_position(mesh)
    # 1. this rank's rows of every device-major pool, one grouped call
    shards = invert_pools(factors, cfg, plan, mesh)
    local_inv = {g.bs: inv for g, inv in zip(plan.groups, shards)}
    # 2.-3. the left product on the local inverses, one gather routing
    # the intermediates to the G owners, the right product locally
    pre: dict = {}
    for grp in wu_plan.groups:
        pre.update(scatter_group_tiles(grp, _owner_group(
            grp, group_tiles(grads_by_name, grp), local_inv, row, mesh,
            cfg.precision)))
    # 4. the inverse shards, gathered for the optimizer state
    inverses: dict = {}
    for g, shard in zip(plan.groups, shards):
        for name, d in _scatter_group(factors, g,
                                      all_gather_rows(shard, mesh),
                                      None).items():
            inverses.setdefault(name, {}).update(d)
    inverses = {name: {side + "_inv": inverses[name][side + "_inv"]
                       for side in factors[name]} for name in factors}
    return inverses, pre
