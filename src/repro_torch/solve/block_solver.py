"""Block-parallel SOI inversion through a plan (counterpart of
``repro.solve.block_solver``).

The partitioner's :class:`~repro_torch.solve.partition.Plan` pools every
same-size diagonal block of the network device-major,
``(ndev, m, bs, bs)``, with an identity block (damping 1.0) in each
padding slot. On a mesh (``mesh=``, a DeviceMesh of ``plan.ndev`` ranks)
each rank takes its row of every pool (the row of its position in
``mesh.mesh.flatten()``), inverts them in one grouped
``invert_blocks_grouped`` call (the ``neumann_inv`` kernel on the card:
one launch a block side up to 128), all-gathers the inverse shards and
scatters them back into the ``A_inv``/``G_inv`` layout, so that each rank
inverts about ``1/ndev`` of the blocks (the paper's factor blocks spread
over parallel INV crossbar groups, Sec. IV-B). Without a mesh the pooled
program runs locally, the reference's "single-process image of the same
graph". The kernel computes every block on its own, and a gather only
moves bits, so the distributed, pooled and replicated paths agree
bitwise. Leaves the plan diverted for being above its cap go through
``solve.pdiv``, their stage pairs spread over the mesh.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import soi
from repro_torch.core.kfac import KFACConfig, invert_blocks_grouped, \
    invert_factors
from repro_torch.dist.api import all_gather_rows, mesh_ndev, mesh_position
from repro_torch.solve.partition import Plan
from repro_torch.solve.pdiv import pdiv_invert

__all__ = ["invert_factor_tree"]


def _leaf_flat(f: torch.Tensor, cfg: KFACConfig):
    """(N, bs, bs) blocks and (N,) per-block Tikhonov damping of a leaf."""
    bs = f.shape[-1]
    return (f.reshape(-1, bs, bs),
            soi.tikhonov_damping(f, cfg.damping).reshape(-1))


def _pool_group(factors, cfg: KFACConfig, group, row=None):
    """A group's blocks concatenated and indexed device-major, flattened
    to (ndev*m, bs, bs) with their (ndev*m,) damping, or with ``row`` only
    that device's (m, bs, bs) and (m,); padding slots take an identity
    block at damping 1.0, which the scatter discards."""
    blocks, lams = zip(*(_leaf_flat(factors[name][side], cfg)
                         for name, side in group.leaves))
    ref = blocks[0]
    ext = torch.cat(blocks + (torch.eye(group.bs, dtype=ref.dtype,
                                        device=ref.device)[None],))
    lam_ext = torch.cat(lams + (torch.ones(1, dtype=lams[0].dtype,
                                           device=ref.device),))
    idx = (group.slots if row is None else group.slots[row]).copy()
    idx[idx < 0] = group.n_blocks                # -> the identity pad
    idx = torch.as_tensor(idx.reshape(-1).astype(np.int64),
                          device=ref.device)
    return ext[idx], lam_ext[idx]


def check_plan_mesh(plan, mesh, what: str = "plan") -> bool:
    """Whether the program is distributed: a mesh and a plan of several
    devices (a one-device plan runs locally, as in the reference). A plan
    built for another rank count than the mesh's raises ``ValueError``."""
    if mesh is None or plan.ndev <= 1:
        return False
    if plan.ndev != mesh_ndev(mesh):
        raise ValueError(
            f"{what} was built for {plan.ndev} devices but the mesh has "
            f"{mesh_ndev(mesh)}; rebuild the plan with "
            f"make_plan(factors, mesh_ndev(mesh), cfg)")
    return True


def invert_pools(factors, cfg: KFACConfig, plan, mesh=None) -> list:
    """Every pool of ``plan`` inverted in one grouped call: on a mesh
    this rank's rows only, (m, bs, bs) a group, else the whole
    device-major pools, (ndev*m, bs, bs)."""
    row = None if mesh is None else mesh_position(mesh)
    pools = [_pool_group(factors, cfg, g, row) for g in plan.groups]
    return invert_blocks_grouped([b for b, _ in pools],
                                 [lam for _, lam in pools], cfg)


def _scatter_group(factors, group, pooled: torch.Tensor, out) -> dict:
    """Undo the pooling: (ndev*m, bs, bs) -> per-leaf inverses (written
    into ``out``'s leaves when given)."""
    ordered = pooled[torch.as_tensor(group.gather_back.astype(np.int64),
                                     device=pooled.device)]
    res: dict = {}
    ofs = 0
    for (name, side), cnt in zip(group.leaves, group.leaf_counts):
        key = side + "_inv"
        inv = ordered[ofs:ofs + cnt].reshape(factors[name][side].shape)
        if out is not None:
            inv = out[name][key].copy_(inv)
        res.setdefault(name, {})[key] = inv
        ofs += cnt
    return res


def invert_factor_tree(factors: Mapping[str, Mapping[str, Any]],
                       cfg: KFACConfig, *, mesh=None,
                       plan: Optional[Plan] = None, out=None) -> dict:
    """Factor tree ``{name: {A|G: ...}}`` -> ``{name: {A_inv|G_inv: ...}}``.

    Without a plan this is the replicated path, ``kfac.invert_factors``
    (one grouped launch a block side). With a plan it pools the blocks
    device-major: with ``mesh`` (a DeviceMesh of ``plan.ndev`` ranks,
    every rank calling) each rank inverts its own row of every pool and
    the inverse shards are all-gathered; without one the whole pools are
    inverted locally. Then the blocks are scattered back and the plan's
    pdiv sub-schedule runs. Every path is bitwise the replicated one.
    ``out``: an inverse tree to write the result into (a refresh reusing
    the tree it retires)."""
    if plan is None:
        return invert_factors(factors, cfg, out=out)
    if check_plan_mesh(plan, mesh):
        invs = [all_gather_rows(inv, mesh)
                for inv in invert_pools(factors, cfg, plan, mesh)]
    else:
        mesh = None
        invs = invert_pools(factors, cfg, plan)
    res: dict = {}
    for g, inv in zip(plan.groups, invs):
        for name, d in _scatter_group(factors, g, inv, out).items():
            res.setdefault(name, {}).update(d)
    for entry in plan.pdiv:
        leaf = factors[entry.name][entry.side]
        flat, lam = _leaf_flat(leaf, cfg)
        inv = pdiv_invert(flat, lam, cfg, depth=entry.depth,
                          mesh=mesh).reshape(leaf.shape)
        key = entry.side + "_inv"
        if out is not None:
            inv = out[entry.name][key].copy_(inv)
        res.setdefault(entry.name, {})[key] = inv
    # the replicated path's layout: factors' name order, A before G
    return {name: {side + "_inv": res[name][side + "_inv"]
                   for side in factors[name]} for name in factors}
