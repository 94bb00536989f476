"""Block-parallel SOI inversion through a plan (counterpart of
``repro.solve.block_solver``, single device).

The partitioner's :class:`~repro_torch.solve.partition.Plan` pools every
same-size diagonal block of the network device-major,
``(ndev, m, bs, bs)``, with an identity block (damping 1.0) in each
padding slot. Without a mesh the reference runs that pooled program
locally, as "the single-process image of the same graph"; so does the
port: every pool is inverted by the same grouped ``neumann_inv`` call as
the replicated refresh (one launch a block side), and scattered back
into the ``A_inv``/``G_inv`` layout. The kernel computes every block on
its own, so the pooled and replicated paths agree bitwise. Leaves the
plan diverted for being above its cap go through ``solve.pdiv``.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.core import soi
from repro_torch.core.kfac import KFACConfig, invert_blocks_grouped, \
    invert_factors
from repro_torch.solve.partition import Plan
from repro_torch.solve.pdiv import pdiv_invert

__all__ = ["invert_factor_tree"]


def _leaf_flat(f: torch.Tensor, cfg: KFACConfig):
    """(N, bs, bs) blocks and (N,) per-block Tikhonov damping of a leaf."""
    bs = f.shape[-1]
    return (f.reshape(-1, bs, bs),
            soi.tikhonov_damping(f, cfg.damping).reshape(-1))


def _pool_group(factors, cfg: KFACConfig, group):
    """A group's blocks concatenated and indexed device-major, flattened
    to (ndev*m, bs, bs) with their (ndev*m,) damping; padding slots take
    an identity block at damping 1.0, which the scatter discards."""
    blocks, lams = zip(*(_leaf_flat(factors[name][side], cfg)
                         for name, side in group.leaves))
    ref = blocks[0]
    ext = torch.cat(blocks + (torch.eye(group.bs, dtype=ref.dtype,
                                        device=ref.device)[None],))
    lam_ext = torch.cat(lams + (torch.ones(1, dtype=lams[0].dtype,
                                           device=ref.device),))
    idx = group.slots.copy()
    idx[idx < 0] = group.n_blocks                # -> the identity pad
    idx = torch.as_tensor(idx.reshape(-1).astype(np.int64),
                          device=ref.device)
    return ext[idx], lam_ext[idx]


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
    device-major, inverts every pool in one grouped call and scatters
    them back, then runs the plan's pdiv sub-schedule. ``out``: an
    inverse tree to write the result into (a refresh reusing the tree
    it retires). ``mesh`` must be None: the distributed solver waits for
    the multi-GPU port (ROADMAP Queue 1 item 8)."""
    if mesh is not None:
        raise NotImplementedError(
            "invert_factor_tree(mesh=...) runs the pooled program under a "
            "device mesh; the port runs on one device (multi-GPU is "
            "ROADMAP Queue 1 item 8)")
    if plan is None:
        return invert_factors(factors, cfg, out=out)
    pools = [_pool_group(factors, cfg, g) for g in plan.groups]
    invs = invert_blocks_grouped([b for b, _ in pools],
                                 [lam for _, lam in pools], cfg)
    res: dict = {}
    for g, inv in zip(plan.groups, invs):
        for name, d in _scatter_group(factors, g, inv, out).items():
            res.setdefault(name, {}).update(d)
    for entry in plan.pdiv:
        leaf = factors[entry.name][entry.side]
        flat, lam = _leaf_flat(leaf, cfg)
        inv = pdiv_invert(flat, lam, cfg, depth=entry.depth).reshape(
            leaf.shape)
        key = entry.side + "_inv"
        if out is not None:
            inv = out[entry.name][key].copy_(inv)
        res.setdefault(entry.name, {})[key] = inv
    # the replicated path's layout: factors' name order, A before G
    return {name: {side + "_inv": res[name][side + "_inv"]
                   for side in factors[name]} for name in factors}
