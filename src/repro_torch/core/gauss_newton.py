"""Gauss-Newton second-order variant (paper Sec. II-A.2; counterpart of
``repro.core.gauss_newton``).

The Hessian block is approximated ``H ~= J B J^T`` with ``B = I`` for
cross-entropy, which in the factored view preconditions with the
output-side factor only: ``dW <- dL/dW G^{-1}`` (A = I). The K-FAC
machinery is reused with the A factors dropped; the G-only factor tree
inverts through the block-parallel solver like full K-FAC's.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import torch

from repro_torch.core import kfac, soi
from repro_torch.core.kfac import KFACConfig, KFACState
from repro_torch.core.soi import LinearSpec
from repro_torch.solve.block_solver import invert_factor_tree


def gn_specs(specs: Mapping[str, LinearSpec]) -> dict:
    """Strip A factors: every linear keeps only its G factor."""
    return {name: LinearSpec(d_in=1, d_out=s.d_out, stack=s.stack,
                             share_a_with=None)
            for name, s in specs.items()}


def stats_rank_k(loss_with_taps, params, taps, batch,
                 specs: Mapping[str, LinearSpec], bs: int):
    """G-only rank-k statistics ``(G_grams, cols, loss)``: the tap-
    gradient columns of ``kfac.stats_rank_k``, with the A side dropped
    (A = I never drifts)."""
    _, g_grams, cols, loss = kfac.stats_rank_k(
        loss_with_taps, params, taps, batch, specs, bs)
    return g_grams, {name: {"G": e["G"]} for name, e in cols.items()}, loss


def refresh_inverses(state: KFACState, cfg: KFACConfig, *, mesh=None,
                     plan=None) -> KFACState:
    """G-only inverse refresh through the solver
    (``solve.block_solver.invert_factor_tree``); without ``plan`` it is
    ``kfac.refresh_inverses`` bitwise on the composed methods."""
    return dataclasses.replace(state, inverses=invert_factor_tree(
        state.factors, cfg, mesh=mesh, plan=plan))


def precondition(grads: Mapping[str, torch.Tensor], state: KFACState,
                 specs: Mapping[str, LinearSpec],
                 cfg: KFACConfig) -> dict:
    """G-side-only preconditioning: ``dW G^{-1}`` per diagonal block, in
    fp32; unfactored leaves pass through."""
    del cfg
    out = {}
    for name, g in grads.items():
        if name not in specs:
            out[name] = g
            continue
        g_inv = state.inverses[name]["G_inv"]
        bs, d_out = g_inv.shape[-1], g.shape[-1]
        gp = soi.pad_to_blocks(g.to(torch.float32), -1, bs)
        nb = gp.shape[-1] // bs
        gp = gp.reshape(g.shape[:-1] + (nb, bs))
        o = torch.einsum("...djb,...jbc->...djc", gp, g_inv)
        out[name] = o.reshape(g.shape[:-1] + (nb * bs,))[..., :d_out]
    return out
