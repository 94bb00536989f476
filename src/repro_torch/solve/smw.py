"""Incremental SOI: Sherman-Morrison-Woodbury rank-k inverse refresh
(counterpart of ``repro.solve.smw``).

Each step's factor EMA ``F' = d F + (1 - d) w V^T V`` (rank k = the
subsample's tokens) is inverted incrementally from the cached inverse,
honouring the decay exactly:

    M      = sym(F_inv) / d
    F'^-1 ~= M - (V M)^T (I/c + V M V^T)^-1 (V M),   c = (1 - d) * w

at O(k bs^2) per block instead of O(bs^3), cheap enough to run every
step. Two gaps are monitored rather than corrected: the cached inverse
is of the damped factor while the tracked damping decays as
``d^n lam_0`` (the true Tikhonov level follows the trace EMA), and token
sets larger than ``SMWConfig.rank`` are strided down. The probe residual
``||Ahat (M v) - v||`` grows with both; ``solve.async_refresh.
SMWRefresher`` reads it one step lagged and falls back to a full
re-inversion when it exceeds ``drift_budget``.

Across data ranks (:func:`gather_cols`) each rank holds the columns of
its rows of the subsample. The update is the one-device update when the
columns are the global subsample's: ``k`` the global token count, the
stride over the columns of every rank in global row order, and each
rank's G columns scaled by its loss share ``w``, so that ``V^T V`` is
the reduced G-Gram. :func:`reduce_drift` makes every rank's gate read
the same drift.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import soi
from repro_torch.core.kfac import KFACConfig
from repro_torch.kernels import ops, ref

__all__ = ["SMWConfig", "smw_refresh", "smw_update_flat", "probe_drift",
           "gather_cols", "reduce_drift"]


@dataclasses.dataclass(frozen=True)
class SMWConfig:
    """Knobs of the incremental refresh.

    ``drift_budget``: probe-residual level above which the host falls
    back to a full re-inversion. ``rank``: max columns per update;
    larger token sets are strided down (rescaled by ``sqrt(k/rank)``).
    ``use_kernel``: route the per-block update through
    ``kernels.ops.smw_update`` (the hi/lo Hopper kernel on CUDA, its
    plain version on the CPU) instead of the fp32 matmul route."""

    drift_budget: float = 0.05
    rank: int = 64
    use_kernel: bool = False


def _stride(k: int, rank: int) -> Tuple[Optional[torch.Tensor], float]:
    """The columns a ``rank`` cap keeps of ``k`` (None: all of them) and
    their rescale."""
    if rank <= 0 or k <= rank:
        return None, 1.0
    return (torch.arange(rank) * (k // rank),
            float(np.float32(np.sqrt(k / rank))))


def _subsample_cols(v: torch.Tensor, rank: int) -> torch.Tensor:
    """(..., k, bs) -> (..., rank, bs) strided subsample, rescaled so
    ``V_sub^T V_sub ~= V^T V`` in expectation over stride phases."""
    idx, scale = _stride(v.shape[-2], rank)
    if idx is None:
        return v
    return torch.index_select(v, -2, idx.to(v.device)) * scale


def gather_cols(cols, data_mesh, weight: float, rank: int, queued=()):
    """This rank's columns (``kfac.stats_rank_k``'s, of its rows of the
    subsample, in global row order over ``data_mesh``'s positions) made
    the global subsample's, the same on every data rank: ``(cols, ks)``
    for :func:`smw_refresh`.

    Each G column is scaled by ``weight``, this rank's share of the
    subsample (the global mean loss's tap gradients are the local ones
    times it). A leaf in ``queued`` (the MoE experts, whose columns are
    the global queue's slots, each rank's tokens at their own) is summed
    over the ranks, A at weight 1. Every other leaf's global ``k`` is the
    sum of the ranks' token counts; only the columns the ``rank`` cap
    keeps of those ``k`` are gathered (one ``all_gather`` of every leaf's
    picks), rescaled as :func:`_subsample_cols` does; ``ks[name][side]``
    is that ``k``."""
    from repro_torch.dist.api import (all_gather_rows, all_reduce,
                                      mesh_ndev, mesh_position)

    names = [(n, s) for n, d in cols.items() for s in sorted(d)]
    dev = next(iter(cols[names[0][0]].values())).device
    scaled = {(n, s): cols[n][s] * weight if s == "G" else cols[n][s]
              for n, s in names}
    out: dict = {n: {} for n in cols}
    # the queues' slots: one sum over the ranks
    qn = [key for key in names if key[0] in queued]
    if qn:
        flat = torch.cat([scaled[key].reshape(-1) for key in qn])
        all_reduce(flat, data_mesh)
        ofs = 0
        for n, s in qn:
            v = scaled[(n, s)]
            out[n][s] = flat[ofs:ofs + v.numel()].reshape(v.shape)
            ofs += v.numel()
    tn = [key for key in names if key[0] not in queued]
    ks: dict = {}
    if not tn:
        return out, ks
    ndev, pos = mesh_ndev(data_mesh), mesh_position(data_mesh)
    mine = torch.tensor([cols[n][s].shape[-2] for n, s in tn],
                        dtype=torch.int64, device=dev)
    counts = all_gather_rows(mine[None], data_mesh).cpu()   # (ndev, leaves)
    picks, parts = [], []       # per leaf: each rank's picked count
    for j, (n, s) in enumerate(tn):
        per = counts[:, j].tolist()
        k = sum(per)
        idx, _ = _stride(k, rank)
        idx = torch.arange(k) if idx is None else idx
        lo = sum(per[:pos])
        got = [int(((idx >= sum(per[:r])) & (idx < sum(per[:r + 1])))
                   .sum()) for r in range(ndev)]
        local = idx[(idx >= lo) & (idx < lo + per[pos])] - lo
        parts.append(torch.index_select(scaled[(n, s)], -2, local.to(dev))
                     .reshape(-1))
        picks.append(got)
        ks.setdefault(n, {})[s] = k
    lens = [sum(math.prod(scaled[key].shape[:-2]) * p[r]
                * scaled[key].shape[-1] for key, p in zip(tn, picks))
            for r in range(ndev)]
    buf = torch.zeros(max(lens), dtype=torch.float32, device=dev)
    mine_flat = torch.cat(parts) if parts else buf[:0]
    buf[:mine_flat.numel()] = mine_flat
    rows = all_gather_rows(buf[None], data_mesh)           # (ndev, len)
    ofs = [0] * ndev
    for (n, s), p in zip(tn, picks):
        v = scaled[(n, s)]
        lead, bs = tuple(v.shape[:-2]), v.shape[-1]
        segs = []
        for r in range(ndev):
            size = math.prod(lead) * p[r] * bs
            segs.append(rows[r, ofs[r]:ofs[r] + size]
                        .reshape(lead + (p[r], bs)))
            ofs[r] += size
        g = torch.cat(segs, dim=-2)
        _, scale = _stride(ks[n][s], rank)
        out[n][s] = g * scale if scale != 1.0 else g
    return out, ks


def reduce_drift(drift: torch.Tensor, mesh) -> torch.Tensor:
    """The drift's max over every rank of ``mesh`` (each probed its own
    blocks), NaN if any rank's is: a MAX reduction may drop a NaN, so a
    NaN flag is reduced beside it."""
    from repro_torch.dist.api import all_reduce

    nan = torch.isnan(drift)
    both = torch.stack([torch.where(nan, torch.zeros_like(drift), drift),
                        nan.to(drift.dtype)])
    all_reduce(both, mesh, "max")
    return torch.where(both[1] > 0, torch.full_like(both[0], float("nan")),
                       both[0])


def smw_update_flat(inv: torch.Tensor, v: torch.Tensor, decay: float,
                    c: float, *, use_kernel: bool = False) -> torch.Tensor:
    """Woodbury rank-k update of a flat batch of cached inverses.

    ``inv``: (N, bs, bs) inverses of the previous damped factors;
    ``v``: (N, k, bs) columns with Gram contribution ``c/(1-d) V^T V``
    per block (``c`` already folds the side weight). The inverse is
    symmetrised before the decay-scale so one product (``Y = V M``)
    serves both Woodbury wings."""
    inv = inv.contiguous()
    v = v.contiguous()
    if use_kernel:
        return ops.smw_update(inv, v, decay=decay, cscale=c)
    return ref.exact_smw_update(inv, v, decay=decay, cscale=c)


def _probes(bs: int, device) -> torch.Tensor:
    """Two deterministic unit probes: uniform and alternating-sign."""
    scale = float(np.float32(1.0 / np.sqrt(bs)))
    ones = torch.full((bs,), scale, dtype=torch.float32, device=device)
    alt = torch.where(torch.arange(bs, device=device) % 2 == 0, ones, -ones)
    return torch.stack([ones, alt])


def probe_drift(factors: Mapping[str, Mapping[str, Any]],
                inverses: Mapping[str, Mapping[str, Any]],
                cfg: KFACConfig) -> torch.Tensor:
    """Max probe residual ``||Ahat (M v) - v||`` over every block, a
    0-d device tensor (NaN if any block is).

    ``Ahat`` is the currently true damped factor (trace-EMA Tikhonov
    level included), so the estimate sees both the rank-k error and the
    decayed-damping gap. O(bs^2) per block."""
    worst = None
    for name, f_d in factors.items():
        inv_d = inverses.get(name, {})
        for side, f in f_d.items():
            inv = inv_d.get(side + "_inv")
            if inv is None:
                continue
            lam = soi.tikhonov_damping(f, cfg.damping)
            v = _probes(f.shape[-1], f.device)              # (p, bs)
            w = torch.einsum("...bc,pc->...pb", inv, v)
            u = torch.einsum("...bc,...pc->...pb", f, w) \
                + lam[..., None, None] * w
            r = torch.sqrt(torch.sum(torch.square(u - v), dim=-1))
            worst = r.max() if worst is None \
                else torch.maximum(worst, r.max())
    if worst is None:
        return torch.zeros((), dtype=torch.float32)
    return worst


def smw_refresh(inverses: Mapping[str, Mapping[str, torch.Tensor]],
                factors: Mapping[str, Mapping[str, torch.Tensor]],
                cols: Mapping[str, Mapping[str, torch.Tensor]],
                cfg: KFACConfig, scfg: Optional[SMWConfig] = None,
                ks: Optional[Mapping[str, Mapping[str, int]]] = None
                ) -> Tuple[dict, torch.Tensor]:
    """Rank-k-update every cached inverse; returns ``(inverses, drift)``.

    ``factors`` must already hold this step's EMA; ``cols[name][side]``
    are the (*stack, nb, k, bs) column factors of the same contribution
    (``kfac.stats_rank_k``), weighted ``w = 1/k`` for A and ``w = 1``
    for G. Leaves without cols keep their inverse (the same tensor);
    their growing error is what the drift reports. One update call per
    factor leaf. ``ks[name][side]``: the ``k`` of columns
    :func:`gather_cols` already strided and rescaled."""
    scfg = scfg or SMWConfig()
    d = cfg.ema_decay
    new_inv: dict = {}
    for name, inv_d in inverses.items():
        c_d = cols.get(name, {}) if cols else {}
        nd = {}
        for key, inv in inv_d.items():
            side = key[:-len("_inv")]
            v = c_d.get(side)
            if v is None:
                nd[key] = inv
                continue
            k = (ks or {}).get(name, {}).get(side)
            if k is None:
                k = v.shape[-2]
                v = _subsample_cols(v, scfg.rank)
            w = 1.0 / k if side == "A" else 1.0
            bs = inv.shape[-1]
            upd = smw_update_flat(inv.reshape(-1, bs, bs),
                                  v.reshape((-1,) + tuple(v.shape[-2:])),
                                  d, (1.0 - d) * w,
                                  use_kernel=scfg.use_kernel)
            nd[key] = upd.reshape(inv.shape)
        new_inv[name] = nd
    return new_inv, probe_drift(factors, new_inv, cfg)
