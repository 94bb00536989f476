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
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import soi
from repro_torch.core.kfac import KFACConfig
from repro_torch.kernels import ops, ref

__all__ = ["SMWConfig", "smw_refresh", "smw_update_flat", "probe_drift"]


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


def _subsample_cols(v: torch.Tensor, rank: int) -> torch.Tensor:
    """(..., k, bs) -> (..., rank, bs) strided subsample, rescaled so
    ``V_sub^T V_sub ~= V^T V`` in expectation over stride phases."""
    k = v.shape[-2]
    if rank <= 0 or k <= rank:
        return v
    idx = torch.arange(rank, device=v.device) * (k // rank)
    scale = float(np.float32(np.sqrt(k / rank)))
    return torch.index_select(v, -2, idx) * scale


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
                cfg: KFACConfig, scfg: Optional[SMWConfig] = None
                ) -> Tuple[dict, torch.Tensor]:
    """Rank-k-update every cached inverse; returns ``(inverses, drift)``.

    ``factors`` must already hold this step's EMA; ``cols[name][side]``
    are the (*stack, nb, k, bs) column factors of the same contribution
    (``kfac.stats_rank_k``), weighted ``w = 1/k`` for A and ``w = 1``
    for G. Leaves without cols keep their inverse (the same tensor);
    their growing error is what the drift reports. One update call per
    factor leaf."""
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
            w = 1.0 / v.shape[-2] if side == "A" else 1.0
            v = _subsample_cols(v, scfg.rank)
            bs = inv.shape[-1]
            upd = smw_update_flat(inv.reshape(-1, bs, bs),
                                  v.reshape((-1,) + tuple(v.shape[-2:])),
                                  d, (1.0 - d) * w,
                                  use_kernel=scfg.use_kernel)
            nd[key] = upd.reshape(inv.shape)
        new_inv[name] = nd
    return new_inv, probe_drift(factors, new_inv, cfg)
