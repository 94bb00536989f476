"""Mixture-of-Experts FFN, training path (counterpart of the portable
dispatch of ``repro.models.moe``): top-k routing, capacity by one-hot
cumsum, drop, an ``(E, C, D)`` dispatch buffer through the stacked
expert linears, and the gate-weighted combine.

The expert dim is a K-FAC factor-stack dim: the experts' taps and Grams
are defined on the global ``(E, C, d)`` buffers, so the factored expert
linears go through ``layers.dense_stacked``. The router stays on the
first-order path.

Where the reference leans on JAX's out-of-bounds rules, this port keeps
every index inside its buffer, with the same values:
  * a dropped ``(token, k)`` pair is parked at slot ``C``, which the
    reference's scatter drops (``mode="drop"``) and its gather clamps to
    slot ``C - 1`` (times a zero weight). Here the buffers have ``C + 1``
    slots: the dispatch writes the pair's zero there and slices it off,
    and the combine reads a zero row there.
  * the combine adds each token's K weighted expert outputs in
    ``(token, k)`` order, each add rounded to the compute dtype, as the
    reference's scatter-add does, but as a fixed-order sum over k with
    no atomics, so a replay is bitwise the run it replays.
  * top-k is a stable descending sort: ties go to the lower expert id,
    as in ``lax.top_k``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Ctx, dense_stacked, swiglu


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens, a multiple of 8."""
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(cfg, router: torch.Tensor, xf: torch.Tensor, n_slots: int):
    """Routing and capacity for (nt, D) tokens in the compute dtype:
    ``(gate, eid, keep, safe_pos)``, each flat over ``(token, k)``.

    ``gate`` (nt*K,) fp32 renormalised top-k probabilities, ``eid`` the
    expert ids, ``keep`` whether the pair got one of the expert's
    ``n_slots`` slots (first come, first served in token order), and
    ``safe_pos`` its slot, ``n_slots`` for a dropped pair."""
    E, K = cfg.n_experts, cfg.top_k
    logits = torch.matmul(xf.to(torch.float32),
                          router.to(xf.dtype).to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = top[:, :K], idx[:, :K]
    gate = gate / (torch.sum(gate, -1, keepdim=True) + 1e-9)
    flat_eid = eid.reshape(-1)
    onehot = F.one_hot(flat_eid, E).to(torch.int32)
    pos = torch.cumsum(onehot, dim=0) - 1
    pos = torch.gather(pos, 1, flat_eid[:, None])[:, 0]
    keep = pos < n_slots
    safe_pos = torch.where(keep, pos, torch.full_like(pos, n_slots))
    return gate.reshape(-1), flat_eid, keep, safe_pos


def moe_ffn(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
            ctx: Optional[Ctx], prefix: str) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D). ``p``: ``router`` (D, E) and the
    experts ``wg``/``wu`` (E, D, F), ``wd`` (E, F, D)."""
    B, T, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    nt = B * T
    C = capacity(cfg, nt)
    dt = x.dtype
    xf = x.reshape(nt, D)
    gate, flat_eid, keep, safe_pos = route(cfg, p["router"], xf, C)
    tok = torch.arange(nt, device=x.device).repeat_interleave(K)

    # dispatch: each kept pair owns its (expert, slot); the dropped ones
    # all write zeros to the spare slot C
    buf = torch.zeros((E, C + 1, D), dtype=dt, device=x.device)
    buf = buf.index_put((flat_eid, safe_pos),
                        xf[tok] * keep[:, None].to(dt))[:, :C]

    g = dense_stacked(buf, p["wg"], f"{prefix}/wg", ctx)
    u = dense_stacked(buf, p["wu"], f"{prefix}/wu", ctx, collect_gram=False)
    y = dense_stacked(swiglu(g, u), p["wd"], f"{prefix}/wd", ctx)

    # combine: the spare slot reads a zero row (its weight is zero too)
    y = F.pad(y, (0, 0, 0, 1))
    gathered = y[flat_eid, safe_pos]
    w = (gate * keep.to(torch.float32)).to(dt)
    terms = (gathered * w[:, None]).reshape(nt, K, D)
    out = terms[:, 0]
    for k in range(1, K):
        out = out + terms[:, k]
    return out.reshape(B, T, D)
