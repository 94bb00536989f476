"""Mixture-of-Experts FFN (counterpart of ``repro.models.moe``): top-k
routing, capacity by one-hot cumsum, drop, an ``(E, C, D)`` dispatch
buffer through the stacked expert linears, and the gate-weighted
combine.

The expert dim is a K-FAC factor-stack dim: the experts' taps and Grams
are defined on the ``(E, C, d)`` buffers, so the factored expert linears
go through ``layers.dense_stacked``. The router stays on the first-order
path.

Which capacity a call takes follows the reference's two datapaths:
  * **training** (no taps, no ``collect``): the reference's train step
    runs the ``shard_map`` fast path, where each data shard routes only
    its own tokens against its share of the global capacity,
    ``c_loc = max(ceil(capacity(nt * n_data) / n_data), 8)``. Here the
    data shard is the submesh a ``dist.api.hint_guard`` bound to
    ``data`` (the program binds it, ``launch.steps.bound``); without one
    ``n_data`` is 1 and ``c_loc`` the global capacity;
  * **the pipeline's stage program** (``dist.api.in_hint_guard``, the
    reference's manual region, where its fast path is off): experts
    sliced over ``model`` route as above, against ``c_loc`` (its
    ``_local_moe`` called directly); whole experts take the reference's
    portable path, ``C = capacity(nt_local)``, the capacity of this data
    shard's own tokens, whatever the data ranks;
  * **statistics** (taps or ``collect``): one queue per expert over the
    whole subsample, ``C = capacity(nt_global)``, as the reference's
    global scatter path. Under a bound data submesh each rank's pairs
    take the slots after those of the data ranks before it: one
    ``all_gather`` of each rank's per-expert pair counts (and its token
    count, which gives ``nt_global``) a layer. A pair is kept when its
    global slot is below ``C`` and is written there, so each rank's
    buffer holds its own tokens at their global slots and zeros
    elsewhere: its A-Gram (over the ``C`` slots) is its part of the
    global one, and the parts sum with weight 1.

Expert parallelism (``--model-parallel``, the reference's ``_local_moe``):
when the expert weights arrive sliced on their expert dim
(``dist.sharding.model_spec_dim``) and a model submesh is bound, a rank
keeps the pairs of its ``E / mp`` experts ``[e0, e0 + E / mp)``
(global ids; queue positions within an expert are those of the global
queue), runs them through its ``(E / mp, c, D)`` buffer, and the
partial outputs are summed over the model ranks by ``fwd_psum``. The
input and the router pass ``bwd_psum``: each rank's backward sees only
its own experts' pull on them.

Where the reference leans on JAX's out-of-bounds rules, this port keeps
every index inside its buffer, with the same values:
  * a dropped ``(token, k)`` pair (or, under expert parallelism, one
    bound for another rank's expert) is parked at slot ``c``, which the
    reference's scatter drops (``mode="drop"``) and its gather clamps
    (times a zero weight). Here the buffers have ``c + 1`` slots: the
    dispatch writes the pair's zero there and slices it off, and the
    combine reads a zero row there.
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

from repro_torch.dist.api import (DATA, MODEL, all_gather_rows, bound_mesh,
                                  bwd_psum, fwd_psum, in_hint_guard,
                                  mesh_ndev, mesh_position)
from repro_torch.models.layers import Ctx, dense_stacked, swiglu


def capacity(cfg, n_tokens: int) -> int:
    """Slots per expert for ``n_tokens`` tokens, a multiple of 8."""
    c = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def shard_capacity(cfg, n_tokens: int, n_data: int) -> int:
    """A data shard's slots per expert on the training path:
    ``n_tokens`` tokens on each of ``n_data`` shards share the global
    capacity (the reference's ``_moe_fast``)."""
    return max(-(-capacity(cfg, n_tokens * n_data) // n_data), 8)


def _top_k(cfg, router: torch.Tensor, xf: torch.Tensor):
    """``(gate, eid)`` flat over ``(token, k)``: renormalised fp32
    top-k probabilities and global expert ids."""
    K = cfg.top_k
    logits = torch.matmul(xf.to(torch.float32),
                          router.to(xf.dtype).to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, eid = top[:, :K], idx[:, :K]
    gate = gate / (torch.sum(gate, -1, keepdim=True) + 1e-9)
    return gate.reshape(-1), eid.reshape(-1)


def route(cfg, router: torch.Tensor, xf: torch.Tensor,
          n_slots: Optional[int] = None, e0: int = 0,
          e_loc: Optional[int] = None, data=None):
    """Routing and capacity for (nt, D) tokens in the compute dtype:
    ``(gate, eid, keep, safe_pos, n_slots)``, the first four flat over
    ``(token, k)``.

    ``gate`` (nt*K,) fp32 renormalised top-k probabilities, ``eid`` the
    expert ids, ``keep`` whether the pair got one of the expert's
    ``n_slots`` slots (first come, first served in token order), and
    ``safe_pos`` its slot, ``n_slots`` for a dropped pair. ``n_slots``
    defaults to the capacity of every data rank's tokens.

    ``e0``, ``e_loc``: this rank's experts ``[e0, e0 + e_loc)`` (default
    all of them); ``eid`` is then the id among them, and a pair bound for
    another rank's expert is parked as a dropped one. ``data``: the data
    submesh whose ranks' tokens share each expert's queue (a statistics
    pass); this rank's pairs take the slots after those of the ranks
    before it (:func:`queue_offsets`)."""
    gate, eid = _top_k(cfg, router, xf)
    e_loc = cfg.n_experts if e_loc is None else e_loc
    lid = eid - e0
    mine = (lid >= 0) & (lid < e_loc)
    lid = torch.where(mine, lid, torch.full_like(lid, e_loc))
    # each pair's place in its expert's queue (another rank's experts
    # share row e_loc)
    onehot = F.one_hot(lid, e_loc + 1).to(torch.int32)
    pos = torch.gather(torch.cumsum(onehot, dim=0) - 1, 1,
                       lid[:, None])[:, 0]
    nt = xf.shape[0]
    if data is not None:
        counts = torch.bincount(lid, minlength=e_loc + 1)[:e_loc]
        offsets, nt = queue_offsets(counts, nt, data)
        pos = pos + F.pad(offsets, (0, 1))[lid].to(pos.dtype)
    if n_slots is None:
        n_slots = capacity(cfg, nt)
    keep = mine & (pos < n_slots)
    safe_pos = torch.where(keep, pos, torch.full_like(pos, n_slots))
    return gate, torch.clamp(lid, max=e_loc - 1), keep, safe_pos, n_slots


def queue_offsets(counts: torch.Tensor, n_tokens: int, mesh):
    """``(offsets, nt_global)``: the slots each expert's queue holds
    before this rank's pairs (the pair counts ``counts`` (e,) of the
    data ranks before it in ``mesh``, summed) and the tokens of every
    rank together, from one ``all_gather`` of ``counts`` and
    ``n_tokens``."""
    row = torch.cat([counts.to(torch.int64),
                     torch.tensor([n_tokens], dtype=torch.int64,
                                  device=counts.device)])
    every = all_gather_rows(row[None], mesh)          # (n_data, e + 1)
    d = mesh_position(mesh)
    return every[:d, :-1].sum(0), int(every[:, -1].sum())


def join_queues(n_layers: int, e_loc: int, mesh, device) -> None:
    """A rank that holds no rows of a statistics subsample: its part
    (zero pairs, zero tokens) of the :func:`queue_offsets` gather of
    each of ``n_layers`` MoE layers of ``e_loc`` experts a rank, over the
    data submesh ``mesh``, so that the ranks holding rows do not wait for
    it (``lm.join_moe_queues`` gives the layers)."""
    zero = torch.zeros(e_loc, dtype=torch.int64, device=device)
    for _ in range(n_layers):
        queue_offsets(zero, 0, mesh)


def _expert_mesh(cfg, p, prefix):
    """The model submesh the experts are sliced over, or None when
    every expert is on this rank."""
    e_loc = p["wg"].shape[-3]
    if e_loc == cfg.n_experts:
        return None
    mesh = bound_mesh(MODEL)
    if mesh is None or mesh_ndev(mesh) * e_loc != cfg.n_experts:
        raise ValueError(
            f"{prefix}: {e_loc} of {cfg.n_experts} experts on this rank "
            f"but no bound '{MODEL}' submesh of "
            f"{cfg.n_experts // e_loc} ranks to dispatch over")
    return mesh


def moe_ffn(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
            ctx: Optional[Ctx], prefix: str) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D). ``p``: ``router`` (D, E) and the
    experts ``wg``/``wu`` (E, D, F), ``wd`` (E, F, D), or under expert
    parallelism this rank's ``E / mp`` of them."""
    B, T, D = x.shape
    K = cfg.top_k
    nt = B * T
    dt = x.dtype
    xf = x.reshape(nt, D)
    router = p["router"]
    e_loc = p["wg"].shape[-3]
    model = _expert_mesh(cfg, p, prefix)
    data = bound_mesh(DATA)
    stats = ctx is not None and (bool(ctx.collect) or (
        ctx.taps is not None
        and any(k.startswith(prefix) for k in ctx.taps)))

    if model is not None:
        xf = bwd_psum(xf, model)
        router = bwd_psum(router, model)
    e0 = 0 if model is None else mesh_position(model) * e_loc
    if stats:       # one queue over every data rank's tokens
        C, queue = None, data
    elif in_hint_guard() and model is None:
        # the pipeline's stage program, experts whole: the reference's
        # portable path there, the capacity of this shard's own tokens
        C, queue = capacity(cfg, nt), None
    else:
        C = shard_capacity(cfg, nt, 1 if data is None else mesh_ndev(data))
        queue = None
    gate, lid, keep, safe_pos, C = route(cfg, router, xf, C, e0, e_loc,
                                         queue)
    tok = torch.arange(nt, device=x.device).repeat_interleave(K)

    # dispatch: each kept pair owns its (expert, slot); the others all
    # write zeros to the spare slot C
    buf = torch.zeros((e_loc, C + 1, D), dtype=dt, device=x.device)
    buf = buf.index_put((lid, safe_pos),
                        xf[tok] * keep[:, None].to(dt))[:, :C]

    g = dense_stacked(buf, p["wg"], f"{prefix}/wg", ctx)
    u = dense_stacked(buf, p["wu"], f"{prefix}/wu", ctx, collect_gram=False)
    y = dense_stacked(swiglu(g, u), p["wd"], f"{prefix}/wd", ctx)

    # combine: the spare slot reads a zero row (its weight is zero too)
    y = F.pad(y, (0, 0, 0, 1))
    gathered = y[lid, safe_pos]
    w = (gate * keep.to(torch.float32)).to(dt)
    terms = (gathered * w[:, None]).reshape(nt, K, D)
    out = terms[:, 0]
    for k in range(1, K):
        out = out + terms[:, k]
    if model is not None:
        out = fwd_psum(out, model)
    return out.reshape(B, T, D)
