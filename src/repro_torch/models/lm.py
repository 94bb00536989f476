"""Decoder LM families of ``repro.models.lm``: dense, moe, ssm, hybrid
and vlm, for training and serving.

  dense, vlm : global attention + SwiGLU MLP (vlm: M-RoPE and a stubbed
               vision frontend, ``img_proj`` of precomputed patch
               embeddings into the first token slots)
  moe        : global attention + top-k MoE FFN (``models.moe``)
  ssm        : Mamba-1 mixer only (``models.ssm``)
  hybrid     : RecurrentGemma pattern units (rec, rec, local attention),
               each sub-layer followed by a SwiGLU MLP, then a tail of
               the ``n_layers % len(pattern)`` sub-layers left over

Parameters are a flat dict keyed by the reference's parameter paths
(``embed``, ``layers/attn/wq``, ``units/sub0/rec/w_a``,
``tail/sub0/mlp/wd`` ...), with the layer (or pattern-unit) stack as a
leading dim exactly as in the JAX tree (MoE experts add a second one,
``(L, e, ...)``; the hybrid tail has none), so K-FAC specs, factors and
converted weights address the same names. Where the reference scans
over layers, a Python loop walks the unbound stack.

K-FAC integration: every factored linear goes through
``layers.dense`` / ``dense_stacked`` under its parameter path; taps
(zeros, one per factored linear, shape ``(*stack, tokens, d_out)``,
tokens being the expert capacity for MoE experts) enter per layer and
their gradients are the per-token output gradients; with ``collect``
the input-side blocked Grams (or, with ``collect="cols"``, blocked
tokens) come back stacked like the taps.

Serving: :func:`init_cache` makes a decode cache, a flat dict keyed like
the parameters: ``layers/k``, ``layers/v`` (L, B, S, kv, hd) and
``layers/pos`` (L, B, S) for attention layers (the hybrid's windowed
layers hold ``S = min(seq_len, window)`` columns written as a ring),
``layers/h`` and ``layers/conv`` for the ssm and RG-LRU states, the
hybrid's under ``units/sub<i>/`` and ``tail/sub<i>/``, and ``idx``: an
int (static decode: every row at the same column) or a (B,) tensor of
per-slot lengths (the serving pool, ``repro_torch.serve.pool``).
:func:`prefill` and :func:`decode_step` write the cache's tensors in
place (the reference donates its cache) and return it with ``idx``
advanced.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.soi import LinearSpec
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (
    UNWRITTEN_POS,
    Ctx,
    apply_rope,
    attention,
    dense,
    kv_cache_update,
    pos_cache_update,
    rms_norm,
    swiglu,
)

Params = Dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
#: the families of this module (the audio encoder-decoder is
#: ``models.whisper``)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_family(cfg) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"models.lm runs the {', '.join(FAMILIES)} families, not "
            f"{cfg.family!r} (the audio family is models.whisper)")


def layer_plan(cfg) -> Tuple[str, ...]:
    """Per-layer kind sequence."""
    if cfg.family in ("dense", "vlm"):
        return ("attn",) * cfg.n_layers
    if cfg.family == "moe":
        return ("moe",) * cfg.n_layers
    if cfg.family == "ssm":
        return ("mamba",) * cfg.n_layers
    if cfg.family == "hybrid":
        return tuple(cfg.pattern[i % len(cfg.pattern)]
                     for i in range(cfg.n_layers))
    raise ValueError(cfg.family)


def _hybrid_split(cfg) -> Tuple[int, Tuple[str, ...]]:
    """``(n_units, tail kinds)`` of the hybrid pattern."""
    unit = tuple(cfg.pattern)
    return cfg.n_layers // len(unit), unit[: cfg.n_layers % len(unit)]


def _stacks(cfg):
    """``[(prefix, kind, stack)]``: every sub-layer parameter group with
    its stack dims (one group of ``L`` layers outside the hybrid)."""
    if cfg.family == "hybrid":
        n_units, tail = _hybrid_split(cfg)
        return ([(f"units/sub{i}", k, (n_units,))
                 for i, k in enumerate(cfg.pattern)]
                + [(f"tail/sub{i}", k, ()) for i, k in enumerate(tail)])
    return [("layers", layer_plan(cfg)[0], (cfg.n_layers,))]


def _init_layer(cfg, kind, prefix, st, normal, zeros) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p: Params = {f"{prefix}/ln1": zeros(st + (d,))}
    if kind in ("attn", "local", "moe", "rec"):
        p[f"{prefix}/ln2"] = zeros(st + (d,))
    if kind in ("attn", "local", "moe"):
        p[f"{prefix}/attn/wq"] = normal(st + (d, h * hd), d ** -0.5)
        p[f"{prefix}/attn/wk"] = normal(st + (d, kv * hd), d ** -0.5)
        p[f"{prefix}/attn/wv"] = normal(st + (d, kv * hd), d ** -0.5)
        p[f"{prefix}/attn/wo"] = normal(st + (h * hd, d), (h * hd) ** -0.5)
    if kind == "rec":
        lw = cfg.lru_width_
        p[f"{prefix}/rec/in_x"] = normal(st + (d, lw), d ** -0.5)
        p[f"{prefix}/rec/in_gate"] = normal(st + (d, lw), d ** -0.5)
        p[f"{prefix}/rec/conv_w"] = normal(st + (lw, cfg.ssm_conv), 0.1)
        p[f"{prefix}/rec/conv_b"] = zeros(st + (lw,))
        p[f"{prefix}/rec/w_a"] = normal(st + (lw, lw), lw ** -0.5)
        p[f"{prefix}/rec/w_x"] = normal(st + (lw, lw), lw ** -0.5)
        lam = torch.log(torch.expm1(torch.linspace(
            0.9, 4.0, lw, dtype=torch.float32)))   # softplus^-1 spread
        p[f"{prefix}/rec/lam"] = lam.to(zeros(()).device).expand(
            st + (lw,)).contiguous()
        p[f"{prefix}/rec/out"] = normal(st + (lw, d), lw ** -0.5)
    if kind in ("attn", "local", "rec"):
        p[f"{prefix}/mlp/wg"] = normal(st + (d, f), d ** -0.5)
        p[f"{prefix}/mlp/wu"] = normal(st + (d, f), d ** -0.5)
        p[f"{prefix}/mlp/wd"] = normal(st + (f, d), f ** -0.5)
    if kind == "moe":
        e = cfg.n_experts
        p[f"{prefix}/moe/router"] = normal(st + (d, e), d ** -0.5)
        p[f"{prefix}/moe/wg"] = normal(st + (e, d, f), d ** -0.5)
        p[f"{prefix}/moe/wu"] = normal(st + (e, d, f), d ** -0.5)
        p[f"{prefix}/moe/wd"] = normal(st + (e, f, d), f ** -0.5)
    if kind == "mamba":
        di, n, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
        p[f"{prefix}/mamba/in_proj"] = normal(st + (d, 2 * di), d ** -0.5)
        p[f"{prefix}/mamba/conv_w"] = normal(st + (di, cfg.ssm_conv), 0.1)
        p[f"{prefix}/mamba/conv_b"] = zeros(st + (di,))
        p[f"{prefix}/mamba/x_proj"] = normal(st + (di, dr + 2 * n),
                                             di ** -0.5)
        p[f"{prefix}/mamba/dt_proj"] = normal(st + (dr, di), dr ** -0.5)
        # softplus^-1(0.01), and A = -[1..n] per channel
        p[f"{prefix}/mamba/dt_bias"] = zeros(st + (di,)) + float(
            torch.log(torch.expm1(torch.tensor(0.01))))
        p[f"{prefix}/mamba/A_log"] = torch.log(
            torch.arange(1, n + 1, dtype=torch.float32,
                         device=zeros(()).device)).expand(
                st + (di, n)).contiguous()
        p[f"{prefix}/mamba/D"] = zeros(st + (di,)) + 1.0
        p[f"{prefix}/mamba/out_proj"] = normal(st + (di, d), di ** -0.5)
    if kind in ("attn", "local", "moe") and cfg.qkv_bias:
        p[f"{prefix}/attn/bq"] = zeros(st + (h * hd,))
        p[f"{prefix}/attn/bk"] = zeros(st + (kv * hd,))
        p[f"{prefix}/attn/bv"] = zeros(st + (kv * hd,))
    return p


def init(cfg, *, generator: torch.Generator, device) -> Params:
    """Random fp32 parameters with the reference's distributions (the
    values differ: torch and jax generators give different numbers)."""
    _check_family(cfg)
    d, v = cfg.d_model, cfg.vocab

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) * scale

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    p = {"embed": normal((v, d), 0.02), "final_norm": zeros((d,))}
    for prefix, kind, st in _stacks(cfg):
        p.update(_init_layer(cfg, kind, prefix, st, normal, zeros))
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, v), d ** -0.5)
    if cfg.family == "vlm" and cfg.vision_dim:
        p["img_proj"] = normal((cfg.vision_dim, d), cfg.vision_dim ** -0.5)
    return p


def _sub(p: Params, group: str) -> Params:
    """The ``group/`` entries of a layer's parameters, prefix dropped."""
    n = len(group) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(group + "/")}


def _attn_block(cfg, p, x, positions, ctx, prefix, *, window=0,
                mrope=False, cache=None, idx=None):
    """Pre-norm attention sub-layer. ``cache``: this layer's ``k``,
    ``v``, ``pos`` tensors (written in place at column ``idx``; a ring
    of ``S`` columns with a ``window``), or None."""
    B, T, _ = x.shape
    hd = cfg.hd
    xin = rms_norm(x, p["ln1"], cfg.norm_eps)
    q = dense(xin, p["attn/wq"], f"{prefix}/attn/wq", ctx,
              bias=p.get("attn/bq"))
    k = dense(xin, p["attn/wk"], f"{prefix}/attn/wk", ctx,
              bias=p.get("attn/bk"), collect_gram=False)
    v = dense(xin, p["attn/wv"], f"{prefix}/attn/wv", ctx,
              bias=p.get("attn/bv"), collect_gram=False)
    q = q.reshape(B, T, -1, hd)
    k = k.reshape(B, T, -1, hd)
    v = v.reshape(B, T, -1, hd)
    sections = cfg.mrope_sections if mrope else ()
    q = apply_rope(q, positions, cfg.rope_theta, sections)
    k = apply_rope(k, positions, cfg.rope_theta, sections)
    q_pos = positions[0] if positions.ndim == 3 else positions
    k_all, v_all, kv_pos = k, v, q_pos
    if cache is not None:
        S = cache["k"].shape[1]
        if T > 1 and window and T > S:
            # a windowed prefill longer than the ring: attend within the
            # sequence, then keep the last S tokens rolled to their ring
            # columns (position p lives at column p % S)
            shift = (idx + T) % S
            cache["k"].copy_(torch.roll(k[:, -S:], shift, dims=1))
            cache["v"].copy_(torch.roll(v[:, -S:], shift, dims=1))
            cache["pos"].copy_(torch.roll(q_pos[:, -S:], shift, dims=1))
        else:
            col = idx % S if window else idx
            kv_cache_update(cache["k"], cache["v"], k, v, col)
            pos_cache_update(cache["pos"], q_pos, col)
            k_all, v_all = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
            kv_pos = cache["pos"]
    out = attention(q, k_all, v_all, q_pos, kv_pos,
                    chunk=cfg.attn_chunk if T > cfg.attn_chunk else 0,
                    window=window)
    out = dense(out.reshape(B, T, -1), p["attn/wo"], f"{prefix}/attn/wo",
                ctx)
    return x + out


def _mlp_block(cfg, p, x, ctx, prefix):
    xin = rms_norm(x, p["ln2"], cfg.norm_eps)
    g = dense(xin, p["mlp/wg"], f"{prefix}/mlp/wg", ctx)
    u = dense(xin, p["mlp/wu"], f"{prefix}/mlp/wu", ctx, collect_gram=False)
    return x + dense(swiglu(g, u), p["mlp/wd"], f"{prefix}/mlp/wd", ctx)


def _write_state(cache, new) -> None:
    """Copy a mixer's new ``(h, conv)`` into the cache's state tensors,
    in their declared dtype (the conv state comes back in the compute
    dtype)."""
    for dst, src in zip(cache, new):
        dst.copy_(src)


def _layer_apply(cfg, kind, p, x, positions, ctx, prefix, cache=None,
                 idx=None, state_len=None):
    """One decoder sub-layer of the given kind; ``p`` holds its
    parameters without the ``prefix/``. ``cache``: the layer's
    attention cache dict or recurrent ``(h, conv)`` state, written in
    place; ``state_len`` (B,), the valid prefix of a right-padded
    prefill, where the recurrent mixers take their carried state."""
    if kind in ("attn", "local"):
        x = _attn_block(cfg, p, x, positions, ctx, prefix,
                        window=cfg.window if kind == "local" else 0,
                        mrope=(cfg.family == "vlm"), cache=cache, idx=idx)
        return _mlp_block(cfg, p, x, ctx, prefix)
    if kind == "moe":
        x = _attn_block(cfg, p, x, positions, ctx, prefix, cache=cache,
                        idx=idx)
        xin = rms_norm(x, p["ln2"], cfg.norm_eps)
        return x + moe_mod.moe_ffn(cfg, _sub(p, "moe"), xin, ctx,
                                   f"{prefix}/moe")
    if kind == "mamba":
        xin = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, new = ssm_mod.mamba_mixer(cfg, _sub(p, "mamba"), xin, ctx,
                                     f"{prefix}/mamba", state=cache,
                                     length=state_len)
        if cache is not None:
            _write_state(cache, new)
        return x + y
    if kind == "rec":
        xin = rms_norm(x, p["ln1"], cfg.norm_eps)
        y, new = rglru_mod.rglru_mixer(cfg, _sub(p, "rec"), xin, ctx,
                                       f"{prefix}/rec", state=cache,
                                       length=state_len)
        if cache is not None:
            _write_state(cache, new)
        return _mlp_block(cfg, p, x + y, ctx, prefix)
    raise ValueError(kind)


def _layer_cache(cache, pfx, kind, i=None):
    """The cache of sub-layer ``pfx`` (layer ``i`` of its stack): views
    into the stacked tensors, so that writes land in ``cache``."""
    if cache is None:
        return None
    pick = (lambda t: t) if i is None else (lambda t: t[i])
    if kind in ("mamba", "rec"):
        return (pick(cache[f"{pfx}/h"]), pick(cache[f"{pfx}/conv"]))
    return {n: pick(cache[f"{pfx}/{n}"]) for n in ("k", "v", "pos")}


def _embed(cfg, params, batch, dt):
    x = params["embed"].to(dt)[batch["tokens"]]
    if cfg.family == "vlm" and "img_embeds" in batch:
        # stubbed vision frontend: precomputed patch embeddings projected
        # into the first n_img token slots
        img = torch.matmul(batch["img_embeds"].to(dt).to(torch.float32),
                           params["img_proj"].to(dt).to(torch.float32))
        img = img.to(dt)
        x = x + F.pad(img, (0, 0, 0, x.shape[1] - img.shape[1]))
    return x


def _logits(cfg, params, x):
    dt = x.dtype
    head = params["embed"].t() if cfg.tie_embeddings else params["lm_head"]
    v = head.shape[-1]
    vpad = (-v) % 128
    if vpad:
        head = F.pad(head, (0, vpad))
    logits = torch.matmul(x.to(torch.float32),
                          head.to(dt).to(torch.float32))
    if vpad:
        mask = torch.where(
            torch.arange(v + vpad, device=x.device) < v, 0.0, -1e30)
        logits = logits + mask
    return logits


def forward(cfg, params: Params, batch, taps=None,
            collect: Union[bool, str] = False,
            soi_block: Optional[int] = None, cache=None,
            last_only: bool = False,
            last_pos: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, dict]:
    """Returns ``(logits, stats)``: fp32 logits (B, T, vocab padded to
    128) and, with ``collect``, the blocked A-Grams ``{name: (*stack,
    nb, bs, bs)}`` (with ``collect="cols"`` the blocked tokens ``{name:
    (*stack, tokens, nb, bs)}``) at block cap ``soi_block`` (default
    ``cfg.soi_block``; the K-FAC stats passes give their own block size
    so the statistics match the factors).

    ``batch``: ``tokens`` (B, T), and for the vlm family optionally
    ``img_embeds`` (B, n_img, vision_dim) and M-RoPE ``positions``
    (3, B, T).

    Serving: ``cache`` (:func:`init_cache`) is written in place at its
    ``idx``, which also offsets the positions; the caller advances
    ``idx``. ``last_only`` projects only the last position onto the
    vocabulary, ``last_pos`` (B,) each row's own (a right-padded
    prefill, whose recurrent mixers then take their state there)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    dt = compute_dtype(cfg)
    idx = cache["idx"] if cache is not None else None
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(T, dtype=torch.int32,
                                 device=tokens.device)[None]
        if idx is not None:
            positions = positions + (idx[:, None] if torch.is_tensor(idx)
                                     and idx.ndim == 1 else idx)
        positions = positions.expand(B, T).to(torch.int32)
    state_len = (last_pos + 1 if cache is not None and last_pos is not None
                 and T > 1 else None)
    x = _embed(cfg, params, batch, dt)
    block = soi_block or cfg.soi_block
    taps = taps or {}
    stats: Dict[str, list] = {}
    out_stats: Dict[str, torch.Tensor] = {}
    stacks = _stacks(cfg)
    stacked = [(pfx, kind) for pfx, kind, st in stacks if st]
    if stacked:
        n = stacks[0][2][0]
        group = stacked[0][0].split("/")[0]     # "layers" or "units"
        unb = {k: v.unbind(0) for k, v in params.items()
               if k.startswith(group + "/")}
        tap_l = {k: v.unbind(0) for k, v in taps.items()
                 if k.startswith(group + "/")}
        for i in range(n):
            for pfx, kind in stacked:
                ctx = Ctx(taps={k: v[i] for k, v in tap_l.items()} or None,
                          collect=collect, soi_block=block)
                p_l = {k[len(pfx) + 1:]: v[i] for k, v in unb.items()
                       if k.startswith(pfx + "/")}
                x = _layer_apply(cfg, kind, p_l, x, positions, ctx, pfx,
                                 cache=_layer_cache(cache, pfx, kind, i),
                                 idx=idx, state_len=state_len)
                for name, s in ctx.stats.items():
                    stats.setdefault(name, []).append(s)
    for pfx, kind, st in stacks:
        if st:
            continue
        # the hybrid tail: unstacked parameters, taps and statistics
        ctx = Ctx(taps=taps or None, collect=collect, soi_block=block)
        x = _layer_apply(cfg, kind, _sub(params, pfx), x, positions, ctx,
                         pfx, cache=_layer_cache(cache, pfx, kind),
                         idx=idx, state_len=state_len)
        out_stats.update(ctx.stats)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if last_only:
        x = x[:, -1:]
    elif last_pos is not None:
        x = x[torch.arange(B, device=x.device), last_pos.long()][:, None]
    logits = _logits(cfg, params, x)
    out_stats.update({k: torch.stack(v) for k, v in stats.items()})
    return logits, out_stats


def loss_from_logits(cfg, logits: torch.Tensor, batch) -> torch.Tensor:
    """Next-token cross-entropy (mean over positions, or over the mask)."""
    del cfg
    labels = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1].to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    nll = logz - gold
    mask = batch.get("mask")
    if mask is not None:
        m = mask[:, 1:].to(torch.float32)
        return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(nll)


def loss_fn(cfg, params: Params, batch, taps=None,
            collect: Union[bool, str] = False,
            soi_block: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Next-token cross-entropy. Returns ``(loss, stats)``."""
    logits, stats = forward(cfg, params, batch, taps=taps, collect=collect,
                            soi_block=soi_block)
    return loss_from_logits(cfg, logits, batch), stats


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _state_leaves(cfg, kind, st, batch, device):
    """Zero ``(h, conv)`` of a recurrent sub-layer kind, stacked."""
    init = (ssm_mod.init_mamba_state if kind == "mamba"
            else rglru_mod.init_rglru_state)
    h, conv = init(cfg, batch, device=device)
    return {"h": h.expand(st + h.shape).contiguous(),
            "conv": conv.expand(st + conv.shape).contiguous()}


def _attn_leaves(cfg, st, batch, S, dtype, device):
    kv, hd = cfg.n_kv_heads, cfg.hd
    # unwritten columns carry a far-future position: the causal mask
    # excludes them
    return {"k": torch.zeros(st + (batch, S, kv, hd), dtype=dtype,
                             device=device),
            "v": torch.zeros(st + (batch, S, kv, hd), dtype=dtype,
                             device=device),
            "pos": torch.full(st + (batch, S), UNWRITTEN_POS,
                              dtype=torch.int32, device=device)}


def init_cache(cfg, batch: int, seq_len: int, dtype=torch.bfloat16, *,
               device) -> dict:
    """A decode cache of ``batch`` rows and ``seq_len`` columns (the
    hybrid's windowed layers ``min(seq_len, window)``, written as a
    ring), at ``idx`` 0; recurrent states are fp32 zeros."""
    _check_family(cfg)
    S = min(seq_len, cfg.window or seq_len) if cfg.family == "hybrid" \
        else seq_len
    cache = {}
    for pfx, kind, st in _stacks(cfg):
        leaves = (_state_leaves(cfg, kind, st, batch, device)
                  if kind in ("mamba", "rec")
                  else _attn_leaves(cfg, st, batch, S, dtype, device))
        cache.update({f"{pfx}/{k}": v for k, v in leaves.items()})
    cache["idx"] = 0
    return cache


def _advance(cache, T: int) -> dict:
    return {**cache, "idx": cache["idx"] + T}


def prefill(cfg, params: Params, batch, cache, length=None):
    """Process a prompt into ``cache``; returns ``(last-token logits
    (B, vocab padded), cache)``. ``length`` (B,): each row's real prompt
    length when the prompts are right-padded to a bucket (the serving
    engine): the logits, and the recurrent states, are taken at the last
    real token."""
    logits, _ = forward(cfg, params, batch, cache=cache,
                        last_only=length is None,
                        last_pos=None if length is None else length - 1)
    return logits[:, -1], _advance(cache, batch["tokens"].shape[1])


def decode_step(cfg, params: Params, token, cache):
    """One decode step; ``token`` (B, 1) int. Returns ``(logits,
    cache)``."""
    logits, _ = forward(cfg, params, {"tokens": token}, cache=cache)
    return logits[:, -1], _advance(cache, token.shape[1])


def cache_write_slot(cache, slot, row_cache, length):
    """Insert a single-request prefill cache into slot ``slot`` of a
    serving pool (``repro_torch.serve.pool``)."""
    from repro_torch.serve.pool import write_slot
    return write_slot(cache, slot, row_cache, length)


def cache_reset_slot(cache, slot):
    """Free slot ``slot``: length 0, positions to the far-future
    sentinel, recurrent states to 0 (``repro_torch.serve.pool``)."""
    from repro_torch.serve.pool import reset_slot
    return reset_slot(cache, slot)


def kfac_specs(cfg) -> Dict[str, LinearSpec]:
    """Every factored linear by parameter path (the reference's
    registry): MoE experts stack ``(L, e)`` over capacity tokens, the
    hybrid's tail linears have no stack."""
    _check_family(cfg)
    d, f = cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    specs: Dict[str, LinearSpec] = {}

    def attn(prefix, st):
        specs[f"{prefix}/attn/wq"] = LinearSpec(d, h * hd, st)
        specs[f"{prefix}/attn/wk"] = LinearSpec(
            d, kv * hd, st, share_a_with=f"{prefix}/attn/wq")
        specs[f"{prefix}/attn/wv"] = LinearSpec(
            d, kv * hd, st, share_a_with=f"{prefix}/attn/wq")
        specs[f"{prefix}/attn/wo"] = LinearSpec(h * hd, d, st)

    def mlp(prefix, st):
        specs[f"{prefix}/mlp/wg"] = LinearSpec(d, f, st)
        specs[f"{prefix}/mlp/wu"] = LinearSpec(
            d, f, st, share_a_with=f"{prefix}/mlp/wg")
        specs[f"{prefix}/mlp/wd"] = LinearSpec(f, d, st)

    def rec(prefix, st):
        lw = cfg.lru_width_
        specs[f"{prefix}/rec/in_x"] = LinearSpec(d, lw, st)
        specs[f"{prefix}/rec/in_gate"] = LinearSpec(
            d, lw, st, share_a_with=f"{prefix}/rec/in_x")
        specs[f"{prefix}/rec/w_a"] = LinearSpec(lw, lw, st)
        specs[f"{prefix}/rec/w_x"] = LinearSpec(
            lw, lw, st, share_a_with=f"{prefix}/rec/w_a")
        specs[f"{prefix}/rec/out"] = LinearSpec(lw, d, st)

    for prefix, kind, st in _stacks(cfg):
        if kind in ("attn", "local", "moe"):
            attn(prefix, st)
        if kind == "rec":
            rec(prefix, st)
        if kind in ("attn", "local", "rec"):
            mlp(prefix, st)
        if kind == "moe":
            es = st + (cfg.n_experts,)
            specs[f"{prefix}/moe/wg"] = LinearSpec(d, f, es, cap_tokens=True)
            specs[f"{prefix}/moe/wu"] = LinearSpec(
                d, f, es, share_a_with=f"{prefix}/moe/wg", cap_tokens=True)
            specs[f"{prefix}/moe/wd"] = LinearSpec(f, d, es, cap_tokens=True)
        if kind == "mamba":
            di, n, dr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
            specs[f"{prefix}/mamba/in_proj"] = LinearSpec(d, 2 * di, st)
            specs[f"{prefix}/mamba/x_proj"] = LinearSpec(di, dr + 2 * n, st)
            specs[f"{prefix}/mamba/dt_proj"] = LinearSpec(dr, di, st)
            specs[f"{prefix}/mamba/out_proj"] = LinearSpec(di, d, st)
    return specs


def build_taps(cfg, specs: Dict[str, LinearSpec], n_tokens: int, *,
               device) -> Dict[str, torch.Tensor]:
    """Zero taps for a stats pass over ``n_tokens`` tokens (the expert
    capacity for ``cap_tokens`` linears), ready to take gradients."""
    out = {}
    for name, s in specs.items():
        t = moe_mod.capacity(cfg, n_tokens) if s.cap_tokens else n_tokens
        out[name] = torch.zeros(s.stack + (t, s.d_out), dtype=torch.float32,
                                device=device, requires_grad=True)
    return out
