"""Dense decoder LM (the dense family of ``repro.models.lm``).

Parameters are a flat dict keyed by the reference's parameter paths
(``embed``, ``final_norm``, ``layers/attn/wq`` ...), with the layer
stack as a leading (L, ...) dim exactly as in the JAX tree, so K-FAC
specs, factors and converted weights address the same names. Where the
reference scans over layers, a Python loop walks the unbound stack.

K-FAC integration: every factored linear goes through
``layers.dense`` under its parameter path; taps (zeros, one per
factored linear, shape (L, tokens, d_out)) enter per layer and their
gradients are the per-token output gradients; with ``collect`` the
input-side blocked Grams (or, with ``collect="cols"``, blocked tokens)
come back stacked over layers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core.soi import LinearSpec
from repro_torch.models.layers import (
    Ctx,
    apply_rope,
    attention,
    dense,
    rms_norm,
    swiglu,
)

Params = Dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def compute_dtype(cfg) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _check_family(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch runs the dense family only, not {cfg.family!r}")


def init(cfg, *, generator: torch.Generator, device) -> Params:
    """Random fp32 parameters with the reference's distributions (the
    values differ: torch and jax generators give different numbers)."""
    _check_family(cfg)
    L, d, v, f = cfg.n_layers, cfg.d_model, cfg.vocab, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) * scale

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    p = {
        "embed": normal((v, d), 0.02),
        "final_norm": zeros((d,)),
        "layers/ln1": zeros((L, d)),
        "layers/ln2": zeros((L, d)),
        "layers/attn/wq": normal((L, d, h * hd), d ** -0.5),
        "layers/attn/wk": normal((L, d, kv * hd), d ** -0.5),
        "layers/attn/wv": normal((L, d, kv * hd), d ** -0.5),
        "layers/attn/wo": normal((L, h * hd, d), (h * hd) ** -0.5),
        "layers/mlp/wg": normal((L, d, f), d ** -0.5),
        "layers/mlp/wu": normal((L, d, f), d ** -0.5),
        "layers/mlp/wd": normal((L, f, d), f ** -0.5),
    }
    if cfg.qkv_bias:
        p["layers/attn/bq"] = zeros((L, h * hd))
        p["layers/attn/bk"] = zeros((L, kv * hd))
        p["layers/attn/bv"] = zeros((L, kv * hd))
    if not cfg.tie_embeddings:
        p["lm_head"] = normal((d, v), d ** -0.5)
    return p


def _attn_block(cfg, p, x, positions, ctx, prefix):
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
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, positions, positions,
                    chunk=cfg.attn_chunk if T > cfg.attn_chunk else 0)
    out = dense(out.reshape(B, T, -1), p["attn/wo"], f"{prefix}/attn/wo",
                ctx)
    return x + out


def _mlp_block(cfg, p, x, ctx, prefix):
    xin = rms_norm(x, p["ln2"], cfg.norm_eps)
    g = dense(xin, p["mlp/wg"], f"{prefix}/mlp/wg", ctx)
    u = dense(xin, p["mlp/wu"], f"{prefix}/mlp/wu", ctx, collect_gram=False)
    return x + dense(swiglu(g, u), p["mlp/wd"], f"{prefix}/mlp/wd", ctx)


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
            soi_block: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Training forward. Returns ``(logits, stats)``: fp32 logits
    (B, T, vocab padded to 128) and, with ``collect``, the blocked
    A-Grams ``{name: (L, nb, bs, bs)}`` (with ``collect="cols"`` the
    blocked tokens ``{name: (L, B*T, nb, bs)}``) at block cap
    ``soi_block`` (default ``cfg.soi_block``; the K-FAC stats passes
    give their own block size so the statistics match the factors)."""
    _check_family(cfg)
    tokens = batch["tokens"]
    B, T = tokens.shape
    dt = compute_dtype(cfg)
    positions = torch.arange(T, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, T)
    x = params["embed"].to(dt)[tokens]
    layer = {k[len("layers/"):]: v.unbind(0) for k, v in params.items()
             if k.startswith("layers/")}
    tap_l = {k: v.unbind(0) for k, v in (taps or {}).items()}
    stats: Dict[str, list] = {}
    for i in range(cfg.n_layers):
        p_l = {k: v[i] for k, v in layer.items()}
        ctx = Ctx(taps={k: v[i] for k, v in tap_l.items()} or None,
                  collect=collect, soi_block=soi_block or cfg.soi_block)
        x = _attn_block(cfg, p_l, x, positions, ctx, "layers")
        x = _mlp_block(cfg, p_l, x, ctx, "layers")
        for name, s in ctx.stats.items():
            stats.setdefault(name, []).append(s)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(cfg, params, x)
    return logits, {k: torch.stack(v) for k, v in stats.items()}


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


def kfac_specs(cfg) -> Dict[str, LinearSpec]:
    """Every factored linear of the dense family, by parameter path."""
    _check_family(cfg)
    d, f = cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    st = (cfg.n_layers,)
    return {
        "layers/attn/wq": LinearSpec(d, h * hd, st),
        "layers/attn/wk": LinearSpec(d, kv * hd, st,
                                     share_a_with="layers/attn/wq"),
        "layers/attn/wv": LinearSpec(d, kv * hd, st,
                                     share_a_with="layers/attn/wq"),
        "layers/attn/wo": LinearSpec(h * hd, d, st),
        "layers/mlp/wg": LinearSpec(d, f, st),
        "layers/mlp/wu": LinearSpec(d, f, st, share_a_with="layers/mlp/wg"),
        "layers/mlp/wd": LinearSpec(f, d, st),
    }


def build_taps(cfg, specs: Dict[str, LinearSpec], n_tokens: int, *,
               device) -> Dict[str, torch.Tensor]:
    """Zero taps for a stats pass over ``n_tokens`` tokens, ready to
    take gradients."""
    del cfg
    return {name: torch.zeros(s.stack + (n_tokens, s.d_out),
                              dtype=torch.float32, device=device,
                              requires_grad=True)
            for name, s in specs.items()}
