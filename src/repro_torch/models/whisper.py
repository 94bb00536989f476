"""Whisper-style encoder-decoder backbone, whisper-tiny's architecture
(counterpart of ``repro.models.whisper``), for training and serving.

As in the reference, the conv/mel frontend is a stub: the batch brings
precomputed frame embeddings ``enc_embeds`` (B, T_frames, D). The
backbone: pre-LN transformer layers with LayerNorm (with bias),
sinusoidal positions, a bidirectional encoder, a causal decoder with
cross-attention over the encoder's output, GELU MLPs and the tied
embedding as the vocabulary head (padded to a multiple of 128, the
padded columns masked at -1e30).

Parameters are a flat dict keyed by the reference's paths: ``embed``,
``enc/attn/wq`` (L_enc, d, h*hd), ``enc/ln1/w``, ``dec/cross/bv``,
``dec/mlp/b1``, ``enc_ln_f/w`` ...; the layer stacks lead, as in the
JAX tree. K-FAC factors every projection (:func:`kfac_specs`):
self-attention's ``wk``/``wv`` share ``wq``'s A factor, and the
cross-attention ``dec/cross/wk`` takes its A factor over the encoder's
frames, which ``dec/cross/wv`` shares, so their taps carry one row a
frame (``launch.steps`` sizes them).

Pipeline parallelism: :func:`stage_channel_init`,
:func:`stage_slice_forward` and :func:`head_loss` are a stage's pieces
over the concatenated ``[encoder | decoder]`` channel, on the layer
loops :func:`encode` and :func:`decode` run.

Serving: :func:`init_cache` is ``layers/self/k``, ``layers/self/v``
(L, B, S, h, hd), ``layers/self/pos`` (L, B, S), the precomputed
cross-attention ``layers/cross_k``/``layers/cross_v`` (L, B, enc_len, h,
hd) and ``idx``, as in ``models.lm``; :func:`prefill` encodes the frames
and fills the cross K/V, :func:`decode_step` attends to them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.core.soi import LinearSpec
from repro_torch.models.layers import (
    UNWRITTEN_POS,
    Ctx,
    attention,
    dense,
    gelu,
    kv_cache_update,
    layer_norm,
    pos_cache_update,
)
from repro_torch.models.lm import compute_dtype

Params = Dict[str, torch.Tensor]


def _sinusoid(positions: torch.Tensor, d: int) -> torch.Tensor:
    """(B, T) -> (B, T, d) sinusoidal embedding, fp32."""
    half = d // 2
    ar = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * ar / (half - 1))
    ang = positions[..., None].to(torch.float32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _check_family(cfg) -> None:
    if cfg.family != "audio":
        raise NotImplementedError(
            f"models.whisper runs the audio family, not {cfg.family!r}")


def init(cfg, *, generator: torch.Generator, device) -> Params:
    """Random fp32 parameters with the reference's distributions (the
    values differ: torch and jax generators give different numbers)."""
    _check_family(cfg)
    d, f, hhd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device) * scale

    def zeros(shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    def ln(name, st):
        return {f"{name}/w": zeros(st + (d,)) + 1.0,
                f"{name}/b": zeros(st + (d,))}

    def attn(name, st):
        return {f"{name}/wq": normal(st + (d, hhd), d ** -0.5),
                f"{name}/wk": normal(st + (d, hhd), d ** -0.5),
                f"{name}/wv": normal(st + (d, hhd), d ** -0.5),
                f"{name}/wo": normal(st + (hhd, d), hhd ** -0.5),
                f"{name}/bq": zeros(st + (hhd,)),
                f"{name}/bv": zeros(st + (hhd,)),
                f"{name}/bo": zeros(st + (d,))}

    def mlp(name, st):
        return {f"{name}/w1": normal(st + (d, f), d ** -0.5),
                f"{name}/b1": zeros(st + (f,)),
                f"{name}/w2": normal(st + (f, d), f ** -0.5),
                f"{name}/b2": zeros(st + (d,))}

    le, ld = (cfg.n_enc_layers,), (cfg.n_dec_layers,)
    p = {"embed": normal((cfg.vocab, d), 0.02)}
    p.update(ln("enc/ln1", le) | attn("enc/attn", le) | ln("enc/ln2", le)
             | mlp("enc/mlp", le))
    p.update(ln("dec/ln1", ld) | attn("dec/attn", ld) | ln("dec/lnx", ld)
             | attn("dec/cross", ld) | ln("dec/ln2", ld)
             | mlp("dec/mlp", ld))
    p.update(ln("enc_ln_f", ()) | ln("dec_ln_f", ()))
    return p


def _ln(x, p, name):
    return layer_norm(x, p[f"{name}/w"], p[f"{name}/b"])


def _mha(cfg, p, pfx, xq, ctx, prefix, causal, q_pos, kv_pos, cache=None,
         idx=None, shared_kv=None):
    """One attention: queries from ``xq``, keys and values from ``xq``
    or ``shared_kv`` (the cross-attention's), through ``cache`` (this
    layer's ``k``, ``v``, ``pos``, written in place at ``idx``) when
    given. ``p[pfx + "/wq"]`` ... are the layer's projections."""
    B, T, _ = xq.shape
    h, hd = cfg.n_heads, cfg.hd
    q = dense(xq, p[f"{pfx}/wq"], f"{prefix}/wq", ctx, bias=p[f"{pfx}/bq"])
    if shared_kv is not None:
        k, v = shared_kv
    else:
        k = dense(xq, p[f"{pfx}/wk"], f"{prefix}/wk", ctx,
                  collect_gram=False).reshape(B, -1, h, hd)
        v = dense(xq, p[f"{pfx}/wv"], f"{prefix}/wv", ctx,
                  bias=p[f"{pfx}/bv"], collect_gram=False).reshape(
                      B, -1, h, hd)
    q = q.reshape(B, T, h, hd)
    if cache is not None:
        kv_cache_update(cache["k"], cache["v"], k, v, idx)
        pos_cache_update(cache["pos"], q_pos, idx)
        k, v = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
        kv_pos = cache["pos"]
    out = attention(q, k, v, q_pos, kv_pos, causal=causal,
                    chunk=cfg.attn_chunk if T > cfg.attn_chunk else 0)
    return dense(out.reshape(B, T, h * hd), p[f"{pfx}/wo"],
                 f"{prefix}/wo", ctx, bias=p[f"{pfx}/bo"])


def _mlp(p, x, ctx, prefix):
    hidden = gelu(dense(x, p["mlp/w1"], f"{prefix}/w1", ctx,
                        bias=p["mlp/b1"]))
    return dense(hidden, p["mlp/w2"], f"{prefix}/w2", ctx, bias=p["mlp/b2"])


def _stack(params: Params, group: str, taps):
    """Per layer of stack ``group``: its parameters (``group/`` dropped)
    and its tap slices."""
    n = len(group) + 1
    unb = {k[n:]: v.unbind(0) for k, v in params.items()
           if k.startswith(group + "/")}
    tap_l = {k: v.unbind(0) for k, v in (taps or {}).items()
             if k.startswith(group + "/")}
    L = len(next(iter(unb.values())))
    return [({k: v[i] for k, v in unb.items()},
             {k: v[i] for k, v in tap_l.items()} or None) for i in range(L)]


def _stack_stats(per_layer):
    out: Dict[str, list] = {}
    for st in per_layer:
        for name, s in st.items():
            out.setdefault(name, []).append(s)
    return {k: torch.stack(v) for k, v in out.items()}


def _frames(cfg, enc_embeds: torch.Tensor):
    """The encoder's input in the compute dtype: the frame embeddings
    plus sinusoidal positions; and the positions."""
    B, T, D = enc_embeds.shape
    pos = torch.arange(T, dtype=torch.int32,
                       device=enc_embeds.device)[None].expand(B, T)
    x = (enc_embeds.to(torch.float32) + _sinusoid(pos, D)).to(
        compute_dtype(cfg))
    return x, pos


def _enc_layers(cfg, params: Params, x, pos, taps, collect, block):
    """The encoder layers ``params`` holds over ``x``: ``(x, per-layer
    stats)``."""
    stats = []
    for p_l, taps_l in _stack(params, "enc", taps):
        ctx = Ctx(taps=taps_l, collect=collect, soi_block=block)
        x = x + _mha(cfg, p_l, "attn", _ln(x, p_l, "ln1"), ctx, "enc/attn",
                     False, pos, pos)
        x = x + _mlp(p_l, _ln(x, p_l, "ln2"), ctx, "enc/mlp")
        stats.append(ctx.stats)
    return x, stats


def encode(cfg, params: Params, enc_embeds: torch.Tensor, taps=None,
           collect: Union[bool, str] = False,
           soi_block: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """enc_embeds (B, T, D) stubbed frame embeddings -> ``(out (B, T,
    D), stats)``: the bidirectional encoder and its final LayerNorm."""
    x, pos = _frames(cfg, enc_embeds)
    x, stats = _enc_layers(cfg, params, x, pos, taps, collect,
                           soi_block or cfg.soi_block)
    return _ln(x, params, "enc_ln_f"), _stack_stats(stats)


def _mha_kv(cfg, p, enc_out, ctx, prefix):
    """The cross-attention's keys and values over the encoder's output;
    ``wk`` records the A statistic over the frames (``wv`` shares it)."""
    B = enc_out.shape[0]
    h, hd = cfg.n_heads, cfg.hd
    k = dense(enc_out, p["cross/wk"], f"{prefix}/wk", ctx)
    v = dense(enc_out, p["cross/wv"], f"{prefix}/wv", ctx,
              bias=p["cross/bv"], collect_gram=False)
    return k.reshape(B, -1, h, hd), v.reshape(B, -1, h, hd)


def _head_logits(cfg, params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied vocabulary head on the post-``dec_ln_f`` activations, the
    vocabulary padded to a multiple of 128 and the padded columns masked
    at -1e30 (loss and argmax unchanged)."""
    dt = x.dtype
    head = params["embed"].t()
    v = head.shape[-1]
    vpad = (-v) % 128
    if vpad:
        head = torch.nn.functional.pad(head, (0, vpad))
    logits = torch.matmul(x.to(torch.float32),
                          head.to(dt).to(torch.float32))
    if vpad:
        logits = logits + torch.where(
            torch.arange(v + vpad, device=x.device) < v, 0.0, -1e30)
    return logits


def loss_from_logits(cfg, logits: torch.Tensor, batch) -> torch.Tensor:
    """Teacher-forced cross-entropy over the decoder tokens."""
    del cfg
    labels = batch["tokens"][:, 1:].long()
    lg = logits[:, :-1].to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, labels[..., None])[..., 0]
    return torch.mean(logz - gold)


def _tokens_in(cfg, params: Params, tokens, pos):
    """The decoder's input in the compute dtype: the token embedding plus
    sinusoidal positions."""
    dt = compute_dtype(cfg)
    return (params["embed"].to(dt)[tokens].to(torch.float32)
            + _sinusoid(pos, cfg.d_model)).to(dt)


def _dec_layers(cfg, params: Params, x, pos, enc_out, enc_pos, taps,
                collect, block, cache=None, idx=None):
    """The decoder layers ``params`` holds over ``x``, cross-attending to
    ``enc_out`` (or the cache's cross K/V): ``(x, per-layer stats)``."""
    stats = []
    for i, (p_l, taps_l) in enumerate(_stack(params, "dec", taps)):
        ctx = Ctx(taps=taps_l, collect=collect, soi_block=block)
        self_cache = None if cache is None else {
            n: cache[f"layers/self/{n}"][i] for n in ("k", "v", "pos")}
        x = x + _mha(cfg, p_l, "attn", _ln(x, p_l, "ln1"), ctx, "dec/attn",
                     True, pos, pos, cache=self_cache, idx=idx)
        xq = _ln(x, p_l, "lnx")
        if cache is not None:
            kv = (cache["layers/cross_k"][i].to(xq.dtype),
                  cache["layers/cross_v"][i].to(xq.dtype))
        else:
            kv = _mha_kv(cfg, p_l, enc_out, ctx, "dec/cross")
        x = x + _mha(cfg, p_l, "cross", xq, ctx, "dec/cross", False, pos,
                     enc_pos, shared_kv=kv)
        x = x + _mlp(p_l, _ln(x, p_l, "ln2"), ctx, "dec/mlp")
        stats.append(ctx.stats)
    return x, stats


def decode(cfg, params: Params, tokens: torch.Tensor,
           enc_out: Optional[torch.Tensor], taps=None,
           collect: Union[bool, str] = False,
           soi_block: Optional[int] = None, cache=None,
           last_only: bool = False,
           last_pos: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, dict]:
    """The decoder over ``tokens`` (B, T): ``(logits, stats)``.

    Without ``cache`` the cross-attention's keys and values come from
    ``enc_out`` (B, T_enc, D). With ``cache`` they come from its
    ``cross_k``/``cross_v`` (``enc_out`` is not read and may be None),
    the self-attention writes the cache in place at its ``idx`` and the
    caller advances ``idx``. ``last_only``/``last_pos`` as in
    ``models.lm.forward``."""
    B, T = tokens.shape
    idx = cache["idx"] if cache is not None else None
    pos = torch.arange(T, dtype=torch.int32, device=tokens.device)[None]
    if idx is not None:
        pos = pos + (idx[:, None] if torch.is_tensor(idx) and idx.ndim == 1
                     else idx)
    pos = pos.expand(B, T).to(torch.int32)
    x = _tokens_in(cfg, params, tokens, pos)
    enc_len = (cache["layers/cross_k"].shape[2] if cache is not None
               else enc_out.shape[1])
    enc_pos = torch.arange(enc_len, dtype=torch.int32,
                           device=tokens.device)[None].expand(B, enc_len)
    x, stats = _dec_layers(cfg, params, x, pos, enc_out, enc_pos, taps,
                           collect, soi_block or cfg.soi_block, cache, idx)
    x = _ln(x, params, "dec_ln_f")
    if last_only:
        x = x[:, -1:]
    elif last_pos is not None:
        x = x[torch.arange(B, device=x.device), last_pos.long()][:, None]
    return _head_logits(cfg, params, x), _stack_stats(stats)


def loss_fn(cfg, params: Params, batch, taps=None,
            collect: Union[bool, str] = False,
            soi_block: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Teacher-forced cross-entropy of ``batch`` (``tokens`` (B, T) and
    ``enc_embeds`` (B, T_enc, D)); returns ``(loss, stats)``, the
    encoder's and the decoder's statistics together."""
    enc_out, stats_e = encode(cfg, params, batch["enc_embeds"], taps=taps,
                              collect=collect, soi_block=soi_block)
    logits, stats_d = decode(cfg, params, batch["tokens"], enc_out,
                             taps=taps, collect=collect, soi_block=soi_block)
    return loss_from_logits(cfg, logits, batch), {**stats_e, **stats_d}


# ---------------------------------------------------------------------------
# Per-stage slices (pipeline parallelism, repro_torch.pipeline)
# ---------------------------------------------------------------------------
#
# The pipeline's channel for the encoder-decoder is the concatenation
# [enc_seg | dec_seg] along time, width T_enc + T_dec: the contiguous
# stage partition over the [enc..., dec...] atoms puts the encoder layers
# on leading stages and the decoder layers on trailing ones, and the one
# channel carries the final encoder output forward to every decoder stage
# and the encoder cotangents backward. A stage that runs decoder layers
# recomputes ``enc_out = layer_norm(enc_seg, enc_ln_f)`` itself
# (``enc_ln_f`` is on every stage); by contiguity its enc segment is
# final.


def stage_channel_init(cfg, params: Params, batch) -> torch.Tensor:
    """The first stage's front: both frontends (frame embeddings plus
    sinusoid for the encoder segment, token embedding plus sinusoid for
    the decoder segment), concatenated along time."""
    enc_x, _ = _frames(cfg, batch["enc_embeds"])
    tokens = batch["tokens"]
    B, T = tokens.shape
    pos = torch.arange(T, dtype=torch.int32,
                       device=tokens.device)[None].expand(B, T)
    return torch.cat([enc_x, _tokens_in(cfg, params, tokens, pos)], dim=1)


def stage_slice_forward(cfg, params: Params, ch: torch.Tensor, t_enc: int,
                        *, taps=None, collect: Union[bool, str] = False,
                        soi_block: Optional[int] = None
                        ) -> Tuple[torch.Tensor, dict]:
    """One stage's encoder layers over the channel's encoder segment,
    then its decoder layers over the decoder segment (either may be
    none): ``(channel, stats)``."""
    B = ch.shape[0]
    block = soi_block or cfg.soi_block
    # each segment contiguous, as the monolithic path's activations are
    # (a strided view takes other kernels, with other rounding)
    enc, dec = ch[:, :t_enc].contiguous(), ch[:, t_enc:].contiguous()
    epos = torch.arange(t_enc, dtype=torch.int32,
                        device=ch.device)[None].expand(B, t_enc)
    stats = []
    if any(k.startswith("enc/") for k in params):
        enc, stats = _enc_layers(cfg, params, enc, epos, taps, collect,
                                 block)
    if any(k.startswith("dec/") for k in params):
        T = dec.shape[1]
        dpos = torch.arange(T, dtype=torch.int32,
                            device=ch.device)[None].expand(B, T)
        dec, st = _dec_layers(cfg, params, dec, dpos,
                              _ln(enc, params, "enc_ln_f"), epos, taps,
                              collect, block)
        stats = stats + st
    return (torch.cat([_DenseGrad.apply(enc), _DenseGrad.apply(dec)], dim=1),
            _stack_stats(stats))


class _DenseGrad(torch.autograd.Function):
    """The identity, whose cotangent is made contiguous: a segment of the
    concatenated channel gets a strided slice of the channel's cotangent,
    and the layers' reductions over a strided cotangent (a bias's sum)
    round otherwise than the monolithic path's over a dense one."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ct.contiguous()


def head_loss(cfg, params: Params, ch: torch.Tensor, batch) -> torch.Tensor:
    """The last stage's head on the channel's decoder segment: the final
    LayerNorm, the tied vocabulary head and :func:`loss_from_logits`,
    the operations :func:`loss_fn` runs after the decoder."""
    x = _ln(ch[:, batch["enc_embeds"].shape[1]:].contiguous(), params,
            "dec_ln_f")
    return loss_from_logits(cfg, _head_logits(cfg, params, x), batch)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, self_len: int, enc_len: int,
               dtype=torch.bfloat16, *, device) -> dict:
    """A decode cache of ``batch`` rows: ``self_len`` self-attention
    columns and ``enc_len`` cross-attention frames, at ``idx`` 0."""
    _check_family(cfg)
    h, hd, L = cfg.n_heads, cfg.hd, cfg.n_dec_layers

    def zeros(n):
        return torch.zeros((L, batch, n, h, hd), dtype=dtype, device=device)

    return {"layers/self/k": zeros(self_len),
            "layers/self/v": zeros(self_len),
            "layers/self/pos": torch.full((L, batch, self_len),
                                          UNWRITTEN_POS, dtype=torch.int32,
                                          device=device),
            "layers/cross_k": zeros(enc_len),
            "layers/cross_v": zeros(enc_len),
            "idx": 0}


def prefill(cfg, params: Params, batch, cache, length=None):
    """Encode ``batch["enc_embeds"]``, put every decoder layer's cross
    K/V into ``cache``, and prefill the decoder prompt
    ``batch["tokens"]``; returns ``(last-token logits, cache)``.
    ``length`` (B,): real prompt lengths of right-padded prompts."""
    enc_out, _ = encode(cfg, params, batch["enc_embeds"])
    for i, (p_l, _) in enumerate(_stack(params, "dec", None)):
        k, v = _mha_kv(cfg, p_l, enc_out, None, "dec/cross")
        cache["layers/cross_k"][i].copy_(k)
        cache["layers/cross_v"][i].copy_(v)
    logits, _ = decode(cfg, params, batch["tokens"], None, cache=cache,
                       last_only=length is None,
                       last_pos=None if length is None else length - 1)
    T = batch["tokens"].shape[1]
    return logits[:, -1], {**cache, "idx": cache["idx"] + T}


def decode_step(cfg, params: Params, token, cache):
    """One decode step; ``token`` (B, 1). The encoder's frame count
    comes from the cache (the reference builds a zero encoder output
    each step for its shape)."""
    logits, _ = decode(cfg, params, token, None, cache=cache)
    return logits[:, -1], {**cache, "idx": cache["idx"] + token.shape[1]}


def cache_write_slot(cache, slot, row_cache, length):
    """Insert a single-request prefill cache (self and cross K/V) into
    slot ``slot`` of a serving pool (``repro_torch.serve.pool``)."""
    from repro_torch.serve.pool import write_slot
    return write_slot(cache, slot, row_cache, length)


def cache_reset_slot(cache, slot):
    """Free slot ``slot`` of a serving pool (``repro_torch.serve.pool``)."""
    from repro_torch.serve.pool import reset_slot
    return reset_slot(cache, slot)


def kfac_specs(cfg) -> Dict[str, LinearSpec]:
    """Every factored linear by parameter path (the reference's
    registry)."""
    _check_family(cfg)
    d, f, hhd = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd
    le, ld = (cfg.n_enc_layers,), (cfg.n_dec_layers,)
    specs: Dict[str, LinearSpec] = {}

    def attn(pfx, st, shared_from):
        specs[f"{pfx}/wq"] = LinearSpec(d, hhd, st)
        specs[f"{pfx}/wk"] = LinearSpec(
            d, hhd, st, share_a_with=shared_from.get("wk"))
        specs[f"{pfx}/wv"] = LinearSpec(
            d, hhd, st, share_a_with=shared_from["wv"])
        specs[f"{pfx}/wo"] = LinearSpec(hhd, d, st)

    def mlp(pfx, st):
        specs[f"{pfx}/w1"] = LinearSpec(d, f, st)
        specs[f"{pfx}/w2"] = LinearSpec(f, d, st)

    for pfx, st in (("enc", le), ("dec", ld)):
        attn(f"{pfx}/attn", st, {"wk": f"{pfx}/attn/wq",
                                 "wv": f"{pfx}/attn/wq"})
        if pfx == "dec":
            # cross-attention: wk's A is over the encoder's frames
            attn("dec/cross", st, {"wv": "dec/cross/wk"})
        mlp(f"{pfx}/mlp", st)
    return specs
