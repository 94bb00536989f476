"""Model primitives (counterpart of ``repro.models.layers``): norms
(RMS and LayerNorm), RoPE and M-RoPE, chunked, windowed and
bidirectional GQA attention, SwiGLU, GELU, the causal depthwise
convolution with its carried decode state, the tapped dense layers
(plain and stacked) that feed K-FAC its statistics, and the serving
caches' column writes (:func:`kv_cache_update`, :func:`pos_cache_update`).

Conventions follow the reference: parameters are fp32, compute casts to
the config's dtype, and every dense product accumulates in fp32. torch
returns bf16 from a bf16 matmul, so :func:`dense` (like the attention
einsums) upcasts its bf16 operands and multiplies in fp32: a product of
two bf16 values is exact in fp32, which is JAX's
``preferred_element_type=float32`` arithmetic, and the result is cast
once at the end as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import soi
from repro_torch.dist.api import fwd_psum

#: far-future sentinel position: the causal mask (q_pos >= kv_pos)
#: excludes cache columns carrying it
UNWRITTEN_POS = 2 ** 30


@dataclasses.dataclass
class Ctx:
    """Per-layer forward context: this layer's tap slices and what the
    factored linears record of their inputs. ``collect`` is False
    (nothing), True (the blocked Gram) or ``"cols"`` (the blocked token
    columns, ``soi.blocked_tokens``, whose Gram is the same statistic:
    the SMW rank-k refresh needs the columns themselves)."""

    taps: Optional[Dict[str, torch.Tensor]] = None
    collect: Union[bool, str] = False
    stats: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    soi_block: int = 1024


def dense(x: torch.Tensor, w: torch.Tensor, name: str,
          ctx: Optional[Ctx] = None, bias: Optional[torch.Tensor] = None,
          collect_gram: bool = True, group=None,
          block: int = 0) -> torch.Tensor:
    """Tapped linear ``y = x @ w (+ b) (+ tap[name])`` in ``x.dtype``.

    With ``ctx.collect`` the input's blocked Gram, or with
    ``collect="cols"`` its blocked tokens, is recorded (skipped with
    ``collect_gram=False`` for linears sharing a sibling's A), in blocks
    of ``block`` when given (a model-sliced input keeps its full
    width's blocks).

    ``group``: the model submesh of a row-parallel ``w`` (rows a slice
    of the full weight): the fp32 partial product is summed over its
    ranks (``dist.api.fwd_psum``) before the bias, the tap and the one
    cast to ``x.dtype``, so the output rounds once, as one rank's
    does."""
    dt = x.dtype
    y = torch.matmul(x.to(torch.float32), w.to(dt).to(torch.float32))
    if group is not None:
        y = fwd_psum(y, group)
    if bias is not None:
        y = y + bias.to(torch.float32)
    if ctx is not None:
        if ctx.collect and collect_gram:
            a = x.detach().to(torch.float32).reshape(-1, x.shape[-1])
            ctx.stats[name] = (
                soi.blocked_tokens(a, ctx.soi_block, block)
                if ctx.collect == "cols"
                else soi.blocked_gram(a, ctx.soi_block, block))
        if ctx.taps is not None and name in ctx.taps:
            y = y + ctx.taps[name].reshape(y.shape)
    return y.to(dt)


def dense_stacked(x: torch.Tensor, w: torch.Tensor, name: str,
                  ctx: Optional[Ctx] = None,
                  collect_gram: bool = True) -> torch.Tensor:
    """Batched tapped linear for stacked weights (the MoE experts):
    ``x`` (S..., T, d_in), ``w`` (S..., d_in, d_out) with matching
    leading stack dims. Collected Grams (or tokens) keep the stack dims:
    (S..., nb, bs, bs)."""
    dt = x.dtype
    y = torch.matmul(x.to(torch.float32), w.to(dt).to(torch.float32))
    if ctx is not None:
        if ctx.collect and collect_gram:
            xf = x.detach().to(torch.float32)
            ctx.stats[name] = (soi.blocked_tokens(xf, ctx.soi_block)
                               if ctx.collect == "cols"
                               else soi.blocked_gram(xf, ctx.soi_block))
        if ctx.taps is not None and name in ctx.taps:
            y = y + ctx.taps[name].reshape(y.shape)
    return y.to(dt)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with bias over the last dim, in fp32 (biased variance,
    as ``jnp.var``)."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * w.to(torch.float32) \
        + b.to(torch.float32)
    return out.to(x.dtype)


def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    ar = torch.arange(0, hd, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               sections: Tuple[int, ...] = ()) -> torch.Tensor:
    """Rotary embedding; ``x`` (B, T, H, hd), ``positions`` (B, T), or
    (3, B, T) for M-RoPE (qwen2-vl), where ``sections`` splits the hd/2
    frequency channels between the temporal, height and width streams."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    if positions.ndim == 3 and sections:
        parts, start = [], 0
        for s, sec in enumerate(sections):
            parts.append(positions[s][..., None].to(torch.float32)
                         * freqs[start:start + sec])
            start += sec
        ang = torch.cat(parts, dim=-1)
    else:
        if positions.ndim == 3:
            positions = positions[0]
        ang = positions[..., None].to(torch.float32) * freqs
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _gqa_scores_to_out(q, k, v, mask, dt):
    """q (B, t, Hkv, G, hd), k/v (B, S, Hkv, hd), mask (B, t, S)."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bthgd,bshd->bhgts", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    s = torch.where(mask[:, None, None, :, :], s,
                    torch.full((), -1e30, dtype=s.dtype, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgts,bshd->bthgd", p.to(dt).to(torch.float32),
                     v.to(torch.float32))
    return o.to(dt)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, kv_pos: torch.Tensor,
              chunk: int = 0, window: int = 0,
              causal: bool = True) -> torch.Tensor:
    """GQA attention, causal unless ``causal=False`` (whisper's encoder
    and cross-attention); queries are processed in chunks of
    ``chunk`` when ``T > chunk`` to bound the (chunk x S) score tensor.
    ``window`` > 0 keeps only the keys less than ``window`` positions
    back (the hybrid family's local layers).

    q (B, T, H, hd); k/v (B, S, Hkv, hd); positions (B, T), (B, S)."""
    B, T, H, hd = q.shape
    hkv = k.shape[2]
    dt = q.dtype
    qg = q.reshape(B, T, hkv, H // hkv, hd)

    def mask_for(qp):
        m = (qp[:, :, None] >= kv_pos[:, None, :] if causal else
             torch.ones((B, qp.shape[1], k.shape[1]), dtype=torch.bool,
                        device=q.device))
        if window:
            m = m & (kv_pos[:, None, :] > qp[:, :, None] - window)
        return m

    if chunk and T > chunk:
        pad = (-T) % chunk
        if pad:
            qg = F.pad(qg, (0, 0, 0, 0, 0, 0, 0, pad))
            q_pos = F.pad(q_pos, (0, pad), value=-1)
        outs = [_gqa_scores_to_out(qg[:, c:c + chunk], k, v,
                                   mask_for(q_pos[:, c:c + chunk]), dt)
                for c in range(0, T + pad, chunk)]
        out = torch.cat(outs, dim=1)[:, :T]
    else:
        out = _gqa_scores_to_out(qg, k, v, mask_for(q_pos), dt)
    return out.reshape(B, T, H, hd)


def _check_columns(idx: int, t: int, S: int) -> None:
    if idx < 0 or idx + t > S:
        raise ValueError(
            f"cache write of {t} columns at column {idx} overruns the "
            f"cache's {S} columns (the reference's dynamic_update_slice "
            f"would clamp the start and write elsewhere)")


def _row_write(cache: torch.Tensor, new: torch.Tensor,
               idx: torch.Tensor) -> None:
    """``cache[b, idx[b]] = new[b]`` in place for the rows whose
    ``idx[b] < S``; the other rows are left bitwise as they were (the
    reference's ``mode="drop"`` scatter). An out-of-range index is a
    device assert on CUDA, so every row writes a column in range, the
    dropped rows their own old values back."""
    S = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    keep = idx < S
    col = torch.clamp(idx, max=S - 1).long()
    old = cache[rows, col]
    keep = keep.reshape((-1,) + (1,) * (old.ndim - 1))
    cache[rows, col] = torch.where(keep, new.to(cache.dtype), old)


def kv_cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                    k: torch.Tensor, v: torch.Tensor, idx):
    """Write k/v (B, t, Hkv, hd) into the caches (B, S, Hkv, hd) in
    place at column ``idx`` and return them.

    ``idx`` is an int or a 0-d tensor (every row writes columns idx ..
    idx + t - 1, the static decode path; a write past the last column
    raises), or a (B,) tensor of per-row columns with t == 1 (the slot
    pool, every slot at its own position), where rows with
    ``idx >= S`` write nothing."""
    if torch.is_tensor(idx) and idx.ndim == 1:
        _row_write(cache_k, k[:, 0], idx)
        _row_write(cache_v, v[:, 0], idx)
        return cache_k, cache_v
    i, t = int(idx), k.shape[1]
    _check_columns(i, t, cache_k.shape[1])
    cache_k[:, i:i + t] = k.to(cache_k.dtype)
    cache_v[:, i:i + t] = v.to(cache_v.dtype)
    return cache_k, cache_v


def pos_cache_update(cache_pos: torch.Tensor, q_pos: torch.Tensor, idx):
    """Write positions (B, t) into the (B, S) position track in place,
    with :func:`kv_cache_update`'s ``idx`` contract."""
    if torch.is_tensor(idx) and idx.ndim == 1:
        _row_write(cache_pos, q_pos[:, 0], idx)
        return cache_pos
    i, t = int(idx), q_pos.shape[1]
    _check_columns(i, t, cache_pos.shape[1])
    cache_pos[:, i:i + t] = q_pos.to(cache_pos.dtype)
    return cache_pos


# ---------------------------------------------------------------------------
# Paged KV (block-table indirection for the serving pool)
# ---------------------------------------------------------------------------
#
# The paged pool keeps KV in fixed-size position blocks, k/v
# (n_blocks, block_len, Hkv, hd) and pos (n_blocks, block_len), and each
# batch row a block table (B, nbps) of physical block ids, entry j
# covering positions [j*bl, (j+1)*bl). The id ``n_blocks`` marks an
# unmapped entry, as in the reference, whose reads fill and whose writes
# drop out of range; here every device index is clamped into range and
# the result masked. Column c of the gathered cache is position c, the
# slot pool's column order, so paged decode is bitwise the slot decode.

def paged_kv_read(cache_k: torch.Tensor, cache_v: torch.Tensor,
                  cache_pos: torch.Tensor, table: torch.Tensor):
    """Gather each row's virtual cache from the block pool: k/v
    (B, nbps*bl, Hkv, hd) and positions (B, nbps*bl). Unmapped entries
    read k/v 0 and positions ``UNWRITTEN_POS`` (masked), whatever block
    the clamped index lands on."""
    B, nbps = table.shape
    n_blocks, bl = cache_k.shape[:2]
    mapped = table < n_blocks
    ids = torch.clamp(table, max=n_blocks - 1).long()
    m = mapped.reshape(B, nbps, 1, 1, 1)
    kg = torch.where(m, cache_k[ids], torch.zeros((), dtype=cache_k.dtype,
                                                  device=cache_k.device))
    vg = torch.where(m, cache_v[ids], torch.zeros((), dtype=cache_v.dtype,
                                                  device=cache_v.device))
    pg = torch.where(mapped[..., None], cache_pos[ids],
                     torch.full((), UNWRITTEN_POS, dtype=cache_pos.dtype,
                                device=cache_pos.device))
    return (kg.reshape(B, nbps * bl, *cache_k.shape[2:]),
            vg.reshape(B, nbps * bl, *cache_v.shape[2:]),
            pg.reshape(B, nbps * bl))


def _paged_row_write(cache: torch.Tensor, new: torch.Tensor,
                     live: torch.Tensor, blk: torch.Tensor,
                     off: torch.Tensor, anchor: torch.Tensor) -> None:
    """``cache[blk[b], off[b]] = new[b]`` in place for the ``live`` rows
    only. A dropped row's clamped target may be a live row's, and which
    of two different values ``index_put_`` keeps at one index is not
    defined on CUDA; so every dropped row writes the ``anchor`` row's
    target with the anchor's value: the first live row's new value, or,
    with no live row, the old value there (every row then writes the
    same value to one place)."""
    a_live = live[anchor].reshape((1,) + (1,) * (new.ndim - 1))
    a_val = torch.where(a_live, new[anchor].to(cache.dtype),
                        cache[blk[anchor], off[anchor]])
    keep = live.reshape((-1,) + (1,) * (new.ndim - 1))
    cache[torch.where(live, blk, blk[anchor]),
          torch.where(live, off, off[anchor])] = torch.where(
              keep, new.to(cache.dtype), a_val)


def paged_kv_write(cache_k: torch.Tensor, cache_v: torch.Tensor,
                   cache_pos: torch.Tensor, table: torch.Tensor,
                   k: torch.Tensor, v: torch.Tensor, q_pos: torch.Tensor,
                   idx: torch.Tensor):
    """Per-row decode write (t == 1) into the block pool, in place:
    k/v (B, 1, Hkv, hd), q_pos (B, 1), idx (B,) positions. A row whose
    table entry for ``idx`` is unmapped, or whose ``idx`` lies past the
    table (the engine's idle rows, at ``max_len``), writes nothing, as
    the slot pool's rows at ``idx >= S``. Returns the three caches."""
    n_blocks, bl = cache_k.shape[:2]
    nbps = table.shape[1]
    rows = torch.arange(table.shape[0], device=table.device)
    col = idx.long() // bl
    blk = table[rows, torch.clamp(col, max=nbps - 1)]
    live = (col < nbps) & (blk < n_blocks)
    blk = torch.clamp(blk, max=n_blocks - 1).long()
    off = idx.long() % bl
    # a (1,) index, not a 0-d one, which indexing would read on the host
    anchor = torch.argmax(live.to(torch.int32)).reshape(1)
    _paged_row_write(cache_k, k[:, 0], live, blk, off, anchor)
    _paged_row_write(cache_v, v[:, 0], live, blk, off, anchor)
    _paged_row_write(cache_pos, q_pos[:, 0], live, blk, off, anchor)
    return cache_k, cache_v, cache_pos


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation, in fp32."""
    return F.gelu(x.to(torch.float32), approximate="tanh").to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``log(1 + exp(x))`` as ``logaddexp(x, 0)``
    (``F.softplus`` turns into the identity above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def causal_conv1d(x: torch.Tensor, w: torch.Tensor,
                  b: Optional[torch.Tensor] = None,
                  state: Optional[torch.Tensor] = None,
                  length: Optional[torch.Tensor] = None):
    """Depthwise causal convolution along time: ``x`` (B, T, C), ``w``
    (C, W); fp32 sums over the W taps in the reference's order, cast
    back to ``x.dtype``. Returns ``(out, new_state)``.

    ``state`` (B, W-1, C), in decode, is the left context; the new state
    is the last W-1 input columns. ``length`` (B,) marks each row's
    valid prefix of a right-padded prefill: the state is then the
    window ending at column ``length - 1``, so padding never reaches
    decode (the outputs need no mask: column c sees columns <= c). With
    neither (training) no state is carried: ``new_state`` is None."""
    W = w.shape[-1]
    T = x.shape[1]
    if state is not None:
        xin = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        xin = F.pad(x, (0, 0, W - 1, 0))
    if state is None and length is None:
        new_state = None
    elif W > 1 and length is not None:
        # xin column length + i holds position length - W + 1 + i: the
        # left context of the first decode step after the prefill
        cols = length.long()[:, None] + torch.arange(W - 1,
                                                     device=x.device)
        new_state = torch.gather(
            xin, 1, cols[:, :, None].expand(-1, -1, xin.shape[-1])).to(
                state.dtype if state is not None else x.dtype)
    elif W > 1:
        new_state = xin[:, -(W - 1):, :]
    else:
        new_state = state
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(W):
        out = out + xin[:, i:i + T, :].to(torch.float32) \
            * w[:, i].to(torch.float32)
    if b is not None:
        out = out + b.to(torch.float32)
    return out.to(x.dtype), new_state


#: steps in a chunk of :func:`linear_scan`
SCAN_CHUNK = 16


def linear_scan(decay: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """Every state ``h_t = decay_t h_{t-1} + inp_t`` from ``h_{-1} = 0``
    along dim 1 of (B, T, ...) fp32 tensors (the recurrences the
    reference runs as ``jax.lax.associative_scan``; the sums run in
    another order).

    In two levels over chunks of :data:`SCAN_CHUNK` steps: every chunk's
    local scan from a zero state, all chunks at once, with the running
    decay products; then the states entering the chunks, one chunk a
    step; then each local state plus its decay product times the state
    entering its chunk. About ``2 c + T / c`` steps of small kernels in
    place of T, and four (B, T, ...) tensors kept for the backward pass
    (decay, local states, decay products, states), where a log-depth
    scan keeps two a level."""
    B, T = decay.shape[:2]
    c = min(SCAN_CHUNK, T)
    K = -(-T // c)
    pad = K * c - T
    rest = decay.shape[2:]
    if pad:
        widths = (0, 0) * len(rest) + (0, pad)
        decay = F.pad(decay, widths, value=1.0)
        inp = F.pad(inp, widths)
    dec = decay.reshape((B, K, c) + rest)
    x = inp.reshape((B, K, c) + rest)
    # a copy: a view would keep all of ``inp`` alive for the backward
    h = x[:, :, 0].clone()
    p = dec[:, :, 0]
    hs, ps = [h], [p]
    for j in range(1, c):
        h = dec[:, :, j] * h + x[:, :, j]
        p = dec[:, :, j] * p
        hs.append(h)
        ps.append(p)
    enter = [torch.zeros_like(h[:, 0])]
    for k in range(1, K):
        enter.append(hs[-1][:, k - 1] + ps[-1][:, k - 1] * enter[-1])
    enter = torch.stack(enter, dim=1)
    out = torch.stack([hj + pj * enter for hj, pj in zip(hs, ps)], dim=2)
    return out.reshape((B, K * c) + rest)[:, :T]
