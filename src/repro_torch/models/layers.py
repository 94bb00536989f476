"""Model primitives for training (counterpart of ``repro.models.layers``):
norms, RoPE, chunked GQA attention, SwiGLU and the tapped dense layer
that feeds K-FAC its statistics.

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
from typing import Dict, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import soi


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
          collect_gram: bool = True) -> torch.Tensor:
    """Tapped linear ``y = x @ w (+ b) (+ tap[name])`` in ``x.dtype``.

    With ``ctx.collect`` the input's blocked Gram, or with
    ``collect="cols"`` its blocked tokens, is recorded (skipped with
    ``collect_gram=False`` for linears sharing a sibling's A)."""
    dt = x.dtype
    y = torch.matmul(x.to(torch.float32), w.to(dt).to(torch.float32))
    if bias is not None:
        y = y + bias.to(torch.float32)
    if ctx is not None:
        if ctx.collect and collect_gram:
            a = x.detach().to(torch.float32).reshape(-1, x.shape[-1])
            ctx.stats[name] = (soi.blocked_tokens(a, ctx.soi_block)
                               if ctx.collect == "cols"
                               else soi.blocked_gram(a, ctx.soi_block))
        if ctx.taps is not None and name in ctx.taps:
            y = y + ctx.taps[name].reshape(y.shape)
    return y.to(dt)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + w.to(torch.float32))
    return out.to(x.dtype)


def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    ar = torch.arange(0, hd, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (ar / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding; ``x`` (B, T, H, hd), ``positions`` (B, T)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
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
              chunk: int = 0) -> torch.Tensor:
    """Causal GQA attention; queries are processed in chunks of
    ``chunk`` when ``T > chunk`` to bound the (chunk x S) score tensor.

    q (B, T, H, hd); k/v (B, S, Hkv, hd); positions (B, T), (B, S)."""
    B, T, H, hd = q.shape
    hkv = k.shape[2]
    dt = q.dtype
    qg = q.reshape(B, T, hkv, H // hkv, hd)

    def mask_for(qp):
        return qp[:, :, None] >= kv_pos[:, None, :]

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


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.to(torch.float32)).to(gate.dtype) * up
