"""RG-LRU recurrent mixer, training path (counterpart of
``repro.models.rglru``, RecurrentGemma / Griffin):

    r_t = sigmoid(W_a x_t)                  (recurrence gate)
    i_t = sigmoid(W_x x_t)                  (input gate)
    a_t = exp(-c softplus(Lambda) r_t)      (per-channel decay)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

on the conv branch, times a GELU gate on the other; the decode step
carries ``(h, conv)``. The reference scans
with ``jax.lax.associative_scan``; this port with the chunked
``layers.linear_scan`` (the sums in another order). The
elementwise ``lam`` takes the first-order path; ``in_x``, ``in_gate``,
``w_a``, ``w_x`` and ``out`` are K-FAC-factored.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.models.layers import (Ctx, causal_conv1d, dense, gelu,
                                       linear_scan, softplus)

_C = 8.0    # Griffin's fixed decay sharpness


def rglru_mixer(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                ctx: Optional[Ctx], prefix: str,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                length: Optional[torch.Tensor] = None):
    """x (B, T, D) -> ``(y (B, T, D), new_state)``; ``state`` is
    ``(h (B, lw), conv (B, W-1, lw))``, and ``length`` is
    :func:`repro_torch.models.ssm.mamba_mixer`'s."""
    B, T, _ = x.shape
    xb = dense(x, p["in_x"], f"{prefix}/in_x", ctx)
    gb = gelu(dense(x, p["in_gate"], f"{prefix}/in_gate", ctx,
                    collect_gram=False))
    h0 = conv0 = None
    if state is not None:
        h0, conv0 = state
    xc, conv1 = causal_conv1d(xb, p["conv_w"], p["conv_b"], state=conv0,
                              length=length if T > 1 else None)
    r = torch.sigmoid(dense(xc, p["w_a"], f"{prefix}/w_a", ctx)
                      .to(torch.float32))
    i = torch.sigmoid(dense(xc, p["w_x"], f"{prefix}/w_x", ctx,
                            collect_gram=False).to(torch.float32))
    log_a = -_C * softplus(p["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)                                  # (B, T, lw)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * i * xc.to(torch.float32)
    if T == 1 and h0 is not None:
        new_h = a[:, 0] * h0 + gated[:, 0]
        hs = new_h[:, None]
    else:
        if h0 is not None:
            gated = torch.cat([gated[:, :1] + a[:, :1] * h0[:, None],
                               gated[:, 1:]], dim=1)
        hs = linear_scan(a, gated)
        new_h = hs[:, -1] if length is None else hs[
            torch.arange(B, device=x.device), length.long() - 1]
    y = hs.to(x.dtype) * gb
    out = dense(y, p["out"], f"{prefix}/out", ctx)
    if state is None and length is None:
        return out, None
    return out, (new_h, conv1)


def init_rglru_state(cfg, batch: int, *, device,
                     dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero ``(h (B, lw), conv (B, W-1, lw))``."""
    lw, w = cfg.lru_width_, cfg.ssm_conv
    return (torch.zeros((batch, lw), dtype=dtype, device=device),
            torch.zeros((batch, w - 1, lw), dtype=dtype, device=device))
