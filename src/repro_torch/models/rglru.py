"""RG-LRU recurrent mixer, training path (counterpart of
``repro.models.rglru``, RecurrentGemma / Griffin):

    r_t = sigmoid(W_a x_t)                  (recurrence gate)
    i_t = sigmoid(W_x x_t)                  (input gate)
    a_t = exp(-c softplus(Lambda) r_t)      (per-channel decay)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

on the conv branch, times a GELU gate on the other. The reference scans
with ``jax.lax.associative_scan``; this port with the chunked
``layers.linear_scan`` (the sums in another order). The
elementwise ``lam`` takes the first-order path; ``in_x``, ``in_gate``,
``w_a``, ``w_x`` and ``out`` are K-FAC-factored.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.layers import (Ctx, causal_conv1d, dense, gelu,
                                       linear_scan, softplus)

_C = 8.0    # Griffin's fixed decay sharpness


def rglru_mixer(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                ctx: Optional[Ctx], prefix: str) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D)."""
    xb = dense(x, p["in_x"], f"{prefix}/in_x", ctx)
    gb = gelu(dense(x, p["in_gate"], f"{prefix}/in_gate", ctx,
                    collect_gram=False))
    xc = causal_conv1d(xb, p["conv_w"], p["conv_b"])
    r = torch.sigmoid(dense(xc, p["w_a"], f"{prefix}/w_a", ctx)
                      .to(torch.float32))
    i = torch.sigmoid(dense(xc, p["w_x"], f"{prefix}/w_x", ctx,
                            collect_gram=False).to(torch.float32))
    log_a = -_C * softplus(p["lam"].to(torch.float32)) * r
    a = torch.exp(log_a)                                  # (B, T, lw)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) \
        * i * xc.to(torch.float32)
    hs = linear_scan(a, gated)
    y = hs.to(x.dtype) * gb
    return dense(y, p["out"], f"{prefix}/out", ctx)
