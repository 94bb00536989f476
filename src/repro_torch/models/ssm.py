"""Mamba-1 selective SSM mixer, training path (counterpart of
``repro.models.ssm``, falcon-mamba-7b).

The reference runs the recurrence ``h_t = exp(dt_t A) h_{t-1} +
dt_t x_t B_t`` as ``jax.lax.associative_scan``; this port as the
chunked two-level ``layers.linear_scan`` (the sums in another order),
which keeps four ``(B, T, d_inner, n)`` tensors for the backward pass
(1.07 GB each at falcon-mamba-7b's widths and 8 x 256 tokens), where a
log-depth scan would keep two a level. The diagonal parameters (``A_log``,
``D``, ``conv_*``, ``dt_bias``) take the first-order path; the four
projections are K-FAC-factored.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (Ctx, causal_conv1d, dense,
                                       linear_scan, softplus)


def mamba_mixer(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                ctx: Optional[Ctx], prefix: str) -> torch.Tensor:
    """x (B, T, D) -> (B, T, D)."""
    n, dr = cfg.ssm_state, cfg.dt_rank_
    xz = dense(x, p["in_proj"], f"{prefix}/in_proj", ctx)
    xin, z = torch.chunk(xz, 2, dim=-1)
    xc = causal_conv1d(xin, p["conv_w"], p["conv_b"])
    xc = F.silu(xc.to(torch.float32)).to(x.dtype)

    x_dbl = dense(xc, p["x_proj"], f"{prefix}/x_proj", ctx)
    dt_r, bmat, cmat = torch.split(x_dbl, [dr, n, n], dim=-1)
    dt = dense(dt_r, p["dt_proj"], f"{prefix}/dt_proj", ctx)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["A_log"].to(torch.float32))          # (di, n)
    decay = torch.exp(dt[..., None] * a)                    # (B, T, di, n)
    inp = (dt * xc.to(torch.float32))[..., None] \
        * bmat.to(torch.float32)[:, :, None, :]
    hs = linear_scan(decay, inp)
    y = torch.einsum("btdn,btn->btd", hs, cmat.to(torch.float32))
    y = y + p["D"].to(torch.float32) * xc.to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    return dense(y, p["out_proj"], f"{prefix}/out_proj", ctx)
