"""Mamba-1 selective SSM mixer (counterpart of ``repro.models.ssm``,
falcon-mamba-7b): the training and prefill scan and the O(1) decode
step with its carried ``(h, conv)`` state.

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

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (Ctx, causal_conv1d, dense,
                                       linear_scan, softplus)


def mamba_mixer(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor,
                ctx: Optional[Ctx], prefix: str,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                length: Optional[torch.Tensor] = None):
    """x (B, T, D) -> ``(y (B, T, D), new_state)``.

    ``state`` is ``(h (B, d_inner, n), conv (B, W-1, d_inner))``, the
    carried decode state (a step of T == 1 is the recurrence itself).
    ``length`` (B,) marks the valid prefix of a right-padded prefill:
    the state returned is the one at position ``length - 1``, not at the
    padded tail. Training passes neither and gets ``new_state`` None."""
    B, T, _ = x.shape
    n, dr = cfg.ssm_state, cfg.dt_rank_
    xz = dense(x, p["in_proj"], f"{prefix}/in_proj", ctx)
    xin, z = torch.chunk(xz, 2, dim=-1)
    h0 = conv0 = None
    if state is not None:
        h0, conv0 = state
    xc, conv1 = causal_conv1d(xin, p["conv_w"], p["conv_b"], state=conv0,
                              length=length if T > 1 else None)
    xc = F.silu(xc.to(torch.float32)).to(x.dtype)

    x_dbl = dense(xc, p["x_proj"], f"{prefix}/x_proj", ctx)
    dt_r, bmat, cmat = torch.split(x_dbl, [dr, n, n], dim=-1)
    dt = dense(dt_r, p["dt_proj"], f"{prefix}/dt_proj", ctx)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    a = -torch.exp(p["A_log"].to(torch.float32))          # (di, n)
    decay = torch.exp(dt[..., None] * a)                    # (B, T, di, n)
    inp = (dt * xc.to(torch.float32))[..., None] \
        * bmat.to(torch.float32)[:, :, None, :]
    if T == 1 and h0 is not None:
        new_h = decay[:, 0] * h0 + inp[:, 0]
        hs = new_h[:, None]
    else:
        if h0 is not None:
            inp = torch.cat([inp[:, :1] + decay[:, :1] * h0[:, None],
                             inp[:, 1:]], dim=1)
        hs = linear_scan(decay, inp)
        new_h = hs[:, -1] if length is None else hs[
            torch.arange(B, device=x.device), length.long() - 1]
    y = torch.einsum("btdn,btn->btd", hs, cmat.to(torch.float32))
    y = y + p["D"].to(torch.float32) * xc.to(torch.float32)
    y = (y * F.silu(z.to(torch.float32))).to(x.dtype)
    out = dense(y, p["out_proj"], f"{prefix}/out_proj", ctx)
    if state is None and length is None:
        return out, None
    return out, (new_h, conv1)


def init_mamba_state(cfg, batch: int, *, device,
                     dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero ``(h (B, d_inner, n), conv (B, W-1, d_inner))``."""
    di, n, w = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    return (torch.zeros((batch, di, n), dtype=dtype, device=device),
            torch.zeros((batch, w - 1, di), dtype=dtype, device=device))
