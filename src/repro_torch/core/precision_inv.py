"""Composed-precision matrix inverse, tensor-core dialect (the production
half of ``repro.core.precision_inv``; the numpy circuit model
``faithful_inv_apply`` is not ported yet).

``composed_inverse`` is the reference formulation of the paper's scheme
(RePAST Sec. III): Newton–Schulz on the bf16 hi slice ``A_H`` plays the
low-precision INV crossbar, a Neumann series over ``A_L`` is Loop A, and
refinement against the full ``A`` recovers the bits the low-precision
primitive lost. The training path runs the same algorithm through the
``neumann_inv`` kernel (``kernels.ops``), whose ``X0`` normalisation
``A_H/(n1·ninf)`` differs from the ``A_H/sqrt(n1·ninf)**2`` here at
rounding level only.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import (
    hilo_matmul,
    hilo_matmul_exact_lhs,
    split_hi_lo_bf16,
)


def _norm_bound(a: torch.Tensor) -> torch.Tensor:
    """Per-block bound on ``||A||_2``: ``sqrt(||A||_1 ||A||_inf)``."""
    n1 = a.abs().sum(dim=-2).amax(dim=-1)
    ninf = a.abs().sum(dim=-1).amax(dim=-1)
    return torch.sqrt(n1 * ninf)


def newton_schulz_inverse(a: torch.Tensor, n_iters: int = 18, *,
                          hilo: bool = True,
                          exact_bf16: bool = False) -> torch.Tensor:
    """``X <- X (2I - A X)`` from ``X0 = A / ||A||^2`` on (..., n, n)."""
    a = a.to(torch.float32)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=a.device)
    x = a / (_norm_bound(a) ** 2)[..., None, None]
    mm = hilo_matmul if hilo else torch.matmul
    if hilo and exact_bf16:
        a16 = a.to(torch.bfloat16)
        mm_a = hilo_matmul_exact_lhs
    else:
        a16, mm_a = a, mm
    for _ in range(n_iters):
        x = mm(x, 2.0 * eye - mm_a(a16, x))
    return x


def composed_inverse(a: torch.Tensor, damping=0.0, *, ns_iters: int = 18,
                     taylor_terms: int = 4,
                     refine_steps: int = 1) -> torch.Tensor:
    """``(A + damping I)^{-1}`` on (..., n, n) blocks; ``damping`` is a
    scalar or broadcasts against the batch dims."""
    a = a.to(torch.float32)
    n = a.shape[-1]
    eye = torch.eye(n, dtype=torch.float32, device=a.device)
    lam = torch.as_tensor(damping, dtype=torch.float32, device=a.device)
    ad = a + lam[..., None, None] * eye
    a_hi16, a_lo16 = split_hi_lo_bf16(ad)
    y = newton_schulz_inverse(a_hi16.to(torch.float32), ns_iters,
                              hilo=True, exact_bf16=True)
    m, t = y, y
    for _ in range(max(taylor_terms - 1, 0)):
        t = -hilo_matmul(y, hilo_matmul_exact_lhs(a_lo16, t))
        m = m + t
    for _ in range(refine_steps):
        m = m + hilo_matmul(m, eye - hilo_matmul(ad, m))
    return m
