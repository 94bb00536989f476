"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

Each one runs the same algorithm as its CUDA kernel at the same working
precision (hi/lo bf16 partial products, fp32 accumulation, identical
iteration counts). The kernel wrappers use them for tensors on the CPU,
and ``chip_smoke.py`` holds every kernel to them on the card.
``exact_two_sided``, ``exact_smw_update`` and ``exact_gram_inv`` are
the fp32 yardsticks bounding the bit-sliced error.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantize import (
    hilo_matmul,
    hilo_matmul_exact_lhs,
    split_hi_lo_bf16,
)


def _damping_vector(damping, nb: int, device) -> torch.Tensor:
    """Scalar or (nb,) damping -> (nb,) fp32 on ``device``."""
    lam = torch.as_tensor(damping, dtype=torch.float32, device=device)
    if lam.numel() == 1:
        return lam.reshape(()).expand(nb)
    if tuple(lam.shape) != (nb,):
        raise ValueError(
            f"damping must be a scalar or shape ({nb},) to match the "
            f"{nb} blocks; got shape {tuple(lam.shape)}")
    return lam


def bitslice_mm_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32-accurate ``a @ b`` as ``a_hi@b_hi + a_hi@b_lo + a_lo@b_hi``
    of the fp32 upcasts (any input dtype)."""
    return hilo_matmul(a.to(torch.float32), b.to(torch.float32))


def neumann_inv_ref(a: torch.Tensor, damping, *, ns_iters: int = 14,
                    taylor_terms: int = 4,
                    refine_steps: int = 1) -> torch.Tensor:
    """Composed-precision inverse of ``a + damping I`` on (nb, n, n)
    blocks, computed on n as given (no padding).

    Split ``A+λI = A_H + A_L`` (bf16), ``X0 = A_H/(‖A_H‖₁‖A_H‖∞)``,
    ``ns_iters`` Newton–Schulz steps on ``A_H``, ``taylor_terms-1``
    Neumann terms over ``A_L``, ``refine_steps`` refinements against
    the full block — every product a hi/lo bf16 partial-product sum."""
    nb, n, _ = a.shape
    lam = _damping_vector(damping, nb, a.device)
    eye = torch.eye(n, dtype=torch.float32, device=a.device)
    ad = a.to(torch.float32) + lam[:, None, None] * eye
    a_hi16 = ad.to(torch.bfloat16)
    a_hi = a_hi16.to(torch.float32)
    a_lo16 = (ad - a_hi).to(torch.bfloat16)
    n1 = a_hi.abs().sum(dim=-2).amax(dim=-1)
    ninf = a_hi.abs().sum(dim=-1).amax(dim=-1)
    x = a_hi / (n1 * ninf)[:, None, None]
    for _ in range(ns_iters):
        x = hilo_matmul(x, 2.0 * eye - hilo_matmul_exact_lhs(a_hi16, x))
    m, t = x, x
    for _ in range(max(taylor_terms - 1, 0)):
        t = -hilo_matmul(x, hilo_matmul_exact_lhs(a_lo16, t))
        m = m + t
    for _ in range(refine_steps):
        m = m + hilo_matmul(m, eye - hilo_matmul(ad, m))
    return m


def _gram_damping(gram: torch.Tensor, rel_damp: float) -> torch.Tensor:
    """Per-block ``rel_damp * tr / n + 1e-8`` in the order the reference
    computes it (n as given: padding columns are zero)."""
    tr = torch.diagonal(gram, dim1=-2, dim2=-1).sum(-1)
    return rel_damp * tr / gram.shape[-1] + 1e-8


def fused_gram_inv_ref(a: torch.Tensor, *, rel_damp: float = 0.03,
                       ns_iters: int = 14, taylor_terms: int = 4,
                       refine_steps: int = 1) -> torch.Tensor:
    """``(a_i^T a_i / T + lam_i I)^{-1}`` per feature block of (T, nb, n)
    activations: the hi/lo Gram from the same three partial products as
    the kernel, ``lam_i = rel_damp * tr_i / n + 1e-8``, then
    :func:`neumann_inv_ref`'s iteration; any n."""
    t = a.shape[0]
    a_hi, a_lo = split_hi_lo_bf16(a.to(torch.float32))

    def mm_t(x, y):
        return torch.einsum("tbn,tbm->bnm", x.to(torch.float32),
                            y.to(torch.float32))

    gram = (mm_t(a_hi, a_hi) + mm_t(a_hi, a_lo) + mm_t(a_lo, a_hi)) / t
    return neumann_inv_ref(gram, _gram_damping(gram, rel_damp),
                           ns_iters=ns_iters, taylor_terms=taylor_terms,
                           refine_steps=refine_steps)


def exact_gram_inv(a: torch.Tensor, rel_damp: float = 0.03) -> torch.Tensor:
    """fp32 Gram and ``torch.linalg.inv``: the algorithmic yardstick of
    :func:`fused_gram_inv_ref`."""
    a32 = a.to(torch.float32)
    gram = torch.einsum("tbn,tbm->bnm", a32, a32) / a.shape[0]
    eye = torch.eye(gram.shape[-1], dtype=torch.float32, device=a.device)
    lam = _gram_damping(gram, rel_damp)
    return torch.linalg.inv(gram + lam[:, None, None] * eye)


def fused_precond_ref(a_inv: torch.Tensor, g: torch.Tensor,
                      g_inv: torch.Tensor, a_src: torch.Tensor | None = None,
                      g_src: torch.Tensor | None = None):
    """``out[t] = hilo(hilo(A_inv[t], g[t]), G_inv[t])`` (left first)
    and the per-tile trust-region dots ``sum(out[t] * g[t])``. With
    ``a_src``/``g_src`` the inverses are pools and tile t takes
    ``a_inv[a_src[t]]`` and ``g_inv[g_src[t]]``: the gather, then the
    same computation, so the indexed call is bitwise the gathered one."""
    if a_src is not None:
        a_inv = a_inv[a_src.long()]
    if g_src is not None:
        g_inv = g_inv[g_src.long()]
    g32 = g.to(torch.float32)
    tmp = hilo_matmul(a_inv.to(torch.float32), g32)
    out = hilo_matmul(tmp, g_inv.to(torch.float32))
    return out, (out * g32).sum(dim=(-2, -1))


def exact_two_sided(a_inv: torch.Tensor, g: torch.Tensor,
                    g_inv: torch.Tensor) -> torch.Tensor:
    """fp32 ``A_inv @ g @ G_inv`` (left first)."""
    return torch.matmul(torch.matmul(a_inv.to(torch.float32),
                                     g.to(torch.float32)),
                        g_inv.to(torch.float32))


def smw_scalars(decay: float, cscale: float):
    """``(0.5/decay, 1/c)`` as the fp32 values the update multiplies by
    and adds to the capacitance diagonal (the reference's
    ``jnp.float32(0.5 / decay)`` and ``eye / jnp.float32(cscale)``)."""
    inv_decay = np.float32(0.5 / decay)
    inv_c = np.float32(1.0) / np.float32(cscale)
    return float(inv_decay), float(inv_c)


def smw_update_ref(inv: torch.Tensor, v: torch.Tensor, *, decay: float,
                   cscale: float) -> torch.Tensor:
    """Batched Woodbury update ``M - (VM)^T (S + I/c)^-1 (VM)`` with
    ``M = sym(inv) * 0.5/decay`` on (N, bs, bs) inverses and (N, k, bs)
    columns, computed on (k, bs) as given (the TPU kernel pads both to
    128, which is exact). ``Y = V M``, ``S = Y V^T`` and ``Y^T Z`` are
    hi/lo partial-product sums; the k x k solve is
    ``torch.linalg.solve_ex`` (LU with partial pivoting, as the kernel
    factors in its CTA): like ``jnp.linalg.solve`` it checks nothing on
    the host (no device sync), and a singular capacitance shows up as a
    non-finite drift, which the SMW gate answers with a full
    re-inversion."""
    inv_decay, inv_c = smw_scalars(decay, cscale)
    inv = inv.to(torch.float32)
    v = v.to(torch.float32)
    k = v.shape[-2]
    m = (inv + inv.transpose(-1, -2)) * inv_decay
    y = hilo_matmul(v, m)
    eye = torch.eye(k, dtype=torch.float32, device=v.device)
    s = hilo_matmul(y, v.transpose(-1, -2)) + eye * inv_c
    z = torch.linalg.solve_ex(s, y)[0]
    return m - hilo_matmul(y.transpose(-1, -2), z)


def exact_smw_update(inv: torch.Tensor, v: torch.Tensor, *, decay: float,
                     cscale: float) -> torch.Tensor:
    """fp32 Woodbury update (fp32 matmuls and ``torch.linalg.solve``),
    the same math as ``solve.smw.smw_update_flat``'s einsum route."""
    inv_decay, inv_c = smw_scalars(decay, cscale)
    inv = inv.to(torch.float32)
    v = v.to(torch.float32)
    k = v.shape[-2]
    m = (inv + inv.transpose(-1, -2)) * inv_decay
    y = torch.matmul(v, m)
    eye = torch.eye(k, dtype=torch.float32, device=v.device)
    s = torch.matmul(y, v.transpose(-1, -2)) + eye * inv_c
    z = torch.linalg.solve(s, y)
    return m - torch.matmul(y.transpose(-1, -2), z)
