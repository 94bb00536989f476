"""hi/lo bf16 precision primitives (the production half of
``repro.core.quantize``).

Every product below feeds the tensor cores bf16 operands only and
accumulates in fp32: ``x = hi + lo`` with both halves bf16 recovers
~16 mantissa bits, the MXU/tensor-core image of programming ``A_H``
into INV crossbars and ``A_L`` into VMM crossbars (paper Sec. III-A.3).

torch's ``bf16 @ bf16`` returns bf16, so the plain versions here upcast
each slice to fp32 before the matmul: a product of two bf16 values is
exact in fp32, and with TF32 off the fp32 matmul accumulates in fp32 —
the same arithmetic as JAX's ``preferred_element_type=float32``.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: ``--precision`` values whose WU products the port runs.
PRECISIONS = ("fp32", "hilo")


def split_hi_lo_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (hi, lo) bf16 with ``hi + lo ≈ x`` (round-to-nearest-even,
    as ``astype(jnp.bfloat16)``)."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    lo = (x - hi.to(torch.float32)).to(torch.bfloat16)
    return hi, lo


def _mm(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """bf16 x bf16 with fp32 accumulation (exact products)."""
    return torch.matmul(x.to(torch.float32), y.to(torch.float32))


def hilo_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32-accurate ``a @ b`` from three bf16 partial products
    (``a_lo @ b_lo`` is below the fp32 floor and dropped)."""
    a_hi, a_lo = split_hi_lo_bf16(a)
    b_hi, b_lo = split_hi_lo_bf16(b)
    return _mm(a_hi, b_hi) + _mm(a_hi, b_lo) + _mm(a_lo, b_hi)


def hilo_matmul_exact_lhs(a16: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a16 @ b`` where ``a16`` is exactly bf16 (a hi or lo slice): its
    own lo slice is zero, so two partial products suffice."""
    b_hi, b_lo = split_hi_lo_bf16(b)
    a16 = a16.to(torch.bfloat16)
    return _mm(a16, b_hi) + _mm(a16, b_lo)


def precision_kind(precision) -> str:
    """Parse a precision spec: ``'fp32' | 'hilo'``. The integer-sliced
    modes of the reference are not ported yet and raise."""
    if precision in (None, "fp32"):
        return "fp32"
    if precision == "hilo":
        return "hilo"
    raise ValueError(
        f"precision {precision!r} is not supported by repro_torch; "
        f"expected one of {PRECISIONS}")


def split_limbs_bf16(x: torch.Tensor, limbs: int = 3) -> list:
    """``sum(limbs) ≈ x``, limb ``i`` bf16 carrying mantissa bits
    ``[8i, 8i+8)``."""
    r = x.to(torch.float32)
    out = []
    for _ in range(limbs):
        l = r.to(torch.bfloat16)
        out.append(l)
        r = r - l.to(torch.float32)
    return out


def hilo_einsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(spec, a, b)`` from three bf16 limbs per operand and the
    six partials of combined limb order <= 2, accumulated in fp32."""
    a_l = split_limbs_bf16(a, 3)
    b_l = split_limbs_bf16(b, 3)
    acc = None
    for i in range(3):
        for j in range(3):
            if i + j > 2:
                continue
            p = torch.einsum(spec, a_l[i].to(torch.float32),
                             b_l[j].to(torch.float32))
            acc = p if acc is None else acc + p
    return acc


def lowp_einsum(spec: str, a: torch.Tensor, b: torch.Tensor, *,
                precision: str = "fp32") -> torch.Tensor:
    """The WU graph's matmul routing point: ``"fp32"`` is the plain fp32
    einsum, ``"hilo"`` the bf16-limb product."""
    if precision_kind(precision) == "fp32":
        return torch.einsum(spec, a.to(torch.float32), b.to(torch.float32))
    return hilo_einsum(spec, a, b)
