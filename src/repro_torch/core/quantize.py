"""hi/lo bf16 precision primitives (the production half of
``repro.core.quantize``) and :class:`CircuitConfig`, the parameters of
the modelled ReRAM datapath.

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

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class CircuitConfig:
    """Parameters of the modeled RePAST datapath (paper Sec. III/VI-A)."""

    q_a: int = 16       # bits of the SOI matrix A
    q_b: int = 16       # bits of the rhs vector b
    q_x: int = 16       # bits of the solution x
    r_dac: int = 4      # DAC resolution (paper: 4-bit)
    r_adc: int = 8      # ADC resolution (paper: 8-bit)
    r_c: int = 4        # bits per ReRAM cell (paper: 4-bit)
    k: int = 2          # chained INV crossbars -> A_H has k*r_c bits
    n_taylor: int = 18  # Loop A iterations (paper Fig. 4(b): 18)

    @property
    def hi_bits(self) -> int:
        return self.k * self.r_c

    @property
    def loops_x(self) -> int:
        return -(-self.q_x // self.r_adc)

    @property
    def loops_b(self) -> int:
        return -(-self.q_b // self.r_dac)

    def cycles_inv(self) -> int:
        """Paper Eqn. 10: cycles of one high-precision INV."""
        return self.n_taylor * (
            2 * self.loops_b * self.loops_x + -(-self.q_x // self.r_dac))

    def cycles_inv_fused(self) -> int:
        """Paper Eqn. 14: cycles of one fused MM+INV high-precision INV."""
        return self.n_taylor * (
            2 * self.loops_b * self.loops_x + 2 * -(-self.q_x // self.r_dac))
