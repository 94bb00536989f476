"""Fixed-point quantization, bit-slicing and hi/lo bf16 precision
primitives, and :class:`CircuitConfig`, the parameters of the modelled
ReRAM datapath (counterpart of ``repro.core.quantize``).

The integer half models the digital view of the ReRAM datapath: a value
``v`` with ``bits`` fractional bits on scale ``s`` is represented as
``v ≈ s * round(v / s * 2**bits) * 2**-bits``, every quantizer symmetric
and saturating; DAC inputs are ``R_DAC``-bit slices of those codes
(paper Eqn. 6, "Loop b").

In the hi/lo half every product feeds the tensor cores bf16 operands
only and accumulates in fp32: ``x = hi + lo`` with both halves bf16
recovers ~16 mantissa bits, the MXU/tensor-core image of programming
``A_H`` into INV crossbars and ``A_L`` into VMM crossbars (paper Sec.
III-A.3).

torch's ``bf16 @ bf16`` returns bf16, so the plain versions here upcast
each slice to fp32 before the matmul: a product of two bf16 values is
exact in fp32, and with TF32 off the fp32 matmul accumulates in fp32 —
the same arithmetic as JAX's ``preferred_element_type=float32``. The
integer slices are small integers held in fp32, so their products are
exact in fp32 too, and so are the sums while they stay under 2**24.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Tuple

import torch


def amax_scale(x: torch.Tensor, dim=None) -> torch.Tensor:
    """Symmetric max-abs scale (never zero)."""
    s = (torch.amax(torch.abs(x)) if dim is None
         else torch.amax(torch.abs(x), dim=dim, keepdim=True))
    return torch.where(s == 0, torch.ones_like(s), s)


def quantize_int(x: torch.Tensor, bits: int, scale) -> torch.Tensor:
    """Quantize to signed integer grid codes in [-(2**bits - 1),
    2**bits - 1] (held in ``x``'s float dtype).

    The clip is symmetric: the two's-complement endpoint ``-2**bits``
    would need ``bits + 1`` magnitude bits, which the sign/magnitude
    slice decomposition (:func:`bit_slices_fixed`, ``ceil(bits/slice)``
    slices) cannot carry — it would silently drop the top bit and
    reconstruct 0 for exactly the saturated-negative input."""
    step = scale * (2.0 ** (-bits))
    q = torch.round(x / step)
    return torch.clamp(q, -(2.0 ** bits - 1), 2.0 ** bits - 1)


def quantize_fixed(x: torch.Tensor, bits: int, scale) -> torch.Tensor:
    """Quantize ``x`` onto a ``bits``-fractional-bit grid of ``scale``;
    returns the *dequantized* value, clipped to (-scale, scale)."""
    step = scale * (2.0 ** (-bits))
    return quantize_int(x, bits, scale) * step


def split_hi_lo_fixed(x: torch.Tensor, total_bits: int, hi_bits: int,
                      scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """Split a ``total_bits`` fixed-point value into hi/lo parts:
    ``x_q = x_hi + x_lo * 2**-hi_bits``, ``x_hi`` the top ``hi_bits``
    fractional bits and ``x_lo`` the rest pre-shifted to ``scale``'s
    magnitude (paper: ``A_L = (A - A_H) * 2**(k*R_c)``)."""
    xq = quantize_fixed(x, total_bits, scale)
    step_hi = scale * (2.0 ** (-hi_bits))
    hi = torch.floor(xq / step_hi) * step_hi
    lo = (xq - hi) * (2.0 ** hi_bits)
    return hi, lo


def bit_slices_fixed(x: torch.Tensor, total_bits: int, slice_bits: int,
                     scale) -> list:
    """Decompose a quantized value into ``ceil(total/slice)`` slices,
    LSB-first, each a float holding an integer in ``[0, 2**slice_bits)``
    times the value's sign (sign/magnitude: the analog driver applies
    the sign by swapping the differential pair), such that
    ``sum_i slices[i] * 2**(i*slice_bits - total_bits) * scale``
    reconstructs the value."""
    n = -(-total_bits // slice_bits)
    q = quantize_int(x, total_bits, scale)
    sign = torch.sign(q)
    mag = torch.abs(q)
    base = 2.0 ** slice_bits
    out = []
    for _ in range(n):
        # jnp.mod's floored remainder; mag >= 0, so fmod is the same
        out.append(sign * torch.fmod(mag, base))
        mag = torch.floor(mag / base)
    return out


def reconstruct_slices(slices: list, total_bits: int, slice_bits: int,
                       scale) -> torch.Tensor:
    """Inverse of :func:`bit_slices_fixed` (the digital S+A unit)."""
    acc = torch.zeros_like(slices[0])
    for i, s in enumerate(slices):
        acc = acc + s * (2.0 ** (i * slice_bits))
    return acc * scale * (2.0 ** (-total_bits))


#: The ``--precision`` knob values.
PRECISIONS = ("fp32", "hilo", "int8")

# "int<total>b<slice>": an integer-sliced product with <total>-bit codes
# composed from <slice>-bit slices (e.g. "int16b4")
_INT_SPEC = re.compile(r"^int(\d+)b(\d+)$")


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


def precision_kind(precision):
    """Parse a precision spec into ``'fp32' | 'hilo' | (total, slice)``.

    ``"int8"`` means 8-bit *hardware operands*: 24-bit fixed-point codes
    composed from three 8-bit slices per side, the ISAAC-style exact
    bit-sliced VMM. ``"int<T>b<S>"`` spells any other rung."""
    if precision in (None, "fp32"):
        return "fp32"
    if precision == "hilo":
        return "hilo"
    if precision == "int8":
        return (24, 8)
    m = _INT_SPEC.match(str(precision))
    if m:
        total, sl = int(m.group(1)), int(m.group(2))
        if not (1 <= sl <= total):
            raise ValueError(
                f"precision {precision!r}: need 1 <= slice bits "
                f"<= total bits, got total={total} slice={sl}")
        return (total, sl)
    raise ValueError(
        f"unknown precision {precision!r}; expected one of "
        f"{PRECISIONS} or 'int<total>b<slice>' (e.g. 'int16b4')")


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


def int_slice_einsum(spec: str, a: torch.Tensor, b: torch.Tensor, *,
                     total_bits: int = 24,
                     slice_bits: int = 8) -> torch.Tensor:
    """Exact bit-sliced ``einsum(spec, a, b)`` of the quantized operands.

    Each operand is quantized to ``total_bits``-bit codes on its
    per-tensor amax scale and cut into ``ceil(total/slice)``
    sign/magnitude slices; every pairwise slice product runs as its own
    fp32 einsum (the crossbar pass: small integers, exact while a sum
    stays under 2**24) and is shift-added with weight
    ``2**((i+j)*slice)`` (the digital S+A unit). The only error is the
    operand quantization (~2**-total relative)."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    sa = amax_scale(a)
    sb = amax_scale(b)
    a_sl = bit_slices_fixed(a, total_bits, slice_bits, sa)
    b_sl = bit_slices_fixed(b, total_bits, slice_bits, sb)
    acc = None
    for i, asl in enumerate(a_sl):
        for j, bsl in enumerate(b_sl):
            part = torch.einsum(spec, asl, bsl)
            part = part * (2.0 ** ((i + j) * slice_bits))
            acc = part if acc is None else acc + part
    return acc * (sa * sb) * (2.0 ** (-2 * total_bits))


def lowp_einsum(spec: str, a: torch.Tensor, b: torch.Tensor, *,
                precision: str = "fp32") -> torch.Tensor:
    """The WU graph's matmul routing point: ``"fp32"`` is the plain fp32
    einsum, ``"hilo"`` the bf16-limb product, ``"int8"`` and
    ``"int<T>b<S>"`` the sliced integer product."""
    kind = precision_kind(precision)
    if kind == "fp32":
        return torch.einsum(spec, a.to(torch.float32), b.to(torch.float32))
    if kind == "hilo":
        return hilo_einsum(spec, a, b)
    total, sl = kind
    return int_slice_einsum(spec, a, b, total_bits=total, slice_bits=sl)


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
