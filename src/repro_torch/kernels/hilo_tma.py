"""Arguments of the batched hi/lo product on TMA and wgmma,
``csrc/hilo_tma.cuh``: the products of ``neumann_inv``'s large route
(sides of 129..1024).

Its operands are n x n blocks kept in device memory as bf16 hi and lo
slices, rows :func:`slice_stride` apart, which the kernel that writes an
operand (the prep kernel or a product's epilogue) splits once as it stores
it; where a later kernel reads a value as fp32 (an epilogue's E, the
copy-out), its writer stores the fp32 value too, rows
:func:`hilo_bmm.row_stride` apart. Nothing here launches or allocates: the
wrapper builds one :class:`Params` a product.
"""

from __future__ import annotations

import ctypes

from repro_torch.kernels import hilo_bmm

#: the forms a value is stored in: fp32, and its bf16 hi and lo slices
F32, HI, LO = "f32", "hi", "lo"
FORMS = (F32, HI, LO)
#: the left operand's slices (the right operand is always read as both):
#: FULL both (three partials), HI or LO one exact slice (two partials)
FULL, HI_SLICE, LO_SLICE = 0, 1, 2
LEFT_FORMS = {FULL: (HI, LO), HI_SLICE: (HI,), LO_SLICE: (LO,)}
#: the epilogues (tbmm::Epi)
STORE, TWO_I_MINUS, I_MINUS, ADD, NEG_ACC = range(5)


class Out(ctypes.Structure):
    """``tbmm::Out``: where a kernel writes a value's forms (null for a
    form not written)."""

    _fields_ = [("f32", ctypes.c_void_p), ("hi", ctypes.c_void_p),
                ("lo", ctypes.c_void_p)]


class Params(ctypes.Structure):
    """``tbmm::Params``: one batched product ``C[b] = epi(L[b] R[b])`` of
    n x n blocks (``l_lo`` null: the left operand is the one exact slice
    at ``l_hi``)."""

    _fields_ = [("l_hi", ctypes.c_void_p), ("l_lo", ctypes.c_void_p),
                ("r_hi", ctypes.c_void_p), ("r_lo", ctypes.c_void_p),
                ("e", ctypes.c_void_p), ("c", Out), ("f", Out),
                ("n", ctypes.c_int), ("ld32", ctypes.c_int),
                ("ld16", ctypes.c_int), ("batch", ctypes.c_int),
                ("epi", ctypes.c_int)]


def slice_stride(n: int) -> int:
    """A slice row's stride: ``n`` rounded up to 8 bf16 (16 bytes, as a
    TMA tensor map's strides need)."""
    return -(-n // 8) * 8


def stride(n: int, form: str) -> int:
    """Row stride of a value of side ``n`` stored in ``form``."""
    return hilo_bmm.row_stride(n) if form == F32 else slice_stride(n)


def itemsize(form: str) -> int:
    return 4 if form == F32 else 2
