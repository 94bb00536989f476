"""Arguments of the batched hi/lo product on TMA and wgmma,
``csrc/hilo_tma.cuh``: the products of ``neumann_inv``'s and
``fused_precond``'s large routes (sides of 129..1024).

Its operands are m x k and k x n blocks kept in device memory as bf16 hi
and lo slices, rows :func:`slice_stride` apart, which the kernel that
writes an operand (a split kernel, the prep kernel or a product's
epilogue) splits once as it stores it; an operand may be a pool of
blocks read through an index array (block ``idx[b]`` for batch entry
``b``). Where a later kernel reads a value as fp32 (an epilogue's E, the
copy-out), its writer stores the fp32 value too, rows
:func:`hilo_bmm.row_stride` apart (or the caller's unpadded rows). Nothing
here launches or allocates: the wrappers build one :class:`Params` a
product.
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
STORE, TWO_I_MINUS, I_MINUS, ADD, NEG_ACC, DOT = range(6)
#: the output tile's rows (BN, its columns, is :func:`tile_n`)
TILE_M = 128


class Out(ctypes.Structure):
    """``tbmm::Out``: where a kernel writes a value's forms (null for a
    form not written)."""

    _fields_ = [("f32", ctypes.c_void_p), ("hi", ctypes.c_void_p),
                ("lo", ctypes.c_void_p)]


class Params(ctypes.Structure):
    """``tbmm::Params``: one batched product ``C[b] = epi(L[b] R[b])``
    (``l_lo`` null: the left operand is the one exact slice at ``l_hi``).
    The first fields give the square form (n x n blocks, one slice stride
    ``ld16``, block ``b`` of each operand); the rectangular fields after
    ``epi``, each left 0 for the square form's value, give an m x k left
    and a k x n right operand, each with its own slice stride, array of
    blocks and optional int32 index array, and DOT's partials."""

    _fields_ = [("l_hi", ctypes.c_void_p), ("l_lo", ctypes.c_void_p),
                ("r_hi", ctypes.c_void_p), ("r_lo", ctypes.c_void_p),
                ("e", ctypes.c_void_p), ("c", Out), ("f", Out),
                ("n", ctypes.c_int), ("ld32", ctypes.c_int),
                ("ld16", ctypes.c_int), ("batch", ctypes.c_int),
                ("epi", ctypes.c_int),
                ("m", ctypes.c_int), ("k", ctypes.c_int),
                ("l_ld16", ctypes.c_int), ("r_ld16", ctypes.c_int),
                ("l_blocks", ctypes.c_int), ("r_blocks", ctypes.c_int),
                ("l_idx", ctypes.c_void_p), ("r_idx", ctypes.c_void_p),
                ("part", ctypes.c_void_p)]


def slice_stride(n: int) -> int:
    """A slice row's stride: ``n`` rounded up to 8 bf16 (16 bytes, as a
    TMA tensor map's strides need)."""
    return -(-n // 8) * 8


def stride(n: int, form: str) -> int:
    """Row stride of a value of side ``n`` stored in ``form``."""
    return hilo_bmm.row_stride(n) if form == F32 else slice_stride(n)


def itemsize(form: str) -> int:
    return 4 if form == F32 else 2


def tile_n(n: int) -> int:
    """The output tile's columns for n columns: 192 or 256, whichever
    pads n less (``tbmm::tile_n``)."""
    return 192 if -(-n // 192) * 192 < -(-n // 256) * 256 else 256


def tiles_of(m: int, n: int) -> int:
    """Output tiles of one m x n result (a DOT product writes two partial
    dots a tile, one a consumer warpgroup)."""
    return -(-m // TILE_M) * -(-n // tile_n(n))
