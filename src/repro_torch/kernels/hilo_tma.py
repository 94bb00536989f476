"""Arguments of the batched hi/lo product on TMA and wgmma,
``csrc/hilo_tma.cuh``: the products of every large route (sides, tiles
and ranks of 129..1024: ``neumann_inv``, ``fused_precond``,
``smw_update`` and ``fused_gram_inv``'s Gram); also the workspace
helpers those routes share (:data:`WORKSPACE_BYTES`, :func:`chunks`,
:func:`row_stride`, :func:`elem_ptr`).

Its operands are m x k and k x n blocks kept in device memory as bf16 hi
and lo slices, rows :func:`slice_stride` apart, which the kernel that
writes an operand (a split kernel, a prep kernel or a product's
epilogue) splits once as it stores it; the left one may be stored k x m
and the right one n x k (``l_t``, ``r_t``), and an operand may be a pool
of blocks read through an index array (block ``idx[b]`` for batch entry
``b``). Where a later kernel reads a value as fp32 (an epilogue's E, a
solve, the copy-out), its writer stores the fp32 value too, rows
:func:`row_stride` apart (or the caller's unpadded rows). Nothing here
launches or allocates: the wrappers build one :class:`Params` a product.
"""

from __future__ import annotations

import ctypes

import torch

#: the reference's largest block and tile side (``repro.kernels``)
MAX_SIDE = 1024
#: the product's largest depth (``htma::MAX_K``; a Gram's token count)
MAX_DEPTH = 1 << 24
#: a chunk's workspace is kept under this many bytes; a side's blocks (or a
#: WU group's tiles) are taken in as many chunks as that needs
WORKSPACE_BYTES = 1 << 30

#: the forms a value is stored in: fp32, and its bf16 hi and lo slices
F32, HI, LO = "f32", "hi", "lo"
FORMS = (F32, HI, LO)
#: the left operand's slices (the right operand is always read as both):
#: FULL both (three partials), HI or LO one exact slice (two partials)
FULL, HI_SLICE, LO_SLICE = 0, 1, 2
LEFT_FORMS = {FULL: (HI, LO), HI_SLICE: (HI,), LO_SLICE: (LO,)}
#: the epilogues (htma::Epi)
STORE, TWO_I_MINUS, I_MINUS, ADD, NEG_ACC, DOT = range(6)
#: the output tile's rows (BN, its columns, is :func:`tile_n`)
TILE_M = 128


class Out(ctypes.Structure):
    """``htma::Out``: where a kernel writes a value's forms (null for a
    form not written)."""

    _fields_ = [("f32", ctypes.c_void_p), ("hi", ctypes.c_void_p),
                ("lo", ctypes.c_void_p)]


class Params(ctypes.Structure):
    """``htma::Params``: one batched product ``C[b] = epi(L[b] R[b])``
    (``l_lo`` null: the left operand is the one exact slice at ``l_hi``;
    ``r_lo`` null too: ``L_H R_H`` alone). The first fields give the
    square form (n x n blocks, one slice stride ``ld16``, block ``b`` of
    each operand); the rectangular fields after ``epi``, each left 0 for
    the square form's value, give an m x k left and a k x n right operand,
    each with its own slice stride, array of blocks and optional int32
    index array, DOT's partials, and each operand's storage (``l_t``: the
    left stored k x m; ``r_t``: the right stored n x k). A library takes
    only the forms it instantiates (``htma::launch<FORMS>``)."""

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
                ("part", ctypes.c_void_p),
                ("l_t", ctypes.c_int), ("r_t", ctypes.c_int)]


def slice_stride(n: int) -> int:
    """A slice row's stride: ``n`` rounded up to 8 bf16 (16 bytes, as a
    TMA tensor map's strides need)."""
    return -(-n // 8) * 8


def stride(n: int, form: str) -> int:
    """Row stride of a value of side ``n`` stored in ``form``."""
    return row_stride(n) if form == F32 else slice_stride(n)


def itemsize(form: str) -> int:
    return 4 if form == F32 else 2


def tile_n(n: int) -> int:
    """The output tile's columns for n columns: 192 or 256, whichever
    pads n less (``htma::tile_n``)."""
    return 192 if -(-n // 192) * 192 < -(-n // 256) * 256 else 256


def tiles_of(m: int, n: int) -> int:
    """Output tiles of one m x n result (a DOT product writes two partial
    dots a tile, one a consumer warpgroup)."""
    return -(-m // TILE_M) * -(-n // tile_n(n))


def row_stride(cols: int) -> int:
    """An fp32 workspace row's stride: ``cols`` rounded up to 4 floats,
    so that every workspace operand takes float4 accesses."""
    return -(-cols // 4) * 4


def chunks(total: int, per_item_bytes: int,
           budget: int = WORKSPACE_BYTES, cap: int = 65535) -> list:
    """``[(start, stop), ...]`` covering ``range(total)`` in equal chunks
    (the last may be shorter) of at most ``budget // per_item_bytes``
    items (at least 1, at most ``cap``)."""
    if total <= 0:
        return []
    most = max(1, min(budget // per_item_bytes, cap))
    parts = -(-total // most)
    size = -(-total // parts)
    return [(lo, min(lo + size, total)) for lo in range(0, total, size)]


def elem_ptr(t: torch.Tensor, offset: int = 0) -> int:
    """Device address of element ``offset`` of ``t`` (any dtype)."""
    return t.data_ptr() + t.element_size() * offset
