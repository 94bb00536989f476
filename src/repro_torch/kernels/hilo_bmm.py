"""Arguments of the batched hi/lo product ``csrc/hilo_bmm.cuh``: the
large-block route of ``smw_update`` and ``fused_gram_inv``'s Gram (sides
and ranks of 129..1024), shared by their wrappers; also the workspace
helpers of every large route (:data:`WORKSPACE_BYTES`, :func:`chunks`,
:func:`row_stride`).

The product's operands are fp32 blocks in device memory (bf16 for the Gram
of bf16 activations), addressed by a base pointer, an optional int32
index array (block ``idx[b]`` for batch entry ``b``), a block stride and a
row stride, in elements; the kernel reads either operand as stored or
transposed (a template flag of the launch, chosen by the wrapper's C
entry), splits it into bf16 hi/lo slices as it stages it and pads every
side with zeros to its 64-wide tiles in shared memory only. Nothing here
launches or allocates: the wrappers build one :class:`Params` a product.
``neumann_inv``'s and ``fused_precond``'s large routes run on a product
of their own (``csrc/hilo_tma.cuh``, :mod:`hilo_tma`).
"""

from __future__ import annotations

import ctypes

import torch

#: the reference's largest block and tile side (``repro.kernels``)
MAX_SIDE = 1024
#: a chunk's workspace is kept under this many bytes; a side's blocks (or a
#: WU group's tiles) are taken in as many chunks as that needs
WORKSPACE_BYTES = 1 << 30

# the left operand's mode (its two slices) and the epilogues (bmm::Mode,
# bmm::Epi)
FULL = 0
STORE, SUB = 0, 6


class Operand(ctypes.Structure):
    """``bmm::Operand``: block ``b`` at ``p + (idx ? idx[b] : b) *
    stride`` elements, rows ``ld`` apart; ``vec`` allows loads of four
    entries at once."""

    _fields_ = [("p", ctypes.c_void_p), ("idx", ctypes.c_void_p),
                ("stride", ctypes.c_longlong), ("ld", ctypes.c_int),
                ("vec", ctypes.c_int)]


class Params(ctypes.Structure):
    """``bmm::Params``: one batched product ``C[b] = epi(sum of the
    partials of L[b] R[b])``, M x K by K x N."""

    _fields_ = [("L", Operand), ("R", Operand),
                ("C", ctypes.c_void_p), ("c_stride", ctypes.c_longlong),
                ("ldc", ctypes.c_int),
                ("E", ctypes.c_void_p), ("e_stride", ctypes.c_longlong),
                ("lde", ctypes.c_int),
                ("M", ctypes.c_int), ("N", ctypes.c_int), ("K", ctypes.c_int),
                ("batch", ctypes.c_int), ("c_vec", ctypes.c_int)]


def row_stride(cols: int) -> int:
    """A workspace row's stride: ``cols`` rounded up to 4 floats, so
    that every workspace operand takes float4 loads."""
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


def operand(ptr: int, stride: int, ld: int, idx: int | None = None) -> Operand:
    """An operand at device address ``ptr`` (strides in elements); loads
    of four entries where the base, block stride and row stride allow
    them (16-byte alignment also covers bf16's 8-byte loads)."""
    vec = ptr % 16 == 0 and stride % 4 == 0 and ld % 4 == 0
    return Operand(ptr, idx, stride, ld, int(vec))


def params(left: Operand, right: Operand, out: int, out_stride: int,
           ldc: int, m: int, n: int, k: int, batch: int, *,
           e: int | None = None, e_stride: int = 0, lde: int = 0) -> Params:
    """One product's :class:`Params`; ``c_vec`` (float2 epilogue
    accesses) where C and E and their strides allow it."""
    ptrs = [x for x in (out, e) if x is not None]
    strides = [out_stride, ldc] + ([e_stride, lde] if e is not None else [])
    c_vec = all(x % 8 == 0 for x in ptrs) and all(s % 2 == 0
                                                  for s in strides)
    return Params(left, right, out, out_stride, ldc, e, e_stride, lde,
                  m, n, k, batch, int(c_vec))


def elem_ptr(t: torch.Tensor, offset: int = 0) -> int:
    """Device address of element ``offset`` of ``t`` (any dtype)."""
    return t.data_ptr() + t.element_size() * offset
