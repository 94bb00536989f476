"""SOI block inverse on Hopper: wrapper of ``csrc/neumann_inv.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.neumann_inv`` (the
VMEM-resident composed-precision inverse). The CUDA kernel runs one
block per CTA with the whole iteration in shared memory and registers,
on wgmma; its source states what bounds it and how the design answers
that. One launch takes up to :data:`MAX_LEAVES` leaves of one block
side (:func:`neumann_inv_grouped`), so a K-FAC refresh inverts every
block of one side in one launch.

Unlike the TPU kernel, blocks are inverted on n as given: the TPU
padded n to a multiple of 128 with an identity tail, which changes
``X0`` for blocks whose norms are below 1. The plain version is
:func:`repro_torch.kernels.ref.neumann_inv_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.ref import _damping_vector

#: largest block side the kernel takes (one CTA holds the block on chip)
MAX_N = 128
#: leaves one launch takes (the kernel's leaf table; longer lists take
#: several launches)
MAX_LEAVES = 32


class LeafTable(ctypes.Structure):
    """The kernel's ``LeafTable``, passed to the launch by pointer and
    to the kernel by value: per leaf the input, damping and output base
    pointers, and the prefix sums of the leaves' block counts."""

    _fields_ = [("a", ctypes.c_void_p * MAX_LEAVES),
                ("damping", ctypes.c_void_p * MAX_LEAVES),
                ("out", ctypes.c_void_p * MAX_LEAVES),
                ("start", ctypes.c_int * (MAX_LEAVES + 1)),
                ("count", ctypes.c_int)]


LIB = CudaLibrary("neumann_inv", "neumann_inv.cu", {
    "neumann_inv_launch": [
        ctypes.POINTER(LeafTable), ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]})


def leaf_tables(blocks: Sequence[torch.Tensor], dampings, outs) -> list:
    """One :class:`LeafTable` per launch over the leaves with blocks,
    :data:`MAX_LEAVES` at most each."""
    live = [i for i, a in enumerate(blocks) if a.shape[0] > 0]
    tables = []
    for k in range(0, len(live), MAX_LEAVES):
        t = LeafTable()
        t.count = len(live[k:k + MAX_LEAVES])
        total = 0
        for j, i in enumerate(live[k:k + MAX_LEAVES]):
            t.a[j] = blocks[i].data_ptr()
            t.damping[j] = dampings[i].data_ptr()
            t.out[j] = outs[i].data_ptr()
            t.start[j] = total
            total += blocks[i].shape[0]
        t.start[t.count] = total
        tables.append(t)
    return tables


def _check(a: torch.Tensor) -> None:
    if not a.is_cuda:
        raise ValueError(f"neumann_inv kernel needs a CUDA tensor, got "
                         f"{a.device}")
    if a.dtype != torch.float32:
        raise ValueError(f"neumann_inv kernel takes float32, got {a.dtype}")
    if a.ndim != 3 or a.shape[-1] != a.shape[-2]:
        raise ValueError(f"neumann_inv takes (nb, n, n) blocks, got "
                         f"{tuple(a.shape)}")
    if a.shape[-1] > MAX_N:
        raise ValueError(
            f"neumann_inv kernel takes blocks of n <= {MAX_N}, got "
            f"n={a.shape[-1]}; use --block-size <= {MAX_N}")
    if not a.is_contiguous():
        raise ValueError("neumann_inv kernel needs a contiguous tensor")


def check_out(blocks: Sequence[torch.Tensor], out) -> None:
    """``out`` must hold one contiguous fp32 buffer per leaf, shaped
    like it and on its device."""
    for a, o in zip(blocks, out):
        if (o.shape != a.shape or o.dtype != torch.float32
                or o.device != a.device or not o.is_contiguous()):
            raise ValueError(
                f"neumann_inv out= needs a contiguous float32 buffer of "
                f"{tuple(a.shape)} on {a.device}, got {tuple(o.shape)} "
                f"{o.dtype} on {o.device}")


def neumann_inv_grouped(blocks: Sequence[torch.Tensor], dampings, *,
                        ns_iters: int, taylor_terms: int,
                        refine_steps: int, out=None) -> list:
    """``(a_i + damping_i I)^{-1}`` for leaves of (nb_i, n_i, n_i) fp32
    CUDA blocks, n_i <= 128, each with (nb_i,) or scalar damping: one
    launch for each block side and each :data:`MAX_LEAVES` leaves of it,
    on the current stream. ``out``: the output buffers (else new ones)."""
    if len(blocks) != len(dampings):
        raise ValueError(f"{len(blocks)} leaves but {len(dampings)} "
                         f"dampings")
    for a in blocks:
        _check(a)
    if len({a.device for a in blocks}) > 1:
        raise ValueError("neumann_inv leaves must be on one device")
    if min(ns_iters, taylor_terms, refine_steps) < 0:
        raise ValueError("iteration counts must be >= 0")
    if out is None:
        outs = [torch.empty_like(a) for a in blocks]
    else:
        if len(out) != len(blocks):
            raise ValueError(f"{len(blocks)} leaves but {len(out)} "
                             f"outputs")
        check_out(blocks, out)
        outs = list(out)
    if not blocks:
        return outs
    lams = [_damping_vector(d, a.shape[0], a.device).contiguous()
            for a, d in zip(blocks, dampings)]
    by_side: dict = {}
    for i, a in enumerate(blocks):
        by_side.setdefault(a.shape[-1], []).append(i)
    dev = blocks[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for n, idx in by_side.items():
            for table in leaf_tables([blocks[i] for i in idx],
                                     [lams[i] for i in idx],
                                     [outs[i] for i in idx]):
                LIB.launch("neumann_inv_launch", ctypes.byref(table), n,
                           ns_iters, taylor_terms, refine_steps, stream)
    return outs


def neumann_inv(a: torch.Tensor, damping, *, ns_iters: int,
                taylor_terms: int, refine_steps: int) -> torch.Tensor:
    """``(a + damping I)^{-1}`` of (nb, n, n) fp32 CUDA blocks, n <= 128,
    with per-block (nb,) or scalar damping."""
    return neumann_inv_grouped([a], [damping], ns_iters=ns_iters,
                               taylor_terms=taylor_terms,
                               refine_steps=refine_steps)[0]
