"""SOI block inverse on Hopper: wrapper of ``csrc/neumann_inv.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.neumann_inv`` (the
VMEM-resident composed-precision inverse), on its whole domain n <= 1024.
Two routes, chosen by the block side:

* n <= :data:`ONE_CTA_N` (128): one block per CTA with the whole
  iteration in shared memory and registers, on wgmma. One launch takes
  up to :data:`MAX_LEAVES` leaves of one block side
  (:func:`neumann_inv_grouped`), so a K-FAC refresh inverts every block
  of one side in one launch.
* 128 < n <= :data:`MAX_N` (1024): a block no longer fits one CTA, so the
  iteration runs as :func:`inv_schedule`'s batched hi/lo products
  (``csrc/hilo_bmm.cuh``) over every block of a chunk of one side, with
  the state in a workspace allocated here on the launches' stream
  (:func:`large_plan`: chunks under ``hilo_bmm.WORKSPACE_BYTES``).

The CUDA source states what bounds each route and how its design answers
that.

Unlike the TPU kernel, blocks are inverted on n as given: the TPU
padded n to a multiple of 128 with an identity tail, which changes
``X0`` for blocks whose norms are below 1. The plain version is
:func:`repro_torch.kernels.ref.neumann_inv_ref`.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from repro_torch.kernels import hilo_bmm
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.ref import _damping_vector

#: largest block side the kernels take (the reference's limit)
MAX_N = hilo_bmm.MAX_SIDE
#: largest block side of the one-CTA route (one CTA holds the block)
ONE_CTA_N = 128
#: workspace buffers of the large route, each (chunk, n, ld) fp32: Ad,
#: the two X buffers, W and M (see :func:`inv_schedule`)
BUFFERS = ("ad", "x0", "x1", "w", "m")
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


_P, _I = ctypes.c_void_p, ctypes.c_int
_TABLE = ctypes.POINTER(LeafTable)
LIB = CudaLibrary("neumann_inv", "neumann_inv.cu", {
    "neumann_inv_launch": [_TABLE, _I, _I, _I, _I, _P],
    "neumann_inv_prep": [_TABLE, _I, _I, _I, _I, _P, _P, _P],
    "neumann_inv_product": [ctypes.POINTER(hilo_bmm.Params), _I, _I, _P],
    "neumann_inv_copy_out": [_TABLE, _I, _I, _I, _I, _P, _P]})


def _table(blocks, dampings, outs, leaves) -> LeafTable:
    t = LeafTable()
    t.count = len(leaves)
    total = 0
    for j, i in enumerate(leaves):
        t.a[j] = blocks[i].data_ptr()
        t.damping[j] = dampings[i].data_ptr()
        t.out[j] = outs[i].data_ptr()
        t.start[j] = total
        total += blocks[i].shape[0]
    t.start[t.count] = total
    return t


def leaf_tables(blocks: Sequence[torch.Tensor], dampings, outs) -> list:
    """One :class:`LeafTable` per launch over the leaves with blocks,
    :data:`MAX_LEAVES` at most each."""
    live = [i for i, a in enumerate(blocks) if a.shape[0] > 0]
    return [_table(blocks, dampings, outs, live[k:k + MAX_LEAVES])
            for k in range(0, len(live), MAX_LEAVES)]


def inv_schedule(ns_iters: int, taylor_terms: int, refine_steps: int):
    """The large route's products, in order, and the buffer that holds
    the inverse at the end. Each product is ``(mode, epilogue, L, R, C,
    E, F)`` over the names of :data:`BUFFERS` (``hilo_bmm`` modes and
    epilogues; E and F only where the epilogue reads or writes them),
    the iteration of :func:`repro_torch.kernels.ref.neumann_inv_ref`:

    * Newton-Schulz, ``W = 2I - A_H X`` then ``X' = X W`` into the other
      X buffer (a product never writes an operand it reads);
    * Neumann terms, ``U = A_L T`` into W, then ``T' = -X U`` into the
      free X buffer with ``M = M + T'`` (M starts as X, T as X);
    * refinements, ``R = I - Ad M`` into W, then ``M + M R`` into
      whichever of M and the free X buffer does not hold M.

    The prep kernel writes Ad and X0 into ``ad`` and ``x0`` first."""
    steps = []
    x, y = "x0", "x1"
    for _ in range(ns_iters):
        steps.append((hilo_bmm.HI, hilo_bmm.TWO_I_MINUS, "ad", x, "w",
                      None, None))
        steps.append((hilo_bmm.FULL, hilo_bmm.STORE, x, "w", y, None, None))
        x, y = y, x
    m = t = x
    for _ in range(max(taylor_terms - 1, 0)):
        steps.append((hilo_bmm.LO, hilo_bmm.STORE, "ad", t, "w", None, None))
        steps.append((hilo_bmm.FULL, hilo_bmm.NEG_ACC, x, "w", y, m, "m"))
        t, m = y, "m"
    for _ in range(refine_steps):
        steps.append((hilo_bmm.FULL, hilo_bmm.I_MINUS, "ad", m, "w", None,
                      None))
        new = y if m == "m" else "m"
        steps.append((hilo_bmm.FULL, hilo_bmm.ADD, m, "w", new, m, None))
        m = new
    return steps, m


def large_plan(nbs: Sequence[int], n: int,
               budget: int = hilo_bmm.WORKSPACE_BYTES) -> list:
    """The large route's launches for leaves of ``nbs[i]`` blocks of one
    side ``n``: per table of at most :data:`MAX_LEAVES` leaves with
    blocks, ``(leaves, chunks, workspace_bytes)``, where ``chunks`` are
    ``(b0, b1)`` ranges of the table's blocks (in leaf order) whose
    workspace (:data:`BUFFERS`, each (chunk, n, ld) fp32) stays under
    ``budget``, and ``workspace_bytes`` the largest chunk's."""
    per_block = len(BUFFERS) * n * hilo_bmm.row_stride(n) * 4
    live = [i for i, nb in enumerate(nbs) if nb > 0]
    plan = []
    for k in range(0, len(live), MAX_LEAVES):
        leaves = live[k:k + MAX_LEAVES]
        parts = hilo_bmm.chunks(sum(nbs[i] for i in leaves), per_block,
                                budget)
        plan.append((leaves, parts,
                     max(b1 - b0 for b0, b1 in parts) * per_block))
    return plan


def launches_per_chunk(ns_iters: int, taylor_terms: int,
                       refine_steps: int) -> int:
    """Kernel launches of one large-route chunk: prep, the schedule's
    products, copy-out."""
    return len(inv_schedule(ns_iters, taylor_terms, refine_steps)[0]) + 2


def expected_launches(sides, ns_iters: int, taylor_terms: int,
                      refine_steps: int) -> int:
    """Launches of one :func:`neumann_inv_grouped` call over leaves whose
    block counts by side are ``sides = {n: [nb, ...]}``."""
    total = 0
    for n, nbs in sides.items():
        if n <= ONE_CTA_N:
            total += -(-sum(1 for nb in nbs if nb > 0) // MAX_LEAVES)
        else:
            per = launches_per_chunk(ns_iters, taylor_terms, refine_steps)
            total += per * sum(len(c) for _, c, _ in large_plan(nbs, n))
    return total


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
            f"neumann_inv kernel takes blocks of n <= {MAX_N} (the "
            f"reference's limit), got n={a.shape[-1]}; use --block-size "
            f"<= {MAX_N}")
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
    CUDA blocks, n_i <= 1024, each with (nb_i,) or scalar damping, on
    the current stream: for a side n <= 128 one launch for each
    :data:`MAX_LEAVES` leaves of it; above, the large route's launches
    (:func:`large_plan`, :func:`launches_per_chunk`). ``out``: the output
    buffers (else new ones)."""
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
            side = ([blocks[i] for i in idx], [lams[i] for i in idx],
                    [outs[i] for i in idx])
            if n > ONE_CTA_N:
                _large_side(*side, n, (ns_iters, taylor_terms,
                                       refine_steps), stream)
                continue
            for table in leaf_tables(*side):
                LIB.launch("neumann_inv_launch", ctypes.byref(table), n,
                           ns_iters, taylor_terms, refine_steps, stream,
                           key=f"n{n}")
    return outs


def _large_side(blocks, lams, outs, n: int, counts, stream) -> None:
    """The large route over the leaves of one side n > 128: per table
    and chunk, prep, the schedule's products, copy-out, all on
    ``stream``, the workspace allocated on it (the current stream)."""
    ld = hilo_bmm.row_stride(n)
    steps, last = inv_schedule(*counts)
    key = f"n{n}"
    for leaves, parts, ws_bytes in large_plan(
            [a.shape[0] for a in blocks], n):
        table = ctypes.byref(_table(blocks, lams, outs, leaves))
        ws = torch.empty(ws_bytes // 4, dtype=torch.float32,
                         device=blocks[0].device)
        for b0, b1 in parts:
            cb = b1 - b0
            size = cb * n * ld
            buf = {name: hilo_bmm.elem_ptr(ws, k * size)
                   for k, name in enumerate(BUFFERS)}
            LIB.launch("neumann_inv_prep", table, b0, cb, n, ld, buf["ad"],
                       buf["x0"], stream, key=key)
            for mode, epi, lft, rgt, c, e, f in steps:
                p = hilo_bmm.params(
                    hilo_bmm.operand(buf[lft], n * ld, ld),
                    hilo_bmm.operand(buf[rgt], n * ld, ld),
                    buf[c], n * ld, ld, n, n, n, cb,
                    e=buf[e] if e else None, e_stride=n * ld, lde=ld,
                    f=buf[f] if f else None)
                LIB.launch("neumann_inv_product", ctypes.byref(p), mode, epi,
                           stream, key=key)
            LIB.launch("neumann_inv_copy_out", table, b0, cb, n, ld,
                       buf[last], stream, key=key)


def neumann_inv(a: torch.Tensor, damping, *, ns_iters: int,
                taylor_terms: int, refine_steps: int) -> torch.Tensor:
    """``(a + damping I)^{-1}`` of (nb, n, n) fp32 CUDA blocks, n <= 1024,
    with per-block (nb,) or scalar damping."""
    return neumann_inv_grouped([a], [damping], ns_iters=ns_iters,
                               taylor_terms=taylor_terms,
                               refine_steps=refine_steps)[0]
