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
  iteration runs as :func:`inv_schedule`'s batched hi/lo products on TMA
  and wgmma (``csrc/hilo_tma.cuh``) over every block of a chunk of one
  side, with the state in a workspace allocated here on the launches'
  stream (:func:`large_plan`: chunks under ``hilo_tma.WORKSPACE_BYTES``),
  each value stored in the forms its readers take: bf16 hi and lo slices
  for a product's operands, fp32 for an epilogue's E and the copy-out.

The CUDA source states what bounds each route and how its design answers
that.

Unlike the TPU kernel, blocks are inverted on n as given: the TPU
padded n to a multiple of 128 with an identity tail, which changes
``X0`` for blocks whose norms are below 1. The plain version is
:func:`repro_torch.kernels.ref.neumann_inv_ref`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from repro_torch.kernels import hilo_tma
from repro_torch.kernels.hilo_tma import F32, FORMS, HI, LO
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.ref import _damping_vector

#: largest block side the kernels take (the reference's limit)
MAX_N = hilo_tma.MAX_SIDE
#: largest block side of the one-CTA route (one CTA holds the block)
ONE_CTA_N = 128
#: workspace buffers of the large route (see :func:`inv_schedule`): Ad,
#: the two X buffers, W and M, each in the forms any schedule writes it in,
#: each form a (chunk, n, ld) array (``hilo_tma.stride``)
BUFFERS = ("ad", "x0", "x1", "w", "m")
BUFFER_FORMS = {"ad": (HI, LO), "x0": FORMS, "x1": FORMS, "w": (HI, LO),
                "m": FORMS}
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
    "neumann_inv_prep": [_TABLE, _I, _I, _I, _I, _I,
                         ctypes.POINTER(hilo_tma.Out),
                         ctypes.POINTER(hilo_tma.Out), _P],
    "neumann_inv_product": [ctypes.POINTER(hilo_tma.Params), _P],
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


class Product(NamedTuple):
    """One product of the large route: ``C = epi(L R)`` over the names of
    :data:`BUFFERS` (``hilo_tma`` left modes and epilogues; E and F only
    where the epilogue reads or writes them), and the forms it writes C
    and F in."""

    mode: int
    epi: int
    left: str
    right: str
    c: str
    e: str | None
    f: str | None
    c_forms: frozenset = frozenset()
    f_forms: frozenset = frozenset()

    @property
    def reads(self) -> list:
        """``(buffer, forms)`` the product reads: the left operand's
        slices, both slices of the right one, E in fp32."""
        got = [(self.left, hilo_tma.LEFT_FORMS[self.mode]),
               (self.right, (HI, LO))]
        return got + ([(self.e, (F32,))] if self.e else [])


class Schedule(NamedTuple):
    """The large route's kernels: the forms the prep kernel writes Ad and
    X0 in, the products in order, and the buffer the copy-out reads (in
    fp32)."""

    prep: dict
    products: tuple
    last: str


def inv_schedule(ns_iters: int, taylor_terms: int,
                 refine_steps: int) -> Schedule:
    """The large route's products, in order, the iteration of
    :func:`repro_torch.kernels.ref.neumann_inv_ref`:

    * Newton-Schulz, ``W = 2I - A_H X`` then ``X' = X W`` into the other
      X buffer (a product never writes an operand it reads);
    * Neumann terms, ``U = A_L T`` into W, then ``T' = -X U`` into the
      free X buffer with ``M = M + T'`` (M starts as X, T as X);
    * refinements, ``R = I - Ad M`` into W, then ``M + M R`` into
      whichever of M and the free X buffer does not hold M.

    The prep kernel writes Ad and X0 into ``ad`` and ``x0`` first. Each
    kernel writes a value in exactly the forms that its readers take
    before the buffer is written again (:meth:`Product.reads`; the
    copy-out reads the last buffer in fp32): a value read only as an
    operand is stored as its two slices, one read as E or copied out also
    (or only) in fp32."""
    steps = []
    x, y = "x0", "x1"
    for _ in range(ns_iters):
        steps.append(Product(hilo_tma.HI_SLICE, hilo_tma.TWO_I_MINUS, "ad",
                             x, "w", None, None))
        steps.append(Product(hilo_tma.FULL, hilo_tma.STORE, x, "w", y, None,
                             None))
        x, y = y, x
    m = t = x
    for _ in range(max(taylor_terms - 1, 0)):
        steps.append(Product(hilo_tma.LO_SLICE, hilo_tma.STORE, "ad", t, "w",
                             None, None))
        steps.append(Product(hilo_tma.FULL, hilo_tma.NEG_ACC, x, "w", y, m,
                             "m"))
        t, m = y, "m"
    for _ in range(refine_steps):
        steps.append(Product(hilo_tma.FULL, hilo_tma.I_MINUS, "ad", m, "w",
                             None, None))
        new = y if m == "m" else "m"
        steps.append(Product(hilo_tma.FULL, hilo_tma.ADD, m, "w", new, m,
                             None))
        m = new
    # backwards: what later kernels read of each buffer's current value
    need = {m: {F32}}
    products = []
    for p in reversed(steps):
        c_forms = need.pop(p.c, set())
        f_forms = need.pop(p.f, set()) if p.f else set()
        for buf, forms in p.reads:
            need.setdefault(buf, set()).update(forms)
        products.append(p._replace(c_forms=frozenset(c_forms),
                                   f_forms=frozenset(f_forms)))
    prep = {buf: frozenset(need.pop(buf, ())) for buf in ("ad", "x0")}
    if need:
        raise AssertionError(f"read before written: {sorted(need)}")
    return Schedule(prep, tuple(products[::-1]), m)


def block_bytes(n: int) -> int:
    """Workspace bytes of one block of side ``n``: every buffer in its
    :data:`BUFFER_FORMS`."""
    return sum(n * hilo_tma.stride(n, f) * hilo_tma.itemsize(f)
               for buf in BUFFERS for f in BUFFER_FORMS[buf])


def workspace(base: int, nb: int, n: int) -> dict:
    """``{(buffer, form): device address}`` of a chunk of ``nb`` blocks in
    a workspace at ``base``: each form of each buffer one (nb, n, stride)
    array, one after the other (every array a multiple of 16 bytes)."""
    addr, off = {}, base
    for buf in BUFFERS:
        for f in BUFFER_FORMS[buf]:
            addr[(buf, f)] = off
            off += nb * n * hilo_tma.stride(n, f) * hilo_tma.itemsize(f)
    return addr


def schedule_bytes(n: int, ns_iters: int, taylor_terms: int,
                   refine_steps: int) -> int:
    """Bytes the large route moves for one block of side ``n``, each
    kernel's inputs read once and its outputs written once (n x n entries
    a form; 4 bytes fp32, 2 a slice): the block and its damping into the
    prep kernel, Ad and X0 out of it; every product's operand slices and
    E, its C and F in their forms; the last buffer into the copy-out and
    the inverse out of it. The floor of a design whose state passes
    through device memory between products."""
    sched = inv_schedule(ns_iters, taylor_terms, refine_steps)

    def size(forms):
        return sum(n * n * hilo_tma.itemsize(f) for f in forms)

    total = 4 * n * n + 4 + sum(size(f) for f in sched.prep.values())
    for p in sched.products:
        total += sum(size(forms) for _, forms in p.reads)
        total += size(p.c_forms) + size(p.f_forms)
    return total + 2 * size((F32,))


def large_plan(nbs: Sequence[int], n: int,
               budget: int = hilo_tma.WORKSPACE_BYTES) -> list:
    """The large route's launches for leaves of ``nbs[i]`` blocks of one
    side ``n``: per table of at most :data:`MAX_LEAVES` leaves with
    blocks, ``(leaves, chunks, workspace_bytes)``, where ``chunks`` are
    ``(b0, b1)`` ranges of the table's blocks (in leaf order) whose
    workspace (:func:`block_bytes` a block) stays under ``budget``, and
    ``workspace_bytes`` the largest chunk's."""
    per_block = block_bytes(n)
    live = [i for i, nb in enumerate(nbs) if nb > 0]
    plan = []
    for k in range(0, len(live), MAX_LEAVES):
        leaves = live[k:k + MAX_LEAVES]
        parts = hilo_tma.chunks(sum(nbs[i] for i in leaves), per_block,
                                budget)
        plan.append((leaves, parts,
                     max(b1 - b0 for b0, b1 in parts) * per_block))
    return plan


def launches_per_chunk(ns_iters: int, taylor_terms: int,
                       refine_steps: int) -> int:
    """Kernel launches of one large-route chunk: prep, the schedule's
    products, copy-out."""
    return len(inv_schedule(ns_iters, taylor_terms,
                            refine_steps).products) + 2


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
            else:
                for table in leaf_tables(*side):
                    LIB.launch("neumann_inv_launch", ctypes.byref(table),
                               n, ns_iters, taylor_terms, refine_steps,
                               stream, key=f"n{n}")
            LIB.note_items(f"n{n}", sum(blocks[i].shape[0] for i in idx))
    return outs


def _large_side(blocks, lams, outs, n: int, counts, stream) -> None:
    """The large route over the leaves of one side n > 128: per table
    and chunk, prep, the schedule's products, copy-out, all on
    ``stream``, the workspace allocated on it (the current stream)."""
    ld32, ld16 = hilo_tma.row_stride(n), hilo_tma.slice_stride(n)
    sched = inv_schedule(*counts)
    key = f"n{n}"
    for leaves, parts, ws_bytes in large_plan(
            [a.shape[0] for a in blocks], n):
        table = ctypes.byref(_table(blocks, lams, outs, leaves))
        ws = torch.empty(ws_bytes, dtype=torch.uint8,
                         device=blocks[0].device)
        for b0, b1 in parts:
            cb = b1 - b0
            addr = workspace(ws.data_ptr(), cb, n)

            def out(buf, forms):
                return hilo_tma.Out(*(addr[(buf, f)] if f in forms else None
                                      for f in FORMS))

            LIB.launch("neumann_inv_prep", table, b0, cb, n, ld32, ld16,
                       ctypes.byref(out("ad", sched.prep["ad"])),
                       ctypes.byref(out("x0", sched.prep["x0"])), stream,
                       key=key)
            for p in sched.products:
                left = [addr[(p.left, f)]
                        for f in hilo_tma.LEFT_FORMS[p.mode]]
                prm = hilo_tma.Params(
                    left[0], left[1] if len(left) > 1 else None,
                    addr[(p.right, HI)], addr[(p.right, LO)],
                    addr[(p.e, F32)] if p.e else None,
                    out(p.c, p.c_forms),
                    out(p.f, p.f_forms) if p.f else hilo_tma.Out(),
                    n, ld32, ld16, cb, p.epi)
                LIB.launch("neumann_inv_product", ctypes.byref(prm), stream,
                           key=key)
            LIB.launch("neumann_inv_copy_out", table, b0, cb, n, ld32,
                       addr[(sched.last, F32)], stream, key=key)


def neumann_inv(a: torch.Tensor, damping, *, ns_iters: int,
                taylor_terms: int, refine_steps: int) -> torch.Tensor:
    """``(a + damping I)^{-1}`` of (nb, n, n) fp32 CUDA blocks, n <= 1024,
    with per-block (nb,) or scalar damping."""
    return neumann_inv_grouped([a], [damping], ns_iters=ns_iters,
                               taylor_terms=taylor_terms,
                               refine_steps=refine_steps)[0]
