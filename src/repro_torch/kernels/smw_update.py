"""Rank-k SMW inverse update on Hopper: wrapper of ``csrc/smw_update.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.smw_update`` on its whole
domain, bs and k up to 1024: per block, ``M = sym(inv)/decay``,
``Y = V M``, ``S = Y V^T + I/c``, ``Z = S^-1 Y`` and ``out = M - Y^T Z``,
every product hi/lo bit-sliced. Two routes:

* bs, k <= :data:`ONE_CTA_N` (128): one CTA a block, one launch a call.
  The TPU program solves the k x k system between its two
  ``pallas_call``s, the CUDA kernel inside the CTA (LU with partial
  pivoting in fp32), so Y, S and Z never cross device memory.
* bs or k of 129..:data:`MAX_N` (1024): a block no longer fits one CTA,
  so the update runs as :func:`smw_schedule`'s kernels over every block
  of a chunk (:func:`smw_plan`: chunks under
  ``hilo_tma.WORKSPACE_BYTES``), with M, Y, S and Z in a workspace
  allocated here on the launches' stream, each value stored in the forms
  its readers take (bf16 hi/lo slices for a product's operands, fp32 for
  the solve and an epilogue's E): the symmetrisation with V's split, two
  batched hi/lo products on TMA and wgmma (``csrc/hilo_tma.cuh``), the
  solve (a slab kernel for k <= 128; above, a blocked LU with partial
  pivoting, two launches a panel of :data:`PANEL` columns and a back
  substitution, ``csrc/lu_blocked.cuh``), whose last launch stores Z's
  slices too, and the correction's product, which writes the output.

The CUDA source states what bounds each route and how its design answers
that. Unlike the TPU kernel, k and bs are not padded to 128. The plain
version is :func:`repro_torch.kernels.ref.smw_update_ref`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import hilo_tma
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.hilo_tma import F32, HI, LO
from repro_torch.kernels.ref import smw_scalars

#: largest block side and rank the kernels take (the reference's limit)
MAX_N = hilo_tma.MAX_SIDE
#: largest block side and rank of the one-CTA route
ONE_CTA_N = 128
#: columns of one panel of the blocked LU (k above :data:`ONE_CTA_N`)
PANEL = 32
#: the large route's kernels
PREP, PRODUCT, SOLVE = "prep", "product", "solve"
#: the LU's row sources (k int32 a block, above k 128), a form of "piv"
I32 = "i32"
SLICES = (HI, LO)
#: the caller's tensors (fp32): the inverses, the columns, the output
CALLER = ("inv", "v", "out")
#: the workspace, per block, in this order: each (buffer, form) array for
#: the chunk's blocks, rows ``hilo_tma.slice_stride`` apart for a slice,
#: ``hilo_tma.row_stride`` for fp32 and the row sources, but M's fp32
#: (out's E, read at out's unpadded rows, so last: its size need not be a
#: multiple of 16 bytes); the row sources only above k 128
LAYOUT = (("v", HI), ("v", LO), ("m", HI), ("m", LO), ("y", F32),
          ("y", HI), ("y", LO), ("s", F32), ("z", F32), ("z", HI),
          ("z", LO), ("piv", I32), ("m", F32))

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary("smw_update", "smw_update.cu", {
    "smw_update_launch": [_P, _P, _P, _I, _I, _I, _F, _F, _P],
    "smw_update_prep": [_P, ctypes.POINTER(hilo_tma.Out), _P, _P, _P, _I,
                        _I, _I, _I, _I, _F, _P],
    "smw_update_product": [ctypes.POINTER(hilo_tma.Params), _P],
    "smw_update_solve_slab": [_P, _I, _P, _P, _I, _I, _I, _I, _F, _P, _P,
                              _I, _P],
    "smw_update_lu_panel": [_P, _I, _P, _I, _I, _I, _I, _F, _P],
    "smw_update_lu_update": [_P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                             _F, _P],
    "smw_update_lu_back": [_P, _I, _P, _I, _I, _I, _I, _P, _P, _I, _P]})


def buffer_shapes(bs: int, k: int) -> dict:
    """(rows, columns) of one block of each operand: the caller's
    ``inv``, ``v`` and ``out`` and the workspace's buffers (the row
    sources ``piv`` only above k 128, where the LU runs)."""
    return {"inv": (bs, bs), "v": (k, bs), "out": (bs, bs), "m": (bs, bs),
            "y": (k, bs), "s": (k, k), "z": (k, bs),
            "piv": (int(k > ONE_CTA_N), k)}


@functools.lru_cache(maxsize=1024)
def stride(buf: str, form: str, bs: int, k: int) -> int:
    """Row stride, in entries, of ``buf`` stored in ``form``."""
    cols = buffer_shapes(bs, k)[buf][1]
    if form in SLICES:
        return hilo_tma.slice_stride(cols)
    if buf in CALLER or (buf, form) == ("m", F32):
        return cols
    return hilo_tma.row_stride(cols)


def itemsize(form: str) -> int:
    return 4 if form in (F32, I32) else 2


class Step(NamedTuple):
    """One kernel of the large route: its kind, the ``(buffer, forms)``
    it reads (a product: left, right, then E) and writes, and for a
    product its epilogue (``hilo_tma`` STORE, or NEG_ACC writing its F
    alone: ``E - acc``) and whether each operand is read as stored
    transposed (``lt``: the left stored k x m; ``rt``: the right stored
    n x k); for a solve launch its ``(kind, j0, j1)``."""

    kind: str
    reads: tuple
    writes: tuple
    epi: int | None = None
    lt: bool = False
    rt: bool = False
    solve: tuple | None = None


def lu_schedule(k: int) -> list:
    """The blocked LU's launches for rank ``k``, in order, as
    ``(kind, j0, j1)``: for each panel of :data:`PANEL` columns
    ``[j0, j1)`` (the last one ragged), ``"panel"`` (one CTA a block
    factors it: pivot search, swaps, multipliers, the panel's rank-1
    updates; it writes L's panel, U11 and the rows' sources) and
    ``"update"`` (the columns right of it, S's and Z's, over many CTAs a
    block: the swaps, U12 = L11^-1 A12, A22 -= L21 U12); then ``("back",
    0, k)``, Z = U^-1 Z."""
    steps = []
    for j0 in range(0, k, PANEL):
        j1 = min(j0 + PANEL, k)
        steps += [("panel", j0, j1), ("update", j0, j1)]
    return steps + [("back", 0, k)]


@functools.lru_cache(maxsize=64)
def smw_schedule(k: int) -> tuple:
    """The large route's kernels, in order, as :class:`Step` tuples over
    the names of :func:`buffer_shapes`: the arithmetic of
    :func:`repro_torch.kernels.ref.smw_update_ref` step by step, each
    value stored in the forms its readers take:

    * ``prep``: ``M = (inv + inv^T) * (0.5/decay)``, as fp32 (out's E) and
      slices (Y's right operand), and V's slices (Y's left operand, S's
      right one read as stored, n x k);
    * ``product``: ``Y = hilo(V, M)``, as fp32 (the solve's) and slices
      (S's left operand, out's left one read as stored, k x m);
      ``S = hilo(Y, V^T)`` in fp32; ``out = M - hilo(Y^T, Z)``;
    * ``solve``: the launches of ``Z = (S + I/c)^-1 Y`` (the diagonal term
      added as ``acc + 1/c``), in fp32: for k <= 128 one ``"slab"`` (S and
      a slab of Y's columns in one CTA's shared memory); above, the
      blocked LU of :func:`lu_schedule` (S factored in place, Z made from
      Y by the first panel's update); the last launch stores Z's slices
      too (out's right operand), Z unchanged."""
    f32, z = (F32,), (("z", (F32, HI, LO)),)
    if k <= ONE_CTA_N:
        solve = [Step(SOLVE, (("s", f32), ("y", f32)), z,
                      solve=("slab", 0, k))]
    else:
        solve = []
        for kind, j0, j1 in lu_schedule(k):
            reads, writes = {
                "panel": ((("s", f32),), (("s", f32), ("piv", (I32,)))),
                "update": ((("s", f32), ("piv", (I32,)),
                            ("z" if j0 else "y", f32)),
                           (("s", f32), ("z", f32))),
                "back": ((("s", f32), ("z", f32)), z)}[kind]
            solve.append(Step(SOLVE, reads, writes, solve=(kind, j0, j1)))
    return (Step(PREP, (("inv", f32), ("v", f32)),
                 (("m", (F32, HI, LO)), ("v", SLICES))),
            Step(PRODUCT, (("v", SLICES), ("m", SLICES)),
                 (("y", (F32, HI, LO)),), hilo_tma.STORE),
            Step(PRODUCT, (("y", SLICES), ("v", SLICES)), (("s", f32),),
                 hilo_tma.STORE, rt=True),
            *solve,
            Step(PRODUCT, (("y", SLICES), ("z", SLICES), ("m", f32)),
                 (("out", f32),), hilo_tma.NEG_ACC, lt=True))


@functools.lru_cache(maxsize=64)
def layout(bs: int, k: int) -> tuple:
    """The workspace's ``(buffer, form)`` arrays of :data:`LAYOUT` that a
    call on (bs, k) stores (the row sources only above k 128)."""
    return tuple(x for x in LAYOUT if x != ("piv", I32) or k > ONE_CTA_N)


@functools.lru_cache(maxsize=1024)
def array_bytes(buf: str, form: str, bs: int, k: int) -> int:
    """Bytes of one block of ``buf``'s ``form`` in the workspace."""
    return buffer_shapes(bs, k)[buf][0] * stride(buf, form, bs, k) * \
        itemsize(form)


@functools.lru_cache(maxsize=64)
def block_bytes(bs: int, k: int) -> int:
    """Workspace bytes of one block on the large route: every array of
    :func:`layout` (4 a float or an int32, 2 a slice entry)."""
    return sum(array_bytes(b, f, bs, k) for b, f in layout(bs, k))


def smw_plan(nb: int, bs: int, k: int,
             budget: int = hilo_tma.WORKSPACE_BYTES) -> list:
    """The large route's ``(b0, b1)`` chunks of blocks: each chunk's
    workspace (:func:`block_bytes` a block) stays under ``budget``."""
    return hilo_tma.chunks(nb, block_bytes(bs, k), budget)


def expected_launches(bs: int, k: int, nb: int) -> int:
    """Launches of one :func:`smw_update` call on ``nb`` blocks of side
    ``bs`` with ``k`` columns."""
    if nb == 0:
        return 0
    if max(bs, k) <= ONE_CTA_N:
        return 1
    return len(smw_schedule(k)) * len(smw_plan(nb, bs, k))


def launch_key(bs: int, k: int) -> str:
    """The label of a call's launches in ``ops.launch_keys()``."""
    return f"bs{bs}k{k}"


def _check(inv: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("inv", inv), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"smw_update kernel needs CUDA tensors; {name} "
                             f"is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"smw_update kernel takes float32; {name} is "
                             f"{t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"smw_update takes 3-d block stacks; {name} "
                             f"has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"smw_update kernel needs contiguous tensors; "
                             f"{name} is not")
    n, k, bs = v.shape
    if tuple(inv.shape) != (n, bs, bs):
        raise ValueError(f"smw_update shapes disagree: inv "
                         f"{tuple(inv.shape)}, v {tuple(v.shape)}")
    if not 1 <= bs <= MAX_N or not 1 <= k <= MAX_N:
        raise ValueError(
            f"smw_update kernel takes 1 <= bs, k <= {MAX_N} (the "
            f"reference's limit), got bs={bs}, k={k}; use --block-size and "
            f"--smw-rank <= {MAX_N}")
    if inv.device != v.device:
        raise ValueError("smw_update operands are on different devices")


def smw_update(inv: torch.Tensor, v: torch.Tensor, *, decay: float,
               cscale: float) -> torch.Tensor:
    """(N, bs, bs) updated inverses of ``decay * F + cscale * V^T V``
    from the cached (N, bs, bs) fp32 CUDA inverses of ``F`` and the
    (N, k, bs) columns ``V``, bs, k <= 1024, on the current stream: one
    launch up to 128, the large route's above (:func:`expected_launches`).
    A singular capacitance gives non-finite blocks (no host check, no
    sync)."""
    _check(inv, v)
    n, k, bs = v.shape
    inv_decay, inv_c = smw_scalars(decay, cscale)
    out = torch.empty_like(inv)
    if not n:
        return out
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        key = launch_key(bs, k)
        if max(bs, k) <= ONE_CTA_N:
            LIB.launch("smw_update_launch", inv.data_ptr(), v.data_ptr(),
                       out.data_ptr(), n, bs, k, inv_decay, inv_c, stream,
                       key=key)
        else:
            _large(inv, v, out, inv_decay, inv_c, stream, key)
    return out


def _large(inv, v, out, inv_decay: float, inv_c: float, stream,
           key: str) -> None:
    """The large route, chunk by chunk on ``stream``, the workspace
    allocated on it (the current stream)."""
    n, k, bs = v.shape
    parts = smw_plan(n, bs, k)
    ws = torch.empty(max(b1 - b0 for b0, b1 in parts) * block_bytes(bs, k),
                     dtype=torch.uint8, device=v.device)
    for b0, b1 in parts:
        addr = _addresses(inv, v, out, ws.data_ptr(), b0, b1)
        _run(smw_schedule(k), addr, b1 - b0, k, bs, inv_decay, inv_c,
             stream, key)


def _addresses(inv, v, out, base: int, b0: int, b1: int) -> dict:
    """``{(buffer, form): device address}`` of the chunk ``[b0, b1)``'s
    first block: the caller's tensors' fp32, and the workspace's arrays of
    :func:`layout` one after another from ``base``, each for the chunk's
    blocks."""
    n, k, bs = v.shape
    addr = {(name, F32): hilo_tma.elem_ptr(t, b0 * t.shape[1] * t.shape[2])
            for name, t in (("inv", inv), ("v", v), ("out", out))}
    for buf, form in layout(bs, k):
        addr[(buf, form)] = base
        base += (b1 - b0) * array_bytes(buf, form, bs, k)
    return addr


def _run(steps, addr: dict, cb: int, k: int, bs: int, inv_decay: float,
         inv_c: float, stream, key: str) -> None:
    """Enqueue ``steps`` (:func:`smw_schedule`'s) on ``cb`` blocks at
    ``addr`` (:func:`_addresses`)."""
    for entry, args in _launches(steps, addr, cb, k, bs, inv_decay, inv_c):
        LIB.launch(entry, *args, stream, key=key)


def _launches(steps, addr: dict, cb: int, k: int, bs: int,
              inv_decay: float, inv_c: float) -> list:
    """``(C entry, its arguments but the stream)`` of each of ``steps`` on
    ``cb`` blocks at ``addr``, all computed before the first launch (a
    call at a few blocks is bound by the host's time to enqueue it)."""
    shapes = buffer_shapes(bs, k)
    ss = hilo_tma.slice_stride
    op = {b: (addr[(b, f)], shapes[b][0] * stride(b, f, bs, k),
              stride(b, f, bs, k))
          for b, f in (("s", F32), ("y", F32), ("z", F32), ("piv", I32))
          if (b, f) in addr}
    zs = (addr[("z", HI)], addr[("z", LO)], ss(bs))
    out = []
    for x in steps:
        if x.kind == PREP:
            (src, _), (vsrc, _) = x.reads
            (dst, forms), (vdst, _) = x.writes
            m = hilo_tma.Out(*(addr[(dst, f)] if f in forms else None
                               for f in hilo_tma.FORMS))
            out.append(("smw_update_prep", (
                addr[(src, F32)], ctypes.byref(m), addr[(vsrc, F32)],
                addr[(vdst, HI)], addr[(vdst, LO)], cb, bs, k,
                stride(dst, F32, bs, k), ss(bs), inv_decay)))
        elif x.kind == PRODUCT:
            out.append(("smw_update_product", (ctypes.byref(
                _product(x, addr, shapes, cb, bs, k)),)))
        else:
            slices = any(HI in forms for _, forms in x.writes)
            out.append(_solve_args(x.solve[0], x.solve[1], op, cb, k, bs,
                                   inv_c, zs if slices else (None, None, 0)))
    return out


def _product(x: Step, addr: dict, shapes: dict, cb: int, bs: int,
             k: int) -> hilo_tma.Params:
    """One product of :func:`smw_schedule` as ``hilo_tma.Params``: the
    left m x k and right k x n operands' slices (each read as stored
    transposed where the step says), E, and C's forms (NEG_ACC: F's, C
    written in no form)."""
    (left, _), (right, _), *e = x.reads
    ((c, forms),) = x.writes
    lr, lc = shapes[left]
    rr, rc = shapes[right]
    m, depth = (lc, lr) if x.lt else (lr, lc)
    n = rr if x.rt else rc
    assert depth == (rc if x.rt else rr), x
    ld32 = stride(c, F32, bs, k)
    if e:
        assert stride(e[0][0], F32, bs, k) == ld32, x
    written = hilo_tma.Out(*(addr[(c, f)] if f in forms else None
                             for f in hilo_tma.FORMS))
    neg = x.epi == hilo_tma.NEG_ACC
    prm = hilo_tma.Params(
        addr[(left, HI)], addr[(left, LO)], addr[(right, HI)],
        addr[(right, LO)], addr[(e[0][0], F32)] if e else None,
        hilo_tma.Out() if neg else written, written if neg else
        hilo_tma.Out(), n, ld32, hilo_tma.slice_stride(n), cb, x.epi)
    prm.m, prm.k = m, depth
    prm.l_ld16 = stride(left, HI, bs, k)
    prm.r_ld16 = stride(right, HI, bs, k)
    prm.l_blocks = prm.r_blocks = cb
    prm.l_t, prm.r_t = int(x.lt), int(x.rt)
    return prm


def _solve_args(kind: str, j0: int, op: dict, cb: int, k: int, bs: int,
                inv_c: float, zs=(None, None, 0)) -> tuple:
    """``(C entry, its arguments but the stream)`` of one launch of the
    solve on ``op`` (name -> (address, block stride, row stride));
    ``zs``: where the last launch (slab, back) stores Z's slices (hi, lo,
    row stride; nulls: not stored)."""
    s, lds = op["s"][0], op["s"][2]
    y, z, ldy = op["y"][0], op["z"][0], op["y"][2]
    if kind == "slab":
        return "smw_update_solve_slab", (s, lds, y, z, ldy, cb, k, bs, inv_c,
                                         *zs)
    if kind == "panel":
        return "smw_update_lu_panel", (s, lds, op["piv"][0], op["piv"][1],
                                       cb, k, j0, inv_c)
    if kind == "update":
        return "smw_update_lu_update", (s, lds, y, z, ldy, op["piv"][0],
                                        op["piv"][1], cb, k, bs, j0, inv_c)
    return "smw_update_lu_back", (s, lds, z, ldy, cb, k, bs, *zs)


def _solve_step(kind: str, j0: int, op: dict, cb: int, k: int, bs: int,
                inv_c: float, stream, key: str) -> None:
    entry, args = _solve_args(kind, j0, op, cb, k, bs, inv_c)
    LIB.launch(entry, *args, stream, key=key)


def solve(s: torch.Tensor, y: torch.Tensor, inv_c: float,
          kind: str = "lu") -> torch.Tensor:
    """``Z = (S + I/c)^-1 Y`` for (N, k, k) ``s`` and (N, k, bs) ``y``,
    fp32 CUDA, k and bs up to 1024, by the large route's solve kernels
    alone on the current stream: ``"lu"``, the blocked LU (any k; the
    route takes it above 128), or ``"slab"`` (k <= 128). ``s`` is
    copied first (the LU factors its copy). Launches are counted under
    the key ``solve_{kind}_k{k}``."""
    if not (s.is_cuda and y.is_cuda) or s.dtype != torch.float32 \
            or y.dtype != torch.float32:
        raise ValueError("smw_update.solve takes fp32 CUDA tensors")
    n, k, bs = y.shape
    if tuple(s.shape) != (n, k, k) or not 1 <= bs <= MAX_N \
            or not 1 <= k <= (ONE_CTA_N if kind == "slab" else MAX_N):
        raise ValueError(f"smw_update.solve ({kind}): s {tuple(s.shape)}, "
                         f"y {tuple(y.shape)}")
    lds, ldy = hilo_tma.row_stride(k), hilo_tma.row_stride(bs)
    sw = torch.zeros(n, k, lds, dtype=torch.float32, device=s.device)
    sw[..., :k] = s
    yw = torch.zeros(n, k, ldy, dtype=torch.float32, device=s.device)
    yw[..., :bs] = y
    zw = torch.empty_like(yw)
    piv = torch.empty(n, lds, dtype=torch.int32, device=s.device)
    op = {"s": (sw.data_ptr(), k * lds, lds),
          "y": (yw.data_ptr(), k * ldy, ldy),
          "z": (zw.data_ptr(), k * ldy, ldy),
          "piv": (piv.data_ptr(), lds, lds)}
    steps = [("slab", 0)] if kind == "slab" else \
        [(kd, j0) for kd, j0, _ in lu_schedule(k)]
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        for kd, j0 in steps:
            _solve_step(kd, j0, op, n, k, bs, inv_c, stream,
                        f"solve_{kind}_k{k}")
    return zw[..., :bs]


def route_stages(inv: torch.Tensor, v: torch.Tensor, *, decay: float,
                 cscale: float) -> dict:
    """The large route's intermediates on (N, bs, bs) ``inv`` and (N, k,
    bs) ``v`` in one chunk (N within :func:`smw_plan`'s first): ``y``,
    ``s`` (before the solve, without 1/c), ``z`` and ``out``, fp32
    copies, for checks of where its rounding goes."""
    _check(inv, v)
    n, k, bs = v.shape
    if max(bs, k) <= ONE_CTA_N or smw_plan(n, bs, k)[0] != (0, n):
        raise ValueError("route_stages takes one chunk of the large route")
    inv_decay, inv_c = smw_scalars(decay, cscale)
    out = torch.empty_like(inv)
    ws = torch.empty(n * block_bytes(bs, k), dtype=torch.uint8,
                     device=v.device)
    addr = _addresses(inv, v, out, ws.data_ptr(), 0, n)
    shapes = buffer_shapes(bs, k)

    def view(name):
        (r, c), ld = shapes[name], stride(name, F32, bs, k)
        off = addr[(name, F32)] - ws.data_ptr()
        return ws[off:off + 4 * n * r * ld].view(torch.float32).view(
            n, r, ld)[..., :c].clone()

    steps = smw_schedule(k)
    first = next(i for i, st in enumerate(steps) if st.kind == SOLVE)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        key = launch_key(bs, k)
        _run(steps[:first], addr, n, k, bs, inv_decay, inv_c, stream, key)
        got = {"y": view("y"), "s": view("s")}
        _run(steps[first:], addr, n, k, bs, inv_decay, inv_c, stream, key)
        got.update(z=view("z"), out=out)
    return got
