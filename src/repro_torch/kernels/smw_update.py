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
  ``hilo_bmm.WORKSPACE_BYTES``), with M, Y, S and Z in a workspace
  allocated here on the launches' stream: the symmetrisation, two batched
  hi/lo products of ``csrc/hilo_bmm.cuh``, the solve (a slab kernel for
  k <= 128; above, a blocked LU with partial pivoting, two launches a
  panel of :data:`PANEL` columns and a back substitution,
  ``csrc/lu_blocked.cuh``) and the correction's product, which writes the
  output.

The CUDA source states what bounds each route and how its design answers
that. Unlike the TPU kernel, k and bs are not padded to 128. The plain
version is :func:`repro_torch.kernels.ref.smw_update_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import hilo_bmm
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.ref import smw_scalars

#: largest block side and rank the kernels take (the reference's limit)
MAX_N = hilo_bmm.MAX_SIDE
#: largest block side and rank of the one-CTA route
ONE_CTA_N = 128
#: columns of one panel of the blocked LU (k above :data:`ONE_CTA_N`)
PANEL = 32
#: workspace buffers of the large route, per block: M (bs x bs), Y (k x
#: bs), S (k x k), Z (k x bs), rows ``hilo_bmm.row_stride`` apart, and
#: above k 128 the LU's row sources (k int32)
BUFFERS = ("m", "y", "s", "z", "piv")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LIB = CudaLibrary("smw_update", "smw_update.cu", {
    "smw_update_launch": [_P, _P, _P, _I, _I, _I, _F, _F, _P],
    "smw_update_prep": [_P, _P, _I, _I, _I, _F, _P],
    "smw_update_product": [ctypes.POINTER(hilo_bmm.Params), _I, _I, _I, _I,
                           _P],
    "smw_update_solve_slab": [_P, _I, _P, _P, _I, _I, _I, _I, _F, _P],
    "smw_update_lu_panel": [_P, _I, _P, _I, _I, _I, _I, _F, _P],
    "smw_update_lu_update": [_P, _I, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                             _F, _P],
    "smw_update_lu_back": [_P, _I, _P, _I, _I, _I, _I, _P]})


def buffer_shapes(bs: int, k: int) -> dict:
    """(rows, columns) of one block of each operand: the caller's
    ``inv``, ``v`` and ``out`` and the workspace's :data:`BUFFERS` (the
    row sources ``piv`` only above k 128, where the LU runs)."""
    return {"inv": (bs, bs), "v": (k, bs), "out": (bs, bs), "m": (bs, bs),
            "y": (k, bs), "s": (k, k), "z": (k, bs),
            "piv": (int(k > ONE_CTA_N), k)}


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


def smw_schedule(k: int) -> list:
    """The large route's kernels, in order, over the names of
    :func:`buffer_shapes`, the arithmetic of
    :func:`repro_torch.kernels.ref.smw_update_ref` step by step:

    * ``("prep", src, dst)``: ``M = (inv + inv^T) * (0.5/decay)``;
    * ``("product", mode, epi, L, lt, R, rt, C, E)``: ``C = epi(hilo(op(L),
      op(R)))`` (``hilo_bmm`` modes and epilogues; ``lt``/``rt`` read the
      operand transposed; E only where the epilogue reads it):
      ``Y = hilo(V, M)``, ``S = hilo(Y, V^T)``, ``out = M - hilo(Y^T, Z)``;
    * ``("solve", kind, j0, j1, reads, writes)``: the launches of
      ``Z = (S + I/c)^-1 Y`` (the diagonal term added as ``acc + 1/c``),
      with the buffers each reads and writes: for k <= 128 one ``"slab"``
      (S and a slab of Y's columns in one CTA's shared memory); above, the
      blocked LU of :func:`lu_schedule` (S factored in place, Z made from
      Y by the first panel's update)."""
    fl, st, sub = hilo_bmm.FULL, hilo_bmm.STORE, hilo_bmm.SUB
    if k <= ONE_CTA_N:
        solve = [("solve", "slab", 0, k, ("s", "y"), ("z",))]
    else:
        solve = []
        for kind, j0, j1 in lu_schedule(k):
            reads, writes = {"panel": (("s",), ("s", "piv")),
                             "update": (("s", "piv", "z" if j0 else "y"),
                                        ("s", "z")),
                             "back": (("s", "z"), ("z",))}[kind]
            solve.append(("solve", kind, j0, j1, reads, writes))
    return [("prep", "inv", "m"),
            ("product", fl, st, "v", False, "m", False, "y", None),
            ("product", fl, st, "y", False, "v", True, "s", None),
            *solve,
            ("product", fl, sub, "y", True, "z", False, "out", "m")]


def block_bytes(bs: int, k: int) -> int:
    """Workspace bytes of one block on the large route (4 a float or an
    int32)."""
    shapes = buffer_shapes(bs, k)
    return 4 * sum(shapes[b][0] * hilo_bmm.row_stride(shapes[b][1])
                   for b in BUFFERS)


def smw_plan(nb: int, bs: int, k: int,
             budget: int = hilo_bmm.WORKSPACE_BYTES) -> list:
    """The large route's ``(b0, b1)`` chunks of blocks: each chunk's
    workspace (:func:`block_bytes` a block) stays under ``budget``."""
    return hilo_bmm.chunks(nb, block_bytes(bs, k), budget)


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
    ws = torch.empty(max(b1 - b0 for b0, b1 in parts)
                     * block_bytes(bs, k) // 4, dtype=torch.float32,
                     device=v.device)
    for b0, b1 in parts:
        op = _operands(inv, v, out, ws, b0, b1)
        _run(smw_schedule(k), op, b1 - b0, k, bs, inv_decay, inv_c, stream,
             key)


def _operands(inv, v, out, ws, b0: int, b1: int) -> dict:
    """name -> (address, block stride, row stride) of every operand of
    the chunk ``[b0, b1)``, strides in elements, the workspace's buffers
    one after another in ``ws``."""
    n, k, bs = v.shape
    shapes = buffer_shapes(bs, k)
    op = {name: (hilo_bmm.elem_ptr(t, b0 * t.shape[1] * t.shape[2]),
                 t.shape[1] * t.shape[2], t.shape[2])
          for name, t in (("inv", inv), ("v", v), ("out", out))}
    off = 0
    for name in BUFFERS:
        rows, ld = shapes[name][0], hilo_bmm.row_stride(shapes[name][1])
        op[name] = (hilo_bmm.elem_ptr(ws, off), rows * ld, ld)
        off += (b1 - b0) * rows * ld
    return op


def _run(steps, op: dict, cb: int, k: int, bs: int, inv_decay: float,
         inv_c: float, stream, key: str) -> None:
    """Enqueue ``steps`` (:func:`smw_schedule`'s) on ``cb`` blocks."""
    shapes = buffer_shapes(bs, k)

    def dims(name, transposed):
        r, c = shapes[name]
        return (c, r) if transposed else (r, c)

    for step in steps:
        if step[0] == "prep":
            _, src, dst = step
            LIB.launch("smw_update_prep", op[src][0], op[dst][0], cb, bs,
                       op[dst][2], inv_decay, stream, key=key)
        elif step[0] == "product":
            _, mode, epi, lft, lt, rgt, rt, c, e = step
            m_rows, depth = dims(lft, lt)
            _, n_cols = dims(rgt, rt)
            ext = dict(e=op[e][0], e_stride=op[e][1], lde=op[e][2]) \
                if e else {}
            p = hilo_bmm.params(hilo_bmm.operand(*op[lft]),
                                hilo_bmm.operand(*op[rgt]), *op[c],
                                m_rows, n_cols, depth, cb, **ext)
            LIB.launch("smw_update_product", ctypes.byref(p), mode, epi,
                       int(lt), int(rt), stream, key=key)
        else:
            _solve_step(step[1], step[2], op, cb, k, bs, inv_c, stream, key)


def _solve_step(kind: str, j0: int, op: dict, cb: int, k: int, bs: int,
                inv_c: float, stream, key: str) -> None:
    s, lds = op["s"][0], op["s"][2]
    y, z, ldy = op["y"][0], op["z"][0], op["y"][2]
    if kind == "slab":
        LIB.launch("smw_update_solve_slab", s, lds, y, z, ldy, cb, k, bs,
                   inv_c, stream, key=key)
    elif kind == "panel":
        LIB.launch("smw_update_lu_panel", s, lds, op["piv"][0],
                   op["piv"][1], cb, k, j0, inv_c, stream, key=key)
    elif kind == "update":
        LIB.launch("smw_update_lu_update", s, lds, y, z, ldy, op["piv"][0],
                   op["piv"][1], cb, k, bs, j0, inv_c, stream, key=key)
    else:
        LIB.launch("smw_update_lu_back", s, lds, z, ldy, cb, k, bs, stream,
                   key=key)


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
    lds, ldy = hilo_bmm.row_stride(k), hilo_bmm.row_stride(bs)
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
    ws = torch.empty(n * block_bytes(bs, k) // 4, dtype=torch.float32,
                     device=v.device)
    op = _operands(inv, v, out, ws, 0, n)
    shapes = buffer_shapes(bs, k)

    def view(name):
        r, c = shapes[name]
        off = (op[name][0] - ws.data_ptr()) // 4
        ld = op[name][2]
        return ws[off:off + n * r * ld].view(n, r, ld)[..., :c].clone()

    steps = smw_schedule(k)
    first = next(i for i, st in enumerate(steps) if st[0] == "solve")
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        key = launch_key(bs, k)
        _run(steps[:first], op, n, k, bs, inv_decay, inv_c, stream, key)
        got = {"y": view("y"), "s": view("s")}
        _run(steps[first:], op, n, k, bs, inv_decay, inv_c, stream, key)
        got.update(z=view("z"), out=out)
    return got
