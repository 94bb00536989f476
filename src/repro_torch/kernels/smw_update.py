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
  k <= 128, an LU in the workspace above) and the correction's product,
  which writes the output.

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
#: workspace buffers of the large route, per block: M (bs x bs), Y (k x
#: bs), S (k x k), Z (k x bs), rows ``hilo_bmm.row_stride`` apart
BUFFERS = ("m", "y", "s", "z")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SOLVE = [_P, _I, _P, _P, _I, _I, _I, _I, _F, _P]
LIB = CudaLibrary("smw_update", "smw_update.cu", {
    "smw_update_launch": [_P, _P, _P, _I, _I, _I, _F, _F, _P],
    "smw_update_prep": [_P, _P, _I, _I, _I, _F, _P],
    "smw_update_product": [ctypes.POINTER(hilo_bmm.Params), _I, _I, _I, _I,
                           _P],
    "smw_update_solve_slab": _SOLVE,
    "smw_update_solve_lu": _SOLVE})


def buffer_shapes(bs: int, k: int) -> dict:
    """(rows, columns) of one block of each operand: the caller's
    ``inv``, ``v`` and ``out`` and the workspace's :data:`BUFFERS`."""
    return {"inv": (bs, bs), "v": (k, bs), "out": (bs, bs), "m": (bs, bs),
            "y": (k, bs), "s": (k, k), "z": (k, bs)}


def smw_schedule(k: int) -> list:
    """The large route's kernels, in order, over the names of
    :func:`buffer_shapes`, the arithmetic of
    :func:`repro_torch.kernels.ref.smw_update_ref` step by step:

    * ``("prep", src, dst)``: ``M = (inv + inv^T) * (0.5/decay)``;
    * ``("product", mode, epi, L, lt, R, rt, C, E)``: ``C = epi(hilo(op(L),
      op(R)))`` (``hilo_bmm`` modes and epilogues; ``lt``/``rt`` read the
      operand transposed; E only where the epilogue reads it):
      ``Y = hilo(V, M)``, ``S = hilo(Y, V^T)``, ``out = M - hilo(Y^T, Z)``;
    * ``("solve", kind, S, Y, Z)``: ``Z = (S + I/c)^-1 Y``, the diagonal
      term added as ``acc + 1/c``; ``kind`` "slab" for k <= 128 (S and a
      slab of Y's columns in one CTA's shared memory), "lu" above (S
      factored in place in the workspace)."""
    fl, st, sub = hilo_bmm.FULL, hilo_bmm.STORE, hilo_bmm.SUB
    return [("prep", "inv", "m"),
            ("product", fl, st, "v", False, "m", False, "y", None),
            ("product", fl, st, "y", False, "v", True, "s", None),
            ("solve", "slab" if k <= ONE_CTA_N else "lu", "s", "y", "z"),
            ("product", fl, sub, "y", True, "z", False, "out", "m")]


def block_bytes(bs: int, k: int) -> int:
    """Workspace bytes of one block on the large route."""
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
    shapes = buffer_shapes(bs, k)
    ld = {b: hilo_bmm.row_stride(shapes[b][1]) for b in BUFFERS}
    parts = smw_plan(n, bs, k)
    ws = torch.empty(max(b1 - b0 for b0, b1 in parts)
                     * block_bytes(bs, k) // 4, dtype=torch.float32,
                     device=v.device)

    def dims(name, transposed):
        r, c = shapes[name]
        return (c, r) if transposed else (r, c)

    for b0, b1 in parts:
        cb = b1 - b0
        # name -> (address, block stride, row stride), in floats
        op = {name: (hilo_bmm.elem_ptr(t, b0 * t.shape[1] * t.shape[2]),
                     t.shape[1] * t.shape[2], t.shape[2])
              for name, t in (("inv", inv), ("v", v), ("out", out))}
        off = 0
        for name in BUFFERS:
            rows = shapes[name][0]
            op[name] = (hilo_bmm.elem_ptr(ws, off), rows * ld[name],
                        ld[name])
            off += cb * rows * ld[name]
        for step in smw_schedule(k):
            if step[0] == "prep":
                _, src, dst = step
                LIB.launch("smw_update_prep", op[src][0], op[dst][0], cb,
                           bs, op[dst][2], inv_decay, stream, key=key)
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
                _, kind, s, y, z = step
                LIB.launch(f"smw_update_solve_{kind}", op[s][0], op[s][2],
                           op[y][0], op[z][0], op[y][2], cb, k, bs, inv_c,
                           stream, key=key)
