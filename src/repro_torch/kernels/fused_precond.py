"""Pooled two-sided WU on Hopper: wrapper of ``csrc/fused_precond.cu``.

Replaces the Pallas TPU kernel ``repro.kernels.fused_precond``: per
gradient tile, ``out = hilo(hilo(A_inv, g), G_inv)`` with the
intermediate kept on chip, and the tile's trust-region dot
``sum(out * g)`` from the same pass. With index arrays the inverse
blocks are read from their pools (tile t uses ``a_inv[a_src[t]]`` and
``g_inv[g_src[t]]``), so the caller never gathers a copy per tile. The
CUDA source states what bounds it and how the design answers that. The
plain version is :func:`repro_torch.kernels.ref.fused_precond_ref`.

Tiles with both sides at most :data:`ONE_CTA_B` (128) take the one-CTA
kernel, one launch a call. A side of 129..:data:`MAX_B` (1024, the
reference's limit) takes the large route, :func:`wu_schedule`'s launches
on ``csrc/hilo_tma.cuh``'s batched product (TMA and wgmma, operands stored
as bf16 hi/lo slices by the kernel that writes them): once a call each
distinct inverse pool split into its slices; then per chunk of tiles
(:func:`wu_chunks`) the chunk's g split, ``tmp = hilo(A_inv, g)`` stored
as its slices, ``out = hilo(tmp, G_inv)`` with each (tile, warpgroup)'s
partial dot, and a kernel that sums the partials in order, the pools
still read by index.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import hilo_tma
from repro_torch.kernels.build import CudaLibrary
from repro_torch.kernels.hilo_tma import F32, HI, LO

#: largest tile side the kernels take (the reference's limit)
MAX_B = hilo_tma.MAX_SIDE
#: largest tile side of the one-CTA route
ONE_CTA_B = 128

_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = CudaLibrary("fused_precond", "fused_precond.cu", {
    "fused_precond_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "fused_precond_split": [_P, ctypes.c_longlong, _I, _I, _P, _P, _I, _P],
    "fused_precond_product": [ctypes.POINTER(hilo_tma.Params), _P],
    "fused_precond_dots": [_P, _I, _P, _I, _P]})

#: the large route's buffers: the caller's tensors (fp32), the pools'
#: slices (made once a call) and a chunk's workspace
A_INV, G_INV, G, OUT, DOTS = "a_inv", "g_inv", "g", "out", "dots"
A_SLICES, G_SLICES = "a_slices", "g_inv_slices"
G_SLICED, TMP, PART = "g_slices", "tmp", "part"
CALLER = (A_INV, G_INV, G, OUT, DOTS)
POOL_SLICES = (A_SLICES, G_SLICES)
CHUNK = (G_SLICED, TMP, PART)
#: the large route's kernels
SPLIT, PRODUCT, SUM = "split", "product", "sum"
SLICES = (HI, LO)


class Launch(NamedTuple):
    """One kernel of the large route: its kind, the ``(buffer, forms)`` it
    reads (a product: left, right, then E) and writes, and for a product
    its epilogue (``hilo_tma`` STORE or DOT) and the index array each
    operand is read through (``"a_src"``, ``"g_src"``, or None: block b of
    the chunk)."""

    kind: str
    reads: tuple
    writes: tuple
    epi: int | None = None
    index: tuple = (None, None)


class WuSchedule(NamedTuple):
    """The large route of one call on (n_tiles, bi, bo) tiles and pools of
    ``pool_blocks`` blocks: the pool splits (once a call), the ``(t0,
    t1)`` chunks of tiles and each chunk's launches in order, the
    workspace of the pools' slices and of the largest chunk in bytes, and
    (:attr:`floor_bytes`) the bytes floor of the call."""

    pools: tuple
    chunks: tuple
    per_chunk: tuple
    pool_bytes: int
    chunk_bytes: int
    shape: tuple
    pool_blocks: tuple

    @property
    def floor_bytes(self) -> int:
        """Each kernel's inputs read once and outputs written once (fp32
        4 bytes an entry, a slice 2; rows x cols entries a block, not the
        strides' padding), each pool's slices read once a call however
        many tiles read them, each index array once (see
        :func:`wu_schedule`)."""
        n, bi, bo = self.shape
        na, ng = self.pool_blocks
        blocks = {A_INV: na, A_SLICES: na, G_INV: ng, G_SLICES: ng}

        def size(buf, forms):
            rows, cols = geometry(buf, bi, bo)
            return blocks.get(buf, n) * rows * cols * sum(
                hilo_tma.itemsize(f) for f in forms)

        launches = self.pools + self.per_chunk
        return sum(size(b, f) for x in launches
                   for b, f in x.reads + x.writes) + \
            4 * n * sum(i is not None for x in self.per_chunk
                        for i in x.index)


def partials(bi: int, bo: int) -> int:
    """Partial dots a tile: two (one a consumer warpgroup) for each
    output tile of the second product."""
    return 2 * hilo_tma.tiles_of(bi, bo)


def geometry(buf: str, bi: int, bo: int) -> tuple:
    """``(rows, cols)`` of one block of ``buf`` (PART: a tile's
    partials as one row; DOTS: one entry)."""
    if buf in (A_INV, A_SLICES):
        return bi, bi
    if buf in (G_INV, G_SLICES):
        return bo, bo
    if buf == PART:
        return 1, partials(bi, bo)
    if buf == DOTS:
        return 1, 1
    return bi, bo


def tile_bytes(bi: int, bo: int) -> int:
    """Chunk workspace a tile: g's and tmp's slices (rows
    ``hilo_tma.slice_stride(bo)`` apart) and its partial dots."""
    return 2 * 4 * bi * hilo_tma.slice_stride(bo) + 4 * partials(bi, bo)


def wu_chunks(n_tiles: int, bi: int, bo: int,
              budget: int = hilo_tma.WORKSPACE_BYTES) -> list:
    """The large route's ``(t0, t1)`` chunks of tiles: each chunk's
    workspace (:func:`tile_bytes` a tile) stays under ``budget``."""
    return hilo_tma.chunks(n_tiles, tile_bytes(bi, bo), budget)


def wu_schedule(n_tiles: int, bi: int, bo: int, pool_blocks=None,
                shared: bool = False) -> WuSchedule:
    """The large route's launches for (n_tiles, bi, bo) tiles, as a pure
    function. ``pool_blocks = (na, ng)``: the inverses are pools of that
    many blocks read through ``a_src``/``g_src``; None: the gathered form,
    block t of each (``shared`` is then False). ``shared``: ``a_inv`` and
    ``g_inv`` are one tensor, split once.

    * once a call, each pool into its slices (rows
      ``hilo_tma.slice_stride`` apart);
    * per chunk: g's split; ``tmp = hilo(A, g)``, stored as its slices
      only (no fp32 ``tmp`` is written); ``out = hilo(tmp, G)`` in fp32
      into the caller's out with the partial dots (E: the caller's g);
      the dots, each tile's partials summed in order.

    Its bytes floor (``floor_bytes``) is 28 bytes an entry of g, 12 an
    entry of a pool (16 of a shared one, read as both sides), 4 an index,
    8 a partial dot and 4 a dot."""
    indexed = pool_blocks is not None
    na, ng = pool_blocks if indexed else (n_tiles, n_tiles)
    if shared and (not indexed or bi != bo or na != ng):
        raise ValueError("a shared pool takes indexed tiles with bi == bo")
    g_pool = A_SLICES if shared else G_SLICES
    pools = [Launch(SPLIT, ((A_INV, (F32,)),), ((A_SLICES, SLICES),))]
    if not shared:
        pools.append(Launch(SPLIT, ((G_INV, (F32,)),),
                            ((G_SLICES, SLICES),)))
    a_idx, g_idx = ("a_src", "g_src") if indexed else (None, None)
    per_chunk = (
        Launch(SPLIT, ((G, (F32,)),), ((G_SLICED, SLICES),)),
        Launch(PRODUCT, ((A_SLICES, SLICES), (G_SLICED, SLICES)),
               ((TMP, SLICES),), hilo_tma.STORE, (a_idx, None)),
        Launch(PRODUCT, ((TMP, SLICES), (g_pool, SLICES), (G, (F32,))),
               ((OUT, (F32,)), (PART, (F32,))), hilo_tma.DOT,
               (None, g_idx)),
        Launch(SUM, ((PART, (F32,)),), ((DOTS, (F32,)),)))
    ss = hilo_tma.slice_stride
    pool_bytes = 4 * (na * bi * ss(bi) + (0 if shared else ng * bo * ss(bo)))
    parts = tuple(wu_chunks(n_tiles, bi, bo))
    most = max((t1 - t0 for t0, t1 in parts), default=0)
    return WuSchedule(tuple(pools), parts, per_chunk, pool_bytes,
                      most * tile_bytes(bi, bo), (n_tiles, bi, bo),
                      (na, ng))


def expected_launches(n_tiles: int, bi: int, bo: int,
                      shared: bool = False) -> int:
    """Launches of one :func:`fused_precond` call on (n_tiles, bi, bo);
    ``shared``: ``a_inv`` is ``g_inv`` (a WU group with bi == bo, whose
    sides share one pool), split once."""
    if n_tiles == 0:
        return 0
    if max(bi, bo) <= ONE_CTA_B:
        return 1
    sched = wu_schedule(n_tiles, bi, bo,
                        (1, 1) if shared else None, shared)
    return len(sched.pools) + len(sched.per_chunk) * len(sched.chunks)


def check_indices(a_inv: torch.Tensor, g_inv: torch.Tensor, n: int,
                  a_src, g_src) -> None:
    """Raise unless ``a_src``/``g_src`` are both None or both int32 (n,)
    tensors on the operands' device. The range is checked only for CPU
    tensors: on the card that would read the indices back (a device
    sync), so callers check it where the indices are still on the host
    (``solve.partition.make_wu_plan``)."""
    if a_src is None and g_src is None:
        return
    if a_src is None or g_src is None:
        raise ValueError("fused_precond takes both a_src and g_src or "
                         "neither")
    for name, idx, pool in (("a_src", a_src, a_inv), ("g_src", g_src, g_inv)):
        if idx.dtype != torch.int32:
            raise ValueError(f"fused_precond {name} must be int32, got "
                             f"{idx.dtype}")
        if tuple(idx.shape) != (n,):
            raise ValueError(f"fused_precond {name} must have shape ({n},) "
                             f"(one index a tile), got {tuple(idx.shape)}")
        if idx.device != pool.device:
            raise ValueError(f"fused_precond {name} is on {idx.device}, its "
                             f"pool on {pool.device}")
        if idx.device.type == "cpu" and n and (
                int(idx.min()) < 0 or int(idx.max()) >= pool.shape[0]):
            raise ValueError(f"fused_precond {name} indexes outside its pool "
                             f"of {pool.shape[0]} blocks")


def fused_precond(a_inv: torch.Tensor, g: torch.Tensor, g_inv: torch.Tensor,
                  a_src: torch.Tensor | None = None,
                  g_src: torch.Tensor | None = None):
    """``(out, dots)`` for (N, bi, bo) fp32 CUDA gradient tiles, bi, bo <=
    1024: (N, bi, bo) preconditioned tiles and (N,) per-tile
    ``sum(out * g)``. Without indices ``a_inv`` and ``g_inv`` are the
    per-tile (N, bi, bi) and (N, bo, bo) blocks; with int32 (N,)
    ``a_src``/``g_src`` they are pools (Ma, bi, bi) and (Mg, bo, bo),
    indexed per tile (any order, repeats allowed, in range)."""
    for name, t in (("a_inv", a_inv), ("g", g), ("g_inv", g_inv)):
        if not t.is_cuda:
            raise ValueError(f"fused_precond kernel needs CUDA tensors; "
                             f"{name} is on {t.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"fused_precond kernel takes float32; {name} "
                             f"is {t.dtype}")
        if t.ndim != 3:
            raise ValueError(f"fused_precond takes 3-d tile stacks; {name} "
                             f"has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"fused_precond kernel needs contiguous "
                             f"tensors; {name} is not")
    n, bi, bo = g.shape
    indexed = a_src is not None or g_src is not None
    na, ng = (a_inv.shape[0], g_inv.shape[0]) if indexed else (n, n)
    if tuple(a_inv.shape) != (na, bi, bi) or \
            tuple(g_inv.shape) != (ng, bo, bo):
        raise ValueError(
            f"fused_precond shapes disagree: a_inv {tuple(a_inv.shape)}, "
            f"g {tuple(g.shape)}, g_inv {tuple(g_inv.shape)}")
    if bi > MAX_B or bo > MAX_B:
        raise ValueError(f"fused_precond kernel takes tiles of at most "
                         f"{MAX_B} x {MAX_B} (the reference's limit), got "
                         f"{bi} x {bo}")
    if not (a_inv.device == g.device == g_inv.device):
        raise ValueError("fused_precond operands are on different devices")
    check_indices(a_inv, g_inv, n, a_src, g_src)
    if indexed and not (a_src.is_contiguous() and g_src.is_contiguous()):
        raise ValueError("fused_precond kernel needs contiguous indices")
    out = torch.empty_like(g)
    dots = torch.empty((n,), dtype=torch.float32, device=g.device)
    if n == 0:
        return out, dots
    key = f"{bi}x{bo}"
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if max(bi, bo) > ONE_CTA_B:
            _large(a_inv, g, g_inv, a_src if indexed else None,
                   g_src if indexed else None, out, dots, stream, key)
            return out, dots
        LIB.launch("fused_precond_launch", a_inv.data_ptr(), g.data_ptr(),
                   g_inv.data_ptr(),
                   a_src.data_ptr() if indexed else None,
                   g_src.data_ptr() if indexed else None,
                   out.data_ptr(), dots.data_ptr(), n, bi, bo, stream,
                   key=key)
    return out, dots


def workspace(base: int, layout, bi: int, bo: int) -> dict:
    """``{(buffer, form): device address}`` for ``layout``, a sequence of
    ``(buffer, blocks)``: each buffer's forms (PART fp32, the others their
    two slices at rows ``hilo_tma.slice_stride`` apart), one array after
    the other from ``base``, each a multiple of 16 bytes but PART's."""
    addr, off = {}, base
    for buf, nb in layout:
        rows, cols = geometry(buf, bi, bo)
        for f in (F32,) if buf == PART else SLICES:
            addr[(buf, f)] = off
            ld = cols if f == F32 else hilo_tma.slice_stride(cols)
            off += nb * rows * ld * hilo_tma.itemsize(f)
    return addr


def _large(a_inv, g, g_inv, a_src, g_src, out, dots, stream, key) -> None:
    """The large route, :func:`wu_schedule`'s launches on ``stream``, its
    workspace (the pools' slices, then the chunk's arrays, laid out for
    the largest chunk) one allocation on it (the current stream)."""
    n, bi, bo = g.shape
    indexed = a_src is not None
    shared = indexed and a_inv is g_inv
    na, ng = a_inv.shape[0], g_inv.shape[0]
    sched = wu_schedule(n, bi, bo, (na, ng) if indexed else None, shared)
    ws = torch.empty(sched.pool_bytes + sched.chunk_bytes,
                     dtype=torch.uint8, device=g.device)
    most = max(t1 - t0 for t0, t1 in sched.chunks)
    pools = ((A_SLICES, na),) if shared else ((A_SLICES, na), (G_SLICES, ng))
    addr = workspace(ws.data_ptr(), pools, bi, bo)
    addr.update(workspace(ws.data_ptr() + sched.pool_bytes,
                          [(b, most) for b in CHUNK], bi, bo))
    geo = {b: geometry(b, bi, bo) for b in CALLER + POOL_SLICES + CHUNK}
    fp32 = {A_INV: a_inv, G_INV: g_inv, G: g, OUT: out, DOTS: dots}
    index = {"a_src": a_src, "g_src": g_src}
    ss = hilo_tma.slice_stride
    for x in sched.pools:
        (src, _), = x.reads
        (dst, _), = x.writes
        rows, cols = geo[src]
        LIB.launch("fused_precond_split", fp32[src].data_ptr(),
                   fp32[src].shape[0], rows, cols, addr[(dst, HI)],
                   addr[(dst, LO)], ss(cols), stream, key=key)
    for t0, t1 in sched.chunks:
        nt = t1 - t0

        def ptr(buf, form):
            """``buf``'s form for the chunk's first tile."""
            rows, cols = geo[buf]
            if buf in fp32:
                return hilo_tma.elem_ptr(fp32[buf], t0 * rows * cols)
            if buf in POOL_SLICES and not indexed:
                return addr[(buf, form)] + 2 * t0 * rows * ss(cols)
            return addr[(buf, form)]

        for x in sched.per_chunk:
            if x.kind == SPLIT:
                (src, _), = x.reads
                (dst, _), = x.writes
                rows, cols = geo[src]
                LIB.launch("fused_precond_split", ptr(src, F32), nt, rows,
                           cols, ptr(dst, HI), ptr(dst, LO), ss(cols),
                           stream, key=key)
            elif x.kind == PRODUCT:
                prm = _product(x, ptr, geo, index, t0, nt,
                               {A_SLICES: na, G_SLICES: ng})
                LIB.launch("fused_precond_product", ctypes.byref(prm),
                           stream, key=key)
            else:
                LIB.launch("fused_precond_dots", ptr(PART, F32),
                           geo[PART][1], ptr(DOTS, F32), nt, stream,
                           key=key)


def _product(x: Launch, ptr, geo: dict, index: dict, t0: int, nt: int,
             pool_blocks: dict) -> hilo_tma.Params:
    """One product of :func:`wu_schedule` as ``hilo_tma.Params``: the
    left m x k and right k x n operands' slices, each through its index
    array (from the chunk's first tile on, over the pool's
    ``pool_blocks``) where it has one, else the chunk's ``nt`` blocks,
    C's forms, E, and the partials of DOT (``geo``: each buffer's
    :func:`geometry`)."""
    (left, _), (right, _), *e = x.reads
    (c, c_forms), *part = x.writes
    m, k = geo[left]
    n = geo[right][1]
    ss = hilo_tma.slice_stride
    idx = [None if i is None else index[i].data_ptr() + 4 * t0
           for i in x.index]
    prm = hilo_tma.Params(
        ptr(left, HI), ptr(left, LO), ptr(right, HI), ptr(right, LO),
        ptr(e[0][0], F32) if e else None,
        hilo_tma.Out(*(ptr(c, f) if f in c_forms else None
                       for f in hilo_tma.FORMS)),
        hilo_tma.Out(), n, n, ss(n), nt, x.epi)
    prm.m, prm.k, prm.l_ld16, prm.r_ld16 = m, k, ss(k), ss(n)
    prm.l_blocks = pool_blocks[left] if idx[0] else nt
    prm.r_blocks = pool_blocks[right] if idx[1] else nt
    prm.l_idx, prm.r_idx = idx
    if part:
        prm.part = ptr(PART, F32)
    return prm
