"""``fused_precond``'s large route (tiles with a side of 129..1024) on the
CPU: its schedule of launches (``kernels.fused_precond.wu_schedule``) as a
pure function, and two emulations of it held bitwise to the plain
version ``ref.fused_precond_ref``.

The CUDA route itself runs only on the card (tests/test_torch_cuda.py,
``chip_smoke.py`` phase ``large_blocks``). Here:

  * the schedule run by a plain emulation of each kernel, every kernel
    reading only the forms (fp32, bf16 hi and lo slices) stored before it
    and writing only its own: the splits, the two products (the plain
    hi/lo partials of the stored slices), the dots;
  * the wrapper's own launches (``fused_precond._large``) on CPU tensors,
    each kernel emulated from its arguments alone (raw addresses, the
    ``hilo_tma.Params`` it is given, index arrays read from memory), so
    that every pointer, stride, block count and index offset the card
    gets is checked here, over one chunk and several;
  * the forms each launch reads written before it, no launch writing
    what it or a later launch of the chunk reads, the caller's inputs
    never written, the chunks under the workspace budget, and the bytes
    floor as its formula gives it.

Tolerance: none, ``out`` is bitwise the plain version's (the same bf16
partials summed in the same order). The emulated DOT product puts a
tile's whole ``sum(out * g)`` in its first partial and zero in the
others, which the dots kernel adds in order: exact, so ``dots`` is
bitwise the plain version's on the chunk's tiles (the CPU's reduction
over a tile adds in an order that depends on how many tiles the call
has, so over several chunks the plain version is taken chunk by chunk;
the card's partials split the sum by warpgroup, held to the plain
version within 1e-4 in tests/test_torch_cuda.py).
"""

from __future__ import annotations

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import one_thread  # noqa: F401 (autouse)

from repro.kernels import ops as jops
from repro_torch.core.quantize import split_hi_lo_bf16
from repro_torch.kernels import fused_precond as kf
from repro_torch.kernels import hilo_tma
from repro_torch.kernels import ref as tref
from repro_torch.kernels.hilo_tma import F32, HI, LO

SHAPES = [(256, 176), (176, 256), (130, 200), (129, 129)]


def _case(seed, n, bi, bo, indexed):
    """Pools (repeated, out-of-order indices) or per-tile blocks."""
    r = np.random.default_rng(seed)
    na, ng = (3, 4) if indexed else (n, n)
    pa = torch.from_numpy(r.standard_normal((na, bi, bi)).astype(np.float32))
    g = torch.from_numpy(r.standard_normal((n, bi, bo)).astype(np.float32))
    pg = torch.from_numpy(r.standard_normal((ng, bo, bo)).astype(np.float32))
    if not indexed:
        return pa, g, pg, None, None
    a_src = torch.from_numpy(r.integers(0, na, n).astype(np.int32))
    g_src = torch.from_numpy(r.integers(0, ng, n).astype(np.int32))
    return pa, g, pg, a_src, g_src


def _mm(x, y):
    """bf16 x bf16 with fp32 accumulation (the plain version's partial)."""
    return torch.matmul(x.to(torch.float32), y.to(torch.float32))


def _hilo(left, right):
    """The product's three partials, in the plain version's order."""
    (lh, ll), (rh, rl) = left, right
    return _mm(lh, rh) + _mm(lh, rl) + _mm(ll, rh)


def _dot_partials(acc, e, per):
    """The emulated DOT: a tile's whole sum in its first partial."""
    part = torch.zeros(acc.shape[0], per)
    part[:, 0] = (acc * e).sum(dim=(-2, -1))
    return part


def _sum_partials(part):
    """The dots kernel: each tile's partials added in order."""
    s = torch.zeros(part.shape[0])
    for q in range(part.shape[1]):
        s = s + part[:, q]
    return s


# ---------------------------------------------------------------------------
# the schedule, run by a plain emulation of its kernels
# ---------------------------------------------------------------------------

def _store(mem, buf, forms, value):
    """A kernel's write of ``value`` into ``buf`` in ``forms``: the
    buffer's previous forms are gone, the new ones split on store."""
    for key in [k for k in mem if k[0] == buf]:
        del mem[key]
    hi, lo = split_hi_lo_bf16(value)
    for f in forms:
        mem[(buf, f)] = {F32: value, HI: hi, LO: lo}[f]


def _emulate(sched, pa, g, pg, a_src, g_src, shared):
    """The schedule on the CPU: each kernel reads only forms stored
    before it (a form never written, or overwritten, is a KeyError),
    pools through their index arrays (or the chunk's blocks), and writes
    only its own outputs; the chunks' outputs land in out and dots."""
    n, bi, bo = g.shape
    indexed = a_src is not None
    pools = {kf.A_INV: pa, kf.G_INV: pa if shared else pg}
    mem = {(b, F32): v for b, v in pools.items()}
    for x in sched.pools:
        (src, _), = x.reads
        (dst, forms), = x.writes
        _store(mem, dst, forms, mem[(src, F32)])
    out, dots = torch.empty_like(g), torch.empty(n)
    index = {"a_src": a_src, "g_src": g_src}
    for t0, t1 in sched.chunks:
        caller = {kf.G: g[t0:t1]}
        for buf in (kf.OUT, kf.DOTS, *kf.CHUNK):
            for key in [k for k in mem if k[0] == buf]:
                del mem[key]
        mem.update({(b, F32): v for b, v in caller.items()})

        def operand(buf, idx, forms):
            vals = [mem[(buf, f)] for f in forms]
            if idx is not None:
                return [v[index[idx][t0:t1].long()] for v in vals]
            if buf in kf.POOL_SLICES:
                return [v[t0:t1] for v in vals]
            return vals

        for x in sched.per_chunk:
            if x.kind == kf.SPLIT:
                (src, _), = x.reads
                (dst, forms), = x.writes
                _store(mem, dst, forms, mem[(src, F32)])
            elif x.kind == kf.PRODUCT:
                (left, lf), (right, rf), *e = x.reads
                acc = _hilo(operand(left, x.index[0], lf),
                            operand(right, x.index[1], rf))
                (c, c_forms), *rest = x.writes
                _store(mem, c, c_forms, acc)
                if x.epi == hilo_tma.DOT:
                    (ebuf, _), = e
                    (pbuf, pforms), = rest
                    _store(mem, pbuf, pforms, _dot_partials(
                        acc, mem[(ebuf, F32)], kf.partials(bi, bo)))
                else:
                    assert x.epi == hilo_tma.STORE and not e and not rest
            else:
                assert x.kind == kf.SUM
                (src, _), = x.reads
                (dst, forms), = x.writes
                _store(mem, dst, forms, _sum_partials(mem[(src, F32)]))
        out[t0:t1] = mem[(kf.OUT, F32)]
        dots[t0:t1] = mem[(kf.DOTS, F32)]
    return out, dots


def _plain_by_chunk(chunks, pa, g, pg, a_src, g_src):
    """The plain version on the whole call (out) and chunk by chunk
    (dots)."""
    out, _ = tref.fused_precond_ref(pa, g, pg, a_src, g_src)
    dots = []
    for t0, t1 in chunks:
        sel = [None if i is None else i[t0:t1] for i in (a_src, g_src)]
        blocks = [x if i is not None else x[t0:t1]
                  for x, i in ((pa, a_src), (pg, g_src))]
        dots.append(tref.fused_precond_ref(blocks[0], g[t0:t1], blocks[1],
                                           *sel)[1])
    return out, torch.cat(dots)


def _schedule(n, bi, bo, pa, pg, indexed, shared=False):
    return kf.wu_schedule(n, bi, bo, (pa.shape[0], pg.shape[0])
                          if indexed else None, shared)


@pytest.mark.parametrize("bi,bo", SHAPES)
@pytest.mark.parametrize("indexed", [False, True])
def test_wu_schedule_emulated_is_the_plain_version(bi, bo, indexed,
                                                   monkeypatch):
    """One chunk, and chunks of 2 tiles (a budget of 2 tiles' workspace):
    bitwise ``fused_precond_ref``, gathered and indexed."""
    pa, g, pg, a_src, g_src = _case(bi * bo, 5, bi, bo, indexed)
    want_out, want_dots = tref.fused_precond_ref(pa, g, pg, a_src, g_src)
    sched = _schedule(5, bi, bo, pa, pg, indexed)
    assert sched.chunks == ((0, 5),)
    got = _emulate(sched, pa, g, pg, a_src, g_src, False)
    assert torch.equal(got[0], want_out) and torch.equal(got[1], want_dots)
    chunks = kf.wu_chunks
    monkeypatch.setattr(kf, "wu_chunks", lambda n, bi, bo: chunks(
        n, bi, bo, budget=2 * kf.tile_bytes(bi, bo)))
    sched = _schedule(5, bi, bo, pa, pg, indexed)
    assert sched.chunks == ((0, 2), (2, 4), (4, 5))
    got = _emulate(sched, pa, g, pg, a_src, g_src, False)
    want_out, want_dots = _plain_by_chunk(sched.chunks, pa, g, pg, a_src,
                                          g_src)
    assert torch.equal(got[0], want_out) and torch.equal(got[1], want_dots)


@pytest.mark.parametrize("b", [129, 256])
def test_wu_schedule_shared_pool_is_the_plain_version(b):
    """``a_inv is g_inv`` (a WU group of bi == bo): one pool split read as
    both sides, bitwise the plain version on the same pool twice."""
    pa, g, _, a_src, g_src = _case(b, 6, b, b, True)
    g_src = g_src % pa.shape[0]
    sched = _schedule(6, b, b, pa, pa, True, shared=True)
    assert len(sched.pools) == 1
    want_out, want_dots = tref.fused_precond_ref(pa, g, pa, a_src, g_src)
    got = _emulate(sched, pa, g, None, a_src, g_src, True)
    assert torch.equal(got[0], want_out) and torch.equal(got[1], want_dots)
    with pytest.raises(ValueError, match="shared pool"):
        kf.wu_schedule(6, 256, 176, (3, 3), shared=True)


@pytest.mark.parametrize("bi,bo,indexed,shared", [
    (bi, bo, indexed, False) for bi, bo in SHAPES for indexed in (False, True)
] + [(129, 129, True, True), (256, 256, True, True)])
def test_wu_schedule_forms_are_written_before_read(bi, bo, indexed, shared):
    """Every form a launch reads was written by the last launch that
    wrote its buffer (the caller's inputs in fp32 from the start, the
    pools' slices before the chunks); every form written is read by a
    later launch or is the call's output; a launch never writes a buffer
    it reads, nor one that a later launch of the chunk reads an earlier
    value of; the caller's inputs are never written; a product reads the
    left slices its mode takes and both right slices, a DOT also E."""
    sched = kf.wu_schedule(9, bi, bo, (3, 3) if indexed else None, shared)
    held = {b: {F32} for b in (kf.A_INV, kf.G_INV, kf.G)}
    unread = {}
    for x in sched.pools + sched.per_chunk:
        reads = {b for b, _ in x.reads}
        for buf, forms in x.reads:
            assert set(forms) <= held[buf], (x, buf, forms)
            unread.get(buf, set()).difference_update(forms)
        for buf, forms in x.writes:
            assert buf not in reads and buf not in (kf.A_INV, kf.G_INV, kf.G)
            assert not unread.get(buf), (x, buf, "written, never read")
            held[buf], unread[buf] = set(forms), set(forms)
        if x.kind == kf.PRODUCT:
            assert x.reads[0][1] == hilo_tma.LEFT_FORMS[hilo_tma.FULL]
            assert x.reads[1][1] == (HI, LO)
            assert (len(x.reads) == 3) == (x.epi == hilo_tma.DOT)
            pools = {b for b, _ in x.reads} & set(kf.POOL_SLICES)
            assert all(i is None for i in x.index) or indexed
            assert sum(i is not None for i in x.index) == \
                (len(pools) if indexed else 0)
    assert unread.pop(kf.OUT) == {F32} and unread.pop(kf.DOTS) == {F32}
    assert not any(unread.values()), unread
    # every chunk's launches find the pools' slices the call made
    assert {b for x in sched.pools for b, _ in x.writes} == \
        ({kf.A_SLICES} if shared else set(kf.POOL_SLICES))
    kinds = [x.kind for x in sched.per_chunk]
    assert kinds == [kf.SPLIT, kf.PRODUCT, kf.PRODUCT, kf.SUM]
    assert [x.epi for x in sched.per_chunk if x.kind == kf.PRODUCT] == \
        [hilo_tma.STORE, hilo_tma.DOT]
    # no fp32 tmp: the first product stores its slices only
    assert sched.per_chunk[1].writes == ((kf.TMP, (HI, LO)),)


def test_wu_chunks_stay_under_the_budget():
    """Chunks cover the tiles in order, each chunk's workspace (g's and
    tmp's slices, rows padded to 8 bf16, and its partial dots) under the
    budget, at most hilo_tma.chunks' cap of tiles; the pools' slices are
    made once a call, outside it."""
    budget = hilo_tma.WORKSPACE_BYTES
    for n, bi, bo in ((1536, 256, 256), (3072, 256, 176), (1536, 176, 256),
                      (768, 1024, 176), (384, 176, 1024), (512, 130, 200),
                      (200000, 129, 129), (6144, 1024, 1024)):
        per = 2 * 4 * bi * hilo_tma.slice_stride(bo) + \
            4 * 2 * hilo_tma.tiles_of(bi, bo)
        assert kf.tile_bytes(bi, bo) == per
        sched = kf.wu_schedule(n, bi, bo, (n // 8 + 1, 8))
        parts = sched.chunks
        assert parts[0][0] == 0 and parts[-1][1] == n
        assert all(b == c for (_, b), (c, _) in zip(parts, parts[1:]))
        most = max(t1 - t0 for t0, t1 in parts)
        assert sched.chunk_bytes == most * per <= budget
        assert most <= 65535
        ss = hilo_tma.slice_stride
        assert sched.pool_bytes == 4 * ((n // 8 + 1) * bi * ss(bi)
                                        + 8 * bo * ss(bo))
    # (768, 1024, 176): 1.44 MB a tile, two chunks of 384
    assert kf.wu_schedule(768, 1024, 176).chunks == ((0, 384), (384, 768))
    # (3072, 256, 176): 1.107 GB of g's and tmp's slices, two chunks
    assert kf.wu_schedule(3072, 256, 176).chunks == ((0, 1536),
                                                     (1536, 3072))
    assert kf.wu_schedule(1536, 256, 256).chunks == ((0, 1536),)


@pytest.mark.parametrize("n,bi,bo,pools,shared", [
    (1536, 256, 256, (192, 8), False), (1536, 256, 256, (768, 768), True),
    (3072, 256, 176, (384, 8), False), (512, 130, 200, None, False),
    (5, 129, 129, (3, 4), False)])
def test_wu_floor_bytes_is_the_formula(n, bi, bo, pools, shared):
    """28 bytes an entry of g (split 4 + 4, the first product's g slices
    and tmp slices 4 + 4, the second's tmp, E and out 4 + 4 + 4), 12 an
    entry of a pool (split 4 + 4, read 4; a shared pool 16, read as both
    sides), 4 an index, 8 a partial dot (written, read), 4 a dot."""
    sched = kf.wu_schedule(n, bi, bo, pools, shared)
    na, ng = pools or (n, n)
    pool_bytes = (16 * na * bi * bi if shared
                  else 12 * (na * bi * bi + ng * bo * bo))
    per = 2 * hilo_tma.tiles_of(bi, bo)
    want = 28 * n * bi * bo + pool_bytes + n * (8 * per + 4) + \
        (8 * n if pools else 0)
    assert sched.floor_bytes == want
    if (n, bi, bo, pools) == (1536, 256, 256, (192, 8)):
        # 0.89 ms at the H100's 3.35 TB/s
        assert 0.88 < want / 3.35e12 * 1e3 < 0.90


def test_wu_chunks_and_launch_counts_of_the_route():
    """Launches of a call: the pool splits (one when a_inv is g_inv),
    then four a chunk (g's split, two products, the dots); one launch on
    the one-CTA route; none for no tiles."""
    assert kf.expected_launches(1536, 176, 256) == 2 + 4
    assert kf.expected_launches(3072, 256, 176) == 2 + 4 * 2
    assert kf.expected_launches(1536, 256, 256, shared=True) == 1 + 4
    assert kf.expected_launches(768, 1024, 176) == 2 + 4 * 2
    assert kf.expected_launches(18816, 128, 128) == 1
    assert kf.expected_launches(0, 256, 256) == 0
    assert kf.partials(176, 256) == 2 * 2 * 1
    assert kf.partials(1024, 176) == 2 * 8 * 1
    assert kf.partials(130, 200) == 2 * 2 * 1
    assert kf.partials(176, 1024) == 2 * 2 * 4


# ---------------------------------------------------------------------------
# the wrapper's launches, each kernel emulated from its raw arguments
# ---------------------------------------------------------------------------

def _mem(addr, ctype, count):
    """A numpy view of ``count`` entries of ``ctype`` at a CPU address."""
    return np.ctypeslib.as_array((ctype * count).from_address(addr))


def _slices(addr, blocks, rows, ld16):
    """A view of bf16 slices (blocks, rows, ld16) at ``addr``."""
    raw = _mem(addr, ctypes.c_int16, blocks * rows * ld16)
    return torch.from_numpy(raw).view(torch.bfloat16).view(blocks, rows,
                                                           ld16)


def _f32(addr, shape):
    return torch.from_numpy(_mem(addr, ctypes.c_float,
                                 int(np.prod(shape)))).view(*shape)


def _operand(p, hi, lo, idx, blocks, rows, cols, ld16):
    """The batch's blocks of an operand, through its index array."""
    pick = (torch.from_numpy(_mem(idx, ctypes.c_int32, p.batch).copy()).long()
            if idx else torch.arange(p.batch))
    assert int(pick.max()) < blocks
    return [_slices(a, blocks, rows, ld16)[pick][:, :, :cols]
            if a else None for a in (hi, lo)]


class _Card:
    """The three large-route kernels, run on CPU memory from their
    arguments as the C entries get them; records the launches."""

    def __init__(self):
        self.calls = []

    def launch(self, entry, *args, key=None):
        self.calls.append((entry, key))
        getattr(self, entry)(*args)

    def fused_precond_split(self, src, blocks, rows, cols, hi, lo, ld16,
                            stream):
        assert ld16 % 8 == 0 and ld16 >= cols and hi % 16 == 0
        hs, ls = split_hi_lo_bf16(_f32(src, (blocks, rows, cols)))
        for addr, v in ((hi, hs), (lo, ls)):
            dst = _slices(addr, blocks, rows, ld16)
            dst.zero_()
            dst[:, :, :cols] = v

    def fused_precond_product(self, ref, stream):
        p = ref._obj
        m, k, n = p.m or p.n, p.k or p.n, p.n
        lb = p.l_blocks or p.batch
        rb = p.r_blocks or p.batch
        for a in (p.l_hi, p.l_lo, p.r_hi, p.r_lo, p.c.hi, p.c.lo):
            assert a is None or a % 16 == 0
        left = _operand(p, p.l_hi, p.l_lo, p.l_idx, lb, m, k, p.l_ld16)
        right = _operand(p, p.r_hi, p.r_lo, p.r_idx, rb, k, n, p.r_ld16)
        acc = _hilo(left, right)
        if p.c.f32:
            _f32(p.c.f32, (p.batch, m, p.ld32))[:, :, :n] = acc
        hs, ls = split_hi_lo_bf16(acc)
        for addr, v in ((p.c.hi, hs), (p.c.lo, ls)):
            if addr:
                _slices(addr, p.batch, m, p.ld16)[:, :, :n] = v
        if p.epi == hilo_tma.DOT:
            per = 2 * hilo_tma.tiles_of(m, n)
            e = _f32(p.e, (p.batch, m, p.ld32))[:, :, :n]
            _f32(p.part, (p.batch, per))[:] = _dot_partials(acc, e, per)
        else:
            assert p.epi == hilo_tma.STORE and not p.part

    def fused_precond_dots(self, part, per, dots, n, stream):
        _f32(dots, (n,))[:] = _sum_partials(_f32(part, (n, per)))


@pytest.mark.parametrize("bi,bo", SHAPES)
@pytest.mark.parametrize("indexed", [False, True])
@pytest.mark.parametrize("budget_tiles", [None, 2])
def test_wrapper_launches_emulated_are_the_plain_version(
        bi, bo, indexed, budget_tiles, monkeypatch):
    """``_large`` on CPU tensors with the three kernels emulated from the
    addresses and ``hilo_tma.Params`` it passes: bitwise the plain version,
    the launches those of ``expected_launches``, all keyed by the shape."""
    pa, g, pg, a_src, g_src = _case(bi + 3 * bo, 5, bi, bo, indexed)
    if budget_tiles:
        chunks = kf.wu_chunks
        monkeypatch.setattr(kf, "wu_chunks", lambda n, bi, bo: chunks(
            n, bi, bo, budget=budget_tiles * kf.tile_bytes(bi, bo)))
    card = _Card()
    monkeypatch.setattr(kf.LIB, "launch", card.launch)
    out = torch.full_like(g, float("nan"))
    dots = torch.full((5,), float("nan"))
    kf._large(pa, g, pg, a_src, g_src, out, dots, 0, f"{bi}x{bo}")
    want_out, want_dots = _plain_by_chunk(kf.wu_chunks(5, bi, bo), pa, g,
                                          pg, a_src, g_src)
    assert torch.equal(out, want_out) and torch.equal(dots, want_dots)
    assert len(card.calls) == kf.expected_launches(5, bi, bo)
    assert {k for _, k in card.calls} == {f"{bi}x{bo}"}


def test_wrapper_shared_pool_splits_once():
    """A WU group of bi == bo passes one pool as both sides: one split."""
    pa, g, _, a_src, g_src = _case(7, 4, 176, 176, True)
    g_src = g_src % pa.shape[0]
    card = _Card()
    mp = pytest.MonkeyPatch()
    mp.setattr(kf.LIB, "launch", card.launch)
    try:
        out, dots = torch.empty_like(g), torch.empty(4)
        kf._large(pa, g, pa, a_src, g_src, out, dots, 0, "176x176")
    finally:
        mp.undo()
    want_out, want_dots = tref.fused_precond_ref(pa, g, pa, a_src, g_src)
    assert torch.equal(out, want_out) and torch.equal(dots, want_dots)
    assert [e for e, _ in card.calls].count("fused_precond_split") == 1 + 1
    assert len(card.calls) == kf.expected_launches(4, 176, 176, shared=True)


def test_plain_version_matches_pallas_kernel_on_an_unaligned_tile():
    """(200, 130): a side that is no multiple of 4, where out and g rows
    are unpadded (the card's DOT epilogue masks by entry), against the
    reference's kernel on the gathered pools."""
    pa, g, pg, a_src, g_src = _case(11, 3, 200, 130, True)
    out, dots = tref.fused_precond_ref(pa, g, pg, a_src, g_src)
    want_out, want_dots = jops.fused_precond(
        *(jnp.asarray(x.numpy()) for x in (pa[a_src.long()], g,
                                           pg[g_src.long()])))
    want_out = np.asarray(want_out)
    err = np.max(np.abs(out.numpy() - want_out))
    assert err <= 1e-5 * np.max(np.abs(want_out))
    np.testing.assert_allclose(dots.numpy(), np.asarray(want_dots),
                               rtol=1e-4, atol=1e-2)
