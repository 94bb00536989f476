"""repro_torch's CUDA kernels against their plain PyTorch versions, on
an NVIDIA GPU, and the serving path's decode chunks on the card (no host
synchronisation inside one; the paged write where idle rows' clamped
targets meet a live row's). Every test is marked ``cuda`` and skips
inside the test when no GPU is present. The file imports neither jax nor ``repro``, so
it runs on a machine with torch alone:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest`` because ``tests/conftest.py`` bootstraps jax.)

Tolerance: 1e-4 of the plain version's largest entry. The tensor cores
sum the exact bf16 partial products in another order than the plain
fp32 matmuls, and the inverse's iterations (for ``smw_update``, the
k x k solve; for ``fused_gram_inv``, the Gram's rounding too) carry that
rounding-level difference along (measured ~2e-5 relative on random SPD
blocks).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

KW = dict(ns_iters=20, taylor_terms=4, refine_steps=2)   # KFACConfig counts


def _damped(seed, nb, n):
    r = np.random.default_rng(seed)
    m = r.standard_normal((nb, n, n)).astype(np.float32)
    a = (np.einsum("bij,bkj->bik", m, m) / n
         + 1e-3 * np.eye(n, dtype=np.float32))
    damp = (0.03 * np.trace(a, axis1=1, axis2=2) / n).astype(np.float32)
    return a, damp


def _tiles(seed, n, bi, bo):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(s).astype(np.float32)
                 for s in ((n, bi, bi), (n, bi, bo), (n, bo, bo)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n", [(8, 128), (3, 32), (2, 100), (4, 1),
                                  (3, 16), (5, 65)])
def test_neumann_inv_kernel_matches_plain(cuda_device, nb, n):
    a, damp = _damped(nb + n, nb, n)
    ta = torch.from_numpy(a).to(cuda_device)
    td = torch.from_numpy(damp).to(cuda_device)
    before = ops.launch_counts()["neumann_inv"]
    got = ops.neumann_inv(ta, td, **KW)
    torch.cuda.synchronize()
    assert ops.launch_counts()["neumann_inv"] == before + 1
    want = tref.neumann_inv_ref(ta, td, **KW)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("taylor,refine", [(1, 0), (4, 0)])
@pytest.mark.parametrize("nb,n", [(1, 128), (3, 65)])
def test_neumann_inv_kernel_ladder_stages(cuda_device, taylor, refine, nb,
                                          n):
    """``benchmarks.kernel_bench``'s ladder settings besides KW's 20/4/2:
    20/1/0 (Newton-Schulz only) and 20/4/0 (no refinement)."""
    a, damp = _damped(nb + n + taylor, nb, n)
    ta = torch.from_numpy(a).to(cuda_device)
    td = torch.from_numpy(damp).to(cuda_device)
    kw = dict(ns_iters=20, taylor_terms=taylor, refine_steps=refine)
    got = ops.neumann_inv(ta, td, **kw)
    want = tref.neumann_inv_ref(ta, td, **kw)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


def _ill_conditioned(seed, n=128, cond=2600.0):
    """A factor-like SPD block whose damped condition number (damping
    0.03 tr / n, as K-FAC's) is ``cond``: one large eigenvalue over a
    geometric tail, as on the main path's own factors."""
    r = np.random.default_rng(seed)
    q = np.linalg.qr(r.standard_normal((n, n)))[0]
    tail = np.geomspace(1.0, 1e-7, n - 1)
    ev = np.concatenate([[0.0], tail / tail.sum() * n])
    delta = 0.03 * ev.sum() / n
    # (top + delta) / (min + delta) = cond, with the top in the trace
    top = (cond * (ev[1:].min() + delta) - delta
           - 0.03 * cond * ev[1:].min() / n) / (1 - 0.03 * cond / n)
    ev[0] = top
    a = (q * ev) @ q.T
    damp = 0.03 * np.trace(a) / n
    evd = np.linalg.eigvalsh(a + damp * np.eye(n))
    return a[None].astype(np.float32), np.float32([damp]), evd[-1] / evd[0]


@pytest.mark.cuda
def test_neumann_inv_kernel_ill_conditioned_block(cuda_device):
    """Condition number ~2600 after damping, as on the run's factors: the
    iteration is unconverged at 20 Newton-Schulz steps and carries the
    rounding-level difference up, so the run-data tolerance of
    chip_smoke.py (1e-3 of the plain version's largest entry) holds."""
    a, damp, cond = _ill_conditioned(17)
    assert 2000 < cond < 3200
    ta = torch.from_numpy(a).to(cuda_device)
    td = torch.from_numpy(damp).to(cuda_device)
    got = ops.neumann_inv(ta, td, **KW)
    want = tref.neumann_inv_ref(ta, td, **KW)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-3 * want.abs().max()


@pytest.mark.cuda
def test_neumann_inv_grouped_kernel_is_the_per_leaf_launches(cuda_device):
    """One launch over leaves of different nb (one above the card's 132
    SMs), each block bitwise what a launch of its leaf alone gives; a
    list with a second block side takes one more launch."""
    leaves = [_damped(40 + k, nb, 128) for k, nb in enumerate((5, 150, 33))]
    blocks = [torch.from_numpy(a).to(cuda_device) for a, _ in leaves]
    damps = [torch.from_numpy(d).to(cuda_device) for _, d in leaves]
    before = ops.launch_counts()["neumann_inv"]
    got = ops.neumann_inv_grouped(blocks, damps, **KW)
    torch.cuda.synchronize()
    assert ops.launch_counts()["neumann_inv"] == before + 1
    for a, d, g in zip(blocks, damps, got):
        assert torch.equal(g, ops.neumann_inv(a, d, **KW))
        want = tref.neumann_inv_ref(a, d, **KW)
        assert (g - want).abs().max() <= 1e-4 * want.abs().max()
    a64, d64 = (torch.from_numpy(x).to(cuda_device) for x in _damped(50, 7, 64))
    before = ops.launch_counts()["neumann_inv"]
    mixed = ops.neumann_inv_grouped(blocks + [a64], damps + [d64], **KW)
    torch.cuda.synchronize()
    assert ops.launch_counts()["neumann_inv"] == before + 2
    for g, h in zip(got, mixed):
        assert torch.equal(g, h)
    assert torch.equal(mixed[-1], ops.neumann_inv(a64, d64, **KW))


@pytest.mark.cuda
def test_neumann_inv_grouped_out_writes_what_it_returns(cuda_device):
    """``out=`` fills the given buffers, bitwise the fresh result, with
    the same one launch a block side."""
    leaves = [_damped(70 + k, nb, n) for k, (nb, n) in
              enumerate(((6, 128), (9, 128), (4, 64)))]
    blocks = [torch.from_numpy(a).to(cuda_device) for a, _ in leaves]
    damps = [torch.from_numpy(d).to(cuda_device) for _, d in leaves]
    want = ops.neumann_inv_grouped(blocks, damps, **KW)
    out = [torch.full_like(a, float("nan")) for a in blocks]
    before = ops.launch_counts()["neumann_inv"]
    got = ops.neumann_inv_grouped(blocks, damps, out=out, **KW)
    torch.cuda.synchronize()
    assert ops.launch_counts()["neumann_inv"] == before + 2
    for g, o, w in zip(got, out, want):
        assert g is o and torch.equal(o, w)
    with pytest.raises(ValueError, match="out="):
        ops.neumann_inv_grouped(blocks[:1], damps[:1],
                                out=[out[0].transpose(1, 2)], **KW)


@pytest.mark.cuda
def test_async_refresh_survives_the_allocators_reuse(cuda_device):
    """The refresh on the side stream stays bitwise a synchronous one
    when the main stream drops the factors right after the dispatch and
    fills fresh allocations of their sizes before the swap: the factors
    are marked as in use by the side stream, so the caching allocator
    cannot hand their memory to the main stream's fills while the
    refresh reads them. Every launch of the refresh is on the side
    stream."""
    from repro_torch.core import kfac
    from repro_torch.solve import AsyncInverseRefresher

    cfg = kfac.KFACConfig(**KW)
    r = np.random.default_rng(5)

    def factors():
        return {f"l{i}": {"A": torch.from_numpy(_damped(
            int(r.integers(1 << 30)), 96, 128)[0]).to(cuda_device)}
            for i in range(12)}

    fac = factors()
    want = kfac.invert_factors({n: {k: v.clone() for k, v in d.items()}
                                for n, d in fac.items()}, cfg)
    zeros = {n: {"A_inv": torch.zeros_like(d["A_inv"])}
             for n, d in want.items()}
    refresher = AsyncInverseRefresher(
        refresh_into=lambda f, buf: kfac.invert_factors(f, cfg, out=buf),
        spare_buffers=zeros)
    st = kfac.KFACState(0, fac, {n: {"A_inv": torch.eye(128, device=cuda_device)
                                     .expand(96, 128, 128).contiguous()}
                                 for n in fac}, {}, {}, {})
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    st = refresher.step(st)
    shapes = [v.shape for d in fac.values() for v in d.values()]
    st = dataclasses.replace(st, factors=None)
    del fac
    junk = [torch.empty(s, device=cuda_device).fill_(float("nan"))
            for s in shapes for _ in range(2)]
    st = refresher.flush(st)
    torch.cuda.synchronize()
    del junk
    for n, d in want.items():
        assert torch.equal(st.inverses[n]["A_inv"], d["A_inv"]), n
    main = torch.cuda.current_stream(cuda_device).cuda_stream
    streams = ops.launch_streams()["neumann_inv"]
    assert sum(streams.values()) == 1 and main not in streams
    assert refresher.stream.cuda_stream in streams


@pytest.mark.cuda
def test_neumann_inv_grouped_kernel_splits_long_lists(cuda_device):
    """40 leaves take two launches (32 leaves a table), each block
    bitwise its leaf's own launch."""
    leaves = [_damped(60 + k, 1 + k % 3, 16) for k in range(40)]
    blocks = [torch.from_numpy(a).to(cuda_device) for a, _ in leaves]
    damps = [torch.from_numpy(d).to(cuda_device) for _, d in leaves]
    before = ops.launch_counts()["neumann_inv"]
    got = ops.neumann_inv_grouped(blocks, damps, **KW)
    torch.cuda.synchronize()
    assert ops.launch_counts()["neumann_inv"] == before + 2
    for a, d, g in zip(blocks, damps, got):
        assert torch.equal(g, ops.neumann_inv(a, d, **KW))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128, 128), (5, 32, 32),
                                   (3, 100, 72)])
def test_fused_precond_kernel_matches_plain(cuda_device, shape):
    x = tuple(torch.from_numpy(v).to(cuda_device) for v in _tiles(5, *shape))
    before = ops.launch_counts()["fused_precond"]
    out, dots = ops.fused_precond(*x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_precond"] == before + 1
    want_out, want_dots = tref.fused_precond_ref(*x)
    assert (out - want_out).abs().max() <= 1e-4 * want_out.abs().max()
    assert (dots - want_dots).abs().max() <= 1e-4 * want_dots.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("n,bi,bo,ma,mg", [(18816, 128, 128, 3120, 3120),
                                           (37, 100, 72, 5, 9),
                                           (9, 32, 32, 2, 3),
                                           (7, 30, 18, 3, 4)])
def test_fused_precond_indexed_kernel_matches_plain(cuda_device, n, bi, bo,
                                                    ma, mg):
    """Pools indexed per tile (repeated, out of order; at the main
    path's size, the plan's own pattern: runs of one A block cycling
    through a few G blocks), against the plain version's gather."""
    r = np.random.default_rng(n + bi)
    pa = torch.from_numpy(r.standard_normal((ma, bi, bi)).astype(
        np.float32)).to(cuda_device)
    pg = torch.from_numpy(r.standard_normal((mg, bo, bo)).astype(
        np.float32)).to(cuda_device)
    g = torch.from_numpy(r.standard_normal((n, bi, bo)).astype(
        np.float32)).to(cuda_device)
    if n == 18816:
        t = np.arange(n)
        a_src, g_src = (t // 8) % ma, (t // 64) * 8 % mg + t % 8
    else:
        a_src, g_src = r.integers(0, ma, n), r.integers(0, mg, n)
    a_src, g_src = (torch.from_numpy(x.astype(np.int32)).to(cuda_device)
                    for x in (a_src, g_src))
    before = ops.launch_counts()["fused_precond"]
    out, dots = ops.fused_precond(pa, g, pg, a_src, g_src)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_precond"] == before + 1
    want_out, want_dots = tref.fused_precond_ref(pa, g, pg, a_src, g_src)
    assert (out - want_out).abs().max() <= 1e-4 * want_out.abs().max()
    assert (dots - want_dots).abs().max() <= 1e-4 * want_dots.abs().max()


@pytest.mark.cuda
def test_neumann_inv_kernel_refuses_large_blocks(cuda_device):
    """Above the reference's 1024 (its Pallas kernel's limit) the
    wrapper raises before any launch."""
    a = torch.eye(1025, device=cuda_device).expand(1, 1025, 1025).contiguous()
    before = ops.launch_counts()["neumann_inv"]
    with pytest.raises(ValueError, match="n <= 1024"):
        ops.neumann_inv(a, 0.1, **KW)
    assert ops.launch_counts()["neumann_inv"] == before


@pytest.mark.cuda
def test_fused_precond_kernel_refuses_tiles_above_1024(cuda_device):
    x = tuple(torch.zeros(s, device=cuda_device)
              for s in ((1, 1025, 1025), (1, 1025, 8), (1, 8, 8)))
    with pytest.raises(ValueError, match="1024 x 1024"):
        ops.fused_precond(*x)


# the large route (sides of 129..1024): the block sides of phase
# large_blocks, nb small; fused_precond's tiles of that phase
LARGE_N = [(3, 129), (4, 176), (3, 256), (2, 512), (2, 1024)]
LARGE_TILES = [(6, 256, 256), (7, 256, 176), (5, 176, 256), (3, 1024, 176),
               (3, 176, 1024), (4, 130, 200), (16, 129, 129), (24, 200, 130)]


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n", LARGE_N)
def test_neumann_inv_large_kernel_matches_plain(cuda_device, nb, n):
    """The large route against the plain version, and its launches: one
    chunk of prep, 52 products at 20/4/2, copy-out, all keyed by the
    side."""
    from repro_torch.kernels import neumann_inv as kn

    a, damp = _damped(nb + n, nb, n)
    ta = torch.from_numpy(a).to(cuda_device)
    td = torch.from_numpy(damp).to(cuda_device)
    ops.reset_launch_counts()
    got = ops.neumann_inv(ta, td, **KW)
    torch.cuda.synchronize()
    assert ops.launch_counts()["neumann_inv"] == \
        kn.expected_launches({n: [nb]}, **KW) == 52
    assert ops.launch_keys()["neumann_inv"] == {f"n{n}": 52}
    want = tref.neumann_inv_ref(ta, td, **KW)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    # bitwise its repeat (no atomics)
    assert torch.equal(got, ops.neumann_inv(ta, td, **KW))


@pytest.mark.cuda
@pytest.mark.parametrize("taylor,refine", [(1, 0), (4, 0), (3, 3)])
def test_neumann_inv_large_kernel_ladder_stages(cuda_device, taylor, refine):
    a, damp = _damped(taylor + refine, 3, 176)
    ta = torch.from_numpy(a).to(cuda_device)
    td = torch.from_numpy(damp).to(cuda_device)
    kw = dict(ns_iters=20, taylor_terms=taylor, refine_steps=refine)
    got = ops.neumann_inv(ta, td, **kw)
    want = tref.neumann_inv_ref(ta, td, **kw)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_neumann_inv_grouped_mixed_sides_is_the_per_leaf_calls(cuda_device):
    """Leaves of 128, 176 and 256 (and an empty one) in one grouped
    call: each side takes its own route, and each leaf is bitwise a
    call on it alone."""
    from repro_torch.kernels import neumann_inv as kn

    shapes = [(5, 256), (3, 128), (0, 176), (6, 176), (2, 256), (4, 128)]
    leaves = [_damped(80 + k, nb, n) for k, (nb, n) in enumerate(shapes)]
    blocks = [torch.from_numpy(a).to(cuda_device) for a, _ in leaves]
    damps = [torch.from_numpy(d).to(cuda_device) for _, d in leaves]
    ops.reset_launch_counts()
    got = ops.neumann_inv_grouped(blocks, damps, **KW)
    torch.cuda.synchronize()
    sides = {}
    for nb, n in shapes:
        sides.setdefault(n, []).append(nb)
    assert ops.launch_counts()["neumann_inv"] == \
        kn.expected_launches(sides, **KW) == 1 + 2 * 52
    assert ops.launch_keys()["neumann_inv"] == {"n256": 52, "n128": 1,
                                                "n176": 52}
    for a, d, g in zip(blocks, damps, got):
        assert torch.equal(g, ops.neumann_inv(a, d, **KW))
        if a.shape[0]:
            want = tref.neumann_inv_ref(a, d, **KW)
            assert (g - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_neumann_inv_large_chunks_are_bitwise_one_chunk(cuda_device,
                                                       monkeypatch):
    """A workspace budget of two blocks takes the side in chunks: each
    block bitwise the one-chunk result (a block's arithmetic does not
    depend on its chunk)."""
    from repro_torch.kernels import hilo_tma
    from repro_torch.kernels import neumann_inv as kn

    leaves = [_damped(90 + k, nb, 256) for k, nb in enumerate((3, 2))]
    blocks = [torch.from_numpy(a).to(cuda_device) for a, _ in leaves]
    damps = [torch.from_numpy(d).to(cuda_device) for _, d in leaves]
    whole = ops.neumann_inv_grouped(blocks, damps, **KW)
    budget = 2 * kn.block_bytes(256)
    plan = kn.large_plan
    monkeypatch.setattr(kn, "large_plan",
                        lambda nbs, n: plan(nbs, n, budget=budget))
    assert [len(p) for _, p, _ in kn.large_plan([3, 2], 256)] == [3]
    ops.reset_launch_counts()
    parts = ops.neumann_inv_grouped(blocks, damps, **KW)
    torch.cuda.synchronize()
    assert ops.launch_counts()["neumann_inv"] == 3 * 52
    assert hilo_tma.WORKSPACE_BYTES > budget
    for x, y in zip(whole, parts):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n", [(3, 131), (2, 200), (2, 300), (1, 520)])
def test_neumann_inv_large_kernel_ragged_tiles(cuda_device, nb, n):
    """Sides whose last k stage, row tile or column panel lies partly or
    wholly outside the block (the TMA's zero fill: 131 and 300 take
    192-wide tiles, 300's second one has a panel wholly outside; 200 and
    520 take 256-wide ones) against the plain version."""
    a, damp = _damped(nb * n, nb, n)
    ta = torch.from_numpy(a).to(cuda_device)
    td = torch.from_numpy(damp).to(cuda_device)
    got = ops.neumann_inv(ta, td, **KW)
    want = tref.neumann_inv_ref(ta, td, **KW)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_neumann_inv_large_product_refuses_what_it_cannot_take(cuda_device):
    """A product whose slices' row stride is not a multiple of 8 (no
    tensor map can take it) or whose operand is not on 16 bytes is
    refused at the launch, and the wrapper raises: nothing falls back."""
    from repro_torch.kernels import hilo_tma
    from repro_torch.kernels import neumann_inv as kn

    n = 176
    ws = torch.zeros(4 * n * 184 * 2 + 64, dtype=torch.uint8,
                     device=cuda_device)
    base = ws.data_ptr()
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    slice_bytes = n * 184 * 2
    ok = dict(l_hi=base, r_hi=base + slice_bytes,
              r_lo=base + 2 * slice_bytes,
              c=hilo_tma.Out(None, base + 3 * slice_bytes, None), n=n,
              ld32=n, ld16=184, batch=1, epi=hilo_tma.STORE)
    kn.LIB.launch("neumann_inv_product",
                  ctypes.byref(hilo_tma.Params(**ok)), stream)
    torch.cuda.synchronize()
    for bad in (dict(ok, ld16=180), dict(ok, r_lo=base + 8),
                dict(ok, epi=hilo_tma.ADD),
                # the rectangular fields: a side above 1024, a slice
                # stride no multiple of 8 or under its rows' width, a
                # block count out of range, an index array off 4 bytes,
                # DOT without E or partials, an epilogue past DOT
                dict(ok, m=1025), dict(ok, k=-1), dict(ok, l_ld16=180),
                dict(ok, r_ld16=168), dict(ok, r_blocks=-1),
                dict(ok, l_blocks=1 << 25), dict(ok, l_idx=base + 2),
                dict(ok, epi=hilo_tma.DOT),
                dict(ok, epi=hilo_tma.DOT, e=base, part=None),
                dict(ok, epi=hilo_tma.DOT + 1),
                # forms neumann_inv's library does not instantiate: an
                # operand stored transposed, one partial; a form flag
                # other than 0 or 1
                dict(ok, l_t=1), dict(ok, r_t=1), dict(ok, r_lo=None),
                dict(ok, l_t=2)):
        with pytest.raises(RuntimeError, match="neumann_inv_product"):
            kn.LIB.launch("neumann_inv_product",
                          ctypes.byref(hilo_tma.Params(**bad)), stream)


@pytest.mark.cuda
def test_neumann_inv_large_out_and_side_stream(cuda_device):
    """``out=`` at 256 fills the given buffers, bitwise the fresh
    result; a refresh at 256 on a side stream (its workspace taken from
    the allocator there) is bitwise the main stream's, every launch on
    the side stream."""
    leaves = [_damped(100 + k, nb, n) for k, (nb, n) in
              enumerate(((6, 256), (4, 176)))]
    blocks = [torch.from_numpy(a).to(cuda_device) for a, _ in leaves]
    damps = [torch.from_numpy(d).to(cuda_device) for _, d in leaves]
    want = ops.neumann_inv_grouped(blocks, damps, **KW)
    out = [torch.full_like(a, float("nan")) for a in blocks]
    got = ops.neumann_inv_grouped(blocks, damps, out=out, **KW)
    torch.cuda.synchronize()
    for g, o, w in zip(got, out, want):
        assert g is o and torch.equal(o, w)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    ops.reset_launch_counts()
    with torch.cuda.stream(side):
        res = ops.neumann_inv_grouped(blocks, damps, **KW)
    # the main stream fills fresh allocations while the side stream may
    # still run: they must not be the side stream's workspace
    junk = [torch.empty(1 << 26, device=cuda_device).fill_(float("nan"))
            for _ in range(4)]
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    torch.cuda.synchronize()
    del junk
    streams = ops.launch_streams()["neumann_inv"]
    assert list(streams) == [side.cuda_stream]
    for r, w in zip(res, want):
        assert torch.equal(r, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n,bi,bo", LARGE_TILES)
def test_fused_precond_large_kernel_matches_plain(cuda_device, n, bi, bo):
    """Gathered and indexed (repeated, out of order), against the plain
    version (sides of 129 and 130 with rows that are no multiple of 4:
    out and g unpadded); the launches of ``wu_schedule`` (two pool
    splits, then g's split, two products and the dots a chunk), all
    keyed by the shape; the indexed call bitwise the gathered one, each
    call bitwise its repeat."""
    from repro_torch.kernels import fused_precond as kf

    x = tuple(torch.from_numpy(v).to(cuda_device)
              for v in _tiles(n + bi, n, bi, bo))
    ops.reset_launch_counts()
    out, dots = ops.fused_precond(*x)
    torch.cuda.synchronize()
    want = kf.expected_launches(n, bi, bo)
    assert ops.launch_counts()["fused_precond"] == want == 2 + 4
    assert ops.launch_keys()["fused_precond"] == {f"{bi}x{bo}": want}
    again = ops.fused_precond(*x)
    assert torch.equal(out, again[0]) and torch.equal(dots, again[1])
    want_out, want_dots = tref.fused_precond_ref(*x)
    assert (out - want_out).abs().max() <= 1e-4 * want_out.abs().max()
    assert (dots - want_dots).abs().max() <= 1e-4 * want_dots.abs().max()
    r = np.random.default_rng(n)
    a_src, g_src = (torch.from_numpy(r.integers(0, n, n).astype(
        np.int32)).to(cuda_device) for _ in range(2))
    io, idots = ops.fused_precond(x[0], x[1], x[2], a_src, g_src)
    go, gdots = ops.fused_precond(x[0][a_src.long()].contiguous(), x[1],
                                  x[2][g_src.long()].contiguous())
    assert torch.equal(io, go) and torch.equal(idots, gdots)
    again = ops.fused_precond(x[0], x[1], x[2], a_src, g_src)
    assert torch.equal(io, again[0]) and torch.equal(idots, again[1])
    want_out, want_dots = tref.fused_precond_ref(x[0], x[1], x[2], a_src,
                                                 g_src)
    assert (io - want_out).abs().max() <= 1e-4 * want_out.abs().max()
    assert (idots - want_dots).abs().max() <= 1e-4 * want_dots.abs().max()


@pytest.mark.cuda
def test_fused_precond_large_chunks_are_bitwise_one_chunk(cuda_device,
                                                         monkeypatch):
    from repro_torch.kernels import fused_precond as kf

    x = tuple(torch.from_numpy(v).to(cuda_device)
              for v in _tiles(3, 9, 256, 176))
    out, dots = ops.fused_precond(*x)
    chunks = kf.wu_chunks
    monkeypatch.setattr(kf, "wu_chunks", lambda n, bi, bo: chunks(
        n, bi, bo, budget=4 * kf.tile_bytes(bi, bo)))
    ops.reset_launch_counts()
    o2, d2 = ops.fused_precond(*x)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_precond"] == \
        kf.expected_launches(9, 256, 176) == 2 + 4 * 3
    assert torch.equal(out, o2) and torch.equal(dots, d2)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [176, 256])
def test_fused_precond_large_shared_pool_is_two_pools(cuda_device, b):
    """A WU group of bi == bo passes one pool as both sides: split once
    (five launches), bitwise the call with a copy of it as the G pool
    (two splits)."""
    from repro_torch.kernels import fused_precond as kf

    r = np.random.default_rng(b)
    pool = torch.from_numpy(r.standard_normal((5, b, b)).astype(
        np.float32)).to(cuda_device)
    g = torch.from_numpy(r.standard_normal((12, b, b)).astype(
        np.float32)).to(cuda_device)
    a_src, g_src = (torch.from_numpy(r.integers(0, 5, 12).astype(
        np.int32)).to(cuda_device) for _ in range(2))
    ops.reset_launch_counts()
    out, dots = ops.fused_precond(pool, g, pool, a_src, g_src)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_precond"] == \
        kf.expected_launches(12, b, b, shared=True) == 1 + 4
    o2, d2 = ops.fused_precond(pool, g, pool.clone(), a_src, g_src)
    assert torch.equal(out, o2) and torch.equal(dots, d2)
    want_out, want_dots = tref.fused_precond_ref(pool, g, pool, a_src,
                                                 g_src)
    assert (out - want_out).abs().max() <= 1e-4 * want_out.abs().max()
    assert (dots - want_dots).abs().max() <= 1e-4 * want_dots.abs().max()


@pytest.mark.cuda
def test_fused_precond_large_on_a_side_stream(cuda_device):
    """The large route on a side stream (its workspace taken from the
    allocator there): bitwise the main stream's, every launch on the
    side stream."""
    x = tuple(torch.from_numpy(v).to(cuda_device)
              for v in _tiles(5, 40, 256, 176))
    want = ops.fused_precond(*x)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    ops.reset_launch_counts()
    with torch.cuda.stream(side):
        got = ops.fused_precond(*x)
    junk = [torch.empty(1 << 26, device=cuda_device).fill_(float("nan"))
            for _ in range(4)]
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    torch.cuda.synchronize()
    del junk
    assert list(ops.launch_streams()["fused_precond"]) == [side.cuda_stream]
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _smw_case(seed, n, k, bs, scale):
    """Inverses of damped factor-like blocks and new columns at
    ``scale`` (3e-4 gives G-side inverse entries ~1e7)."""
    r = np.random.default_rng(seed)
    v0 = r.standard_normal((n, 2 * bs, bs)) * scale
    f = np.einsum("ntb,ntc->nbc", v0, v0) / (2 * bs)
    lam = 0.03 * np.trace(f, axis1=1, axis2=2) / bs + 1e-8
    inv = np.linalg.inv(f + lam[:, None, None] * np.eye(bs))
    v = r.standard_normal((n, k, bs)) * scale
    return inv.astype(np.float32), v.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,bs,scale,c", [
    (528, 64, 128, 1.0, 0.05 / 2048),    # main path, A side
    (528, 64, 128, 3e-4, 0.05),          # main path, G side
    (5, 24, 48, 1.0, 0.05),              # unaligned
    (3, 5, 40, 3e-4, 0.05)])
def test_smw_update_kernel_matches_plain(cuda_device, n, k, bs, scale, c):
    inv, v = (torch.from_numpy(x).to(cuda_device)
              for x in _smw_case(n + k, n, k, bs, scale))
    before = ops.launch_counts()["smw_update"]
    got = ops.smw_update(inv, v, decay=0.95, cscale=c)
    torch.cuda.synchronize()
    assert ops.launch_counts()["smw_update"] == before + 1  # one a call
    want = tref.smw_update_ref(inv, v, decay=0.95, cscale=c)
    assert got.shape == want.shape == (n, bs, bs)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_smw_update_kernel_with_indefinite_inverses(cuda_device):
    """sym(inv) indefinite (unconverged cached inverses can be), so S is
    not SPD: the kernel's pivoted LU stays finite where a Cholesky would
    not, and agrees with the plain version's solve."""
    r = np.random.default_rng(11)
    n, k, bs = 6, 16, 64
    q = np.linalg.qr(r.standard_normal((n, bs, bs)))[0]
    ev = r.uniform(0.5, 2.0, (n, bs)) * np.where(np.arange(bs) % 3, 1, -1)
    inv = np.einsum("nij,nj,nkj->nik", q, ev, q).astype(np.float32)
    v = r.standard_normal((n, k, bs)).astype(np.float32)
    tinv, tv = (torch.from_numpy(x).to(cuda_device) for x in (inv, v))
    got = ops.smw_update(tinv, tv, decay=0.95, cscale=0.05)
    want = tref.smw_update_ref(tinv, tv, decay=0.95, cscale=0.05)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_smw_update_kernel_singular_capacitance_is_non_finite(cuda_device):
    """Two equal rows of V and cscale = inf (1/c = 0): S = Y V^T is
    exactly singular, and kernel and plain version both return
    non-finite blocks (the SMW gate's fallback signal)."""
    inv, v = _smw_case(3, 2, 8, 32, 1.0)
    v[:, 5] = v[:, 2]
    tinv, tv = (torch.from_numpy(x).to(cuda_device) for x in (inv, v))
    got = ops.smw_update(tinv, tv, decay=0.95, cscale=float("inf"))
    want = tref.smw_update_ref(tinv, tv, decay=0.95, cscale=float("inf"))
    assert not torch.isfinite(got).all()
    assert not torch.isfinite(want).all()


@pytest.mark.cuda
def test_smw_update_kernel_refuses_large_rank(cuda_device):
    inv = torch.eye(32, device=cuda_device).expand(2, 32, 32).contiguous()
    v = torch.zeros(2, 1025, 32, device=cuda_device)
    with pytest.raises(ValueError, match="bs, k <= 1024"):
        ops.smw_update(inv, v, decay=0.95, cscale=0.05)


# the large route of smw_update (bs or k of 129..1024): (blocks, k, bs) at
# the shapes of chip_smoke.py's phase large_blocks (d), fewer blocks
LARGE_SMW = [(3, 64, 129), (4, 64, 176), (3, 64, 256), (2, 64, 512),
             (2, 64, 1024), (3, 128, 256), (3, 129, 176), (2, 256, 256),
             (2, 1024, 1024), (3, 160, 96), (2, 1000, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,bs", LARGE_SMW)
@pytest.mark.parametrize("scale,c", [(1.0, 0.05 / 2048), (3e-4, 0.05)])
def test_smw_update_large_kernel_matches_plain(cuda_device, n, k, bs, scale,
                                               c):
    """The large route against the plain version at unit and G-side
    scale, its launches (``expected_launches``: 5 a chunk up to k 128,
    then two a panel of the LU more; keyed by shape) and bitwise its
    repeat; k 1000 ends on a ragged panel of 8."""
    from repro_torch.kernels import smw_update as ks

    inv, v = (torch.from_numpy(x).to(cuda_device)
              for x in _smw_case(n + k + bs, n, k, bs, scale))
    ops.reset_launch_counts()
    got = ops.smw_update(inv, v, decay=0.95, cscale=c)
    torch.cuda.synchronize()
    want = ks.expected_launches(bs, k, n)
    assert want == len(ks.smw_schedule(k))   # one chunk
    assert ops.launch_counts()["smw_update"] == want
    assert ops.launch_keys()["smw_update"] == {f"bs{bs}k{k}": want}
    want = tref.smw_update_ref(inv, v, decay=0.95, cscale=c)
    assert got.shape == want.shape == (n, bs, bs)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.equal(got, ops.smw_update(inv, v, decay=0.95, cscale=c))


@pytest.mark.cuda
@pytest.mark.parametrize("k,bs", [(64, 256), (192, 256)])
def test_smw_update_large_kernel_with_indefinite_inverses(cuda_device, k,
                                                          bs):
    """S not SPD on both solves of the large route (slab, LU): finite,
    and as close to float64 Woodbury as the plain version is. Not held
    to the plain version itself: these S reach condition numbers of
    1.1e3 (k 64) and 2.9e4 (k 192), where the plain version is itself
    3.7e-4 and 4.5e-3 of the largest entry from float64, and two
    roundings of the products move the solve by as much."""
    r = np.random.default_rng(k + bs)
    n = 3
    q = np.linalg.qr(r.standard_normal((n, bs, bs)))[0]
    ev = r.uniform(0.5, 2.0, (n, bs)) * np.where(np.arange(bs) % 3, 1, -1)
    inv = np.einsum("nij,nj,nkj->nik", q, ev, q).astype(np.float32)
    v = r.standard_normal((n, k, bs)).astype(np.float32)
    tinv, tv = (torch.from_numpy(x).to(cuda_device) for x in (inv, v))
    got = ops.smw_update(tinv, tv, decay=0.95, cscale=0.05)
    want = tref.smw_update_ref(tinv, tv, decay=0.95, cscale=0.05)
    assert torch.isfinite(got).all() and torch.isfinite(want).all()
    m = (tinv.double() + tinv.double().transpose(1, 2)) * (0.5 / 0.95)
    y = tv.double() @ m
    s = y @ tv.double().transpose(1, 2) + torch.eye(
        k, device=cuda_device, dtype=torch.float64) / 0.05
    w64 = m - y.transpose(1, 2) @ torch.linalg.solve(s, y)
    assert (got.double() - w64).abs().max() <= \
        2.0 * (want.double() - w64).abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("k,bs", [(8, 256), (160, 192)])
def test_smw_update_large_singular_capacitance_is_non_finite(cuda_device, k,
                                                             bs):
    """Two equal rows of V and 1/c = 0 make S exactly singular: the slab
    and the LU solve give non-finite blocks (the SMW gate's fallback
    signal). The plain version's LAPACK, a blocked LU, may round past
    the zero pivot (on the card it does at k 160), so it is not held to
    the same."""
    inv, v = _smw_case(k, 2, k, bs, 1.0)
    v[:, 5] = v[:, 2]
    tinv, tv = (torch.from_numpy(x).to(cuda_device) for x in (inv, v))
    got = ops.smw_update(tinv, tv, decay=0.95, cscale=float("inf"))
    assert not torch.isfinite(got).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 160])
def test_smw_update_large_slabs_are_bitwise_one_another(cuda_device, k):
    """inv = [[A, A], [A, A]] (A symmetric, 128 x 128) makes M's and Y's
    columns 128..255 copies of 0..127: the second slab of the solve
    (k <= 128), or the LU's other columns (k > 128), computes them as
    the first does, so out's two column halves are bitwise equal."""
    r = np.random.default_rng(k)
    a = r.standard_normal((2, 128, 128)).astype(np.float32)
    a = a + a.transpose(0, 2, 1)
    inv = np.concatenate([np.concatenate([a, a], 2)] * 2, 1)
    v = r.standard_normal((2, k, 256)).astype(np.float32)
    tinv, tv = (torch.from_numpy(x).to(cuda_device) for x in (inv, v))
    got = ops.smw_update(tinv, tv, decay=0.95, cscale=0.05)
    assert torch.isfinite(got).all()
    assert torch.equal(got[:, :, 128:], got[:, :, :128])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 160])
def test_smw_update_large_chunks_are_bitwise_one_chunk(cuda_device,
                                                      monkeypatch, k):
    from repro_torch.kernels import smw_update as ks

    inv, v = (torch.from_numpy(x).to(cuda_device)
              for x in _smw_case(7, 5, k, 176, 1.0))
    whole = ops.smw_update(inv, v, decay=0.95, cscale=0.05)
    plan = ks.smw_plan
    monkeypatch.setattr(ks, "smw_plan", lambda nb, bs, kk: plan(
        nb, bs, kk, budget=2 * ks.block_bytes(bs, kk)))
    assert len(ks.smw_plan(5, 176, k)) == 3
    ops.reset_launch_counts()
    parts = ops.smw_update(inv, v, decay=0.95, cscale=0.05)
    torch.cuda.synchronize()
    assert ops.launch_counts()["smw_update"] == 3 * len(ks.smw_schedule(k))
    assert torch.equal(whole, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 100])
def test_smw_lu_solve_is_the_slab_solve_bitwise(cuda_device, k):
    """The blocked LU launched alone on k <= 128 (the route takes it
    above): every entry of Z goes through the operations of the slab
    kernel's unblocked elimination in its order (explicit fp32 fmas on
    both), so Z is bitwise the slab solve's; k 100 ends on a ragged
    panel of 4."""
    from repro_torch.core.quantize import hilo_matmul
    from repro_torch.kernels import smw_update as ks

    inv, v = (torch.from_numpy(x).to(cuda_device)
              for x in _smw_case(k, 3, k, 256, 1.0))
    m = (inv + inv.transpose(1, 2)) * (0.5 / 0.95)
    y = hilo_matmul(v, m).contiguous()
    s = hilo_matmul(y, v.transpose(1, 2)).contiguous()
    inv_c = 2048 / 0.05
    ops.reset_launch_counts()
    lu = ks.solve(s, y, inv_c, "lu")
    slab = ks.solve(s, y, inv_c, "slab")
    torch.cuda.synchronize()
    assert ops.launch_keys()["smw_update"] == {
        f"solve_lu_k{k}": len(ks.lu_schedule(k)), f"solve_slab_k{k}": 1}
    assert torch.isfinite(lu).all()
    assert torch.equal(lu, slab)
    want = torch.linalg.solve(s + torch.eye(k, device=cuda_device) * inv_c,
                              y)
    assert (lu - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_smw_update_large_route_stages(cuda_device):
    """``route_stages`` runs the route's own launches: its out is bitwise
    a call's, its S and Y within the tolerance of the plain products, and
    Z solves (S + I/c) Z = Y."""
    from repro_torch.core.quantize import hilo_matmul
    from repro_torch.kernels import smw_update as ks

    inv, v = (torch.from_numpy(x).to(cuda_device)
              for x in _smw_case(3, 2, 160, 176, 1.0))
    got = ks.route_stages(inv, v, decay=0.95, cscale=0.05)
    assert torch.equal(got["out"], ops.smw_update(inv, v, decay=0.95,
                                                  cscale=0.05))
    m = (inv + inv.transpose(1, 2)) * (0.5 / 0.95)
    y = hilo_matmul(v, m)
    s = hilo_matmul(y, v.transpose(1, 2))
    for name, want in (("y", y), ("s", s)):
        assert (got[name] - want).abs().max() <= 1e-4 * want.abs().max()
    sc = got["s"].double() + torch.eye(160, device=cuda_device,
                                       dtype=torch.float64) / 0.05
    z = got["z"].double()
    resid = sc @ z - got["y"].double()
    assert resid.abs().max() <= 1e-4 * (sc.abs() @ z.abs()).max()


@pytest.mark.cuda
def test_smw_update_and_gram_large_on_a_side_stream(cuda_device):
    """The large routes on a side stream (their workspace taken from the
    allocator there): bitwise the main stream's, every launch on the
    side stream."""
    inv, v = (torch.from_numpy(x).to(cuda_device)
              for x in _smw_case(8, 4, 192, 256, 1.0))
    a = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (512, 3, 176)).astype(np.float32)).to(cuda_device)
    want_s = ops.smw_update(inv, v, decay=0.95, cscale=0.05)
    want_g = ops.fused_gram_inv(a, rel_damp=0.05, **KW)
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    ops.reset_launch_counts()
    with torch.cuda.stream(side):
        got_s = ops.smw_update(inv, v, decay=0.95, cscale=0.05)
        got_g = ops.fused_gram_inv(a, rel_damp=0.05, **KW)
    junk = [torch.empty(1 << 26, device=cuda_device).fill_(float("nan"))
            for _ in range(4)]
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    torch.cuda.synchronize()
    del junk
    streams = ops.launch_streams()
    for name in ("smw_update", "fused_gram_inv", "neumann_inv"):
        assert list(streams[name]) == [side.cuda_stream], name
    assert torch.equal(got_s, want_s) and torch.equal(got_g, want_g)


def _slices(x, ld16):
    """bf16 hi and lo slices of fp32 ``x`` (round to nearest even, as the
    kernels split), its rows padded with zeros to ``ld16``."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    pad = ld16 - x.shape[-1]
    return tuple(torch.nn.functional.pad(t, (0, pad)).contiguous()
                 for t in (hi, lo))


def _hilo_tma_product(form, lv, rv, e=None):
    """One product of ``csrc/hilo_tma.cuh`` on the values ``lv`` (b, m,
    k) and ``rv`` (b, k, n), stored as ``form`` says and split as their
    writer would: ``l_t`` (the left stored k x m) and ``r_t`` (the right
    stored n x k) through ``smw_update``'s product entry, STORE;
    ``one_partial`` (L_H R_H, the left stored k x m) through
    ``fused_gram_inv``'s; ``sub`` (NEG_ACC writing F = E - acc alone, the
    left stored k x m) through ``smw_update``'s. Returns the (b, m, n)
    fp32 result."""
    from repro_torch.kernels import fused_gram_solve as kg
    from repro_torch.kernels import hilo_tma
    from repro_torch.kernels import smw_update as ks

    b, m, k = lv.shape
    n = rv.shape[2]
    lt, rt = form != "r_t", form == "r_t"
    one, sub = form == "one_partial", form == "sub"
    ls = lv.transpose(1, 2).contiguous() if lt else lv
    rs = rv.transpose(1, 2).contiguous() if rt else rv
    ss = hilo_tma.slice_stride
    lh, ll = _slices(ls, ss(ls.shape[2]))
    rh, rl = _slices(rs, ss(rs.shape[2]))
    out = torch.full((b, m, n), float("nan"), device=lv.device)
    res = hilo_tma.Out(out.data_ptr(), None, None)
    p = hilo_tma.Params(
        lh.data_ptr(), None if one else ll.data_ptr(), rh.data_ptr(),
        None if one else rl.data_ptr(), e.data_ptr() if sub else None,
        hilo_tma.Out() if sub else res, res if sub else hilo_tma.Out(),
        n, n, ss(n), b, hilo_tma.NEG_ACC if sub else hilo_tma.STORE)
    p.m, p.k, p.l_ld16, p.r_ld16 = m, k, ss(ls.shape[2]), ss(rs.shape[2])
    p.l_blocks = p.r_blocks = b
    p.l_t, p.r_t = int(lt), int(rt)
    lib, entry = (kg.LIB, "fused_gram_inv_gram") if one else \
        (ks.LIB, "smw_update_product")
    lib.launch(entry, ctypes.byref(p),
               torch.cuda.current_stream(lv.device).cuda_stream)
    torch.cuda.synchronize(lv.device)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["l_t", "r_t", "one_partial", "sub"])
@pytest.mark.parametrize("m,n,k", [(64, 64, 64), (129, 176, 1024),
                                   (176, 129, 2048), (256, 256, 64),
                                   (1024, 1024, 1024), (256, 1024, 2048)])
def test_hilo_tma_forms_match_a_plain_hilo_product(cuda_device, form, m, n,
                                                   k):
    """The product's operand forms of the large smw_update and Gram
    routes against a plain hi/lo product (three fp32 matmuls of the
    slices, TF32 off; bf16-valued operands and L_H R_H alone for the one
    partial; E - that for ``sub``) within 1e-4 of the largest entry, at
    sides of 64 (half a 128-row tile), 129 and 176 (ragged tiles), 256
    and 1024 and depths of 64, 1024 and 2048 (past the sides' 1024, as a
    Gram's tokens go), each bitwise its repeat."""
    g = torch.Generator(device=cuda_device).manual_seed(m + 7 * n + k)
    lv = torch.randn(2, m, k, device=cuda_device, generator=g)
    rv = torch.randn(2, k, n, device=cuda_device, generator=g)
    if form == "one_partial":
        lv, rv = (x.to(torch.bfloat16).float() for x in (lv, rv))
    e = torch.randn(2, m, n, device=cuda_device, generator=g) * 30.0
    got = _hilo_tma_product(form, lv, rv, e)
    lh, ll = (x.float() for x in _slices(lv, k))
    rh, rl = (x.float() for x in _slices(rv, n))
    want = lh @ rh if form == "one_partial" else \
        lh @ rh + lh @ rl + ll @ rh
    if form == "sub":
        want = e - want
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert torch.equal(got, _hilo_tma_product(form, lv, rv, e))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [
    (1, 1, 1), (1, 257, 33), (33, 1, 257), (257, 33, 1), (257, 257, 257),
    (300, 200, 130),
    (2048, 1024, 2816),    # the timed shape (chip_smoke.py phase 3)
    (1000, 300, 1030),     # ragged in M, N and K
    (1800, 300, 2900),     # 240 ragged tiles: the persistent walk wraps
    (64, 8, 200),          # K under one k-step of 16
    (70, 12, 66),          # K 16-byte rows in fp32 only, N in neither
    (130, 36, 100)])       # K and N 16-byte rows in fp32 only
def test_bitslice_mm_kernel_matches_plain(cuda_device, m, k, n, dtype):
    r = np.random.default_rng(m * 1000 + k * 10 + n)
    a = torch.from_numpy(r.standard_normal((m, k))).to(cuda_device, dtype)
    b = torch.from_numpy(r.standard_normal((k, n))).to(cuda_device, dtype)
    before = ops.launch_counts()["bitslice_mm"]
    got = ops.bitslice_mm(a, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bitslice_mm"] == before + 1
    want = tref.bitslice_mm_ref(a, b)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_bitslice_mm_kernel_unaligned_base(cuda_device, dtype):
    """Contiguous operands whose data start one element past a 16-byte
    boundary (views at storage offset 1): element-wise copies in the
    same kernel, one launch."""
    m, k, n = 200, 64, 320
    r = np.random.default_rng(5)
    a = torch.from_numpy(r.standard_normal(m * k + 1)).to(
        cuda_device, dtype)[1:].view(m, k)
    b = torch.from_numpy(r.standard_normal(k * n + 1)).to(
        cuda_device, dtype)[1:].view(k, n)
    assert a.is_contiguous() and a.data_ptr() % 16
    before = ops.launch_counts()["bitslice_mm"]
    got = ops.bitslice_mm(a, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["bitslice_mm"] == before + 1
    want = tref.bitslice_mm_ref(a, b)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_bitslice_mm_kernel_bf16_one_partial(cuda_device):
    """bf16 input runs a_hi b_hi alone; its lo slices are zero, so it is
    the plain version's three partials and the fp32 kernel's on the
    upcast values (whose two lo partials add exact zeros)."""
    r = np.random.default_rng(6)
    a = torch.from_numpy(r.standard_normal((300, 520))).to(
        cuda_device, torch.bfloat16)
    b = torch.from_numpy(r.standard_normal((520, 400))).to(
        cuda_device, torch.bfloat16)
    got = ops.bitslice_mm(a, b)
    three = ops.bitslice_mm(a.float(), b.float())
    want = tref.bitslice_mm_ref(a, b)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale
    assert (got - three).abs().max() <= 1e-6 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,nb,n", [(700, 3, 33), (1030, 2, 100),
                                    (700, 2, 128), (1030, 1, 128),
                                    (128, 4, 64), (13, 3, 8)])
def test_fused_gram_inv_kernel_matches_plain(cuda_device, t, nb, n, dtype):
    r = np.random.default_rng(t + nb + n)
    a = torch.from_numpy(r.standard_normal((t, nb, n))).to(cuda_device,
                                                           dtype)
    kw = dict(rel_damp=0.05, **KW)
    before = ops.launch_counts()["fused_gram_inv"]
    got = ops.fused_gram_inv(a, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_gram_inv"] == before + 1
    want = tref.fused_gram_inv_ref(a, **kw)
    assert got.shape == want.shape == (nb, n, n)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_fused_gram_inv_kernel_refuses_large_blocks(cuda_device):
    a = torch.ones(64, 2, 1025, device=cuda_device)
    with pytest.raises(ValueError, match="n <= 1024"):
        ops.fused_gram_inv(a, rel_damp=0.05, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,nb,n", [(2048, 3, 129), (2048, 4, 176),
                                    (2048, 3, 256), (2048, 2, 512),
                                    (2048, 2, 1024), (700, 2, 130)])
def test_fused_gram_inv_large_kernel_matches_plain(cuda_device, t, nb, n,
                                                   dtype):
    """The large route against the plain version and against the
    two-step route (the Gram, then neumann_inv); its launches (the
    activations' split, the Gram and the finish, then neumann_inv's 52)
    and bitwise its repeat."""
    from repro_torch.core import soi
    from repro_torch.kernels import fused_gram_solve as kg

    r = np.random.default_rng(t + nb + n)
    a = torch.from_numpy(r.standard_normal((t, nb, n))).to(cuda_device,
                                                           dtype)
    kw = dict(rel_damp=0.05, **KW)
    ops.reset_launch_counts()
    got = ops.fused_gram_inv(a, **kw)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {k: counts[k] for k in ("fused_gram_inv", "neumann_inv")} == \
        kg.expected_launches(a.shape, dtype, **KW) == \
        {"fused_gram_inv": 3, "neumann_inv": 52}
    assert ops.launch_keys()["fused_gram_inv"] == {f"n{n}": 3}
    want = tref.fused_gram_inv_ref(a, **kw)
    assert got.shape == want.shape == (nb, n, n)
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    # the two-step route forms its Gram in plain fp32: the reference's
    # cross-route tolerance (tests/test_kernels.py), atol 5e-3 on entries
    # of order 1, relative to the largest entry above 1
    gram = soi.gram_from_tokens(a.float())
    two = ops.neumann_inv(gram.contiguous(),
                          soi.tikhonov_damping(gram, 0.05), **KW)
    assert (got - two).abs().max() <= 5e-3 * max(1.0, two.abs().max())
    assert torch.equal(got, ops.fused_gram_inv(a, **kw))


@pytest.mark.cuda
def test_fused_gram_inv_large_chunks_are_bitwise_one_chunk(cuda_device,
                                                          monkeypatch):
    from repro_torch.kernels import fused_gram_solve as kg

    a = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (300, 5, 200)).astype(np.float32)).to(cuda_device)
    whole = ops.fused_gram_inv(a, rel_damp=0.05, **KW)
    plan = kg.gram_plan
    monkeypatch.setattr(kg, "gram_plan", lambda nb, n, t, sl: plan(
        nb, n, t, sl, budget=2 * kg.block_bytes(t, n, sl)))
    assert len(kg.gram_plan(5, 200, 300, 2)) == 3
    ops.reset_launch_counts()
    parts = ops.fused_gram_inv(a, rel_damp=0.05, **KW)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_gram_inv"] == 3 * kg.LARGE_LAUNCHES
    assert torch.equal(whole, parts)


@pytest.mark.cuda
@pytest.mark.parametrize("stack", [(2, 3), ()])
def test_fused_precond_kernel_on_stacked_and_unstacked_leaves(cuda_device,
                                                              stack):
    """The pooled WU through the kernel on leaves stacked like MoE
    experts, (L, e), and unstacked like the hybrid's tail, with a padded
    last block on both sides (176 = 128 + 48), against the same WU on
    the CPU (the kernel's plain version)."""
    from repro_torch.core import kfac, soi
    from repro_torch.core.soi import LinearSpec
    from repro_torch.solve.partition import make_wu_plan

    specs = {"moe/wg": LinearSpec(256, 176, stack),
             "moe/wu": LinearSpec(256, 176, stack, share_a_with="moe/wg"),
             "moe/wd": LinearSpec(176, 256, stack)}
    r = np.random.default_rng(len(stack))
    shapes = {n: soi.factor_shapes(s, 128) for n, s in specs.items()}
    inv = {n: {k + "_inv": torch.from_numpy(r.standard_normal(shp).astype(
        np.float32)) for k, shp in d.items()} for n, d in shapes.items()}
    grads = {n: torch.from_numpy(r.standard_normal(
        s.stack + (s.d_in, s.d_out)).astype(np.float32))
        for n, s in specs.items()}
    plan = make_wu_plan(specs, {n: {k: torch.empty(shp, device="meta")
                                    for k, shp in d.items()}
                                for n, d in shapes.items()})
    want = kfac.precondition_pooled(grads, inv, plan, use_kernel=True)
    before = ops.launch_counts()["fused_precond"]
    got = kfac.precondition_pooled(
        {n: g.to(cuda_device) for n, g in grads.items()},
        {n: {k: t.to(cuda_device) for k, t in d.items()}
         for n, d in inv.items()}, plan, use_kernel=True)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_precond"] == before + len(plan.groups)
    for n, w in want.items():
        assert got[n].shape == w.shape == stack + grads[n].shape[-2:]
        assert (got[n].cpu() - w).abs().max() <= 1e-4 * w.abs().max(), n


@pytest.mark.cuda
def test_neumann_inv_grouped_on_a_padded_288_wide_factor(cuda_device):
    """Mamba's x_proj G factor at the published widths: 288 outputs in
    three 128-blocks, the last holding 32 and zero padding, for a stack
    of 2 layers, grouped with an unpadded leaf; each against the plain
    version on the same blocks, with K-FAC's damping."""
    from repro_torch.core import soi

    r = np.random.default_rng(288)
    g = torch.from_numpy(r.standard_normal((2, 512, 288)).astype(
        np.float32))
    padded = (soi.blocked_gram(g, 128) * 512).reshape(-1, 128, 128)
    assert padded.shape == (6, 128, 128)
    assert float(padded[2, 32:].abs().max()) == 0.0
    full = torch.from_numpy(_damped(7, 4, 128)[0])
    blocks = [padded.contiguous(), full]
    damps = [soi.tikhonov_damping(b, 0.03) for b in blocks]
    before = ops.launch_counts()["neumann_inv"]
    got = ops.neumann_inv_grouped([b.to(cuda_device) for b in blocks],
                                  [d.to(cuda_device) for d in damps], **KW)
    torch.cuda.synchronize()
    assert ops.launch_counts()["neumann_inv"] == before + 1
    for b, d, x in zip(blocks, damps, got):
        want = tref.neumann_inv_ref(b.to(cuda_device), d.to(cuda_device),
                                    **KW)
        assert (x - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
def test_engine_decode_chunk_matches_static_on_the_card(cuda_device):
    """One decode chunk of the serving engine on the card, with no host
    synchronisation inside it (``set_sync_debug_mode("error")`` raises on
    one), gives the static path's greedy tokens for the same prompt; an
    idle slot rides along. qwen2-0.5b's smoke config in fp32, weights
    from seed 0; the serving path launches no custom kernel."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as tsteps
    from repro_torch.serve import EngineConfig, Request, ServeEngine

    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                              dtype="float32")
    mod = tsteps.model_module(cfg)
    params = tsteps.init_params(
        cfg, generator=torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab, size=13).astype(np.int32)
    gen = 9
    with torch.no_grad():
        cache = mod.init_cache(cfg, 1, len(prompt) + gen,
                               device=cuda_device)
        logits, cache = mod.prefill(
            cfg, params,
            {"tokens": torch.from_numpy(prompt[None]).to(cuda_device)},
            cache)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        want = [tok]
        for _ in range(gen - 1):
            logits, cache = mod.decode_step(cfg, params, tok, cache)
            tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
            want.append(tok)
        want = torch.cat(want, 1)[0].tolist()

        eng = ServeEngine(cfg, params, EngineConfig(
            max_slots=2, max_len=32, decode_chunk=gen - 1))
        eng.submit(Request(0, prompt, max_new_tokens=gen))
        eng._do_admissions()
        (slot, st), = eng._slots.items()
        before = ops.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            toks, emitted = eng.decode_chunk()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert ops.launch_counts() == before
        got = st.tokens + toks[emitted[:, slot], slot].tolist()
    assert got == want
    assert not bool(eng._active[slot])


def _serve_setup(cuda_device, dtype="float32"):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as tsteps

    cfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"), dtype=dtype)
    params = tsteps.init_params(
        cfg, generator=torch.Generator(device=cuda_device).manual_seed(0),
        device=cuda_device)
    return cfg, params


def _sync_checked_chunk(eng):
    """One decode chunk (after the engine's pre-chunk host work) under
    ``set_sync_debug_mode("error")``, which raises on a host sync; no
    custom kernel launches."""
    eng._pre_decode()
    before = ops.launch_counts()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        toks, emitted = eng.decode_chunk()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert ops.launch_counts() == before
    return toks, emitted


@pytest.mark.cuda
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_engine_graph_chunk_matches_op_by_op_on_the_card(
        cuda_device, quant, paged, monkeypatch):
    """A greedy engine's decode chunk runs on the card as one CUDA graph:
    over a trace whose requests join and leave between chunks (the paged
    engine sharing a prefix), its tokens and its pool are bitwise those
    of the chunk issued op by op, the same kernels on the same
    inputs."""
    from repro_torch.serve import (EngineConfig, PagedConfig,
                                   PagedServeEngine, Request, ServeEngine)
    from repro_torch.serve import engine as tengine

    cfg, params = _serve_setup(cuda_device)
    kw = dict(max_slots=3, max_len=48, decode_chunk=4, quant=quant)
    rng = np.random.default_rng(5)
    head = rng.integers(0, cfg.vocab, size=16).astype(np.int32)
    reqs = [Request(i, np.concatenate([head, rng.integers(
        0, cfg.vocab, size=4 + i).astype(np.int32)]),
        max_new_tokens=6 + i % 5) for i in range(8)]

    def drive():
        eng = PagedServeEngine(cfg, params, PagedConfig(
            block_len=8, prefix_cache=True, **kw)) if paged else \
            ServeEngine(cfg, params, EngineConfig(**kw))
        with torch.no_grad():
            done = eng.run(reqs, arrivals=[i // 2 for i in range(8)])
        return ({rid: f.tokens for rid, f in done.items()},
                {k: v.clone() for k, v in eng._pool.items()}, eng)

    toks, pool, eng = drive()
    assert eng._program != eng._chunk_program
    monkeypatch.setattr(tengine, "_capture", lambda fn, state, n: fn)
    want_toks, want_pool, eng = drive()
    assert toks == want_toks
    assert all(len(toks[r.rid]) == r.max_new_tokens for r in reqs)
    for k, v in want_pool.items():
        assert torch.equal(pool[k], v), k


@pytest.mark.cuda
def test_paged_write_shared_target_lands_on_the_card(cuda_device):
    """The duplicate-index hazard of the paged decode write: idle rows'
    clamped targets (an all-unmapped table, ``idx`` past it: block
    n_blocks - 1, column 0) are a live row's target. Every one of 200
    writes of fresh values must leave the live row's value there,
    bitwise; then the same in an engine's decode chunk, whose live slot
    grows into block n_blocks - 1 and writes its column 0 while seven
    idle slots aim there, against the slot engine's column."""
    from repro_torch.models import layers as tlayers
    from repro_torch.serve import (EngineConfig, PagedConfig,
                                   PagedServeEngine, Request, ServeEngine)

    nb, bl, B, nbps = 8, 16, 64, 4
    g = torch.Generator(device=cuda_device).manual_seed(0)
    ck = torch.randn((nb, bl, 2, 64), generator=g, device=cuda_device)
    cv, cp = ck.clone(), torch.zeros((nb, bl), dtype=torch.int32,
                                     device=cuda_device)
    table = torch.full((B, nbps), nb, dtype=torch.int32, device=cuda_device)
    table[B // 2, 0] = nb - 1
    idx = torch.full((B,), nbps * bl, dtype=torch.int32, device=cuda_device)
    idx[B // 2] = 0
    for i in range(200):
        k = torch.randn((B, 1, 2, 64), generator=g, device=cuda_device)
        qp = torch.full((B, 1), i, dtype=torch.int32, device=cuda_device)
        tlayers.paged_kv_write(ck, cv, cp, table, k, k, qp, idx)
        assert torch.equal(ck[nb - 1, 0], k[B // 2, 0]), i
        assert int(cp[nb - 1, 0]) == i
    assert torch.equal(ck[:nb - 1], cv[:nb - 1])

    cfg, params = _serve_setup(cuda_device)
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab, size=bl).astype(np.int32)
    other = np.random.default_rng(3).integers(
        0, cfg.vocab, size=5).astype(np.int32)
    ecfg = dict(max_slots=8, max_len=64, decode_chunk=4)
    with torch.no_grad():
        eng = PagedServeEngine(cfg, params, PagedConfig(
            block_len=bl, **ecfg))
        n_blocks = eng._n_blocks
        # a one-token request takes block n_blocks - 1 and frees it at
        # once: the live request's first decode block is that one
        eng.submit(Request(0, other, max_new_tokens=1))
        eng.submit(Request(1, prompt, max_new_tokens=5))
        eng._do_admissions()
        eng._harvest()
        (slot, st), = eng._slots.items()
        toks, emitted = _sync_checked_chunk(eng)
        assert int(eng._pool["table"][slot, 1]) == n_blocks - 1
        ref = ServeEngine(cfg, params, EngineConfig(**ecfg))
        ref.submit(Request(1, prompt, max_new_tokens=5))
        ref._do_admissions()
        (rslot, rst), = ref._slots.items()
        rtoks, _ = ref.decode_chunk()
    assert st.tokens + toks[emitted[:, slot], slot].tolist() == \
        rst.tokens + rtoks[:, rslot].tolist()
    for key in ("layers/k", "layers/v", "layers/pos"):
        assert torch.equal(eng._pool[key][:, n_blocks - 1, 0],
                           ref._pool[key][:, rslot, bl]), key


@pytest.mark.cuda
@pytest.mark.parametrize("paged,quant", [(True, "none"), (False, "int8"),
                                         (True, "int8")])
def test_serve_chunk_has_no_host_sync_on_the_card(cuda_device, paged,
                                                  quant):
    """A paged chunk (table growth, paged steps) and an int8 chunk on
    either pool (fp32 dequantization, the dirty requant) with four live
    slots, under ``set_sync_debug_mode("error")``; every live slot emits
    every step."""
    from repro_torch.serve import (EngineConfig, PagedConfig,
                                   PagedServeEngine, Request, ServeEngine)

    cfg, params = _serve_setup(cuda_device, "bfloat16")
    ecfg = dict(max_slots=6, max_len=64, decode_chunk=8, quant=quant)
    with torch.no_grad():
        eng = (PagedServeEngine(cfg, params, PagedConfig(**ecfg))
               if paged else ServeEngine(cfg, params, EngineConfig(**ecfg)))
        for i in range(4):
            eng.submit(Request(i, np.random.default_rng(i).integers(
                0, cfg.vocab, size=10 + 3 * i).astype(np.int32),
                max_new_tokens=20))
        eng._do_admissions()
        toks, emitted = _sync_checked_chunk(eng)
    live = sorted(eng._slots)
    assert bool(emitted[:, live].all()) and not bool(
        emitted[:, [s for s in range(6) if s not in live]].any())
    assert bool(((toks >= 0) & (toks < cfg.vocab)).all())
    if paged:
        led = eng._ledger
        assert int(eng._pool["free_top"]) == led.top
        assert np.array_equal(eng._pool["table"].cpu().numpy(), led.table)


@pytest.mark.cuda
def test_wu_fusion_kernel_route_matches_per_leaf_on_the_card(cuda_device):
    """``benchmarks.wu_fusion`` on the card at smoke size: ``fused`` and
    ``fused+ew_pool`` bitwise ``per_leaf``, fewer product kernels fused,
    and ``fused+kernel`` (the ``fused_precond`` kernel) within
    ``KERNEL_TOL`` of ``per_leaf``'s momentum."""
    from repro_torch.benchmarks import wu_fusion

    before = ops.launch_counts()["fused_precond"]
    c = wu_fusion._wu_case("qwen1.5-0.5b", device=cuda_device, reps=3)
    assert ops.launch_counts()["fused_precond"] > before
    assert c["bitwise_equal"] == {"fused": True, "fused+ew_pool": True}
    v = c["variants"]
    assert v["fused"]["gemms"] < v["per_leaf"]["gemms"]
    assert all(x["kernels"] > 0 for x in v.values())
    assert c["kernel_max_rel_err"] <= wu_fusion.KERNEL_TOL


@pytest.mark.cuda
def test_precision_inv_demo_kernel_inverse_matches_plain(cuda_device):
    """``examples.precision_inv_demo``'s 128-block through the CUDA
    ``neumann_inv`` at 20/4/2: the plain version's inverse within the
    file's tolerance, and the example's residual bound."""
    from repro_torch.examples import precision_inv_demo

    before = ops.launch_counts()["neumann_inv"]
    out = precision_inv_demo.run(cuda_device)
    assert ops.launch_counts()["neumann_inv"] == before + 1
    want = tref.neumann_inv_ref(out["blocks"], out["damping"], **KW)
    assert (out["inverse"] - want).abs().max() <= 1e-4 * want.abs().max()
    assert out["resid"] < 1e-3 and out["final_bits"] >= 16.0


@pytest.mark.cuda
@pytest.mark.parametrize("leaves", [
    # block 128: one side, one launch a rank
    (("wq", "A", 40, 128), ("wq", "G", 24, 128), ("wd", "G", 9, 128)),
    # block 256: sides 256 and 176 on the large route; 60 blocks of 256
    # take three <= 1 GiB chunks on one rank and two on each of two
    (("wq", "A", 36, 256), ("wq", "G", 24, 256), ("wd", "A", 20, 176)),
], ids=["block128", "block256"])
def test_distributed_refresh_two_ranks_on_one_card(cuda_device, leaves):
    """Two gloo ranks (on ``cuda:0`` when the machine has one card) run
    the block-parallel refresh: each rank's ``neumann_inv`` launches are
    its plan rows' schedule and invert its pool rows' blocks alone, and
    the gathered inverses are bitwise the one-rank grouped refresh (every
    block is computed on its own, also when a rank's chunks differ from
    the one-rank run's)."""
    import _torch_dist_ranks as ranks_mod
    from repro_torch.dist.spawn import run_ranks

    ops.build_all()
    torch.cuda.empty_cache()
    res = run_ranks(ranks_mod.cuda_refresh_rank, 2, device="cuda",
                    args=(leaves,), timeout=600)
    for r in res:
        assert r["bitwise"], r
        assert r["launches"] == r["expected"] > 0, r
        # the rank's pool rows, not every block
        assert r["items"] == {f"n{bs}": n
                              for bs, n in r["per_device"].items()}, r


@pytest.mark.cuda
def test_model_parallel_two_ranks_on_one_card(cuda_device):
    """``--model-parallel 2 --dist-inv`` on two gloo ranks (on ``cuda:0``
    when the machine has one card): 4 K-FAC steps of dense smoke at fp32
    and block 32, each step's loss within 1e-5 of one rank's on the card
    (only fp32 summation orders differ), the gathered params equal on
    both ranks, ``fused_precond`` once a WU group a step on each rank, and
    the blocks ``neumann_inv`` inverted over both ranks each block of the
    one-rank refresh once a refresh."""
    import _torch_dist_ranks as ranks_mod
    from repro_torch.dist.spawn import run_ranks

    ops.build_all()
    torch.cuda.empty_cache()
    res = run_ranks(ranks_mod.cuda_tp_rank, 2, device="cuda", timeout=600)
    one = ranks_mod.cuda_tp_one_rank(cuda_device)
    assert res[0]["digest"] == res[1]["digest"]
    blocks = {}
    for r in res:
        np.testing.assert_allclose(r["losses"], one["losses"], rtol=1e-5)
        assert r["fused_precond"] == r["fused_precond_expected"] > 0, r
        for k, n in r["blocks"].items():
            blocks[k] = blocks.get(k, 0) + n
    assert blocks == one["blocks"]
