"""repro_torch's CUDA kernels against their plain PyTorch versions, on
an NVIDIA GPU. Every test is marked ``cuda`` and skips inside the test
when no GPU is present. The file imports neither jax nor ``repro``, so
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
    a = torch.eye(130, device=cuda_device).expand(2, 130, 130).contiguous()
    with pytest.raises(ValueError, match="n <= 128"):
        ops.neumann_inv(a, 0.1, **KW)


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
    v = torch.zeros(2, 130, 32, device=cuda_device)
    with pytest.raises(ValueError, match="k <= 128|bs, k <= 128"):
        ops.smw_update(inv, v, decay=0.95, cscale=0.05)


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
    a = torch.ones(64, 2, 130, device=cuda_device)
    with pytest.raises(ValueError, match="n <= 128"):
        ops.fused_gram_inv(a, rel_damp=0.05, **KW)


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
