"""repro_torch kernels: the plain versions against the JAX reference's
oracles and Pallas kernels (interpret mode), and the device dispatch.
The CUDA kernels themselves are held to the plain versions on the card
by tests/test_torch_cuda.py.

Tolerances and why:
  * neumann_inv plain vs ``ref.neumann_inv_ref``: 5e-5 relative to the
    largest entry. ``tests/test_kernels.py`` holds the Pallas kernel to
    that oracle at atol 1e-5, but there both run XLA's fp32 matmul;
    across frameworks the exact bf16 partial products are summed in
    another order, and the 127 chained products carry that difference
    to the algorithm's own error against the exact inverse (measured:
    up to 2.1e-5 relative between the frameworks, ~5e-5 for either
    against float64 ``inv``). ``composed_inverse`` likewise.
  * neumann_inv plain vs the Pallas kernel: only at n = 128, where the
    kernel does not pad; 5e-5 relative for the same reason.
  * fused_precond plain vs ``ref.fused_precond_ref``: 1e-5 relative
    (summation order); vs ``exact_two_sided`` below 1e-4 relative, the
    bound ``tests/test_wu_fusion.py`` puts on the kernel.
  * bitslice_mm plain vs ``ref.bitslice_mm_ref`` and the Pallas kernel:
    atol 1e-4, the reference's own (``tests/test_kernels.py``).
  * fused_gram_inv plain vs ``ref.fused_gram_inv_ref`` and the Pallas
    kernel: atol 2e-4 at counts 20/4/2 and 5e-4 at 14/3/1, the
    reference's own; vs ``exact_gram_inv`` and the two-step route
    (materialised Gram, then ``composed_inverse``) as the reference
    holds its kernel.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import one_thread  # noqa: F401 (autouse)

from repro.core import precision_inv as jpi
from repro.kernels import bitslice_mm as j_bitslice_mm
from repro.kernels import fused_gram_inv as j_fused_gram_inv
from repro.kernels import fused_precond as j_fused_precond
from repro.kernels import neumann_inv as j_neumann_inv
from repro.kernels import ref as jref
from repro_torch.core import precision_inv as tpi
from repro_torch.kernels import bitslice_mm as t_bitslice_mm
from repro_torch.kernels import fused_gram_solve as t_fused_gram_solve
from repro_torch.kernels import fused_precond as t_fused_precond
from repro_torch.kernels import neumann_inv as t_neumann_inv
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

KW = dict(ns_iters=20, taylor_terms=4, refine_steps=2)   # KFACConfig counts


def _spd(r, nb, n):
    m = r.standard_normal((nb, n, n)).astype(np.float32)
    return (np.einsum("bij,bkj->bik", m, m) / n
            + 1e-3 * np.eye(n, dtype=np.float32))


def _damped(seed, nb, n):
    r = np.random.default_rng(seed)
    a = _spd(r, nb, n)
    damp = (0.03 * np.trace(a, axis1=1, axis2=2) / n).astype(np.float32)
    return a, damp


def _tiles(seed, n, bi, bo):
    r = np.random.default_rng(seed)
    return tuple(r.standard_normal(s).astype(np.float32)
                 for s in ((n, bi, bi), (n, bi, bo), (n, bo, bo)))


def _assert_rel(got, want, tol):
    """max |got - want| <= tol * max |want|."""
    want = np.asarray(want)
    err = np.max(np.abs(got - want))
    assert err <= tol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# neumann_inv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb,n", [(1, 128), (3, 96), (2, 130), (4, 64),
                                  (2, 32)])
def test_neumann_inv_plain_matches_reference_oracle(nb, n):
    a, damp = _damped(nb * 1000 + n, nb, n)
    got = tref.neumann_inv_ref(torch.from_numpy(a), torch.from_numpy(damp),
                               **KW)
    want = jref.neumann_inv_ref(jnp.asarray(a), jnp.asarray(damp), **KW)
    _assert_rel(got.numpy(), want, 5e-5)


def test_neumann_inv_plain_matches_pallas_kernel_at_128():
    a, damp = _damped(5, 2, 128)
    got = tref.neumann_inv_ref(torch.from_numpy(a), torch.from_numpy(damp),
                               **KW)
    want = j_neumann_inv(jnp.asarray(a), jnp.asarray(damp), **KW)
    _assert_rel(got.numpy(), want, 5e-5)


def test_neumann_inv_scalar_damping_broadcasts():
    a, _ = _damped(6, 3, 32)
    ta = torch.from_numpy(a)
    got = tref.neumann_inv_ref(ta, 0.1, **KW)
    vec = tref.neumann_inv_ref(ta, torch.full((3,), 0.1), **KW)
    torch.testing.assert_close(got, vec, rtol=0, atol=0)
    with pytest.raises(ValueError, match="damping"):
        tref.neumann_inv_ref(ta, torch.ones(2), **KW)


@pytest.mark.parametrize("taylor", [4, 1])
def test_composed_inverse_matches_reference(taylor):
    a, damp = _damped(7, 3, 64)
    got = tpi.composed_inverse(torch.from_numpy(a), torch.from_numpy(damp),
                               ns_iters=20, taylor_terms=taylor,
                               refine_steps=2)
    want = np.stack([np.asarray(jpi.composed_inverse(
        jnp.asarray(a[i]), float(damp[i]), ns_iters=20, taylor_terms=taylor,
        refine_steps=2)) for i in range(3)])
    _assert_rel(got.numpy(), want, 5e-5)


def test_neumann_inv_is_accurate_inverse():
    """The algorithm (not a port artefact): at the paper's damping the
    hi/lo ladder reaches ~2^-14 relative, as the reference's own test
    states."""
    a, damp = _damped(11, 2, 128)
    got = tref.neumann_inv_ref(torch.from_numpy(a), torch.from_numpy(damp),
                               ns_iters=20, taylor_terms=5, refine_steps=2)
    ad = a + damp[:, None, None] * np.eye(128, dtype=np.float32)
    exact = np.linalg.inv(ad.astype(np.float64))
    rel = np.max(np.abs(got.numpy() - exact)) / np.max(np.abs(exact))
    assert rel < 2.0 ** -13


# leaves of one refresh: (nb, n, damping form); an empty leaf, per-block
# and scalar dampings, and (second case) two block sides
GROUPED_CASES = [
    [(3, 32, "vec"), (1, 32, "scalar"), (5, 32, "vec"), (0, 32, "scalar")],
    [(2, 48, "vec"), (3, 16, "vec"), (1, 48, "scalar"), (4, 16, "scalar")],
]


def _grouped_leaves(case):
    blocks, damps = [], []
    for k, (nb, n, form) in enumerate(case):
        a, d = _damped(100 + k, nb, n)
        blocks.append(torch.from_numpy(a))
        damps.append(torch.from_numpy(d) if form == "vec" else 0.05 * (k + 1))
    return blocks, damps


@pytest.mark.parametrize("case", GROUPED_CASES)
def test_neumann_inv_grouped_plain_route_is_the_per_leaf_call(case):
    """The grouped entry on CPU tensors returns, leaf by leaf, exactly
    what ``ops.neumann_inv`` returns, and launches nothing."""
    ops.reset_launch_counts()
    blocks, damps = _grouped_leaves(case)
    got = ops.neumann_inv_grouped(blocks, damps, **KW)
    assert len(got) == len(blocks)
    for a, d, g in zip(blocks, damps, got):
        assert g.shape == a.shape
        torch.testing.assert_close(g, ops.neumann_inv(a, d, **KW), rtol=0,
                                   atol=0)
    assert ops.launch_counts()["neumann_inv"] == 0


@pytest.mark.parametrize("case", GROUPED_CASES)
def test_neumann_inv_grouped_plain_matches_reference_oracle(case):
    blocks, damps = _grouped_leaves(case)
    got = ops.neumann_inv_grouped(blocks, damps, **KW)
    for a, d, g in zip(blocks, damps, got):
        if a.shape[0] == 0:
            continue
        d = np.broadcast_to(np.asarray(d, np.float32), a.shape[:1])
        want = jref.neumann_inv_ref(jnp.asarray(a.numpy()), jnp.asarray(d),
                                    **KW)
        _assert_rel(g.numpy(), want, 5e-5)


def test_neumann_inv_leaf_tables_split_long_lists():
    """The CUDA wrapper's launch tables (host side): leaves without
    blocks dropped, at most MAX_LEAVES a launch, the leaves' pointers in
    order and ``start`` the prefix sums of their block counts."""
    counts = [3, 0, 528, 192] * 20
    blocks = [torch.empty(c, 4, 4) for c in counts]
    lams = [torch.empty(c) for c in counts]
    outs = [torch.empty_like(b) for b in blocks]
    tables = t_neumann_inv.leaf_tables(blocks, lams, outs)
    live = [i for i, c in enumerate(counts) if c]
    assert [t.count for t in tables] == [t_neumann_inv.MAX_LEAVES,
                                         len(live) - t_neumann_inv.MAX_LEAVES]
    k = 0
    for t in tables:
        assert t.start[0] == 0
        for j in range(t.count):
            i = live[k]
            k += 1
            assert t.a[j] == blocks[i].data_ptr()
            assert t.damping[j] == lams[i].data_ptr()
            assert t.out[j] == outs[i].data_ptr()
            assert t.start[j + 1] - t.start[j] == counts[i]
    assert k == len(live)


def test_neumann_inv_grouped_refuses_bad_lists():
    a, d = _damped(3, 2, 16)
    ta = torch.from_numpy(a)
    with pytest.raises(ValueError, match="dampings"):
        ops.neumann_inv_grouped([ta, ta], [torch.from_numpy(d)], **KW)
    assert ops.neumann_inv_grouped([], [], **KW) == []
    with pytest.raises(ValueError, match="CUDA"):
        t_neumann_inv.neumann_inv_grouped([ta], [0.1], **KW)


# ---------------------------------------------------------------------------
# fused_precond
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(5, 16, 8), (3, 128, 64), (2, 130, 200),
                                   (4, 128, 128)])
def test_fused_precond_plain_matches_reference(shape):
    a, g, gi = _tiles(0, *shape)
    out, dots = tref.fused_precond_ref(torch.from_numpy(a),
                                       torch.from_numpy(g),
                                       torch.from_numpy(gi))
    want_out, want_dots = jref.fused_precond_ref(
        jnp.asarray(a), jnp.asarray(g), jnp.asarray(gi))
    _assert_rel(out.numpy(), want_out, 1e-5)
    np.testing.assert_allclose(dots.numpy(), np.asarray(want_dots),
                               rtol=1e-4, atol=1e-2)
    ex = np.asarray(jref.exact_two_sided(jnp.asarray(a), jnp.asarray(g),
                                         jnp.asarray(gi)))
    assert np.max(np.abs(out.numpy() - ex)) / np.max(np.abs(ex)) < 1e-4
    np.testing.assert_allclose(
        tref.exact_two_sided(torch.from_numpy(a), torch.from_numpy(g),
                             torch.from_numpy(gi)).numpy(),
        ex, rtol=1e-5, atol=1e-3)


def test_fused_precond_plain_matches_pallas_kernel():
    a, g, gi = _tiles(1, 3, 128, 128)
    out, dots = tref.fused_precond_ref(torch.from_numpy(a),
                                       torch.from_numpy(g),
                                       torch.from_numpy(gi))
    want_out, want_dots = j_fused_precond(jnp.asarray(a), jnp.asarray(g),
                                          jnp.asarray(gi))
    _assert_rel(out.numpy(), want_out, 1e-5)
    np.testing.assert_allclose(dots.numpy(), np.asarray(want_dots),
                               rtol=1e-4, atol=1e-2)


def _pools(seed, n, bi, bo, ma, mg, pattern):
    """Pools of (ma, bi, bi) and (mg, bo, bo) blocks, (n, bi, bo) tiles
    and int32 per-tile indices: ``plan`` is the WU plan's own pattern
    (runs of one A block, cycling G blocks), ``shuffled`` repeated and
    out of order."""
    r = np.random.default_rng(seed)
    pa = r.standard_normal((ma, bi, bi)).astype(np.float32)
    g = r.standard_normal((n, bi, bo)).astype(np.float32)
    pg = r.standard_normal((mg, bo, bo)).astype(np.float32)
    if pattern == "plan":
        t = np.arange(n)
        a_src, g_src = t // 2 % ma, t % mg
    else:
        a_src, g_src = r.integers(0, ma, n), r.integers(0, mg, n)
    return pa, g, pg, a_src.astype(np.int32), g_src.astype(np.int32)


POOL_CASES = [(6, 128, 128, 3, 2, "plan"),        # aligned
              (5, 100, 72, 2, 3, "plan"),         # unaligned
              (9, 32, 16, 4, 5, "shuffled")]      # repeated, out of order


@pytest.mark.parametrize("n,bi,bo,ma,mg,pattern", POOL_CASES)
def test_fused_precond_plain_indexed_is_the_gathered_call(n, bi, bo, ma, mg,
                                                          pattern):
    pa, g, pg, a_src, g_src = (torch.from_numpy(x) for x in _pools(
        n, n, bi, bo, ma, mg, pattern))
    got = tref.fused_precond_ref(pa, g, pg, a_src, g_src)
    want = tref.fused_precond_ref(pa[a_src.long()], g, pg[g_src.long()])
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("n,bi,bo,ma,mg,pattern", POOL_CASES)
def test_fused_precond_indexed_matches_reference_ops(n, bi, bo, ma, mg,
                                                     pattern):
    """``ops.fused_precond`` with pool indices on the CPU against the
    reference's ``kernels.ops.fused_precond`` (the Pallas kernel in
    interpret mode) on the gathered pools."""
    from repro.kernels import ops as jops

    pa, g, pg, a_src, g_src = _pools(n + 1, n, bi, bo, ma, mg, pattern)
    out, dots = ops.fused_precond(*(torch.from_numpy(x)
                                    for x in (pa, g, pg, a_src, g_src)))
    want_out, want_dots = jops.fused_precond(
        jnp.asarray(pa[a_src]), jnp.asarray(g), jnp.asarray(pg[g_src]))
    _assert_rel(out.numpy(), want_out, 1e-5)
    np.testing.assert_allclose(dots.numpy(), np.asarray(want_dots),
                               rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("bad,match", [
    (lambda a, b: (a.long(), b), "int32"),
    (lambda a, b: (a, b.to(torch.int16)), "int32"),
    (lambda a, b: (a[:-1], b), "shape"),
    (lambda a, b: (a, b[None]), "shape"),
    (lambda a, b: (a, None), "both"),
    (lambda a, b: (a * 0 + 3, b), "outside"),
    (lambda a, b: (a, b * 0 - 1), "outside")])
def test_fused_precond_refuses_bad_indices(bad, match):
    pa, g, pg, a_src, g_src = (torch.from_numpy(x) for x in _pools(
        3, 4, 16, 8, 3, 2, "shuffled"))
    with pytest.raises(ValueError, match=match):
        ops.fused_precond(pa, g, pg, *bad(a_src, g_src))


def test_fused_precond_dot_is_trust_region_mass():
    a, g, gi = (torch.from_numpy(x) for x in _tiles(2, 4, 16, 16))
    out, dots = tref.fused_precond_ref(a, g, gi)
    torch.testing.assert_close(dots, (out * g).sum(dim=(-2, -1)),
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# bitslice_mm
# ---------------------------------------------------------------------------

def _mats(seed, m, k, n, dtype=np.float32):
    r = np.random.default_rng(seed)
    return (r.standard_normal((m, k)).astype(dtype),
            r.standard_normal((k, n)).astype(dtype))


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (300, 200, 130), (64, 64, 64),
                                   (1, 257, 5)])
def test_bitslice_mm_plain_matches_reference(m, k, n):
    a, b = _mats(m * 1000 + k * 10 + n, m, k, n)
    got = tref.bitslice_mm_ref(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), jref.bitslice_mm_ref(a, b),
                               rtol=0, atol=1e-4)
    if m % 128 or n % 128:   # the Pallas kernel where it pads
        np.testing.assert_allclose(
            got.numpy(), j_bitslice_mm(a, b, bm=128, bn=128, bk=128),
            rtol=0, atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("m,k,n", [(96, 192, 64), (200, 64, 320),
                                   (33, 129, 257)])
def test_bitslice_mm_plain_dtypes_match_reference(m, k, n, dtype):
    """fp32, bf16 and fp16 inputs, each upcast to fp32 at entry."""
    r = np.random.default_rng(m + k + n)
    a = jnp.asarray(r.standard_normal((m, k)), jnp.dtype(dtype))
    b = jnp.asarray(r.standard_normal((k, n)), jnp.dtype(dtype))
    tdt = getattr(torch, dtype)
    ta = torch.from_numpy(np.array(a, np.float32)).to(tdt)
    tb = torch.from_numpy(np.array(b, np.float32)).to(tdt)
    got = ops.bitslice_mm(ta, tb)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), jref.bitslice_mm_ref(a, b),
                               rtol=0, atol=1e-4)


def test_bitslice_mm_plain_matches_pallas_kernel_fp16():
    a, b = _mats(7, 130, 96, 70, np.float16)
    got = ops.bitslice_mm(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(
        got.numpy(), j_bitslice_mm(a, b, bm=128, bn=128, bk=128),
        rtol=0, atol=1e-4)
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.max(np.abs(got.numpy() - exact)) / np.max(np.abs(exact)) < 1e-5


# ---------------------------------------------------------------------------
# fused_gram_inv
# ---------------------------------------------------------------------------

def _acts(seed, t, nb, n):
    return np.random.default_rng(seed).standard_normal(
        (t, nb, n)).astype(np.float32)


@pytest.mark.parametrize("t,nb,n,bt", [(512, 1, 128, 256), (700, 2, 100, 256),
                                       (128, 3, 64, 128),
                                       (1030, 1, 130, 512)])
def test_fused_gram_inv_plain_matches_reference(t, nb, n, bt):
    a = _acts(t + nb + n, t, nb, n)
    kw = dict(rel_damp=0.05, ns_iters=20, taylor_terms=4, refine_steps=2)
    got = ops.fused_gram_inv(torch.from_numpy(a), **kw)
    assert got.shape == (nb, n, n)
    np.testing.assert_allclose(got.numpy(), jref.fused_gram_inv_ref(a, **kw),
                               rtol=0, atol=2e-4)
    if n % 128:     # the Pallas kernel (interpret mode) where it pads n
        np.testing.assert_allclose(got.numpy(),
                                   j_fused_gram_inv(a, bt=bt, **kw),
                                   rtol=0, atol=2e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,nb,n", [(384, 2, 48), (500, 3, 96), (260, 4, 33)])
def test_fused_gram_inv_plain_dtypes_match_reference(t, nb, n, dtype):
    r = np.random.default_rng(t + 10 * nb + n)
    a = jnp.asarray(r.standard_normal((t, nb, n)), jnp.dtype(dtype))
    kw = dict(rel_damp=0.05, ns_iters=14, taylor_terms=3, refine_steps=1)
    ta = torch.from_numpy(np.array(a, np.float32)).to(getattr(torch, dtype))
    got = ops.fused_gram_inv(ta, **kw)
    np.testing.assert_allclose(
        got.numpy(), jref.fused_gram_inv_ref(a.astype(jnp.float32), **kw),
        rtol=0, atol=5e-4)


def test_fused_gram_inv_plain_matches_exact():
    a = _acts(5, 600, 2, 96)
    got = ops.fused_gram_inv(torch.from_numpy(a), rel_damp=0.05,
                             ns_iters=22, taylor_terms=5, refine_steps=2)
    exact = tref.exact_gram_inv(torch.from_numpy(a), 0.05)
    np.testing.assert_allclose(exact.numpy(), jref.exact_gram_inv(a, 0.05),
                               rtol=1e-5, atol=1e-5)
    assert float((got - exact).abs().max() / exact.abs().max()) < 1e-4


def test_fused_gram_inv_plain_matches_two_step_route():
    """Fused and two-step (materialised Gram, then the composed inverse)
    are one algorithm on differently formed Grams: the reference's
    cross-route tolerance, and both invert the damped Gram to 1e-4."""
    a = _acts(9, 512, 1, 128)
    kw = dict(ns_iters=14, taylor_terms=4, refine_steps=1)
    out_k = ops.fused_gram_inv(torch.from_numpy(a), rel_damp=0.05,
                               **kw)[0].numpy()
    gram = np.einsum("tbn,tbm->bnm", a, a)[0] / a.shape[0]
    lam = float(0.05 * np.trace(gram) / 128 + 1e-8)
    out_c = tpi.composed_inverse(torch.from_numpy(gram), lam, **kw).numpy()
    np.testing.assert_allclose(out_k, out_c, rtol=0, atol=5e-3)
    ad = gram + lam * np.eye(128, dtype=np.float32)
    for m in (out_k, out_c):
        assert np.max(np.abs(m @ ad - np.eye(128))) < 1e-4


# ---------------------------------------------------------------------------
# dispatch and wrappers
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    ops.reset_launch_counts()
    a, damp = _damped(3, 2, 32)
    ta, td = torch.from_numpy(a), torch.from_numpy(damp)
    torch.testing.assert_close(ops.neumann_inv(ta, td, **KW),
                               tref.neumann_inv_ref(ta, td, **KW),
                               rtol=0, atol=0)
    x = tuple(torch.from_numpy(v) for v in _tiles(4, 3, 32, 16))
    for got, want in zip(ops.fused_precond(*x), tref.fused_precond_ref(*x)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    inv = torch.linalg.inv(ta + 0.1 * torch.eye(32))
    v = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 4, 32)).astype(np.float32))
    torch.testing.assert_close(
        ops.smw_update(inv, v, decay=0.95, cscale=0.05),
        tref.smw_update_ref(inv, v, decay=0.95, cscale=0.05),
        rtol=0, atol=0)
    ma, mb = (torch.from_numpy(x) for x in _mats(6, 5, 7, 3))
    torch.testing.assert_close(ops.bitslice_mm(ma, mb),
                               tref.bitslice_mm_ref(ma, mb), rtol=0, atol=0)
    acts = torch.from_numpy(_acts(7, 40, 2, 16))
    torch.testing.assert_close(
        ops.fused_gram_inv(acts, rel_damp=0.05, **KW),
        tref.fused_gram_inv_ref(acts, rel_damp=0.05, **KW), rtol=0, atol=0)
    assert ops.launch_counts() == {"neumann_inv": 0, "fused_precond": 0,
                                   "smw_update": 0, "bitslice_mm": 0,
                                   "fused_gram_inv": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    a, damp = _damped(3, 2, 32)
    with pytest.raises(ValueError, match="CUDA"):
        t_neumann_inv.neumann_inv(torch.from_numpy(a), torch.from_numpy(damp),
                                  **KW)
    x = tuple(torch.from_numpy(v) for v in _tiles(4, 3, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        t_fused_precond.fused_precond(*x)
    with pytest.raises(ValueError, match="CUDA"):
        t_bitslice_mm.bitslice_mm(*(torch.from_numpy(m)
                                    for m in _mats(6, 5, 7, 3)))
    with pytest.raises(ValueError, match="CUDA"):
        t_fused_gram_solve.fused_gram_inv(
            torch.from_numpy(_acts(7, 40, 2, 16)), rel_damp=0.05, **KW)


def test_mixed_devices_are_refused():
    x = tuple(torch.from_numpy(v) for v in _tiles(4, 3, 32, 16))
    with pytest.raises(ValueError, match="all on"):
        ops.fused_precond(x[0], x[1].to("meta"), x[2])


def test_build_names_carry_a_source_digest():
    for lib in ops.LIBRARIES.values():
        assert lib.source.exists()
        assert lib.path.name.startswith(f"lib{lib.name}-")
