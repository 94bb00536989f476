"""Blocks and tiles of 129..1024: the kernels' large route, held on the
CPU as far as the CPU reaches it.

The CUDA route itself runs only on the card (tests/test_torch_cuda.py,
``chip_smoke.py`` phase ``large_blocks``). Here:

  * the plain versions, which the card holds the route to, against the
    reference's Pallas kernels in interpret mode at 256 and (256, 176),
    (176, 256), and against its unpadded oracle at 176 and 384 (the
    Pallas kernel pads 176 to 256 with an identity tail, which changes
    ``X0`` where a block's norms are below 1);
  * the large route's schedule of products (``inv_schedule``) run by a
    plain emulation of each kernel, bitwise ``neumann_inv_ref``: the
    order of the products, the buffers each reads and writes, the forms
    (fp32, bf16 hi and lo slices) each writes and reads, and each
    epilogue's arithmetic are those of the plain version; the forms as a
    pure function (every form written before it is read, fp32 wherever
    an E, an F or the copy-out reads it);
  * its launch plans, workspace layout and chunks, as pure functions;
  * a 2-step K-FAC trajectory through ``launch.train.run`` at block 256
    on a narrow model with sides of 256 and 176, against the reference.

Tolerances and why:
  * plain vs Pallas and oracle: 5e-5 of the largest entry for the
    inverse, 1e-5 for the WU tiles (tests/test_torch_kernels.py: the
    exact bf16 partial products summed in another order).
  * the trajectory: those of tests/test_torch_train.py (losses rtol
    1e-5; inverses 1e-3 of a leaf's largest entry from the reference's
    inverse of the port's own factors; parameters 1%), Adam leaves as
    ``_torch_families.check_params`` holds them (first moments 1%; an
    entry whose gradient was rounding-level at any step within 2 lr a
    step: Adam's first step moves it by lr g / (|g| + eps), rounding
    too; measured on the key bias, g ~4e-9 against eps 1e-8).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import kfac as jkfac
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.data import SyntheticTokens as JTokens
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.core.quantize import split_hi_lo_bf16
from repro_torch.data import SyntheticTokens as TTokens
from repro_torch.kernels import fused_precond as t_fused_precond
from repro_torch.kernels import hilo_tma
from repro_torch.kernels import neumann_inv as t_neumann_inv
from repro_torch.kernels.hilo_tma import F32, HI, LO
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm

from _torch_families import ConvertedProgram, narrow
from _torch_families import one_thread  # noqa: F401 (autouse)

KW = dict(ns_iters=20, taylor_terms=4, refine_steps=2)   # KFACConfig counts


def _damped(seed, nb, n):
    r = np.random.default_rng(seed)
    m = r.standard_normal((nb, n, n)).astype(np.float32)
    a = (np.einsum("bij,bkj->bik", m, m) / n
         + 1e-3 * np.eye(n, dtype=np.float32))
    damp = (0.03 * np.trace(a, axis1=1, axis2=2) / n).astype(np.float32)
    return a, damp


def _assert_rel(got, want, tol):
    want = np.asarray(want)
    err = np.max(np.abs(np.asarray(got) - want))
    assert err <= tol * np.max(np.abs(want)), (err, np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# the plain versions against the reference above 128
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nb", [1, 2])
def test_neumann_inv_plain_matches_pallas_kernel_at_256(nb):
    a, damp = _damped(256 + nb, nb, 256)
    got = tref.neumann_inv_ref(torch.from_numpy(a), torch.from_numpy(damp),
                               **KW)
    want = jops.neumann_inv(jnp.asarray(a), jnp.asarray(damp), **KW)
    _assert_rel(got.numpy(), want, 5e-5)


@pytest.mark.parametrize("nb,n", [(3, 176), (1, 384)])
def test_neumann_inv_plain_matches_unpadded_oracle_above_128(nb, n):
    a, damp = _damped(n + nb, nb, n)
    got = tref.neumann_inv_ref(torch.from_numpy(a), torch.from_numpy(damp),
                               **KW)
    want = jref.neumann_inv_ref(jnp.asarray(a), jnp.asarray(damp), **KW)
    _assert_rel(got.numpy(), want, 5e-5)


@pytest.mark.parametrize("bi,bo", [(256, 176), (176, 256)])
@pytest.mark.parametrize("indexed", [False, True])
def test_fused_precond_plain_matches_pallas_kernel_above_128(bi, bo,
                                                             indexed):
    """Gathered, and indexed into pools (repeated, out of order) against
    the Pallas kernel on the gathered pools."""
    r = np.random.default_rng(bi + 2 * bo)
    n, ma, mg = 5, 3, 4
    pa = r.standard_normal((ma, bi, bi)).astype(np.float32)
    g = r.standard_normal((n, bi, bo)).astype(np.float32)
    pg = r.standard_normal((mg, bo, bo)).astype(np.float32)
    a_src = r.integers(0, ma, n).astype(np.int32)
    g_src = r.integers(0, mg, n).astype(np.int32)
    if indexed:
        out, dots = ops.fused_precond(*(torch.from_numpy(x) for x in
                                        (pa, g, pg, a_src, g_src)))
    else:
        out, dots = ops.fused_precond(*(torch.from_numpy(x) for x in
                                        (pa[a_src], g, pg[g_src])))
    want_out, want_dots = jops.fused_precond(
        jnp.asarray(pa[a_src]), jnp.asarray(g), jnp.asarray(pg[g_src]))
    _assert_rel(out.numpy(), want_out, 1e-5)
    np.testing.assert_allclose(dots.numpy(), np.asarray(want_dots),
                               rtol=1e-4, atol=1e-2)


# ---------------------------------------------------------------------------
# the large route's schedule, run by a plain emulation of its kernels
# ---------------------------------------------------------------------------

def _mm(x, y):
    """bf16 x bf16 with fp32 accumulation (the plain version's partial)."""
    return torch.matmul(x.to(torch.float32), y.to(torch.float32))


def _store(mem, buf, forms, value):
    """A kernel's write of ``value`` into ``buf`` in ``forms``: every form
    of the buffer's previous value is gone, the new ones split on store."""
    for key in [k for k in mem if k[0] == buf]:
        del mem[key]
    hi, lo = split_hi_lo_bf16(value)
    for f in forms:
        mem[(buf, f)] = {F32: value, HI: hi, LO: lo}[f]


def _emulate(a, lam, counts):
    """The large route on the CPU: the prep kernel's Ad and X0, the
    schedule's products with their epilogues, the copy-out, each kernel
    reading only the forms stored before it (a form never written, or
    overwritten, is a KeyError) and writing only its own."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=torch.float32)
    ad = a + lam[:, None, None] * eye
    a_hi = ad.to(torch.bfloat16).to(torch.float32)
    bound = a_hi.abs().sum(dim=-2).amax(dim=-1) * \
        a_hi.abs().sum(dim=-1).amax(dim=-1)
    sched = t_neumann_inv.inv_schedule(*counts)
    mem = {}
    _store(mem, "ad", sched.prep["ad"], ad)
    _store(mem, "x0", sched.prep["x0"], a_hi / bound[:, None, None])
    for p in sched.products:
        left = [mem[(p.left, f)] for f in hilo_tma.LEFT_FORMS[p.mode]]
        r_hi, r_lo = mem[(p.right, HI)], mem[(p.right, LO)]
        acc = _mm(left[0], r_hi) + _mm(left[0], r_lo)
        if len(left) == 2:
            acc = acc + _mm(left[1], r_hi)
        if p.epi == hilo_tma.STORE:
            c = acc
        elif p.epi == hilo_tma.TWO_I_MINUS:
            c = 2.0 * eye - acc
        elif p.epi == hilo_tma.I_MINUS:
            c = eye - acc
        elif p.epi == hilo_tma.ADD:
            c = mem[(p.e, F32)] + acc
        elif p.epi == hilo_tma.NEG_ACC:
            c = -acc
            _store(mem, p.f, p.f_forms, mem[(p.e, F32)] + c)
        else:
            raise AssertionError(f"epilogue {p.epi} in the inverse")
        _store(mem, p.c, p.c_forms, c)
    return mem[(sched.last, F32)]


COUNTS = [(20, 4, 2), (14, 4, 1), (20, 1, 0), (20, 4, 0), (3, 1, 2),
          (0, 1, 0), (2, 3, 3)]


@pytest.mark.parametrize("counts", COUNTS)
def test_large_schedule_emulated_is_the_plain_version(counts):
    a, damp = _damped(sum(counts), 2, 176)
    ta, td = torch.from_numpy(a), torch.from_numpy(damp)
    got = _emulate(ta, td, counts)
    want = tref.neumann_inv_ref(ta, td, ns_iters=counts[0],
                                taylor_terms=counts[1],
                                refine_steps=counts[2])
    assert torch.equal(got, want)


@pytest.mark.parametrize("counts", COUNTS)
def test_large_schedule_never_overwrites_what_a_product_reads(counts):
    """Every product reads only buffers already written, writes none of
    its operands (other CTAs still read them), and its elementwise
    E/F pair is the same buffer or F is written fresh; the counts of
    products are those of the reference's iteration."""
    sched = t_neumann_inv.inv_schedule(*counts)
    written = {"ad", "x0"}
    for p in sched.products:
        assert {p.left, p.right} <= written and (p.e is None
                                                 or p.e in written)
        assert p.c not in (p.left, p.right)
        assert p.f not in (p.left, p.right, p.c)
        assert {p.c, p.f} - {None} <= set(t_neumann_inv.BUFFERS)
        written |= {p.c, p.f} - {None}
    assert sched.last in written
    ns, taylor, refine = counts
    assert len(sched.products) == \
        2 * ns + 2 * max(taylor - 1, 0) + 2 * refine
    assert t_neumann_inv.launches_per_chunk(*counts) == \
        len(sched.products) + 2


@pytest.mark.parametrize("counts", COUNTS)
def test_large_schedule_forms_are_written_before_read(counts):
    """The forms each kernel writes, as a pure function: every form an
    operand, an E or the copy-out reads was written by the kernel that
    last wrote the buffer; fp32 is kept wherever an E, an F or the
    copy-out reads the value, never for a value read only as an operand;
    no form is written that nothing reads; every form lies in the
    buffer's workspace arrays; the right operand is always read as both
    slices, the left as the mode's."""
    sched = t_neumann_inv.inv_schedule(*counts)
    held = dict(sched.prep)          # buffer -> forms of its value
    unread = {b: set(f) for b, f in sched.prep.items()}
    for p in sched.products:
        assert p.reads[:2] == [(p.left, hilo_tma.LEFT_FORMS[p.mode]),
                               (p.right, (HI, LO))]
        for buf, forms in p.reads:
            assert set(forms) <= held[buf], (p, buf, forms)
            unread[buf] -= set(forms)
        for buf, forms in ((p.c, p.c_forms), (p.f, p.f_forms)):
            if buf is None:
                continue
            assert not unread.get(buf), (p, buf, "written, never read")
            assert forms <= set(t_neumann_inv.BUFFER_FORMS[buf])
            held[buf], unread[buf] = set(forms), set(forms)
        if p.epi == hilo_tma.NEG_ACC:
            assert F32 in p.f_forms       # the running M, read as E
    assert F32 in held[sched.last]
    unread[sched.last].discard(F32)
    assert not any(unread.values()), unread
    for buf, forms in sched.prep.items():
        assert forms <= set(t_neumann_inv.BUFFER_FORMS[buf])
        assert F32 not in forms or (counts[0] == 0)


# ---------------------------------------------------------------------------
# launch plans and workspace chunks (pure functions)
# ---------------------------------------------------------------------------

def _block_bytes(n):
    """Ad and W as two slices, X0, X1 and M also in fp32."""
    return 2 * 4 * n * hilo_tma.slice_stride(n) + \
        3 * (4 * n * hilo_tma.row_stride(n)
             + 4 * n * hilo_tma.slice_stride(n))


def test_large_plan_covers_every_block_in_chunks_under_the_budget():
    budget = hilo_tma.WORKSPACE_BYTES
    for nbs, n in (([192], 1024), ([768], 256), ([48, 0, 96, 48], 1024),
                   ([576, 576], 176), ([7], 129)):
        plan = t_neumann_inv.large_plan(nbs, n, budget)
        per_block = _block_bytes(n)
        assert t_neumann_inv.block_bytes(n) == per_block
        (leaves, parts, ws), = plan
        assert leaves == [i for i, nb in enumerate(nbs) if nb]
        assert parts[0][0] == 0 and parts[-1][1] == sum(nbs)
        assert all(b1 == c0 for (_, b1), (c0, _) in zip(parts, parts[1:]))
        sizes = [b1 - b0 for b0, b1 in parts]
        assert ws == max(sizes) * per_block <= budget
        assert max(sizes) - min(sizes) <= 1 or len(sizes) == 1 or \
            sizes[-1] < sizes[0]
    # n = 1024: 32 MiB a block, 32 under 1 GiB -> 6 chunks of 32
    (_, parts, ws), = t_neumann_inv.large_plan([192], 1024)
    assert parts == [(k, k + 32) for k in range(0, 192, 32)]
    assert ws == 32 * 32 * 1024 * 1024
    # block 256 of the main path: two chunks a side (2 MiB a block of 256,
    # 968 KiB a block of 176)
    assert t_neumann_inv.large_plan([768], 256)[0][1] == [(0, 384),
                                                          (384, 768)]
    assert t_neumann_inv.large_plan([1152], 176)[0][1] == [(0, 576),
                                                           (576, 1152)]


@pytest.mark.parametrize("n", [129, 176, 256, 1024])
def test_large_workspace_strides_and_layout(n):
    """The slices' row stride is a multiple of 8 bf16 (16 bytes, a TMA
    tensor map's stride), the fp32 one of 4; each buffer's forms are
    (nb, n, stride) arrays one after the other, every one on 16 bytes,
    the chunk's last byte the workspace's."""
    ld16 = hilo_tma.slice_stride(n)
    assert ld16 % 8 == 0 and n <= ld16 < n + 8
    assert hilo_tma.row_stride(n) % 4 == 0
    nb, base = 7, 1 << 20
    addr = t_neumann_inv.workspace(base, nb, n)
    assert set(addr) == {(b, f) for b in t_neumann_inv.BUFFERS
                         for f in t_neumann_inv.BUFFER_FORMS[b]}
    ordered = sorted(addr.items(), key=lambda kv: kv[1])
    assert ordered[0][1] == base
    for ((b, f), lo), (_, hi) in zip(ordered, ordered[1:]):
        assert hi - lo == nb * n * hilo_tma.stride(n, f) * \
            hilo_tma.itemsize(f)
        assert lo % 16 == 0
    (b, f), last = ordered[-1]
    end = last + nb * n * hilo_tma.stride(n, f) * hilo_tma.itemsize(f)
    assert end - base == nb * t_neumann_inv.block_bytes(n)


def test_schedule_bytes_counts_each_kernel_once():
    """The large route's bytes floor: 614 n^2 a block at 20/4/2 (plus
    the damping); with no product (0/1/0) the prep kernel reads A (4 n^2)
    and writes X0 in fp32 only (4 n^2; Ad is read by nothing, so it is
    not stored), and the copy-out moves 8 n^2."""
    assert t_neumann_inv.schedule_bytes(256, **KW) == 614 * 256 * 256 + 4
    assert t_neumann_inv.schedule_bytes(176, 0, 1, 0) == \
        (4 + 4 + 8) * 176 * 176 + 4


def test_large_plan_splits_long_leaf_lists_and_skips_empty_leaves():
    nbs = [1 + k % 3 for k in range(40)] + [0]
    plan = t_neumann_inv.large_plan(nbs, 200)
    assert [leaves for leaves, _, _ in plan] == [list(range(32)),
                                                 list(range(32, 40))]
    assert [p[-1][1] for _, p, _ in plan] == [sum(nbs[:32]),
                                              sum(nbs[32:40])]
    assert t_neumann_inv.large_plan([0, 0], 300) == []
    # a small budget takes the blocks in chunks of at least one
    tiny = t_neumann_inv.large_plan([5], 256, budget=1)
    assert tiny[0][1] == [(k, k + 1) for k in range(5)]


def test_expected_launches_counts_both_routes():
    per = t_neumann_inv.launches_per_chunk(**KW)
    assert per == 2 * 20 + 2 * 3 + 2 * 2 + 2 == 52
    sides = {128: [528, 0, 192], 256: [720, 48], 176: [1152]}
    assert t_neumann_inv.expected_launches(sides, **KW) == 1 + 4 * per
    assert t_neumann_inv.expected_launches({1024: [192]}, **KW) == 6 * per
    assert t_neumann_inv.expected_launches(
        {64: [1] * 40}, **KW) == 2


def test_wu_chunks_and_expected_launches():
    """The large route's chunks keep g's and tmp's bf16 slices (rows of
    176 padded to 176, of 200 to 200) and the partial dots (two a 128 x
    192 or 128 x 256 output tile) under the budget; a call launches two
    pool splits, then four kernels a chunk (tests/test_torch_wu_large.py
    holds the schedule itself)."""
    assert t_fused_precond.wu_chunks(3072, 256, 176) == [(0, 1536),
                                                         (1536, 3072)]
    assert t_fused_precond.wu_chunks(1536, 256, 256) == [(0, 1536)]
    parts = t_fused_precond.wu_chunks(6144, 1024, 176)
    per_tile = 2 * 2 * 2 * 1024 * 176 + 4 * 2 * 8
    assert t_fused_precond.tile_bytes(1024, 176) == per_tile
    assert parts[0][0] == 0 and parts[-1][1] == 6144
    assert max(b - a for a, b in parts) * per_tile <= \
        hilo_tma.WORKSPACE_BYTES
    assert t_fused_precond.expected_launches(6144, 1024, 176) == \
        2 + 4 * len(parts)
    assert t_fused_precond.expected_launches(1536, 256, 256,
                                             shared=True) == 1 + 4
    assert t_fused_precond.expected_launches(18816, 128, 128) == 1
    assert t_fused_precond.expected_launches(0, 256, 256) == 0
    assert hilo_tma.row_stride(130) == 132 and hilo_tma.row_stride(176) == 176


def test_params_layout_and_vector_flags():
    """The ctypes structures match the C ones' layout (offsets the C
    compiler gives htma::Out and htma::Params on x86-64 and aarch64), the
    square form is what zero in the rectangular fields gives, and the
    tile widths and partial counts are the kernel's."""
    import ctypes

    # five pointers, two Outs of three, five ints (the square form,
    # neumann_inv's), then the rectangular form's six ints, padding to 8
    # bytes, three pointers (two index arrays, the partials), then the
    # operands' storage (l_t, r_t)
    assert ctypes.sizeof(hilo_tma.Out) == 24
    assert hilo_tma.Params.c.offset == 40
    assert hilo_tma.Params.f.offset == 64
    assert hilo_tma.Params.n.offset == 88
    assert hilo_tma.Params.epi.offset == 104
    assert [getattr(hilo_tma.Params, f).offset for f in (
        "m", "k", "l_ld16", "r_ld16", "l_blocks", "r_blocks")] == \
        list(range(108, 132, 4))
    assert hilo_tma.Params.l_idx.offset == 136
    assert hilo_tma.Params.r_idx.offset == 144
    assert hilo_tma.Params.part.offset == 152
    assert hilo_tma.Params.l_t.offset == 160
    assert hilo_tma.Params.r_t.offset == 164
    assert ctypes.sizeof(hilo_tma.Params) == 168
    # neumann_inv's positional Params leave the rectangular fields 0: the
    # square form, both operands stored as they are read
    sq = hilo_tma.Params(16, 32, 48, 64, None, hilo_tma.Out(),
                         hilo_tma.Out(), 176, 176, 176, 3, hilo_tma.STORE)
    assert (sq.m, sq.k, sq.l_ld16, sq.r_ld16, sq.l_blocks, sq.r_blocks,
            sq.l_idx, sq.r_idx, sq.part, sq.l_t, sq.r_t) == \
        (0,) * 6 + (None,) * 3 + (0, 0)
    # the tile's columns and a result's tiles (the partials' count)
    assert [hilo_tma.tile_n(n) for n in (129, 176, 200, 256, 300, 1024)] \
        == [192, 192, 256, 256, 192, 256]
    assert hilo_tma.tiles_of(176, 256) == 2 and \
        hilo_tma.tiles_of(1024, 176) == 8 and \
        hilo_tma.tiles_of(130, 1024) == 8
    # slices on 16 bytes, fp32 workspace rows on 16 bytes (float4)
    assert [hilo_tma.slice_stride(n) for n in (129, 176, 1024)] == \
        [136, 176, 1024]
    assert [hilo_tma.row_stride(n) for n in (129, 130, 176)] == \
        [132, 132, 176]
    assert hilo_tma.MAX_SIDE == 1024 and hilo_tma.MAX_DEPTH == 1 << 24


def test_route_limits_are_the_references():
    """Both wrappers take sides up to the reference's 1024 and switch to
    the large route above 128; a CPU tensor is refused by the CUDA
    wrapper whatever its side (the card test checks the refusal above
    1024 on CUDA)."""
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_neumann_inv.neumann_inv(torch.zeros(1, 1025, 1025), 0.1, **KW)
    assert t_neumann_inv.MAX_N == t_fused_precond.MAX_B == 1024
    assert t_neumann_inv.ONE_CTA_N == t_fused_precond.ONE_CTA_B == 128


# ---------------------------------------------------------------------------
# a K-FAC trajectory at block 256
# ---------------------------------------------------------------------------

def test_block_256_trajectory_matches_reference():
    b, t, n_steps = 2, 32, 2
    jcfg = narrow(get_smoke_config("qwen1.5-0.5b"))
    tcfg = narrow(t_get_smoke_config("qwen1.5-0.5b"))
    common = dict(stats_every=2, inv_every=2, block_size=256,
                  stats_batch=b, stats_seq=t)
    params = jax.device_get(jlm.init(jcfg, jax.random.PRNGKey(0)))

    jk = JKFACConfig(**common)
    state = jsteps.TrainState(params, jkfac.init(params,
                                                 jlm.kfac_specs(jcfg), jk))
    stats = jax.jit(jsteps.make_stats_step(jcfg, jk))
    train = jax.jit(jsteps.make_train_step(jcfg, jk))
    refresh = jax.jit(jsteps.make_inv_refresh(jcfg, jk))
    ds = JTokens(jcfg.vocab, t, b, seed=0)
    j_losses, j_mu = [], []
    for i in range(n_steps):
        batch = {"tokens": jnp.asarray(ds.batch_slice(i, 0, b))}
        if i % 2 == 0:
            state, _ = stats(state, batch)
            state = state._replace(kfac=state.kfac._replace(
                inverses=refresh(state.kfac.factors)))
        state, m = train(state, batch)
        j_losses.append(float(m["loss"]))
        j_mu.append(convert._flatten(jax.device_get(state.kfac.adam_mu)))

    program = ConvertedProgram(tcfg, tkfac.KFACConfig(**common),
                                   device="cpu")
    program.params = convert.params_from_jax(params, device="cpu")
    tstate, hist = ttrain.run(program, TTokens(tcfg.vocab, t, b, seed=0),
                              n_steps)
    sides = {f.shape[-1] for d in tstate.kfac.factors.values()
             for f in d.values()}
    assert {256, 176} <= sides
    assert [sorted(h["phase_s"]) for h in hist] == \
        [["inv", "stats", "train", "wu"], ["train", "wu"]]
    np.testing.assert_allclose([h["loss"] for h in hist], j_losses,
                               rtol=1e-5)
    j_of_t = jax.device_get(refresh({
        n: {s: jnp.asarray(f.numpy()) for s, f in d.items()}
        for n, d in tstate.kfac.factors.items()}))
    for n, d in j_of_t.items():
        for side, v in d.items():
            got = tstate.kfac.inverses[n][side].numpy()
            assert np.max(np.abs(got - v)) <= 1e-3 * np.max(np.abs(v)), \
                (n, side)
    specs = tlm.kfac_specs(tcfg)
    for k, v in convert._flatten(jax.device_get(state.params)).items():
        err = np.abs(tstate.params[k].numpy() - v)
        if k in specs:
            assert err.max() <= 1e-2 * np.max(np.abs(v)), (k, err.max())
            continue
        # an Adam leaf: its first moment within 1%, and its weights
        # within 1% except where a step's gradient was rounding-level,
        # where Adam's step lr g / (|g| + eps) is rounding too (within
        # 2 lr a step)
        mu = j_mu[-1][k]
        mu_err = np.max(np.abs(tstate.kfac.adam_mu[k].numpy() - mu))
        assert mu_err <= 1e-2 * np.max(np.abs(mu)), (k, "adam_mu", mu_err)
        tiny = np.any([np.abs(m[k]) <= 1e-3 * np.max(np.abs(m[k]))
                       for m in j_mu], axis=0)
        assert np.max(err, where=~tiny, initial=0.0) <= \
            1e-2 * np.max(np.abs(v)), (k, err.max())
        assert np.max(err, where=tiny, initial=0.0) <= 2 * jk.lr * n_steps
