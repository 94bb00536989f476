"""repro_torch K-FAC pieces against the JAX reference (``repro.core.kfac``,
``repro.solve.partition``) on the same numpy inputs: the WU plan, the
factor EMA, the inverse refresh, the pooled preconditioning and the
update.

Specs cover every geometry the pooling must handle: dense, shared-A,
a stacked leaf padded to blocks (d % bs != 0) and a 2-d stack.

Tolerances and why:
  * plan index arrays: equal (both are host integer arithmetic).
  * factor EMA: rtol 1e-6 (identical elementwise fp32 arithmetic).
  * inverse refresh: 5e-5 relative to the leaf's largest entry — the
    cross-framework bound of the composed inverse
    (``tests/test_torch_kernels.py`` explains it).
  * pooled WU: rtol 1e-4 and atol 1e-4 of the leaf's largest entry,
    against both the reference's kernel route (``use_kernel=True``, the
    Pallas kernel in interpret mode) and its fp32 einsum path, as
    ``tests/test_wu_fusion.py`` holds the kernel route to the einsum
    path. The atol is scaled because the hi/lo product's error is
    relative to the operands (~2^-16), and the accurate inverses at the
    K-FAC counts here reach entries of ~10.
  * update: rtol 1e-5, atol 1e-6 — same algebra, preconditioned
    directions equal to ~1e-6 relative.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kfac as jkfac
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.core.soi import LinearSpec as JSpec
from repro.solve import make_wu_plan as j_make_wu_plan
from repro_torch import convert
from repro_torch.core import kfac as tkfac
from repro_torch.core.soi import LinearSpec as TSpec
from repro_torch.solve.partition import make_wu_plan as t_make_wu_plan

KCFG_ARGS = dict(block_size=16)

SPEC_ARGS = {
    "w1": dict(d_in=32, d_out=16),
    "w2": dict(d_in=32, d_out=16, share_a_with="w1"),
    "stk/w": dict(d_in=16, d_out=20, stack=(3,)),          # padded
    "moe/wg": dict(d_in=16, d_out=16, stack=(2, 2)),
    "moe/wu": dict(d_in=16, d_out=16, stack=(2, 2), share_a_with="moe/wg"),
}
J_SPECS = {k: JSpec(**v) for k, v in SPEC_ARGS.items()}
T_SPECS = {k: TSpec(**v) for k, v in SPEC_ARGS.items()}
SHAPES = {"w1": (32, 16), "w2": (32, 16), "stk/w": (3, 16, 20),
          "moe/wg": (2, 2, 16, 16), "moe/wu": (2, 2, 16, 16),
          "bias": (7,)}


def _spd(r, shape):
    bs = shape[-1]
    a = r.standard_normal(shape[:-1] + (2 * bs,)).astype(np.float32)
    return np.einsum("...ij,...kj->...ik", a, a) / (2 * bs)


_J_REFRESH = jax.jit(jkfac.refresh_inverses, static_argnums=1)


def _setup(seed=0, **kcfg):
    """Same params, grads and factors for both packages; JAX state has
    its inverses refreshed (composed method)."""
    r = np.random.default_rng(seed)
    flat = {k: r.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    grads = {k: r.standard_normal(s).astype(np.float32)
             for k, s in SHAPES.items()}
    jcfg = JKFACConfig(**{**KCFG_ARGS, **kcfg})
    tcfg = tkfac.KFACConfig(**{**KCFG_ARGS, **kcfg})
    jparams = convert._nest({k: jnp.asarray(v) for k, v in flat.items()})
    jstate = jkfac.init(jparams, J_SPECS, jcfg)
    factors = jax.tree.map(lambda x: _spd(r, x.shape), jstate.factors)
    jstate = jstate._replace(
        factors=jax.tree.map(jnp.asarray, factors))
    jstate = _J_REFRESH(jstate, jcfg)
    tparams = {k: torch.from_numpy(v) for k, v in flat.items()}
    tstate = tkfac.init(tparams, T_SPECS, tcfg)
    tstate = dataclasses.replace(
        tstate, factors=convert.blocks_from_jax(factors, device="cpu"),
        inverses=convert.blocks_from_jax(jax.device_get(jstate.inverses),
                                          device="cpu"))
    return (jparams, convert._nest(grads), jstate, jcfg,
            tparams, {k: torch.from_numpy(v) for k, v in grads.items()},
            tstate, tcfg)


def _close(got: torch.Tensor, want, rtol, atol, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.mark.parametrize("specs", ["mixed", "qwen1.5-smoke"])
def test_wu_plan_matches_reference(specs):
    if specs == "mixed":
        j_specs, t_specs = J_SPECS, T_SPECS
        bs = 16
    else:
        from repro.configs import get_smoke_config
        from repro.models import lm as jlm
        from repro_torch.configs import get_smoke_config as t_get
        from repro_torch.models import lm as tlm
        j_specs = jlm.kfac_specs(get_smoke_config("qwen1.5-0.5b"))
        t_specs = tlm.kfac_specs(t_get("qwen1.5-0.5b"))
        assert {k: dataclasses.asdict(v) for k, v in t_specs.items()} == \
            {k: dataclasses.asdict(v) for k, v in j_specs.items()}
        bs = 32
    jcfg = JKFACConfig(block_size=bs)
    jfac = jax.eval_shape(lambda: jkfac.init(
        {}, j_specs, jcfg).factors)
    tfac = {n: {s: torch.empty(v.shape) for s, v in d.items()}
            for n, d in jfac.items()}
    jp = j_make_wu_plan(j_specs, jfac, jcfg, ndev=1)
    tp = t_make_wu_plan(t_specs, tfac)
    assert [(g.bs, g.leaves, g.leaf_counts) for g in tp.inv_plan.groups] == \
        [(g.bs, g.leaves, g.leaf_counts) for g in jp.inv_plan.groups]
    assert len(tp.groups) == len(jp.groups)
    for tg, jg in zip(tp.groups, jp.groups):
        assert (tg.bi, tg.bo) == (jg.bi, jg.bo)
        assert [l.name for l in tg.leaves] == [l.name for l in jg.leaves]
        np.testing.assert_array_equal(tg.a_src, jg.a_src)
        np.testing.assert_array_equal(tg.g_src, jg.g_src)
    assert tp.total_tiles == jp.total_tiles


def test_update_factors_matches_reference():
    jp, _, jstate, jcfg, tp, _, tstate, tcfg = _setup(1)
    r = np.random.default_rng(2)
    a = {n: _spd(r, f["A"].shape) for n, f in jstate.factors.items()
         if "A" in f}
    g = {n: _spd(r, f["G"].shape) for n, f in jstate.factors.items()}
    want = jkfac.update_factors(
        jstate, jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, g),
        jcfg).factors
    got = tkfac.update_factors(
        tstate, {k: torch.from_numpy(v) for k, v in a.items()},
        {k: torch.from_numpy(v) for k, v in g.items()}, tcfg).factors
    for n, d in want.items():
        for s, v in d.items():
            _close(got[n][s], v, 1e-6, 0, f"{n}/{s}")


@pytest.mark.parametrize("method", ["composed", "composed_fast", "exact"])
def test_refresh_inverses_matches_reference(method):
    jp, _, jstate, jcfg, tp, _, tstate, tcfg = _setup(3, inv_method=method)
    want = jstate.inverses          # refreshed from the same factors
    got = tkfac.refresh_inverses(tstate, tcfg).inverses
    for n, d in want.items():
        for s, v in d.items():
            v = np.asarray(v)
            err = np.max(np.abs(got[n][s].numpy() - v))
            assert err <= 5e-5 * np.max(np.abs(v)), (n, s, err)


def test_invert_factors_is_one_grouped_call_over_all_sides(monkeypatch):
    """At K-FAC block 32 the factor leaves have sides 32, 20 and 16: the
    refresh hands every leaf to one ``ops.neumann_inv_grouped`` call (on
    the card one launch a side), and still matches the reference's
    ``refresh_inverses`` at the tolerance above."""
    from repro_torch.kernels import ops

    _, _, jstate, _, _, _, tstate, tcfg = _setup(9, block_size=32)
    leaves = [f for d in tstate.factors.values() for f in d.values()]
    assert {f.shape[-1] for f in leaves} == {16, 20, 32}
    calls = []
    real = ops.neumann_inv_grouped

    def spy(blocks, dampings, **kw):
        calls.append([tuple(b.shape) for b in blocks])
        return real(blocks, dampings, **kw)

    monkeypatch.setattr(ops, "neumann_inv_grouped", spy)
    got = tkfac.refresh_inverses(tstate, tcfg).inverses
    assert calls == [[tuple(f.reshape(-1, *f.shape[-2:]).shape)
                      for f in leaves]]
    for n, d in jstate.inverses.items():
        for s, v in d.items():
            v = np.asarray(v)
            assert got[n][s].shape == v.shape
            err = np.max(np.abs(got[n][s].numpy() - v))
            assert err <= 5e-5 * np.max(np.abs(v)), (n, s, err)


def test_precondition_pooled_matches_reference_kernel_and_einsum_paths():
    jp, jg, jstate, jcfg, tp, tg, tstate, tcfg = _setup(4)
    jwu = j_make_wu_plan(J_SPECS, jstate.factors, jcfg, ndev=1)
    twu = t_make_wu_plan(T_SPECS, tstate.factors)
    j_kernel = convert._flatten(jax.device_get(jkfac.precondition(
        jg, jstate, J_SPECS, jcfg, wu_plan=jwu, use_kernel=True)))
    j_einsum = convert._flatten(jax.device_get(jax.jit(
        lambda g, s: jkfac.precondition(g, s, J_SPECS, jcfg))(jg, jstate)))
    for use_kernel in (True, False):
        got = tkfac.precondition(tg, tstate, T_SPECS, tcfg, wu_plan=twu,
                                 use_kernel=use_kernel)
        per_leaf = tkfac.precondition(tg, tstate, T_SPECS, tcfg)
        for k in SHAPES:
            atol = 1e-4 * np.max(np.abs(j_einsum[k]))
            _close(got[k], j_kernel[k], 1e-4, atol, f"{k} vs kernel route")
            _close(got[k], j_einsum[k], 1e-4, atol, f"{k} vs einsum path")
            _close(per_leaf[k], j_einsum[k], 1e-4, atol, f"{k} per leaf")
        assert got["bias"] is tg["bias"]


@pytest.mark.parametrize("use_plan", [False, True])
def test_apply_updates_matches_reference(use_plan):
    jp, jg, jstate, jcfg, tp, tg, tstate, tcfg = _setup(5)
    # a second step exercises momentum and the Adam bias correction
    j_step = jax.jit(lambda p, g, s: jkfac.apply_updates(
        p, g, s, J_SPECS, jcfg))
    twu = t_make_wu_plan(T_SPECS, tstate.factors) if use_plan else None
    for _ in range(2):
        jp, jstate = j_step(jp, jg, jstate)
        tp, tstate = tkfac.apply_updates(tp, tg, tstate, T_SPECS, tcfg,
                                         wu_plan=twu, use_kernel=use_plan)
    assert tstate.step == int(jstate.step) == 2
    want_p = convert._flatten(jax.device_get(jp))
    for k in SHAPES:
        _close(tp[k], want_p[k], 1e-5, 1e-6, k)
    moments = convert.moments_to_jax(tstate.momentum, tp)
    for k, v in convert._flatten(jax.device_get(jstate.momentum)).items():
        _close(torch.from_numpy(convert._flatten(moments)[k]), v, 1e-5,
               1e-6, f"momentum {k}")
    for name, tree in (("adam_mu", tstate.adam_mu),
                       ("adam_nu", tstate.adam_nu)):
        want = convert._flatten(jax.device_get(getattr(jstate, name)))
        assert sorted(tree) == ["bias"]
        assert np.size(want["w1"]) == 0
        _close(tree["bias"], want["bias"], 1e-5, 1e-9, name)


def test_pooled_kernel_route_reads_the_pools_by_index(monkeypatch):
    """``use_kernel=True`` hands ``fused_precond`` the per-bs pools and
    the plan's int32 ``a_src``/``g_src`` (no gathered copy per tile),
    and its output is bitwise the gathered call's."""
    from repro_torch.kernels import ops, ref

    _, _, _, _, tp, tg, tstate, tcfg = _setup(8)
    twu = t_make_wu_plan(T_SPECS, tstate.factors)
    pools = tkfac.inverse_pools(tstate.inverses, twu.inv_plan)
    calls = []
    real = ops.fused_precond

    def spy(a_inv, g, g_inv, a_src=None, g_src=None):
        calls.append((a_inv, g_inv, a_src, g_src))
        got = real(a_inv, g, g_inv, a_src, g_src)
        want = ref.fused_precond_ref(a_inv[a_src.long()], g,
                                     g_inv[g_src.long()])
        for x, y in zip(got, want):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        return got

    monkeypatch.setattr(ops, "fused_precond", spy)
    tkfac.precondition(tg, tstate, T_SPECS, tcfg, wu_plan=twu,
                       use_kernel=True)
    assert len(calls) == len(twu.groups)
    for (a_inv, g_inv, a_src, g_src), grp in zip(calls, twu.groups):
        assert torch.equal(a_inv, pools[grp.bi])
        assert torch.equal(g_inv, pools[grp.bo])
        assert a_src.dtype == g_src.dtype == torch.int32
        np.testing.assert_array_equal(a_src.numpy(), grp.a_src)
        np.testing.assert_array_equal(g_src.numpy(), grp.g_src)


def test_wu_plan_refuses_indices_outside_the_pools():
    """The kernel reads the pools by the plan's indices unchecked on the
    card, so the plan holds them in range where they are built."""
    from repro_torch.solve.partition import Plan, make_plan

    _, _, _, _, _, _, tstate, _ = _setup(9)
    plan = make_plan(tstate.factors)
    short = Plan(groups=tuple(
        dataclasses.replace(g, leaf_counts=g.leaf_counts[:-1]
                            + (g.leaf_counts[-1] - 1,))
        for g in plan.groups))
    with pytest.raises(ValueError, match="outside"):
        t_make_wu_plan(T_SPECS, tstate.factors, inv_plan=short)


def test_precondition_rejects_a_stale_plan():
    _, _, _, _, tp, tg, tstate, tcfg = _setup(6)
    twu = t_make_wu_plan({k: v for k, v in T_SPECS.items()
                          if k != "stk/w"}, tstate.factors)
    with pytest.raises(ValueError, match="does not cover"):
        tkfac.precondition(tg, tstate, T_SPECS, tcfg, wu_plan=twu)


def test_convert_round_trips_params_blocks_and_moments():
    jp, _, jstate, _, tp, _, tstate, _ = _setup(7)
    back = convert._flatten(convert.params_to_jax(tp))
    for k, v in convert._flatten(jax.device_get(jp)).items():
        np.testing.assert_array_equal(back[k], v)
    inv = jax.device_get(jstate.inverses)
    again = convert.blocks_to_jax(convert.blocks_from_jax(inv,
                                                          device="cpu"))
    for n, d in inv.items():
        for side, v in d.items():
            np.testing.assert_array_equal(again[n][side], v)
    # moments: the reference's params-shaped trees with (0,) placeholders
    mom = convert.moments_from_jax(jax.device_get(jstate.momentum),
                                   device="cpu")
    assert sorted(mom) == sorted(T_SPECS)
    tree = convert.moments_to_jax(mom, tp)
    for k, v in convert._flatten(jax.device_get(jstate.momentum)).items():
        np.testing.assert_array_equal(convert._flatten(tree)[k], v)
    adam = convert.moments_from_jax(jax.device_get(jstate.adam_mu),
                                   device="cpu")
    assert sorted(adam) == ["bias"] == sorted(tstate.adam_mu)
