"""repro_torch's single-device solver API against the JAX reference
(``repro.solve``): the partitioner's plans, the pooled and replicated
``invert_factor_tree``, ``pdiv_invert``, and the pooled elementwise WU
tail (``kfac.apply_updates(pool_elementwise=True)``).

Tolerances and why:
  * plans: equal (both are host integer and float arithmetic on shapes).
  * the port's replicated, pooled (ndev 1 and 4) and ``kfac`` refreshes:
    bitwise equal (every path inverts through one grouped
    ``neumann_inv`` call, and each block is computed on its own).
  * against the reference: 5e-5 of the leaf's largest entry, the
    composed inverse's cross-framework bound (``tests/test_torch_kernels.py``);
    the reference runs its jnp composed inverse, as its own solver tests
    do.
  * ``pdiv_invert`` against the reference's: the same 5e-5; its Schur
    bridges are fp32 products on both sides, on blocks as well
    conditioned as the pooled ones.
  * ``pool_elementwise``: bitwise (elementwise algebra does not depend on
    position).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.core import soi as jsoi
from repro.models import lm as jlm
from repro.solve import invert_factor_tree as j_invert_factor_tree
from repro.solve import make_plan as j_make_plan
from repro.solve import make_wu_plan as j_make_wu_plan
from repro.solve import pdiv_invert as j_pdiv_invert
from repro.solve.partition import inverse_block_flops as j_flops
from repro.solve.partition import pdiv_depth as j_pdiv_depth
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.core import soi as tsoi
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.solve import (invert_factor_tree, make_plan, make_wu_plan,
                               pdiv_invert)
from repro_torch.solve.partition import inverse_block_flops, pdiv_depth

# the K-FAC counts (20/4/2), the reference's and the port's default
KW = dict(ns_iters=20, taylor_terms=4, refine_steps=2)
TCFG = tkfac.KFACConfig(**KW)
JCFG = JKFACConfig(**KW)
TOL = 5e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and the smoke-size products gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spd(r, shape):
    bs = shape[-1]
    a = r.standard_normal(shape[:-1] + (2 * bs,)).astype(np.float32)
    return np.einsum("...ij,...kj->...ik", a, a) / (2 * bs)


def _factors(seed=0, big=False):
    """Mixed block sizes, stack dims and G-only (shared-A) leaves, the
    shapes the reference's solver tests use; ``big`` adds leaves of 64
    and 128 for the pdiv cap."""
    r = np.random.default_rng(seed)
    f = {"layers/attn/wq": {"A": _spd(r, (3, 2, 32, 32)),
                            "G": _spd(r, (3, 1, 48, 48))},
         "layers/mlp/wg": {"A": _spd(r, (3, 1, 32, 32)),
                           "G": _spd(r, (3, 4, 16, 16))},
         "layers/attn/wk": {"G": _spd(r, (3, 1, 48, 48))},
         "embed": {"G": _spd(r, (1, 48, 48))}}
    if big:
        f["big"] = {"A": _spd(r, (1, 128, 128)), "G": _spd(r, (2, 64, 64))}
    return f


def _torch(tree):
    return {n: {s: torch.from_numpy(np.ascontiguousarray(v))
                for s, v in d.items()} for n, d in tree.items()}


def _jax(tree):
    return {n: {s: jnp.asarray(v) for s, v in d.items()}
            for n, d in tree.items()}


def _plan_key(p):
    return (p.ndev, p.device_blocks, p.device_flops, p.pdiv,
            [(g.bs, g.leaves, g.leaf_counts, g.slots.tolist(),
              g.gather_back.tolist(), g.per_device) for g in p.groups],
            p.total_blocks, p.summary())


def _assert_bitwise(a, b):
    assert a.keys() == b.keys()
    for n in a:
        assert a[n].keys() == b[n].keys(), n
        for k in a[n]:
            assert torch.equal(a[n][k], b[n][k]), (n, k)


def _assert_close_to_reference(got, want):
    want = jax.device_get(want)
    assert got.keys() == want.keys()
    for n in got:
        assert got[n].keys() == want[n].keys(), n
        for k, v in got[n].items():
            ref = np.asarray(want[n][k])
            err = np.max(np.abs(v.numpy() - ref))
            assert err <= TOL * np.max(np.abs(ref)), (n, k, err)


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
@pytest.mark.parametrize("cap", [None, 48])
def test_plan_matches_reference(ndev, cap):
    f = _factors(big=True)
    tp = make_plan(f, ndev, TCFG, pdiv_cap_bs=cap)
    jp = j_make_plan(f, ndev, JCFG, pdiv_cap_bs=cap)
    assert _plan_key(tp)[:3] == _plan_key(jp)[:3]
    assert [(e.name, e.side, e.bs, e.depth) for e in tp.pdiv] == \
        [(e.name, e.side, e.bs, e.depth) for e in jp.pdiv]
    assert _plan_key(tp)[4:] == _plan_key(jp)[4:]
    assert tp.max_device_blocks == jp.max_device_blocks
    if cap is not None:
        assert {(e.name, e.side): e.depth for e in tp.pdiv} == {
            ("big", "A"): 2, ("big", "G"): 1}


@pytest.mark.parametrize("ndev", [1, 2, 4, 8])
def test_wu_plan_stacked_matches_reference(ndev):
    """The smoke model's WU plan: the tile-indexed groups and the
    concat-stacked geometry groups, for plans of 1 to 8 devices."""
    arch = "qwen2-0.5b"
    jcfg, tcfg = get_smoke_config(arch), t_get_smoke_config(arch)
    j_specs, t_specs = jlm.kfac_specs(jcfg), tlm.kfac_specs(tcfg)
    bs = 32
    shapes = {n: {s: np.empty(shp, np.float32)
                  for s, shp in jsoi.factor_shapes(sp, bs).items()}
              for n, sp in j_specs.items()}
    assert shapes.keys() == {n: tsoi.factor_shapes(sp, bs)
                             for n, sp in t_specs.items()}.keys()
    tp = make_wu_plan(t_specs, shapes, TCFG, ndev=ndev)
    jp = j_make_wu_plan(j_specs, shapes, JCFG, ndev=ndev)
    assert tp.ndev == jp.ndev == ndev
    assert _plan_key(tp.inv_plan) == _plan_key(jp.inv_plan)
    assert tp.total_tiles == jp.total_tiles
    for tg, jg in zip(tp.groups, jp.groups, strict=True):
        assert (tg.bi, tg.bo) == (jg.bi, jg.bo)
        assert [dataclasses.astuple(l) for l in tg.leaves] == \
            [dataclasses.astuple(l) for l in jg.leaves]
        np.testing.assert_array_equal(tg.a_src, jg.a_src)
        np.testing.assert_array_equal(tg.g_src, jg.g_src)
    assert [(s.nb_i, s.bi, s.nb_o, s.bo, s.pooled,
             [dataclasses.astuple(m) for m in s.members])
            for s in tp.stacked] == \
        [(s.nb_i, s.bi, s.nb_o, s.bo, s.pooled,
          [dataclasses.astuple(m) for m in s.members]) for s in jp.stacked]
    assert tp.summary() == jp.summary()


def test_cost_model_and_depth_match_reference():
    for method in ("composed", "composed_fast", "exact"):
        t = dataclasses.replace(TCFG, inv_method=method)
        j = JKFACConfig(inv_method=method, **KW)
        for bs in (16, 48, 128, 1024):
            assert inverse_block_flops(bs, t) == j_flops(bs, j)
    for bs, cap in ((96, 24), (96, 5), (32, 48), (256, 128), (1024, 64),
                    (128, 128)):
        assert pdiv_depth(bs, cap) == j_pdiv_depth(bs, cap)


def test_plan_and_wu_plan_refuse_bad_inputs():
    with pytest.raises(ValueError, match="ndev"):
        make_plan(_factors(), 0, TCFG)
    with pytest.raises(ValueError, match="not .*stack"):
        make_plan({"w": {"A": np.zeros((4, 8))}}, 2, TCFG)
    f = {"big": {"A": np.zeros((1, 64, 64)), "G": np.zeros((1, 64, 64))}}
    plan = make_plan(f, 2, TCFG, pdiv_cap_bs=32)
    with pytest.raises(ValueError, match="pdiv"):
        make_wu_plan({}, f, TCFG, ndev=2, inv_plan=plan)
    with pytest.raises(ValueError, match="devices"):
        make_wu_plan({}, f, TCFG, ndev=1, inv_plan=make_plan(f, 2, TCFG))


# ---------------------------------------------------------------------------
# invert_factor_tree and pdiv_invert
# ---------------------------------------------------------------------------

def test_replicated_and_pooled_paths_are_bitwise_and_match_reference():
    f = _factors(1)
    tf = _torch(f)
    repl = invert_factor_tree(tf, TCFG)
    _assert_bitwise(repl, tkfac.invert_factors(tf, TCFG))
    _assert_bitwise(repl, tkfac.refresh_inverses(
        tkfac.KFACState(0, tf, {}, {}, {}, {}), TCFG).inverses)
    pooled = {ndev: invert_factor_tree(tf, TCFG,
                                       plan=make_plan(tf, ndev, TCFG))
              for ndev in (1, 4)}
    for got in pooled.values():
        _assert_bitwise(repl, got)
    # each against the reference's own paths
    jf = _jax(f)
    j_repl = jax.jit(lambda x: j_invert_factor_tree(x, JCFG))(jf)
    _assert_close_to_reference(repl, j_repl)
    for ndev, got in pooled.items():
        jplan = j_make_plan(f, ndev, JCFG)
        _assert_close_to_reference(got, jax.jit(
            lambda x: j_invert_factor_tree(x, JCFG, plan=jplan))(jf))


def test_pooled_path_writes_into_out():
    tf = _torch(_factors(2))
    want = invert_factor_tree(tf, TCFG, plan=make_plan(tf, 3, TCFG))
    for plan in (None, make_plan(tf, 3, TCFG)):
        out = {n: {k: torch.full_like(v, float("nan")) for k, v in d.items()}
               for n, d in want.items()}
        got = invert_factor_tree(tf, TCFG, plan=plan, out=out)
        _assert_bitwise(got, want)
        for n, d in got.items():
            for k, v in d.items():
                assert v is out[n][k]


@pytest.mark.parametrize("depth", [1, 2])
def test_pdiv_invert_matches_reference(depth):
    r = np.random.default_rng(depth)
    blocks = _spd(r, (3, 64, 64))
    lam = (0.03 * np.trace(blocks, axis1=1, axis2=2) / 64).astype(np.float32)
    got = pdiv_invert(torch.from_numpy(blocks), torch.from_numpy(lam), TCFG,
                      depth=depth)
    one = pdiv_invert(torch.from_numpy(blocks[1]), float(lam[1]), TCFG,
                      depth=depth)
    assert got.shape == (3, 64, 64) and one.shape == (64, 64)
    for i in range(3):
        want = np.asarray(jax.jit(
            lambda b, l: j_pdiv_invert(b, l, JCFG, depth=depth))(
                jnp.asarray(blocks[i]), jnp.asarray(lam[i])))
        scale = np.max(np.abs(want))
        assert np.max(np.abs(got[i].numpy() - want)) <= TOL * scale, i
    assert np.max(np.abs(one.numpy() - got[1].numpy())) <= \
        TOL * float(got[1].abs().max())
    exact = np.linalg.inv(blocks.astype(np.float64)
                          + lam[:, None, None] * np.eye(64))
    assert np.max(np.abs(got.numpy() - exact)) <= 1e-4 * np.max(
        np.abs(exact))


def test_pdiv_sub_schedule_matches_reference():
    """Leaves above the cap go through pdiv, the rest through the pools,
    in one tree; ``steps.make_inv_refresh`` takes such a plan."""
    f = _factors(3, big=True)
    tf = _torch(f)
    plan = make_plan(tf, 2, TCFG, pdiv_cap_bs=48)
    assert plan.pdiv
    got = invert_factor_tree(tf, TCFG, plan=plan)
    jplan = j_make_plan(f, 2, JCFG, pdiv_cap_bs=48)
    want = jax.jit(lambda x: j_invert_factor_tree(x, JCFG, plan=jplan))(
        _jax(f))
    _assert_close_to_reference(got, want)
    assert list(got) == list(tf)
    plan1 = make_plan(tf, 1, TCFG, pdiv_cap_bs=48)
    got1 = tsteps.make_inv_refresh(None, TCFG, plan=plan1)(tf)
    _assert_bitwise(got1, invert_factor_tree(tf, TCFG, plan=plan1))
    _assert_close_to_reference(got1, want)


def test_mesh_raises():
    tf = _torch(_factors())
    with pytest.raises(NotImplementedError, match="item 8"):
        invert_factor_tree(tf, TCFG, mesh=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        pdiv_invert(torch.eye(4), 0.0, TCFG, mesh=object())


def test_dist_refresh_on_one_device_is_the_replicated_one():
    tf = _torch(_factors(4))
    cfg = t_get_smoke_config("qwen1.5-0.5b")
    got = tsteps.make_inv_refresh(cfg, TCFG, distributed=True,
                                  pdiv_cap_bs=16)(tf)
    _assert_bitwise(got, tkfac.invert_factors(tf, TCFG))
    st = tsteps.TrainState({}, tkfac.KFACState(0, tf, {}, {}, {}, {}))
    _assert_bitwise(tsteps.make_inv_step(cfg, TCFG, distributed=True)(
        st).kfac.inverses, got)


# ---------------------------------------------------------------------------
# pooled elementwise WU tail
# ---------------------------------------------------------------------------

def test_apply_updates_pool_elementwise_is_bitwise():
    cfg = t_get_smoke_config("qwen1.5-0.5b")
    kc = tkfac.KFACConfig(block_size=32, weight_decay=1e-3)
    params = tlm.init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    specs = tlm.kfac_specs(cfg)
    state = tkfac.init(params, specs, kc)
    r = np.random.default_rng(0)
    state = dataclasses.replace(
        state, step=3,
        momentum={k: torch.from_numpy(r.standard_normal(v.shape).astype(
            np.float32)) for k, v in state.momentum.items()},
        adam_mu={k: torch.from_numpy(r.standard_normal(v.shape).astype(
            np.float32)) for k, v in state.adam_mu.items()},
        adam_nu={k: torch.from_numpy(np.abs(r.standard_normal(
            v.shape)).astype(np.float32)) for k, v in state.adam_nu.items()})
    grads = {k: torch.from_numpy(r.standard_normal(p.shape).astype(
        np.float32)) for k, p in params.items()}
    plan = tsteps.make_wu_plan_for(cfg, tsteps.TrainState(params, state))
    want_p, want_s = tkfac.apply_updates(params, grads, state, specs, kc,
                                         wu_plan=plan)
    got_p, got_s = tkfac.apply_updates(params, grads, state, specs, kc,
                                       wu_plan=plan, pool_elementwise=True)
    assert list(got_p) == list(want_p)
    for tree_g, tree_w in ((got_p, want_p), (got_s.momentum, want_s.momentum),
                           (got_s.adam_mu, want_s.adam_mu),
                           (got_s.adam_nu, want_s.adam_nu)):
        assert list(tree_g) == list(tree_w)
        for k in tree_w:
            assert torch.equal(tree_g[k], tree_w[k]), k
    assert got_s.step == want_s.step == 4
