"""repro_torch's distributed solver on gloo CPU ranks against its local
path and the JAX reference: ``invert_factor_tree(mesh=)`` (with ``out=``
and the pdiv sub-schedule), ``pdiv_invert(mesh=)``, and
``refresh_and_precondition`` in both modes; the WU plan's owner routing
against the reference's.

Ranks are spawned once per configuration in a module fixture
(``repro_torch.dist.spawn.run_ranks``: worlds 2 and 4, meshes (2,),
(4,) and (2, 2)); each rank holds its results bitwise to the port's
local path (``tests/_torch_dist_ranks.solve_rank``) and rank 0's come
back. The reference runs its replicated path here on one CPU device:
its distributed paths are bitwise its replicated ones
(``tests/test_dist_solve_multidev.py``, ``tests/test_wu_fusion_multidev.py``).

Tolerances and why:
  * the port's mesh paths against its local path: bitwise (every block
    is inverted on its own, each tile's products are the same
    left-first association, and a gather only moves bits);
  * against the reference: 5e-5 of the leaf's largest entry (``TOL``,
    the composed inverse's cross-framework bound,
    ``tests/test_torch_solve.py``), for the preconditioned gradients too
    (random SPD factors, well conditioned);
  * plans and owner routing: equal (host integer arithmetic on shapes).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_ranks as ranks_mod
from repro.configs import get_smoke_config
from repro.core import soi as jsoi
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.models import lm as jlm
from repro.solve import invert_factor_tree as j_invert_factor_tree
from repro.solve import make_plan as j_make_plan
from repro.solve import make_wu_plan as j_make_wu_plan
from repro.solve import pdiv_invert as j_pdiv_invert
from repro.solve import refresh_and_precondition as j_refresh_precondition
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.dist.spawn import run_ranks
from repro_torch.models import lm as tlm
from repro_torch.solve import make_wu_plan

JCFG = JKFACConfig(**ranks_mod.KW)
TOL = 5e-5
ARCH, BS = "qwen2-0.5b", 32
CONFIGS = [(2, (2,)), (4, (4,)), (4, (2, 2))]


def _grads():
    specs = tlm.kfac_specs(t_get_smoke_config(ARCH))
    r = np.random.default_rng(3)
    return {n: r.standard_normal(s.stack + (s.d_in, s.d_out)).astype(
        np.float32) for n, s in sorted(specs.items())}


@pytest.fixture(scope="module")
def runs():
    grads = _grads()
    return {cfg: run_ranks(ranks_mod.solve_rank, cfg[0],
                           args=(cfg[1], ARCH, BS, grads))
            for cfg in CONFIGS}


def _close(got, want):
    want = np.asarray(jax.device_get(want))
    err = np.max(np.abs(got - want))
    return err <= TOL * np.max(np.abs(want)), err


def _close_tree(got, want):
    assert got.keys() == want.keys()
    for n in got:
        assert got[n].keys() == want[n].keys(), n
        for k in got[n]:
            ok, err = _close(got[n][k], want[n][k])
            assert ok, (n, k, err)


def _jax(tree):
    return {n: {s: jnp.asarray(v) for s, v in d.items()}
            for n, d in tree.items()}


# the reference's results, computed once: its replicated paths do not
# depend on the device count a plan is built for
@functools.cache
def _ref_tree():
    return jax.device_get(jax.jit(lambda x: j_invert_factor_tree(x, JCFG))(
        _jax(ranks_mod.mixed_factors(0))))


@functools.cache
def _ref_pdiv_tree():
    fb = ranks_mod.mixed_factors(1, big=True)
    jplan = j_make_plan(fb, 1, JCFG, pdiv_cap_bs=48)
    return jax.device_get(jax.jit(
        lambda x: j_invert_factor_tree(x, JCFG, plan=jplan))(_jax(fb)))


@functools.cache
def _ref_pdiv(depth):
    blocks = ranks_mod.spd(np.random.default_rng(5), (3, 64, 64))
    lam = (0.03 * np.trace(blocks, axis1=1, axis2=2) / 64).astype(
        np.float32)
    fn = jax.jit(lambda b, l: j_pdiv_invert(b, l, JCFG, depth=depth))
    return [np.asarray(fn(jnp.asarray(blocks[i]), jnp.asarray(lam[i])))
            for i in range(3)]


@functools.cache
def _ref_fused():
    specs = jlm.kfac_specs(get_smoke_config(ARCH))
    f = ranks_mod.model_factors(specs, BS, seed=2)
    wu = j_make_wu_plan(specs, f, JCFG)
    grads = {n: jnp.asarray(v) for n, v in _grads().items()}
    return jax.device_get(jax.jit(
        lambda x, g: j_refresh_precondition(x, g, JCFG, wu))(_jax(f), grads))


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_every_rank_bitwise_its_local_path(runs, cfg):
    for rank, r in enumerate(runs[cfg]):
        bad = [k for k, v in r["flags"].items() if not v]
        assert not bad, (rank, bad)


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_invert_factor_tree_matches_reference(runs, cfg):
    out = runs[cfg][0]["out"]
    _close_tree(out["tree"], _ref_tree())
    _close_tree(out["pdiv_tree"], _ref_pdiv_tree())


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_pdiv_invert_matches_reference(runs, cfg):
    out = runs[cfg][0]["out"]
    for depth in (1, 2):
        for i, want in enumerate(_ref_pdiv(depth)):
            ok, err = _close(out[f"pdiv_{depth}"][i], want)
            assert ok, (depth, i, err)


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_fused_wu_matches_reference(runs, cfg):
    """Both modes against the reference's replicated fused program (its
    pooled refresh and product)."""
    out = runs[cfg][0]["out"]
    inv, pre = _ref_fused()
    for mode in ("gather", "owner"):
        got_inv, got_pre = out[f"fused_{mode}"]
        _close_tree(got_inv, inv)
        assert got_pre.keys() == set(pre)
        for n, v in got_pre.items():
            ok, err = _close(v, pre[n])
            assert ok, (mode, n, err)


@pytest.mark.parametrize("ndev", [1, 2, 4])
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "moonshot-v1-16b-a3b"])
def test_wu_owner_routing_matches_reference(arch, ndev):
    jcfg, tcfg = get_smoke_config(arch), t_get_smoke_config(arch)
    j_specs, t_specs = jlm.kfac_specs(jcfg), tlm.kfac_specs(tcfg)
    shapes = {n: {s: np.empty(shp, np.float32)
                  for s, shp in jsoi.factor_shapes(sp, BS).items()}
              for n, sp in j_specs.items()}
    tp = make_wu_plan(t_specs, shapes, tkfac.KFACConfig(**ranks_mod.KW),
                      ndev=ndev)
    jp = j_make_wu_plan(j_specs, shapes, JCFG, ndev=ndev)
    assert len(tp.groups) == len(jp.groups)
    for tg, jg in zip(tp.groups, jp.groups):
        assert [dataclasses.astuple(l) for l in tg.leaves] == \
            [dataclasses.astuple(l) for l in jg.leaves]
        for field in ("a_src", "g_src", "slots", "gather_back", "a_slot",
                      "g_slots", "g_gather_back", "g_slot"):
            np.testing.assert_array_equal(getattr(tg, field),
                                          getattr(jg, field), err_msg=field)
