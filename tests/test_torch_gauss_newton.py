"""repro_torch's Gauss-Newton variant (``core.gauss_newton``) against the
JAX reference (``repro.core.gauss_newton``): G-only specs, the G-only
rank-k statistics on the smoke model, the G-only refresh through the
solver and the G-side preconditioning.

Tolerances and why:
  * specs: equal.
  * statistics: loss rtol 1e-5, G Grams rtol 1e-4 with atol 1e-6 of the
    largest entry, columns rtol and atol 1e-5 (of the largest entry) —
    ``tests/test_torch_smw.py``'s tolerances for the same pass.
  * refresh: bitwise the port's ``kfac.refresh_inverses`` without a plan
    and through a 3-device plan; 5e-5 of the largest entry from the
    reference (the composed inverse's cross-framework bound).
  * preconditioning: rtol 1e-5, atol 1e-6 of the largest entry (one fp32
    product, summed in another order).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import gauss_newton as jgn
from repro.core import kfac as jkfac
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.core.soi import LinearSpec as JSpec
from repro.data import SyntheticTokens as JTokens
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import gauss_newton as tgn
from repro_torch.core import kfac as tkfac
from repro_torch.core.soi import LinearSpec as TSpec
from repro_torch.models import lm as tlm
from repro_torch.solve import make_plan

ARCH = "qwen1.5-0.5b"
KW = dict(ns_iters=20, taylor_terms=4, refine_steps=2)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and the smoke-size products gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_gn_specs_match_reference():
    args = {"w": dict(d_in=32, d_out=16, stack=(4,)),
            "v": dict(d_in=8, d_out=24, share_a_with="w")}
    got = tgn.gn_specs({k: TSpec(**a) for k, a in args.items()})
    want = jgn.gn_specs({k: JSpec(**a) for k, a in args.items()})
    for k, s in want.items():
        assert (got[k].d_in, got[k].d_out, got[k].stack,
                got[k].share_a_with) == (s.d_in, s.d_out, s.stack,
                                         s.share_a_with)
    assert got["w"].d_in == 1 and got["v"].share_a_with is None


@pytest.fixture(scope="module")
def gn_stats():
    """The G-only rank-k pass of both packages on the smoke model's
    weights and tokens."""
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32")
    bs = jcfg.soi_block
    params = jax.device_get(jlm.init(jcfg, jax.random.PRNGKey(0)))
    toks = JTokens(jcfg.vocab, 32, 2, seed=3).batch_slice(0, 0, 2)
    specs = jlm.kfac_specs(jcfg)

    def j_pass(p, batch):
        def loss_with_taps(pp, tp, bt):
            return jlm.loss_fn(jcfg, pp, bt, taps=tp, collect="cols")

        return jgn.stats_rank_k(loss_with_taps, p,
                                jlm.build_taps(jcfg, specs, toks.size),
                                batch, specs, bs)

    ref = jax.device_get(jax.jit(j_pass)(params,
                                         {"tokens": jnp.asarray(toks)}))
    tspecs = tlm.kfac_specs(tcfg)
    port = tgn.stats_rank_k(
        lambda p, tp, bt: tlm.loss_fn(tcfg, p, bt, taps=tp, collect="cols",
                                      soi_block=bs),
        convert.params_from_jax(params, device="cpu"),
        tlm.build_taps(tcfg, tspecs, toks.size, device="cpu"),
        {"tokens": torch.from_numpy(toks)}, tspecs, bs)
    return ref, port


def test_gn_stats_rank_k_matches_reference(gn_stats):
    (jg, jcols, jloss), (tg, tcols, tloss) = gn_stats
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert sorted(tg) == sorted(jg)
    for n, v in jg.items():
        v = np.asarray(v)
        np.testing.assert_allclose(tg[n].numpy(), v, rtol=1e-4,
                                   atol=1e-6 * np.max(np.abs(v)), err_msg=n)
    assert {n: sorted(d) for n, d in tcols.items()} == \
        {n: ["G"] for n in jcols}
    for n, d in jcols.items():
        v = np.asarray(d["G"])
        np.testing.assert_allclose(tcols[n]["G"].numpy(), v, rtol=1e-5,
                                   atol=1e-5 * np.max(np.abs(v)), err_msg=n)


def test_gn_refresh_inverses_routes_through_solver(gn_stats):
    """The G-only factor tree (the Grams plus a unit floor, so that the
    tiny smoke G factors are not all damping) inverts bitwise as K-FAC's
    replicated refresh, through a plan too, and near the reference's."""
    (jg, _, _), _ = gn_stats
    g_fac = {n: {"G": np.asarray(v) + np.eye(v.shape[-1], dtype=np.float32)}
             for n, v in jg.items()}
    t_fac = {n: {"G": torch.from_numpy(d["G"].copy())}
             for n, d in g_fac.items()}
    cfg = tkfac.KFACConfig(**KW)
    st = tkfac.KFACState(0, t_fac, {}, {}, {}, {})
    want = tkfac.refresh_inverses(st, cfg).inverses
    for plan in (None, make_plan(t_fac, 3, cfg)):
        got = tgn.refresh_inverses(st, cfg, plan=plan).inverses
        assert got.keys() == want.keys()
        for n, d in want.items():
            assert set(got[n]) == {"G_inv"}
            assert torch.equal(got[n]["G_inv"], d["G_inv"]), n
    jst = jkfac.KFACState(step=jnp.zeros((), jnp.int32),
                          factors=jax.tree.map(jnp.asarray, g_fac),
                          inverses={}, momentum=None, adam_mu=None,
                          adam_nu=None)
    ref = jax.device_get(jax.jit(lambda s: jgn.refresh_inverses(
        s, JKFACConfig(**KW)).inverses)(jst))
    for n, d in ref.items():
        v = np.asarray(d["G_inv"])
        err = np.max(np.abs(want[n]["G_inv"].numpy() - v))
        assert err <= 5e-5 * np.max(np.abs(v)), (n, err)


def test_gn_precondition_matches_reference():
    """Dense, stacked and padded (d_out % bs != 0) leaves; an unfactored
    leaf passes through."""
    r = np.random.default_rng(0)
    bs = 8
    shapes = {"w": (4, 16), "stk": (3, 5, 20), "bias": (7,)}
    args = {"w": dict(d_in=4, d_out=16), "stk": dict(d_in=5, d_out=20,
                                                      stack=(3,))}
    grads = {k: r.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    ginv = {"w": r.standard_normal((2, bs, bs)).astype(np.float32),
            "stk": r.standard_normal((3, 3, bs, bs)).astype(np.float32)}
    j_specs = {k: JSpec(**a) for k, a in args.items()}
    t_specs = {k: TSpec(**a) for k, a in args.items()}
    jst = jkfac.KFACState(step=jnp.zeros((), jnp.int32), factors={},
                          inverses={k: {"G_inv": jnp.asarray(v)}
                                    for k, v in ginv.items()},
                          momentum=None, adam_mu=None, adam_nu=None)
    want = jax.device_get(jgn.precondition(
        {k: jnp.asarray(v) for k, v in grads.items()}, jst, j_specs,
        JKFACConfig(block_size=bs)))
    tst = tkfac.KFACState(0, {}, {k: {"G_inv": torch.from_numpy(v)}
                                  for k, v in ginv.items()}, {}, {}, {})
    got = tgn.precondition({k: torch.from_numpy(v) for k, v in grads.items()},
                           tst, t_specs, tkfac.KFACConfig(block_size=bs))
    assert got.keys() == want.keys()
    for k, v in want.items():
        v = np.asarray(v)
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_allclose(got[k].numpy(), v, rtol=1e-5,
                                   atol=1e-6 * np.max(np.abs(v)), err_msg=k)
    np.testing.assert_array_equal(got["bias"].numpy(), grads["bias"])
