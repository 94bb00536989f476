"""The incremental-SOI (``--smw``) slice of repro_torch against the JAX
reference: token columns, the plain SMW kernel version, the column
subsample, rank-k stats, the Woodbury refresh of the inverse tree with
its drift probe, the host drift gate, 4 training steps end to end, and
the ``--smw`` CLI.
Inputs are made with numpy from fixed seeds and handed to both
packages; no jax global state is changed (the one mesh is scoped by a
``with`` block).

Tolerances and why:
  * token columns: equal (reshape and pad only); their Gram rtol 1e-6
    (fp32 einsum, another summation order), and within the port
    ``gram_from_tokens(blocked_tokens(a))`` equals ``blocked_gram(a)``
    bitwise, as the reference promises for its own pair.
  * plain ``smw_update`` vs the reference's oracle and Pallas kernel
    (interpret mode): 1e-5 of the largest entry. The exact bf16
    partial products are summed in another order and the k x k solves
    are LAPACK calls of different frameworks (and, in the reference,
    on k padded to 128); measured up to 1.5e-6, also with inverse
    entries above 1e6. Against the fp32 ``exact_smw_update``: the
    reference's own atol/rtol 5e-3 (``tests/test_smw.py``) at unit
    scale, 5e-5 of the largest entry at the large scale (measured
    4.4e-6 on entries of 1.2e7).
  * column subsample: bitwise (a gather and one fp32 multiply).
  * rank-k stats on the smoke model: Grams rtol 1e-4 with atol 1e-6 of
    the factor's largest entry, as ``tests/test_torch_model.py``; cols
    rtol 1e-5 with atol 1e-5 of the leaf's largest entry (activations
    and tap gradients, fp32 summation order).
  * the Woodbury refresh on the reference's own smoke factors and
    inverses (entries up to ~1e7): updated inverses within 1e-4 of the
    leaf's largest entry and the drift rtol 1e-4 on both routes (hi/lo
    and fp32).
  * 4-step trajectory: see the test.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core import kfac as jkfac
from repro.core import soi as jsoi
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.data import SyntheticTokens as JTokens
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.solve import smw as jsmw
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.core import soi as tsoi
from repro_torch.kernels import ref as tref
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.solve import smw as tsmw
from repro_torch.solve.async_refresh import SMWRefresher

ARCH = "qwen1.5-0.5b"


def _rel_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# 1. token columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,cap", [((2, 24, 64), 32), ((40, 100), 32),
                                       ((3, 16, 48), 64)])
def test_token_columns_match_reference(shape, cap):
    a = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ta = torch.from_numpy(a)
    bt = tsoi.blocked_tokens(ta, cap)
    jbt = jsoi.blocked_tokens(jnp.asarray(a), cap)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(jbt))
    np.testing.assert_array_equal(tsoi.cols_from_tokens(bt).numpy(),
                                  np.asarray(jsoi.cols_from_tokens(jbt)))
    np.testing.assert_allclose(tsoi.gram_from_tokens(bt).numpy(),
                               np.asarray(jsoi.gram_from_tokens(jbt)),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(tsoi.gram_from_tokens(bt), tsoi.blocked_gram(ta, cap))


# ---------------------------------------------------------------------------
# 2. the plain SMW update against the reference's oracle and kernel
# ---------------------------------------------------------------------------

def _smw_case(seed, n, k, bs, scale):
    """Cached inverses of damped factor-like blocks (the Gram of 4*bs
    columns at ``scale``, Tikhonov-damped as K-FAC does) and new
    columns at the same scale."""
    r = np.random.default_rng(seed)
    v0 = r.standard_normal((n, 4 * bs, bs)) * scale
    f = np.einsum("ntb,ntc->nbc", v0, v0) / (4 * bs)
    lam = 0.03 * np.trace(f, axis1=1, axis2=2) / bs + 1e-8
    inv = np.linalg.inv(f + lam[:, None, None] * np.eye(bs))
    v = r.standard_normal((n, k, bs)) * scale
    return inv.astype(np.float32), v.astype(np.float32)


SMW_CASES = [  # (n, k, bs, column scale, c)
    (3, 8, 32, 1.0, 0.05),
    (2, 64, 128, 1.0, 0.05 / 2048),     # the A side at the main path's k
    (5, 24, 48, 1.0, 0.05),
    (3, 5, 40, 3e-4, 0.05),             # G-side scale: inverses ~1e7
]


@pytest.mark.parametrize("n,k,bs,scale,c", SMW_CASES)
def test_smw_update_plain_matches_reference(n, k, bs, scale, c):
    inv, v = _smw_case(n + k + bs, n, k, bs, scale)
    kw = dict(decay=0.95, cscale=c)
    got = tref.smw_update_ref(torch.from_numpy(inv), torch.from_numpy(v),
                              **kw).numpy()
    assert got.shape == (n, bs, bs)
    oracle = jref.smw_update_ref(jnp.asarray(inv), jnp.asarray(v), **kw)
    kernel = jops.smw_update(jnp.asarray(inv), jnp.asarray(v), **kw)
    assert _rel_err(got, oracle) <= 1e-5
    assert _rel_err(got, kernel) <= 1e-5
    exact = tref.exact_smw_update(torch.from_numpy(inv),
                                  torch.from_numpy(v), **kw).numpy()
    np.testing.assert_allclose(
        exact, np.asarray(jref.exact_smw_update(jnp.asarray(inv),
                                                jnp.asarray(v), **kw)),
        rtol=1e-4, atol=1e-5 * np.max(np.abs(exact)))
    if scale == 1.0:
        np.testing.assert_allclose(got, exact, atol=5e-3, rtol=5e-3)
    else:
        assert np.max(np.abs(got)) >= 1e6
        assert _rel_err(got, exact) <= 5e-5


def test_smw_update_plain_is_the_woodbury_inverse():
    """inv(d F + c V^T V) from inv(F), in float64 terms."""
    inv, v = _smw_case(7, 3, 6, 24, 1.0)
    f = np.linalg.inv(inv.astype(np.float64))
    truth = np.linalg.inv(0.95 * f + 0.05 * np.einsum(
        "nkb,nkc->nbc", v.astype(np.float64), v.astype(np.float64)))
    got = tref.smw_update_ref(torch.from_numpy(inv), torch.from_numpy(v),
                              decay=0.95, cscale=0.05).numpy()
    assert _rel_err(got, truth) <= 1e-4


# ---------------------------------------------------------------------------
# 3. column subsample
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,rank", [(200, 64), (2048, 64), (64, 64),
                                    (8, 64), (10, 3)])
def test_subsample_cols_matches_reference(k, rank):
    v = np.random.default_rng(k).standard_normal(
        (2, 3, k, 16)).astype(np.float32)
    got = tsmw._subsample_cols(torch.from_numpy(v), rank)
    want = jsmw._subsample_cols(jnp.asarray(v), rank)
    assert tuple(got.shape) == want.shape == (2, 3, min(k, rank), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# 4. rank-k stats on the smoke model (and 5. the refresh on its factors)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_stats():
    """The reference's rank-k stats pass on the smoke model, its factor
    EMA and the fully re-inverted inverses of those factors, plus the
    port's same pass on the same weights and tokens."""
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32")
    bs = jcfg.soi_block
    params = jax.device_get(jlm.init(jcfg, jax.random.PRNGKey(0)))
    toks = JTokens(jcfg.vocab, 32, 2, seed=1).batch_slice(0, 0, 2)
    specs = jlm.kfac_specs(jcfg)
    jk = JKFACConfig(block_size=bs)

    def j_pass(p, batch):
        taps = jlm.build_taps(jcfg, specs, toks.size)

        def loss_with_taps(pp, tp, bt):
            return jlm.loss_fn(jcfg, pp, bt, taps=tp, collect="cols")

        a, g, cols, loss = jkfac.stats_rank_k(loss_with_taps, p, taps,
                                              batch, specs, bs)
        st = jkfac.update_factors(jkfac.init(p, specs, jk), a, g, jk)
        return a, g, cols, loss, jkfac.refresh_inverses(st, jk)

    a, g, cols, loss, jstate = jax.jit(j_pass)(
        params, {"tokens": jnp.asarray(toks)})

    tparams = convert.params_from_jax(params, device="cpu")
    tspecs = tlm.kfac_specs(tcfg)
    tb = {"tokens": torch.from_numpy(toks)}

    def t_loss(collect):
        def loss_with_taps(p, tp, bt):
            return tlm.loss_fn(tcfg, p, bt, taps=tp, collect=collect,
                               soi_block=bs)
        return loss_with_taps

    def taps():
        return tlm.build_taps(tcfg, tspecs, toks.size, device="cpu")

    port = tkfac.stats_rank_k(t_loss("cols"), tparams, taps(), tb, tspecs,
                              bs)
    port_grams = tkfac.stats_grams(t_loss(True), tparams, taps(), tb,
                                   tspecs, bs)
    return dict(ref=jax.device_get((a, g, cols, loss)), port=port,
                port_grams=port_grams, bs=bs,
                factors=jax.device_get(jstate.factors),
                inverses=jax.device_get(jstate.inverses))


def test_stats_rank_k_matches_reference(smoke_stats):
    ja, jg, jcols, jloss = smoke_stats["ref"]
    ta, tg, tcols, tloss = smoke_stats["port"]
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    for got, want in ((ta, ja), (tg, jg)):
        assert sorted(got) == sorted(want)
        for n, v in want.items():
            v = np.asarray(v)
            np.testing.assert_allclose(got[n].numpy(), v, rtol=1e-4,
                                       atol=1e-6 * np.max(np.abs(v)),
                                       err_msg=n)
    assert {n: sorted(d) for n, d in tcols.items()} == \
        {n: sorted(d) for n, d in jcols.items()}
    for n, d in jcols.items():
        for side, v in d.items():
            v = np.asarray(v)
            got = tcols[n][side]
            assert tuple(got.shape) == v.shape and v.shape[-2] == 64
            np.testing.assert_allclose(got.numpy(), v, rtol=1e-5,
                                       atol=1e-5 * np.max(np.abs(v)),
                                       err_msg=f"{n}/{side}")


def test_stats_rank_k_grams_bitwise_vs_stats_grams(smoke_stats):
    ta, tg, tcols, tloss = smoke_stats["port"]
    ga, gg, gloss = smoke_stats["port_grams"]
    assert float(tloss) == float(gloss)
    for got, want in ((ta, ga), (tg, gg)):
        assert sorted(got) == sorted(want)
        for n in want:
            assert torch.equal(got[n], want[n]), n
    # the cols are the rank-k factors of the same contributions
    for n, d in tcols.items():
        k = d["G"].shape[-2]
        torch.testing.assert_close(
            torch.einsum("...kb,...kc->...bc", d["G"], d["G"]), tg[n],
            rtol=1e-4, atol=1e-6 * float(tg[n].abs().max()))
        if "A" in d:
            torch.testing.assert_close(
                torch.einsum("...kb,...kc->...bc", d["A"], d["A"]) / k,
                ta[n], rtol=1e-4, atol=1e-6 * float(ta[n].abs().max()))


# ---------------------------------------------------------------------------
# 5. the Woodbury refresh of the inverse tree and the drift probe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernel", [True, False])
def test_smw_refresh_matches_reference(smoke_stats, use_kernel):
    """On the reference's own smoke factors, fully re-inverted inverses
    and rank-k columns: ``use_kernel=True`` holds the port's hi/lo route
    to the reference's Pallas kernel (interpret mode), ``False`` the
    fp32 routes to each other."""
    kcfg_j = JKFACConfig(block_size=smoke_stats["bs"])
    kcfg_t = tkfac.KFACConfig(block_size=smoke_stats["bs"])
    cols = smoke_stats["ref"][2]
    factors, inverses = smoke_stats["factors"], smoke_stats["inverses"]
    # drop one leaf's columns: its inverse must come back untouched
    cols = {n: dict(d) for n, d in cols.items()}
    del cols["layers/attn/wo"]["G"]
    jinv, jdrift = jsmw.smw_refresh(
        inverses, factors, cols, kcfg_j,
        jsmw.SMWConfig(rank=16, use_kernel=use_kernel))
    tinv, tdrift = tsmw.smw_refresh(
        convert.blocks_from_jax(inverses, device="cpu"),
        convert.blocks_from_jax(factors, device="cpu"),
        convert.blocks_from_jax(cols, device="cpu"), kcfg_t,
        tsmw.SMWConfig(rank=16, use_kernel=use_kernel))
    jinv = jax.device_get(jinv)
    for n, d in jinv.items():
        for side, v in d.items():
            assert _rel_err(tinv[n][side].numpy(), v) <= 1e-4, (n, side)
    np.testing.assert_array_equal(tinv["layers/attn/wo"]["G_inv"].numpy(),
                                  inverses["layers/attn/wo"]["G_inv"])
    assert math.isfinite(float(tdrift))
    np.testing.assert_allclose(float(tdrift), float(jdrift), rtol=1e-4)
    np.testing.assert_allclose(
        float(tsmw.probe_drift(convert.blocks_from_jax(factors,
                                                       device="cpu"),
                               tinv, kcfg_t)), float(tdrift), rtol=0)


def test_smw_refresh_side_weights():
    """A side w = 1/k (token-mean Gram), G side w = 1, before the
    subsample; the rest of the tree is kept as the same tensors."""
    r = np.random.default_rng(4)
    bs, k = 16, 12
    kcfg = tkfac.KFACConfig()
    d = kcfg.ema_decay
    inv = {"lin": {"A_inv": torch.from_numpy(_smw_case(1, 2, 1, bs, 1)[0]),
                   "G_inv": torch.from_numpy(_smw_case(2, 2, 1, bs, 1)[0])},
           "other": {"G_inv": torch.eye(bs).expand(1, bs, bs)}}
    va = torch.from_numpy(r.standard_normal((2, k, bs)).astype(np.float32))
    vg = torch.from_numpy(r.standard_normal((2, k, bs)).astype(np.float32))
    factors = {"lin": {"A": torch.zeros(2, bs, bs),
                       "G": torch.zeros(2, bs, bs)},
               "other": {"G": torch.zeros(1, bs, bs)}}
    scfg = tsmw.SMWConfig(rank=4, use_kernel=True)
    new, drift = tsmw.smw_refresh(inv, factors, {"lin": {"A": va, "G": vg}},
                                  kcfg, scfg)
    assert new["other"]["G_inv"] is inv["other"]["G_inv"]
    for key, v, w in (("A_inv", va, 1.0 / k), ("G_inv", vg, 1.0)):
        want = tref.smw_update_ref(inv["lin"][key],
                                   tsmw._subsample_cols(v, 4), decay=d,
                                   cscale=(1.0 - d) * w)
        assert torch.equal(new["lin"][key], want), key
    assert drift.ndim == 0 and math.isfinite(float(drift))


# ---------------------------------------------------------------------------
# 6. the host drift gate
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _KState:
    factors: dict
    inverses: dict


@dataclasses.dataclass
class _TState:
    kfac: _KState


def test_smw_refresher_lagged_gate_seed_nan_and_reset():
    """Step 0 always falls back; a large drift queued at step N trips
    the gate at step N+1; a drift measured on replaced inverses is
    discarded; a NaN drift trips it; reset forces a fallback."""
    drifts = iter([0.01, 99.0, 0.01, 0.01, float("nan"), 0.01, 0.01])
    calls = []

    def smw_step(state, batch):
        return state, {"smw_drift": torch.tensor(next(drifts))}

    def refresh(factors):
        calls.append(factors)
        return {"x": {"G_inv": torch.ones(1, 2, 2)}}

    gate = SMWRefresher(smw_step, refresh, drift_budget=0.05)
    state = _TState(_KState({"x": {"G": torch.zeros(1, 2, 2)}},
                            {"x": {"G_inv": torch.zeros(1, 2, 2)}}))
    flags = []
    for _ in range(6):
        state, m = gate.step(state, None)
        flags.append(m["smw_fallback"])
    # 0: seed; 1: queues 99; 2: trips on 99 (its own drift discarded);
    # 3: queues 0.01... 4: reads 0.01, queues NaN; 5: trips on NaN
    assert flags == [1.0, 0.0, 1.0, 0.0, 0.0, 1.0]
    assert len(calls) == gate.n_fallbacks == 3 and gate.n_steps == 6
    assert math.isnan(gate.last_drift)
    assert float(state.kfac.inverses["x"]["G_inv"].sum()) == 4.0
    assert gate.peek(state.kfac) is state.kfac
    assert gate.flush(state.kfac) is state.kfac
    gate.reset()
    state, m = gate.step(state, None)
    assert m["smw_fallback"] == 1.0, "reset must force a fallback"


# ---------------------------------------------------------------------------
# 7. the slice as a whole
# ---------------------------------------------------------------------------

def test_smw_four_step_trajectory_matches_reference():
    """4 steps of ``KFACProgram(smw=True)`` against the reference's on a
    1-device mesh, same weights and tokens. The reference's ``--smw``
    runs the fp32 einsum update (``SMWConfig(use_kernel=False)``), the
    port's the ``smw_update`` kernel route (its hi/lo plain version on
    the CPU), so the inverses differ by the hi/lo rounding on top of
    the composed inverse's cross-framework 1e-4
    (``tests/test_torch_train.py``). Tolerances (measured in
    brackets): losses rtol 1e-5 (2.5e-6); drifts rtol 2e-3 (2.2e-4; a
    drift is a residual ``||F M v - v||`` of inverses reaching 1e7);
    the fallback flags equal wherever the reference's drift of the
    step before is not within 1% of the budget; final weights within
    1% of each leaf's largest entry (0.61%, on ``embed``: the smoke G
    factors are ~1e-7, so ``A^-1 g G^-1`` cancels heavily, as in the
    stats/inv trajectory test)."""
    from repro.launch.train import KFACProgram as JProgram

    b, t, n_steps, budget = 2, 32, 4, 0.05
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32")
    common = dict(block_size=min(128, jcfg.soi_block), stats_batch=b,
                  stats_seq=t)
    ds = JTokens(jcfg.vocab, t, b, seed=0)
    batches = [ds.batch_slice(i, 0, b) for i in range(n_steps)]

    jprog = JProgram(jcfg, JKFACConfig(**common), seed=0, smw=True,
                     smw_drift_budget=budget, smw_rank=16)
    # a 1-device (data, model) mesh with Auto axes, as the reference's
    # production meshes have: jax's default (Explicit) axes refuse the
    # embedding gather (launch.mesh.make_dev_mesh fails there)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    j_hist = []
    with jax.set_mesh(mesh):
        jstate = jprog.init_state(mesh)
        params = jax.device_get(jstate.params)
        jstep = jprog.make_step(mesh)
        for toks in batches:
            jstate, m = jstep(jstate, {"tokens": jnp.asarray(toks)})
            j_hist.append((float(m["loss"]), float(m["smw_drift"]),
                           float(m["smw_fallback"])))
        j_params = convert._flatten(jax.device_get(jstate.params))

    tprog = ttrain.KFACProgram(tcfg, tkfac.KFACConfig(**common),
                               device="cpu", smw=True,
                               smw_drift_budget=budget, smw_rank=16)
    tparams = convert.params_from_jax(params, device="cpu")
    state = tsteps.TrainState(tparams, tkfac.init(
        tparams, tlm.kfac_specs(tcfg), tprog.kcfg))
    step_fn = tprog.make_step(state)
    t_hist, phases = [], []
    for toks in batches:
        state, m = step_fn(state, {"tokens": torch.from_numpy(toks)})
        t_hist.append((float(m["loss"]), float(m["smw_drift"]),
                       m["smw_fallback"]))
        phases.append(sorted(m["phase_s"]))

    assert phases[0] == ["inv", "smw", "train", "wu"]
    assert all(p in (["inv", "smw", "train", "wu"], ["smw", "train", "wu"])
               for p in phases)
    assert state.kfac.step == n_steps
    np.testing.assert_allclose([h[0] for h in t_hist],
                               [h[0] for h in j_hist], rtol=1e-5)
    np.testing.assert_allclose([h[1] for h in t_hist],
                               [h[1] for h in j_hist], rtol=2e-3)
    for i, ((_, _, jf), (_, _, tf)) in enumerate(zip(j_hist, t_hist)):
        # step i's flag is decided by step i-1's drift (lagged gate)
        if i == 0 or abs(j_hist[i - 1][1] - budget) > 0.01 * budget:
            assert tf == jf, (i, j_hist, t_hist)
    assert t_hist[0][2] == 1.0
    for k, v in j_params.items():
        err = np.max(np.abs(state.params[k].numpy() - v))
        assert err <= 1e-2 * np.max(np.abs(v)), (k, err)
    # the recovery hook forces the next step to re-invert
    tprog.reset_async()
    _, m = step_fn(state, {"tokens": torch.from_numpy(batches[0])})
    assert m["smw_fallback"] == 1.0 and "inv" in m["phase_s"]


def test_cli_smw_runs_on_cpu_and_defaults_to_cuda(monkeypatch):
    """The slice's CLI on the CPU (plain kernel versions, no launches),
    and without ``--device`` on a machine without CUDA it raises."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    args = ["--arch", ARCH, "--smoke", "--smw", "--steps", "4", "--batch",
            "2", "--seq", "32"]
    summary = ttrain.main(args + ["--device", "cpu"])
    assert summary["smw"] is True
    assert all(math.isfinite(x) for x in summary["losses"])
    assert len(summary["smw_drift"]) == 4
    assert summary["smw_fallback"][0] == 1.0
    assert summary["kernel_launches"] == {"neumann_inv": 0,
                                          "fused_precond": 0,
                                          "smw_update": 0,
                                          "bitslice_mm": 0,
                                          "fused_gram_inv": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(args)
