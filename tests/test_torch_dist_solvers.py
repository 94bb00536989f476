"""``--smw``, ``--async-inv`` and the SGD baseline across gloo CPU ranks,
and ``--async-inv`` (the bubble refresh) and ``--smw`` under ``--pp``,
against the JAX reference on one device with the same global batch and
against the port's one rank, at fp32 compute on the reference's seed-0
weights.

Ranks are spawned once (world 2, ``tests/_torch_dist_ranks.
solvers_rank``): ``--smw --dist-inv`` at ``(2, 1)`` (and one step of
a subsample one rank holds none of) and ``(1, 2)``,
``--async-inv --dist-inv`` at ``(2, 1)``, SGD at ``(2, 1)`` and ``(1,
2)``, ``--pp 2 --async-inv --dist-inv`` and ``--pp 2 --smw --dist-inv``
at ``(2, 1, 1)``, and ``benchmarks.dist_inverse``'s ``--smw`` probe.
The references and the one-rank runs run in this process meanwhile.

Tolerances and why (those of the one-device tests of each path):
  * ``--smw`` (``tests/test_torch_smw.py``'s 4-step trajectory): losses
    rtol 1e-5, drifts rtol 2e-3 (a residual of inverses reaching 1e7),
    the fallback flags equal wherever the previous step's drift is not
    within 1% of the budget, final weights within 1% of each leaf's
    largest entry. Across the ranks: the inverses bitwise on the ranks
    holding the same blocks, the flags equal (the drift is reduced);
  * ``--async-inv`` (``tests/test_torch_async.py``'s): losses rtol 1e-5,
    final weights within 1%; both refreshers dispatched 3 and swapped 2;
  * SGD (``tests/test_torch_sgd.py``'s): losses rtol 1e-5, weights
    within 1e-4 of each leaf's largest entry;
  * ``--pp 2 --async-inv``: against the reference's and the port's one
    device at ``train_accum`` 2, the pipeline's microbatches (the
    pipeline program equals its one-device accumulation,
    ``tests/test_torch_dist_pp.py``), the async tolerances above; the
    bubble metrics are the schedule's. ``--pp 2 --smw``: against the
    port's one rank at ``train_accum`` 2, the SMW tolerances above.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_dist_ranks as ranks_mod
from _torch_families import one_thread  # noqa: F401 (autouse)
from repro.configs import get_smoke_config
from repro.core import kfac as jkfac
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.data import SyntheticTokens as JTokens
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.solve import AsyncInverseRefresher as JAsync
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.dist.spawn import start_ranks
from repro_torch.launch import train as ttrain
from repro_torch.pipeline import kfac_glue, make_schedule

ARCH = "qwen1.5-0.5b"
B, T = 2, 32
BUDGET, RANK = 0.05, 16
SMW_KCFG = dict(block_size=32, stats_batch=B, stats_seq=T)
ASYNC_KCFG = dict(stats_every=2, inv_every=2, block_size=32, stats_batch=B,
                  stats_seq=T)
SMW_KW = dict(smw=True, smw_drift_budget=BUDGET, smw_rank=RANK,
              dist_inv=True)
ASYNC_KW = dict(async_inv=True, dist_inv=True)
DS = dict(seq_len=T, global_batch=B, seed=0)
STEPS = {"smw": 4, "async": 6, "sgd": 4, "pp_async": 4, "pp_smw": 4}


def _jcfg(**over):
    return dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                               **over)


@pytest.fixture(scope="module")
def params():
    return jax.device_get(jlm.init(_jcfg(), jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def runs(params):
    tparams = {k: v.numpy() for k, v in
               convert.params_from_jax(params, device="cpu").items()}
    cases = [
        ("smw_dp", ARCH, {}, (2, 1), SMW_KCFG, SMW_KW, "smw"),
        ("smw_tp", ARCH, {}, (1, 2), SMW_KCFG, SMW_KW, "smw"),
        ("async_dp", ARCH, {}, (2, 1), ASYNC_KCFG, ASYNC_KW, "async"),
        ("sgd_dp", ARCH, {}, (2, 1), None, {"lr": 1e-2}, "sgd"),
        ("sgd_tp", ARCH, {}, (1, 2), None, {"lr": 1e-2}, "sgd"),
        ("pp_async", ARCH, {}, (2, 1, 1), ASYNC_KCFG, ASYNC_KW, "pp_async"),
        ("pp_smw", ARCH, {}, (2, 1, 1), SMW_KCFG, SMW_KW, "pp_smw"),
    ]
    ranks = start_ranks(ranks_mod.solvers_rank, 2, args=([
        (key, arch, over, shape, kc, kw, tparams, DS, STEPS[kind])
        for key, arch, over, shape, kc, kw, kind in cases], True))
    # the port's one rank on the same weights and batches
    one = {}
    for kind, kc, kw, over in (("smw", SMW_KCFG, SMW_KW, {}),
                               ("async", ASYNC_KCFG, ASYNC_KW, {}),
                               ("sgd", None, {"lr": 1e-2}, {}),
                               ("pp_async", ASYNC_KCFG, ASYNC_KW,
                                {"train_accum": 2}),
                               ("pp_smw", SMW_KCFG, SMW_KW,
                                {"train_accum": 2})):
        cfg = dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32",
                                  **over)
        one[kind] = ranks_mod.solvers_run(
            ranks_mod.solvers_program(cfg, kc, **kw), tparams, DS,
            STEPS[kind])
    ref = {"smw": _reference_smw(params), "sgd": _reference_sgd(params),
           "async": _reference_async(params, 1),
           "pp_async": _reference_async(params, 2)}
    ref["dist_inverse_smw"] = _reference_smw_probe()
    got = ranks.results()
    return ({key: [r[key] for r in got]
             for key in [c[0] for c in cases]
             + ["dist_inverse_smw", "drift_max", "drift_nan",
                "smw_no_rows"]},
            one, ref)


def _batches(n):
    ds = JTokens(_jcfg().vocab, T, B, seed=0)
    return [{"tokens": jnp.asarray(ds.batch_slice(i, 0, B))}
            for i in range(n)]


def _reference_smw(params):
    """The reference's ``--smw`` program on a 1-device mesh with Auto
    axes (``tests/test_torch_smw.py``'s trajectory)."""
    from repro.launch.train import KFACProgram as JProgram

    jprog = JProgram(_jcfg(), JKFACConfig(**SMW_KCFG), seed=0, smw=True,
                     smw_drift_budget=BUDGET, smw_rank=RANK)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    hist = []
    with jax.set_mesh(mesh):
        state = jprog.init_state(mesh)
        # its init's weights differ from jlm.init's in the last bit: take
        # the same weights as every other run
        state = state._replace(params=jax.tree.map(
            lambda a, p: jax.device_put(p, a.sharding), state.params,
            params))
        step = jprog.make_step(mesh)
        for batch in _batches(STEPS["smw"]):
            state, m = step(state, batch)
            hist.append((float(m["loss"]), float(m["smw_drift"]),
                         float(m["smw_fallback"])))
        return hist, convert._flatten(jax.device_get(state.params))


def _reference_sgd(params):
    step = jax.jit(jsteps.make_sgd_step(_jcfg(), 1e-2))
    state = (params, jax.tree.map(jnp.zeros_like, params))
    losses = []
    for batch in _batches(STEPS["sgd"]):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses, convert._flatten(jax.device_get(state[0]))


def _reference_async(params, accum):
    """The reference's ``--async-inv`` cadence on one device
    (``tests/test_torch_async.py``'s), at ``train_accum`` ``accum``."""
    cfg = _jcfg(train_accum=accum)
    kcfg = JKFACConfig(**ASYNC_KCFG)
    state = jsteps.TrainState(params, jkfac.init(params, jlm.kfac_specs(cfg),
                                                 kcfg))
    stats = jax.jit(jsteps.make_stats_step(cfg, kcfg))
    train = jax.jit(jsteps.make_train_step(cfg, kcfg))
    refresh = jax.jit(jsteps.make_inv_refresh(cfg, kcfg))
    refresher = JAsync(
        refresh_into=jax.jit(lambda f, retired: refresh(f)),
        spare_buffers=jax.tree.map(jnp.zeros_like, state.kfac.inverses))
    losses = []
    n = STEPS["pp_async" if accum > 1 else "async"]
    for i, batch in enumerate(_batches(n)):
        if i % kcfg.stats_every == 0:
            state, _ = stats(state, batch)
        if i % kcfg.inv_every == 0:
            state = state._replace(kfac=refresher.step(state.kfac))
        state, m = train(state, batch)
        losses.append(float(m["loss"]))
    return losses, convert._flatten(jax.device_get(state.params))


def _reference_smw_probe():
    """The SMW part of the reference's ``benchmarks/dist_inverse.py
    --smw`` child on one device, with its seeds and sizes: the base
    drift, the largest drift and the fallbacks of its 15 steps."""
    from repro.solve import SMWConfig, invert_factor_tree, probe_drift, \
        smw_refresh

    from repro_torch.benchmarks import dist_inverse

    bs, k = dist_inverse.SMW_BS, dist_inverse.SMW_K
    kcfg = JKFACConfig(block_size=bs, ns_iters=12, taylor_terms=4,
                       refine_steps=2)
    scfg = SMWConfig(drift_budget=0.05, rank=k)
    r = np.random.default_rng(0)

    def spd(shape):
        a = r.standard_normal(shape[:-1] + (2 * shape[-1],)).astype(
            np.float32)
        return jnp.asarray(np.einsum("...ij,...kj->...ik", a, a)
                           / (2 * shape[-1]))

    factors = {"lin0": {"G": spd((2, bs, bs))},
               "lin1": {"G": spd((2, bs, bs))}}
    full = jax.jit(lambda f: invert_factor_tree(f, kcfg))
    step = jax.jit(lambda inv, f, c: smw_refresh(inv, f, c, kcfg, scfg))
    d = kcfg.ema_decay

    def cols_like(seed):
        rr = np.random.default_rng(seed)
        return {n: {"G": jnp.asarray(
            rr.standard_normal((2, k, bs)).astype(np.float32)
            / np.sqrt(k, dtype=np.float32))} for n in factors}

    inv = full(factors)
    base = float(probe_drift(factors, inv, kcfg))
    drifts, fallbacks = [], 0
    for t in range(dist_inverse.SMW_STEPS):
        c = cols_like(100 + t)
        factors = {n: {"G": d * factors[n]["G"] + (1.0 - d) * jnp.einsum(
            "nkb,nkc->nbc", c[n]["G"], c[n]["G"])} for n in factors}
        inv, drift = step(inv, factors, c)
        drifts.append(float(drift))
        if not drifts[-1] <= scfg.drift_budget:
            inv = full(factors)
            fallbacks += 1
    return base, max(drifts), fallbacks


def _params_close(got, want, rel):
    for k, v in want.items():
        err = np.max(np.abs(got[k] - v))
        assert err <= rel * np.max(np.abs(v)), (k, err)


def _losses(run):
    return [h["loss"] for h in run["hist"]]


@pytest.mark.parametrize("key", ["smw_dp", "smw_tp"])
def test_smw_across_ranks_matches_reference_and_one_rank(runs, key):
    got, one, ref = runs
    j_hist, j_params = ref["smw"]
    r0 = got[key][0]
    drifts = [h["smw_drift"] for h in r0["hist"]]
    flags = [h["smw_fallback"] for h in r0["hist"]]
    # every rank's gate read the same drift and fell back alike
    for r in got[key]:
        assert [h["smw_fallback"] for h in r["hist"]] == flags
        assert [h["smw_drift"] for h in r["hist"]] == drifts
        assert _losses(r) == _losses(r0)
    if key == "smw_dp":
        # the same blocks on both ranks: bitwise the same inverses
        assert got[key][1]["local_inverses"] == r0["local_inverses"]
    assert r0["hist"][0]["phases"] == ["inv", "smw", "train", "wu"]
    assert flags[0] == 1.0
    assert flags == [h["smw_fallback"] for h in one["smw"]["hist"]]
    np.testing.assert_allclose(_losses(r0), [h[0] for h in j_hist],
                               rtol=1e-5)
    np.testing.assert_allclose(drifts, [h[1] for h in j_hist], rtol=2e-3)
    for i, (jh, f) in enumerate(zip(j_hist, flags)):
        # step i's flag is decided by step i-1's drift (lagged gate)
        if i == 0 or abs(j_hist[i - 1][1] - BUDGET) > 0.01 * BUDGET:
            assert f == jh[2], (i, j_hist, flags)
    _params_close(r0["params"], j_params, 1e-2)
    np.testing.assert_allclose(_losses(r0), _losses(one["smw"]), rtol=1e-5)
    np.testing.assert_allclose(
        drifts, [h["smw_drift"] for h in one["smw"]["hist"]], rtol=2e-3)
    _params_close(r0["params"], one["smw"]["params"], 1e-2)


def test_async_inv_across_ranks_matches_reference_and_one_rank(runs):
    got, one, ref = runs
    j_losses, j_params = ref["async"]
    r0 = got["async_dp"][0]
    assert got["async_dp"][1]["local_inverses"] == r0["local_inverses"]
    assert _losses(got["async_dp"][1]) == _losses(r0)
    assert r0["refresher"] == one["async"]["refresher"] == (3, 2)
    assert [h["phases"] for h in r0["hist"]] == \
        [["inv", "stats", "train", "wu"], ["train", "wu"]] * 3
    np.testing.assert_allclose(_losses(r0), j_losses, rtol=1e-5)
    np.testing.assert_allclose(_losses(r0), _losses(one["async"]),
                               rtol=1e-5)
    _params_close(r0["params"], j_params, 1e-2)
    _params_close(r0["params"], one["async"]["params"], 1e-2)


@pytest.mark.parametrize("key", ["sgd_dp", "sgd_tp"])
def test_sgd_across_ranks_matches_reference_and_one_rank(runs, key):
    got, one, ref = runs
    j_losses, j_params = ref["sgd"]
    r0 = got[key][0]
    assert _losses(got[key][1]) == _losses(r0)
    assert all(h["phases"] == ["train"] for h in r0["hist"])
    np.testing.assert_allclose(_losses(r0), j_losses, rtol=1e-5)
    np.testing.assert_allclose(_losses(r0), _losses(one["sgd"]), rtol=1e-5)
    _params_close(r0["params"], j_params, 1e-4)
    _params_close(r0["params"], one["sgd"]["params"], 1e-4)


def test_pp_async_inv_is_the_bubble_refresh(runs):
    got, one, ref = runs
    j_losses, j_params = ref["pp_async"]
    r0 = got["pp_async"][0]
    assert _losses(got["pp_async"][1]) == _losses(r0)
    assert r0["refresher"] == (2, 1)
    sched = make_schedule("1f1b", 2, 2)
    for i, h in enumerate(r0["hist"]):
        if i % 2 == 0:
            assert h["pp_bubble_ticks"] == kfac_glue.bubble_ticks(sched)
            assert h["pp_bubble_fraction"] == pytest.approx(
                sched.bubble_fraction)
        else:
            assert "pp_bubble_ticks" not in h
    np.testing.assert_allclose(_losses(r0), j_losses, rtol=1e-5)
    np.testing.assert_allclose(_losses(r0), _losses(one["pp_async"]),
                               rtol=1e-5)
    _params_close(r0["params"], j_params, 1e-2)
    _params_close(r0["params"], one["pp_async"]["params"], 1e-2)


def test_pp_smw_matches_one_rank(runs):
    """``--pp 2 --smw``: the columns through the stages' statistics pass;
    held to the port's one rank at ``train_accum`` 2 (the pipeline's
    microbatches) at the SMW tolerances, and through it to the
    reference (the one-rank ``--smw`` trajectory,
    ``tests/test_torch_smw.py``)."""
    got, one, _ = runs
    r0, want = got["pp_smw"][0], one["pp_smw"]
    flags = [h["smw_fallback"] for h in r0["hist"]]
    assert [h["smw_fallback"] for h in got["pp_smw"][1]["hist"]] == flags
    assert flags == [h["smw_fallback"] for h in want["hist"]]
    assert flags[0] == 1.0 and _losses(got["pp_smw"][1]) == _losses(r0)
    np.testing.assert_allclose(_losses(r0), _losses(want), rtol=1e-5)
    np.testing.assert_allclose([h["smw_drift"] for h in r0["hist"]],
                               [h["smw_drift"] for h in want["hist"]],
                               rtol=2e-3)
    _params_close(r0["params"], want["params"], 1e-2)


def test_smw_subsample_a_rank_holds_none_of(runs):
    """A subsample of one row: rank 1 holds none of it and adds zero
    Grams and columns; one ``--smw`` step's factors, inverses and drift
    bitwise one rank's on the same row (the reduction adds zeros, the
    gather moves columns, each G column scaled by the share 1), on both
    ranks. A drift reduced over the ranks is their max, NaN when one
    rank's is NaN."""
    got, _, _ = runs
    assert [r["rows"] for r in got["smw_no_rows"]] == [1, 0]
    for r in got["smw_no_rows"]:
        assert r["factors"] and r["inverses"] and r["drift"], r
    assert got["drift_max"] == [0.5, 0.5]
    assert all(np.isnan(d) for d in got["drift_nan"])


def test_dist_inverse_smw_probe_across_ranks(runs):
    """``benchmarks.dist_inverse --smw`` on the two ranks: each step's
    columns split over them and gathered, the update bitwise the one-rank
    update, the drift reduced, pdiv across the mesh bitwise local; the
    SMW step at least 3x below a full re-inversion (the reference's
    assert); the drifts held to the reference's probe at rtol 2e-3 (the
    SMW tolerance above) and its fallbacks equal."""
    got, _, ref = runs
    base, drift_max, fallbacks = ref["dist_inverse_smw"]
    for r in got["dist_inverse_smw"]:
        assert r["smw_bitwise_local"] and r["pdiv_bitwise"]
        assert r["smw_speedup"] >= 3 and r["ndev"] == 2
        assert r["drift_final"] <= r["drift_budget"]
        np.testing.assert_allclose(r["drift_base"], base, rtol=2e-3)
        np.testing.assert_allclose(r["drift_max"], drift_max, rtol=2e-3)
        assert r["n_fallbacks"] == fallbacks
        for key in ("drift_base", "drift_max", "drift_final"):
            assert r[key] == got["dist_inverse_smw"][0][key]
