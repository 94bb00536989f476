"""repro_torch's asynchronous double-buffered inverse refresh
(``--async-inv``, ``solve.AsyncInverseRefresher``) on the CPU, where it
runs inline with the same lag as on the card's side stream.

* The refresher's host semantics: the reference's three tests
  (``tests/test_dist_solve.py``), on the port's dataclass state.
* A 6-step trajectory of ``qwen1.5-0.5b`` at smoke size, held to the
  reference's ``AsyncInverseRefresher`` around its jitted refresh, at
  ``tests/test_torch_train.py``'s tolerances: losses rtol 1e-5; the last
  inverses within 1e-3 of the reference's inverse of the port's own
  factors and within 1% (or the reference's own move, +5%) of the
  reference run's; parameters 1% of the leaf's largest entry. Each
  step's inverses are bitwise a synchronous refresh of the factors of
  the trigger before the last (step N - 2 here), identities before the
  first swap.
* The program's rules: ``--smw`` with ``--async-inv`` raises, and
  ``--dist-inv`` on one device trains bitwise as the default refresh.
* ``TrainLoop`` with ``--async-inv``: a checkpoint holds the pending
  inverses, recovery resets the refresher, and the history has one row
  per executed step.
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
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.data import SyntheticTokens as JTokens
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.solve import AsyncInverseRefresher as JAsync
from repro_torch import convert
from repro_torch.checkpoint import restore
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.data import DataCursor, SyntheticTokens as TTokens
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.runtime import DeviceLoss, LoopConfig, TrainLoop
from repro_torch.solve import AsyncInverseRefresher

ARCH = "qwen1.5-0.5b"
B, T, STEPS = 2, 32, 6


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and the smoke-size products gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kstate(factors, inverses=None):
    return tkfac.KFACState(step=0, factors=factors, inverses=inverses,
                           momentum={}, adam_mu={}, adam_nu={})


def _with(st, **kw):
    return dataclasses.replace(st, **kw)


# ---------------------------------------------------------------------------
# host semantics (the reference's tests/test_dist_solve.py:258-340)
# ---------------------------------------------------------------------------

def test_async_refresher_staleness_semantics():
    """Trigger k swaps in the refresh dispatched at trigger k-1."""
    calls = []

    def refresh(factors):
        calls.append(factors)
        return {"from": factors}

    r = AsyncInverseRefresher(refresh)
    st = _kstate(0, {"from": None})
    st = r.step(_with(st, factors=10))
    assert st.inverses == {"from": None}          # nothing pending yet
    st = r.step(_with(st, factors=20))
    assert st.inverses == {"from": 10}            # previous trigger's
    st = r.step(_with(st, factors=30))
    assert st.inverses == {"from": 20}
    assert calls == [10, 20, 30]
    assert r.n_dispatched == 3 and r.n_swapped == 2


def test_async_refresher_donated_variant_and_flush_reset():
    donated = []

    def refresh(f):
        return ("inv", f)

    def refresh_into(f, retired):
        donated.append(retired)
        return ("inv", f)

    r = AsyncInverseRefresher(refresh, refresh_into=refresh_into)
    st = _kstate(1, "init")
    st = r.step(st)                    # first dispatch: nothing retired
    assert donated == [] and r.has_pending
    st = r.step(_with(st, factors=2))
    assert donated == ["init"]         # retired buffers fed back in
    st = r.flush(st)
    assert st.inverses == ("inv", 2) and not r.has_pending
    st = r.step(_with(st, factors=3))
    r.reset()
    assert not r.has_pending
    st2 = r.flush(st)                  # flush after reset: no-op
    assert st2.inverses == st.inverses


def test_async_refresher_donated_only_never_goes_cold():
    """refresh_into + spare, no fallback: the buffers-given form runs
    from the first dispatch, flush() re-seeds the spare, and a starved
    refresher is an error rather than a fallback."""
    calls = []

    def refresh_into(f, buf):
        calls.append(buf)
        return ("inv", f)

    r = AsyncInverseRefresher(refresh_into=refresh_into,
                              spare_buffers="spare0")
    st = _kstate(1, "init")
    st = r.step(st)                        # first dispatch: uses spare
    st = r.flush(st)                       # fold pending, re-seed spare
    assert st.inverses == ("inv", 1)
    st = r.step(_with(st, factors=2))      # uses the re-seeded spare
    assert calls == ["spare0", "init"]
    st = r.step(_with(st, factors=3))
    r.reset()
    assert not r.has_pending
    r.step(_with(st, factors=4))
    assert calls[-1] == ("inv", 3)

    with pytest.raises(ValueError, match="refresh_fn"):
        AsyncInverseRefresher()
    starved = AsyncInverseRefresher(refresh_into=refresh_into)
    with pytest.raises(RuntimeError, match="spare"):
        starved.step(st)


def test_async_refresher_on_cpu_tensors_has_no_stream_and_counts():
    from repro_torch import obs as obs_mod
    from repro_torch.obs.export import prometheus_text

    obs = obs_mod.Observability(enabled=True)
    f = {"w": {"A": torch.eye(4)[None] * 2}}
    cfg = tkfac.KFACConfig(ns_iters=8, taylor_terms=2, refine_steps=1)
    r = AsyncInverseRefresher(
        refresh_into=lambda fac, buf: tkfac.invert_factors(fac, cfg,
                                                           out=buf),
        spare_buffers={"w": {"A_inv": torch.zeros(1, 4, 4)}}, obs=obs)
    st = r.step(_kstate(f, {"w": {"A_inv": torch.eye(4)[None]}}))
    st = r.step(st)
    assert r.stream is None          # inline on the CPU
    assert torch.equal(st.inverses["w"]["A_inv"],
                       tkfac.invert_factors(f, cfg)["w"]["A_inv"])
    text = prometheus_text(obs.registry)
    assert "solve_inv_dispatch_total 2" in text
    assert "solve_inv_swap_total 1" in text
    names = [e["name"] for e in obs.tracer.to_chrome()["traceEvents"]]
    assert names.count("inv_refresh_dispatch") == 2


# ---------------------------------------------------------------------------
# the 6-step trajectory against the reference's refresher
# ---------------------------------------------------------------------------

def _configs():
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32")
    common = dict(stats_every=2, inv_every=2,
                  block_size=min(128, jcfg.soi_block), stats_batch=B,
                  stats_seq=T)
    return jcfg, tcfg, common


def _reference_async_run(cfg, kcfg, params, ds, n_steps):
    """The reference's --async-inv cadence (``repro.launch.train``)
    without a mesh: its refresher around the jitted refresh, seeded with
    zero spare buffers."""
    specs = jlm.kfac_specs(cfg)
    state = jsteps.TrainState(params, jkfac.init(params, specs, kcfg))
    stats = jax.jit(jsteps.make_stats_step(cfg, kcfg))
    train = jax.jit(jsteps.make_train_step(cfg, kcfg))
    refresh = jax.jit(jsteps.make_inv_refresh(cfg, kcfg))
    refresher = JAsync(
        refresh_into=jax.jit(lambda f, retired: refresh(f)),
        spare_buffers=jax.tree.map(jnp.zeros_like, state.kfac.inverses))
    losses = []
    for i in range(n_steps):
        batch = {"tokens": jnp.asarray(ds.batch_slice(i, 0,
                                                      ds.global_batch))}
        if i % kcfg.stats_every == 0:
            state, _ = stats(state, batch)
        if i % kcfg.inv_every == 0:
            state = state._replace(kfac=refresher.step(state.kfac))
        state, m = train(state, batch)
        losses.append(float(m["loss"]))
    assert (refresher.n_dispatched, refresher.n_swapped) == (3, 2)
    return losses, state, refresh


def _clone(tree):
    return {n: {k: v.clone() for k, v in d.items()} for n, d in tree.items()}


def test_six_step_async_trajectory_matches_reference():
    jcfg, tcfg, common = _configs()
    params = jax.device_get(jlm.init(jcfg, jax.random.PRNGKey(0)))
    j_losses, j_state, j_refresh = _reference_async_run(
        jcfg, JKFACConfig(**common), params, JTokens(jcfg.vocab, T, B,
                                                     seed=0), STEPS)

    kcfg = tkfac.KFACConfig(**common)
    program = ttrain.KFACProgram(tcfg, kcfg, device="cpu", async_inv=True)
    tparams = convert.params_from_jax(params, device="cpu")
    state = tsteps.TrainState(tparams, tkfac.init(
        tparams, ttrain.steps_mod.kfac_specs(tcfg), kcfg))
    init_inv = _clone(state.kfac.inverses)
    step_fn = program.make_step(state)
    ds = TTokens(tcfg.vocab, T, B, seed=0)
    cursor, t_losses, factors, inverses, phases = DataCursor(), [], [], [], []
    for _ in range(STEPS):
        state, m = step_fn(state, ds.batch(cursor, device="cpu"))
        cursor = cursor.advance()
        t_losses.append(float(m["loss"]))
        factors.append(_clone(state.kfac.factors))
        inverses.append(_clone(state.kfac.inverses))
        phases.append(sorted(m["phase_s"]))
    assert phases == [["inv", "stats", "train", "wu"], ["train", "wu"]] * 3
    r = program.refresher
    assert (r.n_dispatched, r.n_swapped) == (3, 2) and r.has_pending
    assert r.stream is None

    # staleness, bitwise: steps 0-1 precondition with the identities,
    # step N >= 2 with a synchronous refresh of the factors of step
    # N - N % 2 - 2 (the trigger before the last)
    for n, inv in enumerate(inverses):
        want = init_inv if n < 2 else tkfac.invert_factors(
            factors[n - n % 2 - 2], kcfg)
        for name, d in want.items():
            for k, v in d.items():
                assert torch.equal(inv[name][k], v), (n, name, k)

    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    j_of_t = jax.device_get(j_refresh({
        n: {s: jnp.asarray(f.numpy()) for s, f in d.items()}
        for n, d in factors[2].items()}))
    for n, d in jax.device_get(j_state.kfac.inverses).items():
        for side, v in d.items():
            got = state.kfac.inverses[n][side].numpy()
            scale = np.max(np.abs(v))
            own = np.max(np.abs(got - j_of_t[n][side]))
            assert own <= 1e-3 * scale, (n, side, own)
            err = np.max(np.abs(got - v))
            moved = np.max(np.abs(j_of_t[n][side] - v))
            assert err <= max(1e-2 * scale, 1.05 * moved), (n, side, err)
    for k, v in convert._flatten(jax.device_get(j_state.params)).items():
        err = np.max(np.abs(state.params[k].numpy() - v))
        assert err <= 1e-2 * np.max(np.abs(v)), (k, err)


# ---------------------------------------------------------------------------
# the program's rules and TrainLoop
# ---------------------------------------------------------------------------

def test_smw_with_async_inv_raises():
    _, tcfg, common = _configs()
    with pytest.raises(ValueError, match="async-inv"):
        ttrain.KFACProgram(tcfg, tkfac.KFACConfig(**common), device="cpu",
                           smw=True, async_inv=True)
    with pytest.raises(ValueError, match="async-inv"):
        ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--steps", "1", "--smw", "--async-inv"])


def test_cli_dist_inv_is_the_default_refresh_on_one_device():
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--batch", "2", "--seq", "16", "--stats-every", "1",
            "--inv-every", "2"]
    base = ttrain.main(args)
    dist = ttrain.main(args + ["--dist-inv"])
    assert dist["dist_inv"] and not base["dist_inv"]
    assert dist["losses"] == base["losses"]
    assert "n_dispatched" not in dist


def test_train_loop_async_checkpoint_holds_pending_and_recovery_resets(
        tmp_path, monkeypatch):
    """6 steps, a checkpoint every 3 and a device loss at step 4: the
    step-3 checkpoint (the state after step 2) holds the refresh
    dispatched at step 2, still in flight then, not the live inverses;
    recovery resets the refresher and replays step 3."""
    resets = []
    orig_reset = AsyncInverseRefresher.reset
    monkeypatch.setattr(AsyncInverseRefresher, "reset",
                        lambda self: resets.append(self.has_pending)
                        or orig_reset(self))
    _, tcfg, common = _configs()
    kcfg = tkfac.KFACConfig(**common)
    program = ttrain.KFACProgram(tcfg, kcfg, device="cpu", async_inv=True)
    live = {}
    orig_flush = program.flush_async

    def flush(state):
        live[state.kfac.step] = _clone(state.kfac.inverses)
        return orig_flush(state)

    program.flush_async = flush
    fired = []

    def inject(step):
        if step == 4 and not fired:
            fired.append(step)
            raise DeviceLoss(0, "drill")

    out = TrainLoop(LoopConfig(total_steps=STEPS,
                               ckpt_dir=str(tmp_path / "ck"), ckpt_every=3,
                               hang_factor=None),
                    program, TTokens(tcfg.vocab, T, B, seed=0),
                    inject=inject).run()
    assert out["recoveries"] == 1 and resets == [True]
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3, 3, 4, 5]
    assert all(math.isfinite(h["loss"]) for h in out["history"])
    like = program.init_state()
    saved, manifest = restore(str(tmp_path / "ck"), like, step=3)
    assert manifest["step"] == 3 and saved.kfac.step == 3
    pending = tkfac.invert_factors(saved.kfac.factors, kcfg)
    for name, d in pending.items():
        for k, v in d.items():
            assert torch.equal(saved.kfac.inverses[name][k], v), (name, k)
            # the live state at that checkpoint still used step 0's
            assert not torch.equal(live[3][name][k], v), (name, k)
