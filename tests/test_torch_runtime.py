"""repro_torch.runtime: the step watchdog, the recovery table, and
``TrainLoop`` with a toy program and with the K-FAC program at smoke
size (fp32 and ``--smw``) — it completes and checkpoints, recovers from
an injected failure, replays the data exactly once, gives up after
``max_failures`` and re-raises what it must not hide; its K-FAC losses
are held to the reference's step functions on the same converted
weights at ``tests/test_torch_train.py``'s loss tolerance (rtol 1e-5).

No test here depends on the machine's load: the loops run without the
median-relative hang deadline (``hang_factor=None``), the straggler
tests drive the watchdog with a fake clock, and the deadline test's
step sleeps far past its own deadline.
"""

from __future__ import annotations

import dataclasses
import math
import time

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
from repro_torch import convert
from repro_torch.checkpoint import latest_step, restore
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.data import SyntheticTokens as TTokens
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.runtime import (DeviceLoss, LoopConfig, StepDeadlineExceeded,
                                 StepWatchdog, TrainLoop)
from repro_torch.runtime import watchdog as wd_mod
from repro_torch.runtime.loop import _recoverable

ARCH = "qwen1.5-0.5b"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several test processes at
    once, and torch's per-process pool of one thread a core oversubscribes
    the cores many times over (the smoke-size products gain nothing from
    it)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# watchdog
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _timed_step(wd, clock, dt):
    with wd.step():
        clock.t += dt


def test_watchdog_flags_straggler(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(wd_mod.time, "monotonic", clock)
    wd = StepWatchdog(straggler_factor=2.0, hang_factor=None,
                      warmup_steps=1, window=8)
    for _ in range(4):
        _timed_step(wd, clock, 0.01)
    _timed_step(wd, clock, 0.05)
    assert wd.last_was_straggler and wd.n_stragglers == 1
    assert wd.median() == pytest.approx(0.01)   # the straggler stays out
    _timed_step(wd, clock, 0.011)
    assert not wd.last_was_straggler and wd.n_steps == 6


def test_watchdog_reset_window_keeps_counters(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(wd_mod.time, "monotonic", clock)
    wd = StepWatchdog(straggler_factor=2.0, hang_factor=None,
                      warmup_steps=1, window=8)
    for dt in (0.01, 0.01, 0.01, 0.05):
        _timed_step(wd, clock, dt)
    assert wd.n_stragglers == 1
    wd.reset_window()
    assert wd.n_stragglers == 1 and wd.n_steps == 4
    assert wd.median() is None
    _timed_step(wd, clock, 0.05)        # slow, but the window is warming up
    assert wd.n_stragglers == 1


def test_watchdog_deadline_raises():
    wd = StepWatchdog(hang_factor=None, hard_deadline_s=0.02)
    with pytest.raises(StepDeadlineExceeded):
        with wd.step():
            time.sleep(0.5)


def test_watchdog_without_hang_factor_has_no_median_deadline(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(wd_mod.time, "monotonic", clock)
    wd = StepWatchdog(hang_factor=None, warmup_steps=1)
    _timed_step(wd, clock, 0.01)
    assert wd._deadline() is None
    _timed_step(wd, clock, 100.0)       # a straggler, never a hang
    assert wd.n_stragglers == 1
    assert StepWatchdog(hang_factor=10.0, warmup_steps=0)._deadline() is None


# ---------------------------------------------------------------------------
# recovery classification
# ---------------------------------------------------------------------------

def test_recoverable_classification_table():
    assert _recoverable(DeviceLoss(0, "drill"))
    assert _recoverable(StepDeadlineExceeded("hang"))
    assert _recoverable(torch.cuda.OutOfMemoryError("CUDA out of memory"))
    # programming errors re-raise, whatever their message says
    assert not _recoverable(ValueError("device mesh error: bad axis"))
    assert not _recoverable(TypeError("cannot add device error type"))
    assert not _recoverable(KeyError("layers/attn/wq"))
    # a kernel's launch or build error (kernels.build.CudaLibrary) and
    # any other CUDA runtime error must surface, not be retried
    assert not _recoverable(RuntimeError(
        "neumann_inv: launch failed: an illegal memory access was "
        "encountered"))
    assert not _recoverable(RuntimeError("nvcc failed for fused_precond"))
    assert not _recoverable(RuntimeError("RESOURCE_EXHAUSTED: out of memory"))


# ---------------------------------------------------------------------------
# the loop with a toy program
# ---------------------------------------------------------------------------

class ToyProgram:
    """Counts the data it consumed, to check exactly-once replay."""

    device = "cpu"

    def __init__(self):
        self.n_resets = 0

    def init_state(self):
        return {"w": torch.zeros(4), "seen": 0}

    def make_step(self, state):
        def step(state, batch):
            s = batch["tokens"][:, 0].sum().to(torch.float32)
            return ({"w": state["w"] + s, "seen": state["seen"] + 1},
                    {"loss": s, "phase_s": {"train": 0.0}})
        return step

    def reset_async(self):
        self.n_resets += 1


def _toy_loop(tmp_path, inject=None, total=12, prog=None, **kw):
    ds = TTokens(vocab=97, seq_len=8, global_batch=4, seed=3)
    cfg = dict(total_steps=total, ckpt_dir=str(tmp_path / "ck"),
               ckpt_every=4, log_every=1, max_failures=3, hang_factor=None)
    cfg.update(kw)
    loop = TrainLoop(LoopConfig(**cfg), prog or ToyProgram(), ds,
                     inject=inject)
    return loop, loop.run()


def _fail_once_at(at, exc=None):
    fired = []

    def inject(step):
        if step == at and not fired:
            fired.append(step)
            raise exc or DeviceLoss(0, "drill")

    return inject


def test_loop_completes_and_checkpoints(tmp_path):
    loop, summary = _toy_loop(tmp_path)
    assert summary["steps"] == 12 and summary["recoveries"] == 0
    assert [h["step"] for h in summary["history"]] == list(range(12))
    assert latest_step(str(tmp_path / "ck")) == 12
    state, manifest = restore(str(tmp_path / "ck"), ToyProgram().init_state())
    assert manifest["meta"]["cursor"] == {"step": 12}
    assert state["seen"] == 12 and isinstance(state["seen"], int)


@pytest.mark.parametrize("exc", [DeviceLoss(0, "drill"),
                                 StepDeadlineExceeded("hang"),
                                 torch.cuda.OutOfMemoryError("oom")])
def test_loop_recovers_and_replays_exactly_once(tmp_path, exc):
    """A failure at step 7 restores the step-4 checkpoint and replays
    steps 4-6: the final state equals a clean run's."""
    _, clean = _toy_loop(tmp_path / "a")
    prog = ToyProgram()
    _, failed = _toy_loop(tmp_path / "b", inject=_fail_once_at(7, exc),
                          prog=prog)
    assert failed["recoveries"] == 1 and failed["steps"] == 12
    assert prog.n_resets == 1
    # every executed step has its row: 0-6, then the replay from 4
    assert [h["step"] for h in failed["history"]] == \
        list(range(7)) + list(range(4, 12))
    by_step = {h["step"]: h["loss"] for h in clean["history"]}
    assert all(h["loss"] == by_step[h["step"]] for h in failed["history"])
    sa, _ = restore(str(tmp_path / "a" / "ck"), ToyProgram().init_state())
    sb, _ = restore(str(tmp_path / "b" / "ck"), ToyProgram().init_state())
    assert torch.equal(sa["w"], sb["w"])
    assert sb["seen"] == 12


def test_loop_without_checkpoints_restarts_from_init(tmp_path):
    _, s = _toy_loop(tmp_path, inject=_fail_once_at(3), total=6,
                     ckpt_dir=None)
    assert s["recoveries"] == 1
    assert [h["step"] for h in s["history"]] == [0, 1, 2, 0, 1, 2, 3, 4, 5]
    assert not (tmp_path / "ck").exists()


def test_loop_gives_up_after_max_failures(tmp_path):
    def inject(step):
        if step == 2:
            raise DeviceLoss(0, "permanent")

    ds = TTokens(vocab=97, seq_len=8, global_batch=4, seed=3)
    loop = TrainLoop(LoopConfig(total_steps=8, ckpt_dir=str(tmp_path / "ck"),
                                ckpt_every=1, max_failures=2,
                                hang_factor=None),
                     ToyProgram(), ds, inject=inject)
    with pytest.raises(DeviceLoss):
        loop.run()
    assert loop.n_recoveries == 3       # two recoveries, then the give-up


def test_loop_raises_on_programming_error(tmp_path):
    def inject(step):
        if step == 2:
            raise ValueError("device layout error: bad spec")

    ds = TTokens(vocab=97, seq_len=8, global_batch=4, seed=3)
    loop = TrainLoop(LoopConfig(total_steps=8, ckpt_dir=str(tmp_path / "ck"),
                                ckpt_every=4, hang_factor=None),
                     ToyProgram(), ds, inject=inject)
    with pytest.raises(ValueError):
        loop.run()
    assert loop.n_recoveries == 0


def test_loop_straggler_count_survives_recovery(tmp_path):
    ds = TTokens(vocab=97, seq_len=8, global_batch=4, seed=3)
    loop = TrainLoop(LoopConfig(total_steps=10, ckpt_dir=str(tmp_path / "ck"),
                                ckpt_every=4, hang_factor=None),
                     ToyProgram(), ds, inject=_fail_once_at(5))
    loop.watchdog.n_stragglers = 2      # observed before the failure
    summary = loop.run()
    assert summary["recoveries"] == 1 and summary["stragglers"] >= 2


def test_loop_deadline_recovers(tmp_path):
    """A step that sleeps far past the hard deadline is a hang: the loop
    restores and replays it."""
    slow = []

    class SlowOnce(ToyProgram):
        def make_step(self, state):
            inner = super().make_step(state)

            def step(state, batch):
                if not slow and state["seen"] == 2:
                    slow.append(1)
                    time.sleep(4.0)
                return inner(state, batch)
            return step

    _, s = _toy_loop(tmp_path, total=6, prog=SlowOnce(),
                     hard_deadline_s=1.0)
    assert s["recoveries"] == 1 and s["steps"] == 6


# ---------------------------------------------------------------------------
# the loop with the K-FAC program at smoke size
# ---------------------------------------------------------------------------

# 4 steps, test_torch_train.py's trajectory: a failure at step 3
# restores the step-2 checkpoint and replays steps 2 (a refresh step of
# the restored KFACState.step) and 3
B, T, STEPS = 2, 32, 4


def _configs():
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32")
    common = dict(stats_every=2, inv_every=2,
                  block_size=min(128, jcfg.soi_block), stats_batch=B,
                  stats_seq=T)
    return jcfg, tcfg, common


@pytest.fixture(scope="module")
def reference():
    """The reference's step functions over STEPS steps (the cadence of
    ``repro.launch.train``) on seed-0 weights: losses and weights."""
    jcfg, _, common = _configs()
    kcfg = JKFACConfig(**common)
    params = jax.device_get(jlm.init(jcfg, jax.random.PRNGKey(0)))
    state = jsteps.TrainState(params, jkfac.init(params, jlm.kfac_specs(jcfg),
                                                 kcfg))
    stats = jax.jit(jsteps.make_stats_step(jcfg, kcfg))
    train = jax.jit(jsteps.make_train_step(jcfg, kcfg))
    inv = jax.jit(jsteps.make_inv_step(jcfg, kcfg))
    ds = JTokens(jcfg.vocab, T, B, seed=0)
    losses = []
    for i in range(STEPS):
        batch = {"tokens": jnp.asarray(ds.batch_slice(i, 0, B))}
        if i % 2 == 0:
            state, _ = stats(state, batch)
            state = inv(state)
        state, m = train(state, batch)
        losses.append(float(m["loss"]))
    return params, losses


class _ConvertedKFAC(ttrain.KFACProgram):
    """The port's program on the reference's converted weights."""

    params = None

    def init_state(self):
        p = convert.params_from_jax(self.params, device="cpu")
        return tsteps.TrainState(p, tkfac.init(
            p, ttrain.steps_mod.kfac_specs(self.cfg), self.kcfg))


def _kfac_loop(tmp_path, params, inject=None, **kw):
    _, tcfg, common = _configs()
    prog = _ConvertedKFAC(tcfg, tkfac.KFACConfig(**common), device="cpu",
                          **kw)
    prog.params = params
    loop = TrainLoop(LoopConfig(total_steps=STEPS,
                                ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
                                hang_factor=None),
                     prog, TTokens(tcfg.vocab, T, B, seed=0), inject=inject)
    return loop.run()


def test_kfac_loop_recovers_and_matches_reference(tmp_path, reference):
    params, j_losses = reference
    clean = _kfac_loop(tmp_path / "a", params)
    failed = _kfac_loop(tmp_path / "b", params, inject=_fail_once_at(3))
    assert clean["recoveries"] == 0 and failed["recoveries"] == 1
    steps = [h["step"] for h in failed["history"]]
    assert steps == [0, 1, 2, 2, 3]
    # the replay from the step-2 checkpoint recomputes what the clean
    # run computed, bit for bit
    by_step = {h["step"]: h["loss"] for h in clean["history"]}
    assert [h["loss"] for h in failed["history"]] == [by_step[s]
                                                     for s in steps]
    np.testing.assert_allclose([by_step[s] for s in range(STEPS)], j_losses,
                               rtol=1e-5)
    # the cadence follows the restored KFACState.step
    phases = [sorted(h["phase_s"]) for h in failed["history"]]
    refresh = ["inv", "stats", "train", "wu"]
    assert phases == [refresh if s % 2 == 0 else ["train", "wu"]
                      for s in steps]
    st_a, _ = restore(str(tmp_path / "a" / "ck"), _kfac_state_like(params))
    st_b, _ = restore(str(tmp_path / "b" / "ck"), _kfac_state_like(params))
    assert st_b.kfac.step == STEPS and isinstance(st_b.kfac.step, int)
    for k in st_a.params:
        assert torch.equal(st_a.params[k], st_b.params[k]), k


def _kfac_state_like(params):
    _, tcfg, common = _configs()
    prog = _ConvertedKFAC(tcfg, tkfac.KFACConfig(**common), device="cpu")
    prog.params = params
    return prog.init_state()


def test_smw_loop_recovers_and_reseeds_the_gate(tmp_path, reference):
    """On ``--smw`` the gate is reset on recovery: the replayed step 2
    re-inverts, as a restored inverse tree is un-probed. The clean run's
    gate re-inverts at step 2 too (the smoke drifts are far over the
    budget), so the replay matches the clean run bit for bit."""
    params, _ = reference
    clean = _kfac_loop(tmp_path / "a", params, smw=True, smw_rank=16)
    failed = _kfac_loop(tmp_path / "b", params, smw=True, smw_rank=16,
                        inject=_fail_once_at(3))
    assert failed["recoveries"] == 1
    hist = failed["history"]
    assert [h["step"] for h in hist] == [0, 1, 2, 2, 3]
    assert [h["smw_fallback"] for h in clean["history"]] == \
        [1.0, 0.0, 1.0, 0.0]
    assert [h["smw_fallback"] for h in hist] == [1.0, 0.0, 1.0, 1.0, 0.0]
    by_step = {h["step"]: h["loss"] for h in clean["history"]}
    assert [h["loss"] for h in hist] == [by_step[h["step"]] for h in hist]
    assert all(math.isfinite(h["loss"]) for h in hist)
