"""The first-order baseline of repro_torch against the JAX reference:
``optim.SGD`` and ``optim.Adam`` on the same numpy trees, and
``launch.steps.make_sgd_step`` (the ``--optimizer sgd`` step) on the
same converted smoke weights and synthetic batches; then the CLI.

Tolerances and why:
  * the optimizers on given gradients: rtol 1e-6, atol 1e-7 (the same
    elementwise fp32 formulas; Adam's bias corrections are fp32 powers,
    whose last bit may differ between the two frameworks' ``pow``);
  * one SGD step: the loss at rtol 1e-5 (``tests/test_torch_train.py``'s
    loss tolerance) and parameters at atol 1e-6: the step moves them by
    ``lr * g`` with ``lr = 1e-2``, so a rounding-level gradient
    difference (~1e-5 relative) stays far below;
  * the 4-step trajectory: losses rtol 1e-5, parameters 1e-4 of the
    leaf's largest entry (momentum carries each step's rounding into
    the next).
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
from repro.data import SyntheticTokens as JTokens
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro.optim import Adam as JAdam, SGD as JSGD
from repro_torch import convert, optim
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.data import DataCursor, SyntheticTokens as TTokens
from repro_torch.kernels import ops
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

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


def _tree(seed):
    r = np.random.default_rng(seed)
    return {"w": r.standard_normal((16, 8)).astype(np.float32),
            "b": r.standard_normal(8).astype(np.float32),
            "e": (r.standard_normal((4, 4)) * 1e-6).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(got: dict, want: dict, rtol=1e-6, atol=1e-7):
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=rtol,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("kw", [{}, {"nesterov": True},
                                {"weight_decay": 0.1, "momentum": 0.5}])
def test_sgd_update_matches_reference(kw):
    j_opt, t_opt = JSGD(lr=0.05, **kw), optim.SGD(lr=0.05, **kw)
    p = _tree(0)
    jp, tp = dict(p), _t(p)
    jm, tm = j_opt.init(jp), t_opt.init(tp)
    for step in range(3):
        g = _tree(step + 1)
        jp, jm = j_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jm, jp)
        tp, tm = t_opt.update(_t(g), tm, tp)
        _close(tp, jp)
        _close(tm, jm)


@pytest.mark.parametrize("kw", [{}, {"weight_decay": 0.01, "b2": 0.99}])
def test_adam_update_matches_reference(kw):
    j_opt, t_opt = JAdam(lr=1e-2, **kw), optim.Adam(lr=1e-2, **kw)
    p = _tree(0)
    jp, tp = dict(p), _t(p)
    js, ts = j_opt.init(jp), t_opt.init(tp)
    for step in range(3):
        g = _tree(step + 1)
        jp, js = j_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                              js, jp)
        tp, ts = t_opt.update(_t(g), ts, tp)
        _close(tp, jp)
        _close(ts.mu, js.mu)
        _close(ts.nu, js.nu)
        assert ts.step == int(js.step) == step + 1


def _sgd_runs(n_steps, lr=1e-2):
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32")
    b, t = 2, 32
    params = jax.device_get(jlm.init(jcfg, jax.random.PRNGKey(0)))
    jstep = jax.jit(jsteps.make_sgd_step(jcfg, lr))
    jstate = (params, jax.tree.map(jnp.zeros_like, params))
    tstep = tsteps.make_sgd_step(tcfg, lr)
    tp = convert.params_from_jax(params, device="cpu")
    tstate = (tp, {k: torch.zeros_like(v) for k, v in tp.items()})
    jds, tds = JTokens(jcfg.vocab, t, b, seed=0), TTokens(tcfg.vocab, t, b,
                                                         seed=0)
    j_losses, t_losses = [], []
    for i in range(n_steps):
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(
            jds.batch_slice(i, 0, b))})
        tstate, tm = tstep(tstate, tds.batch(DataCursor(i), device="cpu"))
        j_losses.append(float(jm["loss"]))
        t_losses.append(float(tm["loss"]))
    return (j_losses, convert._flatten(jax.device_get(jstate[0])),
            convert._flatten(jax.device_get(jstate[1])), t_losses, tstate)


def test_sgd_step_matches_reference():
    j_losses, j_params, j_mom, t_losses, (tp, tm) = _sgd_runs(1)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    for k, v in j_params.items():
        np.testing.assert_allclose(tp[k].numpy(), v, rtol=0, atol=1e-6,
                                   err_msg=k)
        # the first momentum is the gradient itself
        err = np.max(np.abs(tm[k].numpy() - j_mom[k]))
        assert err <= 1e-4 * max(np.max(np.abs(j_mom[k])), 1e-30), k


def test_sgd_trajectory_matches_reference():
    j_losses, j_params, _, t_losses, (tp, _) = _sgd_runs(4)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    for k, v in j_params.items():
        err = np.max(np.abs(tp[k].numpy() - v))
        assert err <= 1e-4 * np.max(np.abs(v)), (k, err)


def test_sgd_program_starts_from_the_kfac_weights():
    cfg = t_get_smoke_config(ARCH)
    params, mom = ttrain.SGDProgram(cfg, seed=3, device="cpu").init_state()
    kfac_params = ttrain.KFACProgram(
        cfg, ttrain.KFACConfig(block_size=32), seed=3,
        device="cpu").init_state().params
    assert params.keys() == kfac_params.keys() == mom.keys()
    for k in params:
        assert torch.equal(params[k], kfac_params[k])
        assert not mom[k].any()


def test_cli_sgd_runs_no_kernel():
    ops.reset_launch_counts()
    s = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--optimizer", "sgd", "--steps", "3", "--batch", "2",
                     "--seq", "16"])
    assert s["optimizer"] == "sgd" and "wu_route" not in s
    assert len(s["losses"]) == 3 and s["steps"] == 3
    assert all(math.isfinite(x) for x in s["losses"])
    assert set(s["kernel_launches"].values()) == {0}
    assert all(sorted(h["phase_s"]) == ["train"] for h in s["history"])
