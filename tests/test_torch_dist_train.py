"""Data-parallel K-FAC training on gloo CPU ranks: ``KFACProgram(mesh=)``
against the JAX reference and the port's one-rank run, and
``launch.train`` under ``torchrun`` (ranks kept bitwise equal, a restore
after ``--inject-failure-at`` on every rank alike).

Tolerances and why:
  * ranks: bitwise equal params after every run (a digest of their
    bytes): every rank applies the same all-reduced gradients and the
    same gathered inverses;
  * the fp32 trajectory (``tests/_torch_dist_ranks.train_rank``, 2
    ranks, each one of the batch's 2 rows, ``--dist-inv``) against the
    reference and against the one-rank port: ``tests/test_torch_train.py``'s
    tolerances (losses rtol 1e-5; the last refresh's inverses within
    1e-3 of the reference's inverse of the port's own factors; final
    parameters within 1% of the leaf's largest entry). Reducing per-rank
    gradients and Grams changes only the fp32 summation order;
  * the CLI's smoke config computes in bf16, where each rank's weight
    gradient is rounded to bf16 before the reduction (one bf16 rounding
    of a half-batch sum, against one of the whole batch's). Its yardstick
    is the one-rank run with ``train_accum`` 2, which rounds the same two
    halves: the first step's gradient norm (the same weights and rows) is
    bitwise that run's, which pins the reduction's scale (a 0.3% error
    in it moves the losses by less than the bf16 noise below); the first
    loss is held at rtol 1e-5 to the one-rank CLI's, the second at 3e-5
    to the accumulated run's (measured 8.2e-6; 1.1e-4 to the plain run's),
    and all at 3e-3 to both (measured 1.1e-3 at step 4: the two runs'
    factors differ in the Grams' fp32 summation order, and K-FAC's
    ``A^-1 g G^-1`` amplifies it over the steps);
  * the replay after a restore: the losses of the steps both runs took,
    bitwise the failure-free run's (the data is a pure function of the
    step, and every reduction is deterministic).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks_mod
from _torch_families import one_thread  # noqa: F401 (autouse)
from repro.configs import get_smoke_config
from repro.core import kfac as jkfac
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.data import SyntheticTokens as JTokens
from repro.launch import steps as jsteps
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.data import DataCursor, SyntheticTokens
from repro_torch.dist.spawn import run_ranks
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain

ARCH = "qwen1.5-0.5b"
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CLI = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
       "--seq", "16", "--stats-every", "1", "--inv-every", "2",
       "--dist-inv"]


def _torchrun(tmp_path, name, extra):
    out = tmp_path / f"{name}.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
         *extra, "--out", str(out)], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    return _torchrun(tmp_path_factory.mktemp("dp"), "plain",
                     ["--steps", "5"])


def test_torchrun_trains_with_ranks_bitwise_equal(cli_run):
    s = cli_run
    assert s["ranks"] == 2 and s["dist_inv"] and s["steps"] == 5
    assert len(s["params_digest"]) == 2
    assert s["params_digest"][0] == s["params_digest"][1]
    assert len(s["losses"]) == 5 and all(map(math.isfinite, s["losses"]))
    one = ttrain.main([a for a in CLI if a != "--dist-inv"]
                      + ["--steps", "5"])
    # the CLI's program on one rank, each step's rows in 2 microbatches
    cfg = t_get_smoke_config(ARCH)
    kcfg = tkfac.KFACConfig(lr=3e-2, damping=0.03, stats_every=1,
                            inv_every=2, block_size=min(128, cfg.soi_block),
                            stats_batch=4, stats_seq=16)
    _, acc = ttrain.run(ttrain.KFACProgram(
        dataclasses.replace(cfg, train_accum=2), kcfg, seed=0,
        device="cpu"), SyntheticTokens(cfg.vocab, 16, 4, seed=0), 5)
    acc_losses = [h["loss"] for h in acc]
    assert s["history"][0]["grad_norm"] == acc[0]["grad_norm"]
    np.testing.assert_allclose(s["losses"][0], one["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(s["losses"][1], acc_losses[1], rtol=3e-5)
    np.testing.assert_allclose(s["losses"], acc_losses, rtol=3e-3)
    np.testing.assert_allclose(s["losses"], one["losses"], rtol=3e-3)


def test_torchrun_recovers_every_rank_alike(cli_run, tmp_path):
    s = _torchrun(tmp_path, "drill", [
        "--steps", "5", "--ckpt-dir", str(tmp_path / "ck"),
        "--ckpt-every", "2", "--inject-failure-at", "3"])
    assert s["recoveries"] == 1 and s["steps"] == 5
    assert s["params_digest"][0] == s["params_digest"][1] == \
        cli_run["params_digest"][0]
    # steps 0-2, then 2-4 again from the checkpoint after step 1
    assert [h["step"] for h in s["history"]] == [0, 1, 2, 2, 3, 4]
    for h in s["history"]:
        assert h["loss"] == cli_run["losses"][h["step"]], h["step"]
    assert sorted(os.listdir(tmp_path / "ck"))


RECOVERY = dict(stats_every=2, inv_every=2, block_size=64, stats_batch=2,
                stats_seq=16)


def test_failure_on_one_rank_recovers_every_rank(tmp_path):
    """A DeviceLoss from the ``inject`` hook of rank 1 alone: the ranks
    agree on it, both restore rank 0's checkpoint and replay, and the run
    ends bitwise the failure-free one's."""
    res = run_ranks(ranks_mod.recovery_rank, 2, args=(
        ARCH, str(tmp_path / "ck"), RECOVERY, 5, 1, 3, False))
    for r in res:
        plain, drill = r["plain"], r["drill"]
        assert plain["recoveries"] == 0 and drill["recoveries"] == 1
        assert drill["steps"] == 5
        assert [s for s, _ in drill["history"]] == [0, 1, 2, 2, 3, 4]
        losses = dict(plain["history"])
        for s, loss in drill["history"]:
            assert loss == losses[s], s
        assert drill["digest"] == plain["digest"] == res[0]["plain"]["digest"]


def test_failure_inside_one_ranks_step_is_not_recovered(tmp_path):
    """A DeviceLoss raised inside rank 1's step, where its peer waits in
    the step's reductions, re-raises as a RuntimeError naming it."""
    with pytest.raises(RuntimeError,
                       match="not recoverable across ranks"):
        run_ranks(ranks_mod.recovery_rank, 2, args=(
            ARCH, None, RECOVERY, 3, 1, 1, True), timeout=120)


def test_torchrun_refuses_what_is_not_ported():
    # --pp and --model-parallel are ported: one rank cannot fill their
    # groups; the SGD baseline never pipelines (the reference's message),
    # on the CLI and on a mesh with a stage axis
    with pytest.raises(ValueError, match="--pp 2"):
        ttrain.main(CLI + ["--pp", "2"])
    with pytest.raises(SystemExit, match="KFACProgram feature"):
        ttrain.main(CLI + ["--pp", "2", "--optimizer", "sgd"])
    with pytest.raises(ValueError, match="--model-parallel 2"):
        ttrain.main(CLI + ["--model-parallel", "2"])
    cfg = t_get_smoke_config(ARCH)
    with pytest.raises(SystemExit, match="KFACProgram feature"):
        ttrain.SGDProgram(cfg, device="cpu",
                          mesh={"stage": 2, "data": 1, "model": 1})


def _reference_run(cfg, kcfg, params, ds, n_steps):
    specs = jlm.kfac_specs(cfg)
    state = jsteps.TrainState(params, jkfac.init(params, specs, kcfg))
    stats = jax.jit(jsteps.make_stats_step(cfg, kcfg))
    train = jax.jit(jsteps.make_train_step(cfg, kcfg))
    refresh = jax.jit(jsteps.make_inv_refresh(cfg, kcfg))
    losses = []
    for i in range(n_steps):
        batch = {"tokens": jnp.asarray(ds.batch_slice(i, 0,
                                                      ds.global_batch))}
        if i % kcfg.stats_every == 0:
            state, _ = stats(state, batch)
        if i % kcfg.inv_every == 0:
            state = state._replace(kfac=state.kfac._replace(
                inverses=refresh(state.kfac.factors)))
        state, m = train(state, batch)
        losses.append(float(m["loss"]))
    return losses, state, refresh


def test_program_trajectory_matches_reference_and_one_rank():
    """4 steps, stats and refresh every 2, batch 2 x 32 split 1/1 over 2
    ranks with ``dist_inv``, fp32 compute, on the reference's weights."""
    b, t, n_steps = 2, 32, 4
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    common = dict(stats_every=2, inv_every=2,
                  block_size=min(128, jcfg.soi_block), stats_batch=b,
                  stats_seq=t)
    params = jax.device_get(jlm.init(jcfg, jax.random.PRNGKey(0)))
    tparams = {k: v.numpy() for k, v in
               convert.params_from_jax(params, device="cpu").items()}
    res = run_ranks(ranks_mod.train_rank, 2,
                    args=(ARCH, tparams, n_steps, common, True))
    j_losses, j_state, j_refresh = _reference_run(
        jcfg, JKFACConfig(**common), params, JTokens(jcfg.vocab, t, b,
                                                     seed=0), n_steps)
    r0 = res[0]
    assert res[1]["digest"] == r0["digest"]
    assert res[1]["losses"] == r0["losses"]
    assert r0["phases"] == [["inv", "stats", "train", "wu"],
                            ["train", "wu"]] * 2
    np.testing.assert_allclose(r0["losses"], j_losses, rtol=1e-5)
    j_of_t = jax.device_get(j_refresh({
        n: {s: jnp.asarray(f) for s, f in d.items()}
        for n, d in r0["factors"].items()}))
    for n, d in jax.device_get(j_state.kfac.inverses).items():
        for side, v in d.items():
            got = r0["inverses"][n][side]
            scale = np.max(np.abs(v))
            own = np.max(np.abs(got - j_of_t[n][side]))
            assert own <= 1e-3 * scale, (n, side, own)
            err = np.max(np.abs(got - v))
            moved = np.max(np.abs(j_of_t[n][side] - v))
            assert err <= max(1e-2 * scale, 1.05 * moved), (n, side, err)
    for k, v in convert._flatten(jax.device_get(j_state.params)).items():
        err = np.max(np.abs(r0["params"][k] - v))
        assert err <= 1e-2 * np.max(np.abs(v)), (k, err)
    # the port's one-rank run of the same program and weights
    cfg = dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32")
    program = ttrain.KFACProgram(cfg, tkfac.KFACConfig(**common),
                                 device="cpu")
    tp = {k: torch.from_numpy(v) for k, v in tparams.items()}
    state = tsteps.TrainState(tp, tkfac.init(tp, tsteps.kfac_specs(cfg),
                                             program.kcfg))
    step_fn = program.make_step(state)
    ds = SyntheticTokens(cfg.vocab, t, b, seed=0)
    cursor, losses = DataCursor(), []
    for _ in range(n_steps):
        state, m = step_fn(state, ds.batch(cursor, device="cpu"))
        cursor = cursor.advance()
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(r0["losses"], losses, rtol=1e-5)
    for k, v in state.params.items():
        err = np.max(np.abs(r0["params"][k] - v.numpy()))
        assert err <= 1e-2 * float(v.abs().max()), (k, err)
