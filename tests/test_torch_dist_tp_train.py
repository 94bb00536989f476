"""Tensor-parallel K-FAC training (``--model-parallel``) on gloo CPU
ranks: ``KFACProgram`` on ``(data, model)`` meshes through
``runtime.TrainLoop`` against the JAX reference and the port's one rank,
its checkpoint restored on one rank, ``launch.train --model-parallel 2``
under ``torchrun`` with a recovery, and the compressed reduction over
``data`` of a ``(data, model)`` mesh.

Ranks are spawned once per world size (``tests/_torch_dist_ranks.
tp_train_rank``): world 2 at ``(1, 2)``, world 4 at ``(2, 2)``, each 4
steps of dense smoke (qwen1.5-0.5b: attention and MLP sliced at block 32)
at fp32 compute with ``--dist-inv``, stats and refresh every 2 steps,
batch 2 x 32 on the port's seed-0 weights.

Tolerances and why:
  * against the reference: ``tests/test_torch_train.py``'s (losses rtol
    1e-5; the last refresh's inverses within 1e-3 of the reference's
    inverse of the port's own factors; final parameters within 1% of
    the leaf's largest entry). Slicing changes only fp32 summation
    orders (the row-parallel outputs, the input cotangents, the
    trust-region dot);
  * against the port's one rank: losses rtol 1e-5; the trust-region
    ``nu`` of one update on the same state and seeded gradients rtol
    1e-6 (one fp32 dot, its sliced leaves' parts summed over the ranks:
    a few ulps. Along the trajectory ``nu`` is ``1 / |dot|`` of a dot
    that cancels, and moves 1e-4 where the losses move 1e-6);
  * replicated leaves, gathered params, the compressed reduction and a
    restored checkpoint: bitwise (every rank applies the same reduced
    values; a gather and a checkpoint only move bits);
  * the CLI (bf16 compute): the ranks' gathered params bitwise equal,
    the replayed steps' losses bitwise the first pass's. Against the
    one-rank CLI: step 0 rtol 1e-5 (the same weights: the row-parallel
    outputs' fp32 summation order before their one bf16 rounding), step
    1 rtol 3e-4 (measured 1.0e-4: each rank's input cotangents and
    weight gradients round to bf16 over its slice), every step 1e-2
    (measured 4.2e-3 at step 4: K-FAC's preconditioning amplifies that
    rounding over the steps, as ``chip_smoke.py``'s ``tp`` phase shows
    at full width, where it gates only steps 0-1).
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
from repro_torch.checkpoint import restore
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.data import SyntheticTokens
from repro_torch.dist.spawn import run_ranks
from repro_torch.launch import train as ttrain

ARCH = "qwen1.5-0.5b"
N_STEPS = 4
COMMON = dict(stats_every=2, inv_every=2, block_size=ranks_mod.TP_BLOCK,
              stats_batch=2, stats_seq=32)
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
CLI = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
       "--seq", "16", "--stats-every", "1", "--inv-every", "2",
       "--dist-inv", "--steps", "5"]


def _cfgs():
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{(data, model): (rank results, checkpoint dir)}``."""
    out = {}
    for shape in ((1, 2), (2, 2)):
        ck = str(tmp_path_factory.mktemp(f"tp{shape[0]}x{shape[1]}"))
        out[shape] = (run_ranks(ranks_mod.tp_train_rank, math.prod(shape),
                                args=(shape, ARCH, N_STEPS, COMMON, ck),
                                timeout=300), ck)
    return out


@pytest.fixture(scope="module")
def one_rank():
    """The port's one-rank run of the same program: final state and
    per-step records."""
    _, tcfg = _cfgs()
    return ttrain.run(ttrain.KFACProgram(tcfg, tkfac.KFACConfig(**COMMON),
                                         device="cpu"),
                      SyntheticTokens(tcfg.vocab, COMMON["stats_seq"],
                                      COMMON["stats_batch"], seed=0),
                      N_STEPS)


@pytest.fixture(scope="module")
def reference(one_rank):
    """The reference's program on the port's seed-0 weights."""
    jcfg, _ = _cfgs()
    kcfg = JKFACConfig(**COMMON)
    params = convert.params_to_jax(ttrain.KFACProgram(
        _cfgs()[1], tkfac.KFACConfig(**COMMON),
        device="cpu").init_state().params)
    params = jax.tree_util.tree_map(jnp.asarray, params)
    state = jsteps.TrainState(params, jkfac.init(
        params, jlm.kfac_specs(jcfg), kcfg))
    stats = jax.jit(jsteps.make_stats_step(jcfg, kcfg))
    train = jax.jit(jsteps.make_train_step(jcfg, kcfg))
    refresh = jax.jit(jsteps.make_inv_refresh(jcfg, kcfg))
    ds = JTokens(jcfg.vocab, COMMON["stats_seq"], COMMON["stats_batch"],
                 seed=0)
    losses = []
    for i in range(N_STEPS):
        batch = {"tokens": jnp.asarray(ds.batch_slice(i, 0,
                                                      ds.global_batch))}
        if i % kcfg.stats_every == 0:
            state, _ = stats(state, batch)
        if i % kcfg.inv_every == 0:
            state = state._replace(kfac=state.kfac._replace(
                inverses=refresh(state.kfac.factors)))
        state, m = train(state, batch)
        losses.append(float(m["loss"]))
    return losses, jax.device_get(state), refresh


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_trajectory_matches_reference_and_one_rank(runs, one_rank,
                                                   reference, shape):
    res, _ = runs[shape]
    r0 = res[0]
    for r in res:
        assert r["digest"] == r0["digest"]
        assert r["losses"] == r0["losses"] and r["nu"] == r0["nu"]
    # the replicated leaves bitwise equal on every rank at every step
    assert len(r0["replicated_digests"]) == N_STEPS
    assert all(r["replicated_digests"] == r0["replicated_digests"]
               for r in res)
    # each sliced leaf lives as its slice: half of the full width
    full = r0["state"]["params"]
    assert r0["local_shapes"]["layers/mlp/wd"] == (
        full["layers/mlp/wd"].shape[0], full["layers/mlp/wd"].shape[1] // 2,
        full["layers/mlp/wd"].shape[2])
    assert r0["local_shapes"]["embed"] == full["embed"].shape
    assert all(r["refresh_bitwise"] for r in res)
    _, hist = one_rank
    np.testing.assert_allclose(r0["losses"], [h["loss"] for h in hist],
                               rtol=1e-5)
    for r in res:
        one, tp = r["nu_same_inputs"]
        assert tp < 1.0                  # the clip is active
        np.testing.assert_allclose(tp, one, rtol=1e-6)
    j_losses, j_state, j_refresh = reference
    np.testing.assert_allclose(r0["losses"], j_losses, rtol=1e-5)
    got = r0["state"]
    j_of_t = jax.device_get(j_refresh({
        n: {s: jnp.asarray(f) for s, f in d.items()}
        for n, d in got["factors"].items()}))
    for n, d in j_state.kfac.inverses.items():
        for side, v in d.items():
            scale = np.max(np.abs(v))
            own = np.max(np.abs(got["inverses"][n][side] - j_of_t[n][side]))
            assert own <= 1e-3 * scale, (n, side, own)
    for k, v in convert._flatten(j_state.params).items():
        err = np.max(np.abs(got["params"][k] - v))
        assert err <= 1e-2 * np.max(np.abs(v)), (k, err)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_checkpoint_restores_bitwise_on_one_rank(runs, shape):
    """The loop's last checkpoint, written by rank 0 from the gathered
    state, restores into a one-rank program's state: every tensor
    bitwise the full state the ranks gathered."""
    res, ck = runs[shape]
    _, tcfg = _cfgs()
    like = ttrain.KFACProgram(tcfg, tkfac.KFACConfig(**COMMON),
                              device="cpu").init_state()
    state, manifest = restore(ck, like)
    assert manifest["step"] == N_STEPS
    got = res[0]["state"]
    for k, v in state.params.items():
        assert np.array_equal(v.numpy(), got["params"][k]), k
    for tree, name in ((state.kfac.factors, "factors"),
                       (state.kfac.inverses, "inverses")):
        for n, d in tree.items():
            for s, v in d.items():
                assert np.array_equal(v.numpy(), got[name][n][s]), (n, s)
    assert res[0]["digest"] == ttrain.params_digest(state.params)


def test_compressed_reduction_over_data_of_a_model_mesh(runs):
    res, _ = runs[(2, 2)]
    for r in res:
        assert r["compressed"] == {"data_axis": True, "pod_data_axes": True}


def test_fused_wu_runs_over_the_data_submesh(runs):
    """``refresh_and_precondition`` handed ``mesh["data"]`` of a (2, 2)
    mesh, on each rank's own slices: both modes bitwise the local call
    (the WU of a sliced leaf needs no model collective)."""
    res, _ = runs[(2, 2)]
    for r in res:
        assert r["fused_wu_data_submesh"] == {"owner": True, "gather": True}


def _torchrun(tmp_path, extra):
    out = tmp_path / "tp.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
         *extra, "--out", str(out)], env=env, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def test_cli_model_parallel_recovers_every_rank(tmp_path):
    """``launch.train --model-parallel 2`` under torchrun with a device
    loss at step 3: one recovery from the checkpoint after step 1 on both
    ranks, the replayed steps' losses bitwise the first pass's, the
    gathered params equal on both ranks, and the losses near the one-rank
    CLI's."""
    s = _torchrun(tmp_path, ["--model-parallel", "2", "--ckpt-dir",
                             str(tmp_path / "ck"), "--ckpt-every", "2",
                             "--inject-failure-at", "3"])
    assert s["ranks"] == 2 and s["model_parallel"] == 2
    assert s["recoveries"] == 1 and s["steps"] == 5
    assert s["params_digest"][0] == s["params_digest"][1]
    assert [h["step"] for h in s["history"]] == [0, 1, 2, 2, 3, 4]
    first = {}
    for h in s["history"]:
        assert first.setdefault(h["step"], h["loss"]) == h["loss"], h
    assert all(map(math.isfinite, s["losses"]))
    one = ttrain.main([a for a in CLI if a != "--dist-inv"])["losses"]
    got = [first[i] for i in range(5)]
    np.testing.assert_allclose(got[0], one[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], one[1], rtol=3e-4)
    np.testing.assert_allclose(got, one, rtol=1e-2)


def test_refusals_name_the_roadmap_item(monkeypatch):
    """--pp and a model axis without ranks to fill them, and --pp with
    a model axis that does not divide the stage's ranks; moe under
    --model-parallel is taken (expert parallelism): it meets the same
    mesh check as the dense family, and the slicing rule puts its experts
    on their expert dim (``tests/test_torch_dist_ep.py`` trains it)."""
    from repro_torch.dist import sharding

    cfg = t_get_smoke_config("moonshot-v1-16b-a3b")
    assert sharding.model_spec_dim(cfg, "layers/moe/wg", 4, 2, 32) == 1
    assert sharding.model_spec_dim(cfg, "layers/moe/router", 3, 2, 32) \
        is None
    with pytest.raises(ValueError, match="--pp 2"):
        ttrain.main(CLI + ["--pp", "2"])
    with monkeypatch.context() as m:      # each divides 2 ranks, not both
        m.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="--pp 2 x --model-parallel 2"):
            ttrain.main(CLI + ["--pp", "2", "--model-parallel", "2"])
    for cli in (CLI, ["--arch", "moonshot-v1-16b-a3b"] + CLI[2:]):
        with pytest.raises(ValueError, match="--model-parallel 2"):
            ttrain.main(cli + ["--model-parallel", "2"])
