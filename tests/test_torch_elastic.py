"""Elastic re-meshing on a device loss (``runtime.elastic``): the
largest-mesh rule against the JAX reference, the loss drill on gloo CPU
ranks through ``runtime.TrainLoop``, and ``launch.train`` under
``torchrun`` on a world that is not a multiple of its group.

Ranks are spawned once per world size (``tests/_torch_dist_ranks.
elastic_rank``): world 2 drills ``(2, 1)`` losing 1 rank, world 4 drills
``(2, 2)`` losing 2 and ``(2, 2, 1)`` losing 1. In each drill rank
``fail_rank`` raises ``DeviceLoss(lost)`` from the ``inject`` hook at
step 3 of 4; every rank agrees on it and on ``lost``, the survivors
re-form the largest mesh over the first ranks, restore the checkpoint of
step 2 and replay steps 2-3, and the ranks left out return their
summary.

Tolerances and why:
  * the drill against a failure-free run at the new shape restored from
    the drill's own checkpoint: losses and gathered params bitwise (the
    same operations on the same bits; the data is a pure function of the
    step);
  * against the port's one rank (the whole run, 4 steps; for the
    pipeline at ``train_accum`` 2, its microbatches):
    ``tests/test_torch_dist_train.py``'s, losses rtol 1e-5 and final
    parameters within 1% of each leaf's largest entry (reductions over
    ranks change only the fp32 summation order).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks_mod
from _torch_families import one_thread  # noqa: F401 (autouse)
from repro.runtime import DeviceLoss as JDeviceLoss
from repro.runtime import largest_mesh as j_largest_mesh
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.data import SyntheticTokens
from repro_torch.dist.spawn import start_ranks
from repro_torch.launch import train as ttrain
from repro_torch.runtime import DeviceLoss, largest_mesh

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))


# ---------------------------------------------------------------------------
# the largest mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,model,pp", [
    (256, 16, 1), (255, 16, 1), (512, 16, 1), (8, 4, 1), (7, 4, 1),
    (3, 4, 1),                      # the reference's impossible case
    (4, 1, 2), (3, 1, 2), (8, 2, 2), (7, 2, 2), (12, 1, 3), (3, 2, 2),
])
def test_largest_mesh_matches_reference(n, model, pp):
    try:
        want = j_largest_mesh(n, model, pp=pp)
    except JDeviceLoss:
        with pytest.raises(DeviceLoss, match="cannot keep"):
            largest_mesh(n, model, pp=pp)
        return
    assert largest_mesh(n, model, pp=pp) == want


# ---------------------------------------------------------------------------
# the drill
# ---------------------------------------------------------------------------

#: (key, mesh shape, lost, failing rank) by world size
DRILLS = {2: [("dp", (2, 1), 1, 1)],
          4: [("tp", (2, 2), 2, 3), ("pp", (2, 2, 1), 1, 0)]}
NEW_SHAPE = {"dp": {"data": 1, "model": 1},
             "tp": {"data": 1, "model": 2},
             "pp": {"stage": 2, "data": 1, "model": 1}}
OLD_SHAPE = {"dp": {"data": 2, "model": 1},
             "tp": {"data": 2, "model": 2},
             "pp": {"stage": 2, "data": 2, "model": 1}}


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    handles = {w: start_ranks(ranks_mod.elastic_rank, w,
                              args=(DRILLS[w], str(root / f"w{w}")))
               for w in DRILLS}
    # the port's one rank meanwhile: the same program, weights and data,
    # and for the pipeline its microbatches (train_accum 2)
    one = {}
    for accum in (1, 2):
        cfg = dataclasses.replace(t_get_smoke_config("qwen1.5-0.5b"),
                                  dtype="float32", train_accum=accum)
        kcfg = tkfac.KFACConfig(**ranks_mod.ELASTIC_KCFG)
        state, hist = ttrain.run(
            ttrain.KFACProgram(cfg, kcfg, device="cpu"),
            SyntheticTokens(cfg.vocab, kcfg.stats_seq, kcfg.stats_batch,
                            seed=0), ranks_mod.ELASTIC_STEPS)
        one[accum] = {"losses": [h["loss"] for h in hist],
                      "params": {k: v.numpy()
                                 for k, v in state.params.items()}}
    res = {}
    for w, h in handles.items():
        for rank, r in enumerate(h.results()):
            for key, v in r.items():
                res.setdefault(key, [None] * w)[rank] = v
    return res, one


@pytest.mark.parametrize("key", ["dp", "tp", "pp"])
def test_drill_remeshes_restores_and_replays(drills, key):
    res, ones = drills
    one = ones[2 if key == "pp" else 1]
    world = len(res[key])
    lost = next(n for k, _, n, _ in DRILLS[world] if k == key)
    survivors = int(np.prod(list(NEW_SHAPE[key].values())))
    for rank, r in enumerate(res[key]):
        s = r["summary"]
        assert s["recoveries"] == 1
        assert s["mesh"] == NEW_SHAPE[key], (rank, s)
        if rank >= survivors:
            # left out: the summary says so, at the failed step
            assert s["excluded"] and s["excluded_at_step"] == 3, s
            assert [st for st, _ in r["history"]] == [0, 1, 2]
            assert "ref_digest" not in r
            continue
        assert not s.get("excluded") and s["steps"] == 4
        assert s["excluded_ranks"] == lost
        # steps 0-2, then 2-3 again from the checkpoint after step 1
        assert [st for st, _ in r["history"]] == [0, 1, 2, 2, 3]
        # the replay bitwise a failure-free run at the new shape from the
        # same checkpoint
        assert r["history"][3:] == r["ref_history"], rank
        assert r["digest"] == r["ref_digest"] == res[key][0]["digest"]
        for st, loss in r["history"]:
            np.testing.assert_allclose(loss, one["losses"][st], rtol=1e-5)
    for k, v in one["params"].items():
        err = np.max(np.abs(res[key][0]["params"][k] - v))
        assert err <= 1e-2 * np.max(np.abs(v)), (key, k, err)
    if key == "pp":
        # rank 1 moved from stage 0 to stage 1 of the (2, 1, 1) mesh
        assert [r.get("stage") for r in res[key]][:survivors] == [0, 1]
    # the remesh events (the first mesh and the re-formed one), the
    # counter and the recovery, on rank 0
    r0 = res[key][0]
    remesh = [e for e in r0["events"] if e["kind"] == "remesh"]
    assert [e["shape"] for e in remesh] == [OLD_SHAPE[key], NEW_SHAPE[key]]
    assert [e["excluded"] for e in remesh] == [0, lost]
    assert [e["n_devices"] for e in remesh] == [world, survivors]
    assert [row["value"] for row in r0["remesh_total"]] == [2]
    rec = [e for e in r0["events"] if e["kind"] == "recovery"]
    assert [(e["step"], e["lost"]) for e in rec] == [(3, lost)]


# ---------------------------------------------------------------------------
# torchrun on a world that is not a multiple of the group
# ---------------------------------------------------------------------------

CLI = ["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu", "--batch",
       "4", "--seq", "16", "--stats-every", "1", "--inv-every", "2",
       "--dist-inv", "--ckpt-every", "2"]


def _torchrun(n, extra):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), "-m", "repro_torch.launch.train", *CLI,
         *extra], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_torchrun_drill_then_three_ranks_on_the_largest_mesh(tmp_path):
    """``--inject-failure-at 3 --inject-lost 1`` on 2 ranks: rank 1 prints
    that it was excluded at step 3 and exits 0; rank 0 re-forms ``(1,
    1)``, restores the checkpoint of step 2 and ends the run. Then 3
    ranks at ``--model-parallel 1`` resume that checkpoint (written on
    ``(2, 1)``) on the largest mesh of their world, ``(2, 1)``: the third
    rank prints why and exits 0, and the replayed step 2 is bitwise the
    2-rank run's first step 2."""
    drill = tmp_path / "drill.json"
    out = _torchrun(2, ["--steps", "4", "--ckpt-dir", str(tmp_path / "ck"),
                        "--inject-failure-at", "3", "--inject-lost", "1",
                        "--out", str(drill)])
    assert "rank 1: excluded at step 3 by the re-formed mesh " \
        "{'data': 1, 'model': 1}" in out
    with open(drill) as f:
        s2 = json.load(f)
    assert s2["recoveries"] == 1 and s2["steps"] == 4 and s2["ranks"] == 1
    assert s2["mesh"] == {"data": 1, "model": 1}
    assert s2["excluded_ranks"] == 1
    assert [h["step"] for h in s2["history"]] == [0, 1, 2, 2, 3]
    shutil.copytree(tmp_path / "ck" / "step_0000000002",
                    tmp_path / "ck3" / "step_0000000002")
    three = tmp_path / "three.json"
    out = _torchrun(3, ["--steps", "4", "--ckpt-dir", str(tmp_path / "ck3"),
                        "--out", str(three)])
    assert "rank 2 of 3: outside the largest mesh {'data': 2, 'model': 1}" \
        in out
    with open(three) as f:
        s3 = json.load(f)
    assert s3["ranks"] == 2 and s3["mesh"] == {"data": 2, "model": 1}
    assert [h["step"] for h in s3["history"]] == [2, 3]
    assert s3["losses"][0] == s2["losses"][2]
    assert len(set(s3["params_digest"])) == 1


def test_world_below_one_group_is_a_usage_error():
    with pytest.raises(ValueError, match="--model-parallel 2 needs at "
                                         "least 2 ranks"):
        ttrain.main(CLI + ["--model-parallel", "2"])
    assert torch.distributed.is_available()
