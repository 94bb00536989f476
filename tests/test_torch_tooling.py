"""``repro_torch.benchmarks``' single-device tooling (``precision_ladder``,
``wu_fusion``, ``serve_engine``, ``serve_scale``, ``obs_overhead``)
against the reference's ``benchmarks/`` on the CPU, at smoke size.

Tolerances and why:
  * ``precision_ladder.block_rows``: equal (``==``), the same NumPy
    arithmetic;
  * ``update_rows``/``trajectory_rows``/``serve_rows`` (fast) run on the
    port's own seeded weights, not the reference's, so their bit counts
    are held to the contracts the existing tests hold them to, not to
    the reference's values: the hilo and int8 updates >= 16 bits
    (``tests/test_torch_lowp.py``), a trajectory's first step at equal
    losses and >= 16 bits for int8, the int8 serving contract of
    ``tests/test_torch_paged.py`` (every margin-decided request matches,
    at least two decided); the rungs, steps and columns equal the
    reference's, and so do the resident-byte reductions (shapes and
    dtypes only);
  * ``wu_fusion``: ``n_tiles``, ``stacked_groups``, ``moment_bytes`` and
    ``moment_bytes_legacy_3x`` equal to what the reference's ``_wu_case``
    computes for each arch; ``fused`` and ``fused+ew_pool`` bitwise
    ``per_leaf`` and strictly fewer ``gemms`` fused (the module's own
    asserts); ``fused+kernel``'s momentum within ``KERNEL_TOL`` (1e-4)
    of ``per_leaf``'s relative to each leaf's largest entry, the bound
    ``tests/test_torch_kernels.py`` puts on ``fused_precond``;
  * ``serve_scale`` (fast): ``peak_sessions``, ``prefill_tokens``,
    ``prefix_hits`` and ``kv_bytes`` equal to the reference's (counts;
    both pools hold bf16 k/v and int32 positions and tables);
  * ``serve_engine``: the trace's tokens equal the reference's engine on
    converted weights, token for token, in fp32 (as
    ``tests/test_torch_serve.py`` holds the engines);
  * ``obs_overhead``: the rows' schema and the obs variant's JSONL rows.
    Wall times and the 2% budget are not asserted on the CPU: the suite
    runs several test processes at once, and load moves them (the
    reference's own loop tests flake that way).
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys

import jax
import numpy as np
import pytest

from _torch_families import one_thread  # noqa: F401 (autouse)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:            # benchmarks/ has no __init__.py
    sys.path.insert(0, ROOT)

import benchmarks.precision_ladder as j_precision_ladder  # noqa: E402
import benchmarks.serve_scale as j_serve_scale  # noqa: E402
import benchmarks.wu_fusion as j_wu_fusion  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.core import kfac as jkfac  # noqa: E402
from repro.core.kfac import KFACConfig as JKFACConfig  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.benchmarks import (obs_overhead, precision_ladder,  # noqa
                                    serve_engine, serve_scale, wu_fusion)
from repro_torch.configs import get_smoke_config as t_get_smoke_config  # noqa
from repro_torch.serve import ServeEngine  # noqa: E402


# ---------------------------------------------------------------------------
# precision_ladder
# ---------------------------------------------------------------------------

def test_block_rows_equal_reference():
    assert precision_ladder.block_rows() == j_precision_ladder.block_rows()
    assert precision_ladder.LADDER == j_precision_ladder.LADDER


def test_update_and_trajectory_rows_fast():
    upd = precision_ladder.update_rows(fast=True, device="cpu")
    assert [r["precision"] for r in upd] == ["int8b4", "hilo", "int8"]
    bits = {r["precision"]: r["min_bits"] for r in upd}
    assert bits["hilo"] >= 16.0 and bits["int8"] >= 16.0, upd
    # the ladder: 4-bit slices of 8-bit codes sit far below the budget
    assert bits["int8b4"] < bits["int8"]
    assert all(r["mean_bits"] >= r["min_bits"] for r in upd)

    traj = precision_ladder.trajectory_rows(fast=True, device="cpu")
    assert [(r["precision"], r["step"]) for r in traj] == [
        (p, s) for p in ("int8b4", "int8") for s in (1, 2, 3)]
    for r in traj:
        assert math.isfinite(r["loss_fp32"]) and math.isfinite(
            r["loss_lowp"])
    first = {r["precision"]: r for r in traj if r["step"] == 1}
    # the first step starts from the same warm state
    assert all(r["loss_lowp"] == r["loss_fp32"] for r in first.values())
    assert first["int8"]["bits"] >= 16.0


def test_serve_rows_fast_and_headline():
    (got,) = precision_ladder.serve_rows(fast=True, device="cpu")
    (want,) = j_precision_ladder.serve_rows(fast=True)
    assert sorted(got) == sorted(want)
    for k in ("arch", "total", "margin_floor", "param_reduction",
              "pool_reduction"):
        assert got[k] == want[k], k
    assert got["decided_total"] >= 2, got
    assert got["decided_matched"] == got["decided_total"], got
    data = {"update": [{"precision": "int8", "min_bits": 17.0},
                       {"precision": "hilo", "min_bits": 19.0}],
            "serve": [got]}
    assert [r["name"] for r in precision_ladder.headline(data)] == \
        [r["name"] for r in j_precision_ladder.headline(data)]


# ---------------------------------------------------------------------------
# wu_fusion
# ---------------------------------------------------------------------------

def _reference_wu_numbers(arch):
    """What the reference's ``_wu_case`` computes for its plan and
    moments (its own calls, without the timed variants)."""
    cfg = get_smoke_config(arch)
    kcfg = JKFACConfig(block_size=j_wu_fusion.BLOCK_SIZE, ns_iters=6,
                       taylor_terms=2, refine_steps=1)
    specs = jsteps.kfac_specs(cfg)
    params = jsteps.model_module(cfg).init(cfg, jax.random.PRNGKey(0))
    state = jkfac.init(params, specs, kcfg)
    plan = jsteps.make_wu_plan_for(cfg, kcfg)
    p_bytes = sum(np.asarray(x).nbytes for x in jax.tree.leaves(params))
    moment_bytes = sum(
        np.asarray(x).nbytes
        for t in (state.momentum, state.adam_mu, state.adam_nu)
        for x in jax.tree.leaves(t))
    return {"n_tiles": plan.total_tiles,
            "stacked_groups": plan.summary()["stacked"],
            "moment_bytes": moment_bytes,
            "moment_bytes_legacy_3x": 3 * p_bytes}


@pytest.mark.parametrize("arch", wu_fusion.ARCHS + wu_fusion.EXTRA_ARCHS)
def test_wu_case_matches_reference(arch):
    assert wu_fusion.ARCHS == j_wu_fusion.ARCHS
    assert wu_fusion.EXTRA_ARCHS == j_wu_fusion.EXTRA_ARCHS
    c = wu_fusion._wu_case(arch, device="cpu", reps=3)
    want = _reference_wu_numbers(arch)
    for k, v in want.items():
        assert c[k] == v, k
    if arch == "qwen1.5-0.5b":
        assert (c["n_tiles"], c["moment_bytes"]) == (320, 464384)
    assert c["bitwise_equal"] == {"fused": True, "fused+ew_pool": True}
    v = c["variants"]
    assert list(v) == ["per_leaf", "fused", "fused+ew_pool", "fused+kernel"]
    assert v["fused"]["gemms"] < v["per_leaf"]["gemms"]
    assert all(x["kernels"] is None for x in v.values())   # the CPU
    assert all(x["aten_ops"] > 0 and x["wall_ms"] > 0 for x in v.values())
    assert c["kernel_max_rel_err"] <= wu_fusion.KERNEL_TOL
    assert set(c["paired"]) == {"paired_diff_med_us", "fused_win_frac"}


def test_wu_fusion_dist_raises_naming_item_8(tmp_path):
    """``--dist`` (once not ported, and raising) runs on 2 gloo CPU ranks:
    both dataflows bitwise the replicated refresh and the per-leaf
    product on every rank, as the reference's child asserts."""
    out = tmp_path / "dist.json"
    d = wu_fusion.main(["--dist", "--device", "cpu", "--ranks", "2",
                        "--out", str(out)])
    assert out.exists() and d["ndev"] == 2 and len(d["ranks"]) == 2
    for r in d["ranks"]:
        for mode in ("gather", "owner"):
            assert r[mode]["bitwise_equal"], (r["rank"], mode)
            assert r[mode]["wall_ms"] > 0
    assert d["total_tiles"] > 0


# ---------------------------------------------------------------------------
# serve_scale
# ---------------------------------------------------------------------------

def test_serve_scale_counts_equal_reference():
    got = serve_scale.rows(fast=True, device="cpu")
    want = j_serve_scale.rows(fast=True)
    assert [r["case"] for r in got] == [r["case"] for r in want]
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w), g["case"]
        for k in ("requests", "peak_sessions", "prefill_tokens",
                  "prefix_hits", "kv_bytes"):
            assert g.get(k) == w.get(k), (g["case"], k)
    by = {r["case"]: r for r in got}
    assert (by["slot"]["peak_sessions"], by["paged"]["peak_sessions"]) == \
        (2, 8)
    assert (by["paged_noprefix"]["prefill_tokens"],
            by["paged_prefix"]["prefill_tokens"],
            by["paged_prefix"]["prefix_hits"]) == (384, 144, 5)
    assert serve_scale.headline(got) == j_serve_scale.headline(want)


# ---------------------------------------------------------------------------
# serve_engine
# ---------------------------------------------------------------------------

def test_serve_engine_trace_tokens_equal_reference(monkeypatch):
    arch = serve_engine.ARCH
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config(arch), dtype="float32")
    params = jax.device_get(jsteps.model_module(jcfg).init(
        jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(serve_engine, "model_setup", lambda *a, **k: (
        tcfg, convert.params_from_jax(params, device="cpu")))
    runs = []
    real_run = ServeEngine.run

    def recording_run(self, *a, **kw):
        out = real_run(self, *a, **kw)
        runs.append(out)
        return out

    monkeypatch.setattr(ServeEngine, "run", recording_run)
    rows = serve_engine.engine_rows(device="cpu")
    assert [r["case"] for r in rows] == ["engine_trace", "engine_steady"]
    (got,) = runs
    reqs, arrivals = serve_engine._trace(tcfg, 3 * serve_engine.MAX_SLOTS)
    want = jengine.ServeEngine(jcfg, params, jengine.EngineConfig(
        max_slots=serve_engine.MAX_SLOTS, max_len=serve_engine.MAX_LEN,
        decode_chunk=serve_engine.DECODE_CHUNK)).run(
        [jengine.Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs],
        arrivals=arrivals)
    assert {k: v.tokens for k, v in got.items()} == \
        {k: v.tokens for k, v in want.items()}
    assert rows[0]["tokens"] == sum(len(v.tokens) for v in want.values())
    assert rows[1]["tokens"] == serve_engine.MAX_SLOTS * \
        serve_engine.DECODE_CHUNK * serve_engine.STEADY_CHUNKS


def test_serve_engine_rows_schema():
    r = serve_engine.rows(device="cpu")
    assert [x["case"] for x in r] == ["engine_trace", "engine_steady",
                                      "static_steady",
                                      "speedup_engine_vs_static"]
    assert all(x["decode_tok_per_s"] > 0 for x in r)
    assert serve_engine.speedup(r) == r[-1]["decode_tok_per_s"]


# ---------------------------------------------------------------------------
# obs_overhead
# ---------------------------------------------------------------------------

def test_obs_overhead_rows_and_jsonl(tmp_path):
    r = obs_overhead.rows(20, 8, device="cpu", out_dir=str(tmp_path))
    assert [x["case"] for x in r] == ["train_step", "decode_chunk"]
    for row in r:
        assert set(row) == {"case", "reps", "off_us_med", "obs_us_med",
                            "overhead_frac", "paired_diff_med_us",
                            "obs_loses_frac"}
        assert row["off_us_med"] > 0 and row["obs_us_med"] > 0
        assert obs_overhead.budget_us(row) >= obs_overhead.ABS_FLOOR_US
    with open(tmp_path / "train" / "events.jsonl") as f:
        rows = [json.loads(line) for line in f]
    # drains at steps 0 and 10 write steps 0..10; the tail is drained
    # unwritten, as in the reference
    assert [x["step"] for x in rows] == list(range(11))
    assert all(x["kind"] == "train_step" and math.isfinite(x["loss"])
               for x in rows)
    assert (tmp_path / "serve" / "events.jsonl").exists()
