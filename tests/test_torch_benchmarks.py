"""``repro_torch.benchmarks`` against the reference's ``benchmarks/``.

Tolerances and why:
  * the pimsim-backed tables and headlines (``soi_sizes``, ``area``,
    ``dse``, ``speedup``, ``energy``, ``mapping_impact``) and the NumPy
    studies (``soi_precision``, ``inv_convergence`` at full size): equal
    (``==``), the same arithmetic on the same carrier;
  * ``kernel_bench.traffic_model``: equal, its resident column renamed
    from the TPU's ``vmem_resident_mb`` to ``smem_resident_mb``;
  * ``kernel_bench.accuracy_ladder`` (the plain version here, the
    reference's Pallas kernel in interpret mode): each stage's inverse
    within 5e-5 of the largest entry, as ``tests/test_torch_kernels.py``
    holds ``neumann_inv`` to the Pallas kernel (measured 9.3e-6); the
    ``rel_err`` column within the same 5e-5 (its inverses' distance
    bounds it; measured 7e-6), the rounded ``bits`` column equal;
  * ``kfac_convergence.quadratic_probe``: step counts equal;
  * ``kfac_convergence.lm_probe(steps=10)`` on the reference's initial
    weights: the first loss (same weights, same batch) rtol 1e-5, the
    dense trajectory tests' tolerance (measured 3.3e-6). Past it the
    bf16 smoke model drifts beyond 1e-5 in both frameworks, so each
    arm's losses are held to the reference's own spread: over 8
    perturbations of its initial weights by 2^-22 relative (signs from
    seeds 0-7) the reference's 10-step losses moved by up to 2.28e-2
    relative in the K-FAC arm and 2.78e-4 in the SGD arm (measured);
    the port lies within 1.98e-2 and 2.62e-4 of the unperturbed
    reference (measured), and steps to the target are equal.
"""

from __future__ import annotations

import csv
import hashlib
import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
if ROOT not in sys.path:            # benchmarks/ has no __init__.py
    sys.path.insert(0, ROOT)

from _torch_families import one_thread  # noqa: E402,F401 (autouse)
import benchmarks.area as j_area  # noqa: E402
import benchmarks.dse as j_dse  # noqa: E402
import benchmarks.energy as j_energy  # noqa: E402
import benchmarks.inv_convergence as j_inv_convergence  # noqa: E402
import benchmarks.kernel_bench as j_kernel_bench  # noqa: E402
import benchmarks.kfac_convergence as j_kfac_convergence  # noqa: E402
import benchmarks.mapping_impact as j_mapping_impact  # noqa: E402
import benchmarks.soi_precision as j_soi_precision  # noqa: E402
import benchmarks.soi_sizes as j_soi_sizes  # noqa: E402
import benchmarks.speedup as j_speedup  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.benchmarks import (area, dse, energy,  # noqa: E402
                                    inv_convergence, kernel_bench,
                                    kfac_convergence, mapping_impact, run,
                                    soi_precision, soi_sizes, speedup)

# module, function: the pimsim-backed tables and headlines
PIMSIM = [(soi_sizes, j_soi_sizes, "rows"), (area, j_area, "rows"),
          (area, j_area, "headline"), (dse, j_dse, "rows"),
          (dse, j_dse, "headline"), (speedup, j_speedup, "rows"),
          (speedup, j_speedup, "headline"), (energy, j_energy, "rows"),
          (energy, j_energy, "headline"),
          (mapping_impact, j_mapping_impact, "rows_blocksize"),
          (mapping_impact, j_mapping_impact, "rows_writes"),
          (mapping_impact, j_mapping_impact, "headline")]
# the reference runner's 19 module rows
MODULES = ["table1_soi_sizes", "table2_area", "fig3_soi_precision",
           "fig4b_inv_convergence", "fig10_dse", "fig11_speedup",
           "fig12_energy", "fig13_mapping", "kernel_bench", "wu_fusion",
           "serve_engine", "obs_overhead", "serve_scale",
           "precision_ladder", "dist_inverse", "pipeline_bench",
           "grad_compression_dcn", "sec6c_kfac_convergence", "roofline"]


@pytest.mark.parametrize("t_mod,j_mod,fn", PIMSIM,
                         ids=[f"{j.__name__.split('.')[-1]}.{fn}"
                              for _, j, fn in PIMSIM])
def test_pimsim_tables_equal_reference(t_mod, j_mod, fn):
    assert getattr(t_mod, fn)() == getattr(j_mod, fn)()


@pytest.mark.parametrize("t_mod,j_mod", [
    (soi_precision, j_soi_precision), (inv_convergence, j_inv_convergence)],
    ids=["soi_precision", "inv_convergence"])
def test_numpy_studies_equal_reference(t_mod, j_mod):
    rows = t_mod.rows()
    want = j_mod.rows()
    assert rows == want
    assert t_mod.headline(rows) == j_mod.headline(want)


def test_chip_smoke_pimsim_headlines_are_the_references():
    """``chip_smoke.py`` holds the card machine's pimsim headlines to
    these values."""
    import chip_smoke

    heads = [j_area.headline(), j_dse.headline(), *j_speedup.headline(),
             *j_energy.headline(), j_mapping_impact.headline()]
    assert chip_smoke.PIMSIM_HEADLINES == {h["name"]: h["value"]
                                           for h in heads}


def test_traffic_model_equals_reference_with_smem_column():
    want = [{("smem_resident_mb" if k == "vmem_resident_mb" else k): v
             for k, v in r.items()} for r in j_kernel_bench.traffic_model()]
    assert kernel_bench.traffic_model() == want


def test_accuracy_ladder_cpu_matches_reference_pallas():
    from repro.kernels import neumann_inv as j_neumann_inv

    invs = {}
    rows = kernel_bench.accuracy_ladder(device="cpu", out=invs)
    want = j_kernel_bench.accuracy_ladder()
    a, damp, exact = kernel_bench.ladder_problem()
    assert [r["stage"] for r in rows] == [r["stage"] for r in want] == [
        tag for tag, _ in kernel_bench.STAGES]
    for row, ref_row, (tag, kw) in zip(rows, want, kernel_bench.STAGES):
        pallas = np.asarray(j_neumann_inv(jnp.asarray(a), jnp.asarray(damp),
                                          **kw))
        got = invs[tag].numpy()
        assert np.max(np.abs(got - pallas)) <= 5e-5 * np.max(np.abs(pallas))
        assert abs(row["rel_err"] - ref_row["rel_err"]) <= 5e-5
        assert row["bits"] == ref_row["bits"]
        assert row["rel_err"] == pytest.approx(
            np.max(np.abs(got - exact)) / np.max(np.abs(exact)))
    # the ladder climbs: each stage recovers bits
    assert rows[0]["bits"] < rows[1]["bits"] < rows[2]["bits"]


def test_quadratic_probe_matches_reference():
    got = kfac_convergence.quadratic_probe(device="cpu")
    assert got == j_kfac_convergence.quadratic_probe()
    assert got["kfac_steps"] == 1 and got["sgd_steps"] > 10


def test_lm_probe_losses_match_reference(monkeypatch):
    """Both arms of the 10-step probe on the reference's initial weights,
    the reference's losses read from its own ``lm_probe`` (its jitted
    train and sgd steps' metrics, in call order)."""
    steps = 10
    seen = []
    real_jit = jax.jit

    def recording_jit(fn, *a, **kw):
        jitted = real_jit(fn, *a, **kw)
        if getattr(fn, "__name__", "") not in ("train_step", "sgd_step"):
            return jitted

        def call(*args):
            out = jitted(*args)
            seen.append(float(out[1]["loss"]))
            return out

        return call

    monkeypatch.setattr(jax, "jit", recording_jit)
    want = j_kfac_convergence.lm_probe(steps=steps)
    monkeypatch.setattr(jax, "jit", real_jit)
    j_kfac, j_sgd = seen[:steps], seen[steps:]
    assert len(j_sgd) == steps

    cfg = get_smoke_config("qwen2-0.5b")
    params = jax.device_get(jsteps.model_module(cfg).init(
        cfg, jax.random.PRNGKey(0)))
    got = kfac_convergence.lm_probe(
        steps=steps, device="cpu",
        params=convert.params_from_jax(params, device="cpu"))
    for arm, ref, rtol in (("kfac", j_kfac, 2.28e-2),
                           ("sgd", j_sgd, 2.78e-4)):
        losses = got[f"{arm}_losses"]
        np.testing.assert_allclose(losses[0], ref[0], rtol=1e-5)
        np.testing.assert_allclose(losses, ref, rtol=rtol, err_msg=arm)
    for key in ("probe", "target", "sgd_steps", "kfac_steps", "speedup_x"):
        assert got[key] == want[key], key


def _scorecard(text):
    block = text.split("# --- reproduction_scorecard ---\n", 1)[1]
    block = block.split("# ---", 1)[0]
    return list(csv.DictReader(io.StringIO(block)))


def _root_bench_hashes():
    out = {}
    for name in sorted(os.listdir(ROOT)):
        if name.startswith("BENCH_") and name.endswith(".json"):
            with open(os.path.join(ROOT, name), "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def test_run_cpu_fast_scorecard_and_out_dir(tmp_path, monkeypatch, capsys):
    """The runner's 19 status rows, every ported module ``ok``, and its
    files, only under --out-dir. obs_overhead's ``--fast`` paired rounds
    are raised to 200 train steps and 26 chunks (the most its trace
    allows): its 2% guard is a median of paired differences, and with
    20 rounds the suite's other processes move that median past the
    budget (296 µs against 269 µs, once in a whole run)."""
    from repro_torch.benchmarks import obs_overhead

    monkeypatch.setattr(obs_overhead, "FAST_REPS", (200, 26))
    before = _root_bench_hashes()
    assert before                      # the reference's artifacts
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    out_dir = tmp_path / "out"
    failures = run.main(["--device", "cpu", "--fast", "--out-dir",
                         str(out_dir)])
    assert failures == 0
    rows = _scorecard(capsys.readouterr().out)
    # status rows; headline rows carry the paper's value
    status = [r for r in rows if r["metric"] and not r["paper"]]
    assert [r["metric"] for r in status] == MODULES
    for r in status:
        if r["metric"] in run.UNPORTED:
            assert r["status"] == "skipped"
            assert f"item {run.UNPORTED[r['metric']]}" in r["note"]
        else:
            assert r["status"] == "ok", r
    assert {r["name"] for r in rows if not r["metric"]} >= {
        "table2_chip_area_mm2", "fig11_speedup_vs_gpu2_mean",
        "lowp_update_min_bits_int8", "int8_serve_decided_greedy_match"}
    assert {r["metric"] for r in rows if r["paper"] and r["metric"]} == {
        "serve_sessions_paged_vs_slot", "serve_prefill_cut_prefix"}
    assert sorted(os.listdir(cwd)) == []
    assert sorted(os.listdir(out_dir)) == [
        "BENCH_dist_inverse.json", "BENCH_grad_compression.json",
        "BENCH_kernel_bench.json", "BENCH_kfac_convergence.json",
        "BENCH_obs.json", "BENCH_precision.json",
        "BENCH_serve_engine.json", "BENCH_serve_scale.json",
        "BENCH_summary.json", "BENCH_wu_fusion.json"]
    assert _root_bench_hashes() == before


def test_run_defaults_to_cuda_and_raises_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out_dir = tmp_path / "out"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run.main(["--fast", "--out-dir", str(out_dir)])
    assert not out_dir.exists()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kfac_convergence.lm_probe(steps=1)
