"""``repro_torch.examples`` against the reference's ``examples/`` on the
CPU: ``quickstart``, ``precision_inv_demo``, ``serve_batched`` and
``train_kfac_100m``, and that none of them runs when imported.

Tolerances and why:
  * the circuit model's numbers (the Fig. 5 toy, the production
    configuration's per-iteration and final bits, cycle counts, the
    quickstart's circuit bits) and the bare bf16 solve: equal to the
    reference's printed values (the same NumPy arithmetic; bf16 rounding
    to nearest even in both);
  * the quickstart's composed inverse: its bits within 1.0 of the
    reference's (``tests/test_torch_precision_inv.py``'s bound: both sum
    the exact bf16 partial products in another order), the SGD residual
    equal to its printed digits, the preconditioned residual within 2x of
    the reference's (it is the inverse's error, ~2^-14);
  * ``precision_inv_demo``'s inverse through the plain ``neumann_inv``:
    within 5e-5 of the largest entry of the reference's Pallas kernel's
    (interpret mode) on the same block, as ``tests/test_torch_kernels.py``
    holds ``neumann_inv`` to the Pallas kernel; both residuals under the
    example's 1e-3;
  * ``serve_batched``'s engine on the reference's converted weights, in
    fp32: the same tokens as the reference's ``ServeEngine`` on the same
    trace, token for token (the reference's serving CLI itself fails
    under this jax, ``ROADMAP.md`` reference caveats);
  * ``train_kfac_100m --smoke --steps 6 --inject-failure-at 3`` on the
    reference's converted weights in fp32: one recovery, the replayed
    steps bitwise the clean run's, the losses within rtol 1e-5 of the
    reference's step functions (``tests/test_torch_runtime.py``'s
    ``TrainLoop`` tolerance);
  * ``train_kfac_100m --smoke`` (24 steps) on the same weights: the
    example's own assert holds, the losses within rtol 2e-4 of the
    reference's step functions (another summation order, through three
    K-FAC refreshes: ~1e-4 at the last step).

Run as a script, the file prints the ``--smoke`` run's first and last
losses for seeds 0-5, the reference's ``TrainLoop`` on its weights
beside the port's on its own (the two frameworks draw different
weights from one seed)::

  PYTHONPATH=src python tests/test_torch_examples.py
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import re
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families import one_thread  # noqa: F401 (autouse)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
EXAMPLES = os.path.join(ROOT, "examples")

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import kfac as jkfac  # noqa: E402
from repro.core.kfac import KFACConfig as JKFACConfig  # noqa: E402
from repro.data import SyntheticTokens as JTokens  # noqa: E402
from repro.kernels import neumann_inv as j_neumann_inv  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.serve import engine as jengine  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_smoke_config as t_get_smoke_config  # noqa
from repro_torch.core import kfac as tkfac  # noqa: E402
from repro_torch.examples import (precision_inv_demo, quickstart,  # noqa
                                  serve_batched, train_kfac_100m)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.serve import synthetic_trace  # noqa: E402

NUM = r"([-+]?\d+\.?\d*(?:e[-+]?\d+)?)"


def _reference_output(name, capsys):
    """Run the reference's example script as it runs itself, and return
    what it printed."""
    capsys.readouterr()
    runpy.run_path(os.path.join(EXAMPLES, name), run_name="__main__")
    return capsys.readouterr().out


def _num(pattern, text):
    return float(re.search(pattern, text).group(1))


@pytest.mark.parametrize("name", ["quickstart", "precision_inv_demo",
                                  "serve_batched", "train_kfac_100m"])
def test_example_does_nothing_at_import(name, capsys):
    mod = importlib.reload(importlib.import_module(
        f"repro_torch.examples.{name}"))
    assert callable(mod.main)
    assert capsys.readouterr().out == ""


def test_quickstart_numbers_match_reference(capsys):
    want = _reference_output("quickstart.py", capsys)
    got = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "quickstart OK" in out
    for key, pat in (("bits_low", r"plain bf16 primitive alone:\s+" + NUM),
                     ("bits_circuit",
                      r"faithful circuit \(Loop A/x/b\):\s+" + NUM)):
        assert round(got[key], 1) == _num(pat, want), key
    assert abs(got["bits_device"]
               - _num(r"TPU composed-precision \(MXU\):\s+" + NUM, want)) \
        < 1.0
    assert round(got["resid_sgd"], 3) == _num(
        r"one-step residual, SGD-scaled:\s+" + NUM, want)
    ref_kfac = _num(r"one-step residual, preconditioned:\s+" + NUM, want)
    assert ref_kfac / 2 < got["resid_kfac"] < 2 * ref_kfac


def test_precision_inv_demo_matches_reference(capsys):
    want = _reference_output("precision_inv_demo.py", capsys)
    got = precision_inv_demo.main(["--device", "cpu"])
    assert "precision_inv_demo OK" in capsys.readouterr().out
    assert round(got["toy_bits"], 1) == _num(
        r"quantized-problem solve:\s+" + NUM, want)
    assert got["toy_cycles"] == _num(r"cycles \(Eqn. 10\): " + NUM, want)
    assert got["cycles"] == _num(r"Q=16.*\ncycles \(Eqn. 10\): " + NUM,
                                 want)
    assert got["cycles_fused"] == _num(r"fused \(Eqn. 14\): " + NUM, want)
    want_iters = [float(x) for x in re.findall(
        r"iter\s+\d+:\s+" + NUM + " bits", want)]
    assert [round(b, 1) for b in got["iter_bits"]] == want_iters
    assert round(got["final_bits"], 1) == _num(r"final:\s+" + NUM, want)
    # the same block through the reference's Pallas kernel (interpret)
    blocks = got["blocks"].numpy()
    pallas = np.asarray(j_neumann_inv(jnp.asarray(blocks),
                                      jnp.zeros((1,), jnp.float32),
                                      ns_iters=20, taylor_terms=4,
                                      refine_steps=2))
    inv = got["inverse"].numpy()
    assert np.max(np.abs(inv - pallas)) <= 5e-5 * np.max(np.abs(pallas))
    assert got["resid"] < 1e-3
    assert _num(r"kernel \|MA - I\|_inf = " + NUM, want) < 1e-3


def test_serve_batched_matches_reference_engine(monkeypatch, capsys):
    jcfg = dataclasses.replace(get_smoke_config("qwen2-0.5b"),
                               dtype="float32")
    tcfg = dataclasses.replace(t_get_smoke_config("qwen2-0.5b"),
                               dtype="float32")
    params = jax.device_get(jsteps.model_module(jcfg).init(
        jcfg, jax.random.PRNGKey(0)))
    monkeypatch.setattr(tserve, "get_smoke_config", lambda arch: tcfg)
    monkeypatch.setattr(tserve, "init_params", lambda cfg, seed, device:
                        convert.params_from_jax(params, device=device))
    out = serve_batched.main(["--device", "cpu"])
    assert "serve_batched OK" in capsys.readouterr().out
    summary, done = out["engine"]
    reqs, arrivals = synthetic_trace(tcfg.vocab, 6, 24, 8, 2, seed=0)
    want = jengine.ServeEngine(jcfg, params, jengine.EngineConfig(
        max_slots=2, max_len=summary["max_len"],
        decode_chunk=summary["decode_chunk"])).run(
        [jengine.Request(r.rid, r.prompt, r.max_new_tokens) for r in reqs],
        arrivals=arrivals)
    assert {k: v.tokens for k, v in done.items()} == \
        {k: v.tokens for k, v in want.items()}
    _, gen = out["static"]
    assert gen.shape == (4, 12)


def test_train_kfac_100m_configs_are_the_references():
    sys.path.insert(0, EXAMPLES)
    try:
        j_example = importlib.import_module("train_kfac_100m")
    finally:
        sys.path.remove(EXAMPLES)
    for make in ("config_100m", "config_smoke"):
        got = dataclasses.asdict(getattr(train_kfac_100m, make)())
        assert got == dataclasses.asdict(getattr(j_example, make)()), make
    cfg = train_kfac_100m.config_100m()
    assert train_kfac_100m.kfac_config(cfg, 8, 128).block_size == 256
    assert 90e6 < cfg.param_count() < 110e6


@pytest.fixture(scope="module")
def reference_smoke():
    """The example's ``--smoke`` run through the reference's step
    functions in fp32 on its weights from ``PRNGKey(0)``: the config,
    those weights and the 24 losses."""
    steps, b, t = 24, 4, 32
    jcfg = dataclasses.replace(
        train_kfac_100m.config_smoke(), dtype="float32")
    kw = dict(lr=2e-2, damping=0.05, block_size=64, stats_every=10,
              inv_every=10, stats_batch=b, stats_seq=t)
    params = jax.device_get(jlm.init(jcfg, jax.random.PRNGKey(0)))
    jk = JKFACConfig(**kw)
    state = jsteps.TrainState(params, jkfac.init(params,
                                                 jlm.kfac_specs(jcfg), jk))
    stats = jax.jit(jsteps.make_stats_step(jcfg, jk))
    train = jax.jit(jsteps.make_train_step(jcfg, jk))
    inv = jax.jit(jsteps.make_inv_step(jcfg, jk))
    ds = JTokens(jcfg.vocab, t, b, seed=0)
    want = []
    for i in range(steps):
        batch = {"tokens": jnp.asarray(ds.batch_slice(i, 0, b))}
        if i % 10 == 0:
            state, _ = stats(state, batch)
            state = inv(state)
        state, m = train(state, batch)
        want.append(float(m["loss"]))
    return jcfg, params, want


def _on_reference_weights(monkeypatch, jcfg, params):
    """Make the example train ``jcfg`` from the reference's weights."""
    class Converted(ttrain.KFACProgram):
        def init_state(self):
            p = convert.params_from_jax(params, device="cpu")
            return tsteps.TrainState(p, tkfac.init(
                p, tsteps.kfac_specs(self.cfg), self.kcfg))

    monkeypatch.setattr(ttrain, "KFACProgram", Converted)
    monkeypatch.setattr(train_kfac_100m, "config_smoke", lambda: jcfg)


def test_train_kfac_100m_smoke_recovers_and_matches_reference(
        monkeypatch, capsys, reference_smoke):
    """``--smoke --steps 6 --inject-failure-at 3`` through the example's
    CLI on the reference's initial weights (fp32): no checkpoint is due
    before step 25, so the recovery restarts from those weights and
    replays steps 0-2."""
    steps = 6
    jcfg, params, want = reference_smoke
    _on_reference_weights(monkeypatch, jcfg, params)
    s = train_kfac_100m.main(["--smoke", "--device", "cpu", "--steps",
                              str(steps), "--inject-failure-at", "3"])
    assert "train_kfac_100m OK" in capsys.readouterr().out
    assert s["recoveries"] == 1 and s["steps"] == steps
    hist = s["history"]
    assert [h["step"] for h in hist] == [0, 1, 2, 0, 1, 2, 3, 4, 5]
    assert [h["loss"] for h in hist[:3]] == [h["loss"] for h in hist[3:6]]
    np.testing.assert_allclose([h["loss"] for h in hist[3:]],
                               want[:steps], rtol=1e-5)


def test_train_kfac_100m_smoke_run_drops_on_reference_weights(
        monkeypatch, capsys, reference_smoke):
    """The example's documented ``--smoke`` run, all 24 steps, on the
    reference's initial weights (fp32): its own assert holds (the last
    loss below the first, as the reference's run on these weights), and
    every loss is the reference's step functions' within rtol 2e-4 (the
    two sum in another order; through three refreshes the gap grows to
    ~1e-4 at the last step)."""
    jcfg, params, want = reference_smoke
    assert want[-1] < want[0]
    _on_reference_weights(monkeypatch, jcfg, params)
    s = train_kfac_100m.main(["--smoke", "--device", "cpu"])
    assert "train_kfac_100m OK" in capsys.readouterr().out
    assert s["recoveries"] == 0 and s["steps"] == len(want)
    np.testing.assert_allclose([h["loss"] for h in s["history"]], want,
                               rtol=2e-4)


def test_train_kfac_100m_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_kfac_100m.main(["--smoke", "--steps", "1"])


def seed_sweep(seeds=range(6)):
    """The example's ``--smoke`` run (24 steps, its own config and
    settings) from each seed's weights, the reference's and the port's:
    ``(seed, reference losses, port losses)``."""
    import tempfile

    from repro.data import SyntheticTokens
    from repro.launch.train import KFACProgram
    from repro.runtime import LoopConfig, TrainLoop
    from repro_torch.data import SyntheticTokens as TTokens
    from repro_torch.runtime import LoopConfig as TLoopConfig
    from repro_torch.runtime import TrainLoop as TTrainLoop

    cfg = train_kfac_100m.config_smoke()
    steps, b, t = 24, 4, 32
    kcfg = train_kfac_100m.kfac_config(cfg, b, t)
    jk = JKFACConfig(**dataclasses.asdict(kcfg))
    out = []
    for seed in seeds:
        with tempfile.TemporaryDirectory() as d:
            ref = TrainLoop(
                LoopConfig(total_steps=steps, ckpt_dir=d, ckpt_every=25,
                           log_every=10),
                KFACProgram(cfg, jk, seed=seed),
                SyntheticTokens(vocab=cfg.vocab, seq_len=t,
                                global_batch=b, seed=0)).run()
        with tempfile.TemporaryDirectory() as d:
            port = TTrainLoop(
                TLoopConfig(total_steps=steps, ckpt_dir=d, ckpt_every=25,
                            log_every=10),
                ttrain.KFACProgram(cfg, kcfg, seed=seed,
                                   device=torch.device("cpu")),
                TTokens(vocab=cfg.vocab, seq_len=t, global_batch=b,
                        seed=0)).run()
        out.append((seed, [h["loss"] for h in ref["history"]],
                    [h["loss"] for h in port["history"]]))
    return out


if __name__ == "__main__":
    for seed, ref, port in seed_sweep():
        print(f"seed {seed}: reference {ref[0]:.4f} -> {ref[-1]:.4f}, "
              f"last 6 mean {np.mean(ref[-6:]):.4f}; port "
              f"{port[0]:.4f} -> {port[-1]:.4f}, last 6 mean "
              f"{np.mean(port[-6:]):.4f}")
