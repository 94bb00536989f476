"""Pipeline parallelism (``--pp``) on gloo CPU ranks: the port's
executor (``pipeline.make_pipeline_grads_fn`` through
``launch.steps.make_pipeline_step`` and ``KFACProgram``) on ``(stage,
data, model)`` meshes against the JAX reference and the port's one rank,
in every family the reference pipelines, at fp32 compute.

Ranks are spawned once per world size (``tests/_torch_dist_ranks.
pp_rank``): world 2 at ``(2, 1, 1)``, world 4 at ``(2, 1, 2)`` and
``(2, 2, 1)``. The reference's pipeline program runs in one subprocess on
a forced 4-device CPU platform (``tests/_torch_pp_reference.py``, Auto
axes); its one-device gradient accumulation, and the port's one rank,
run in this process. The CLI under ``torchrun`` starts beside them.

The oracle of a pipelined step at ``M`` microbatches over ``n`` data
ranks is the reference's one-device accumulation over ``M n`` blocks of
contiguous rows: each data rank's microbatch is one such block (the
reference's data shard of a microbatch is another block of the same
partition). In the MoE cases capacity binds (half the tokens one id,
checked), and at ``(2, 2, 1)`` the in-stage rule is pinned: whole
experts route a shard's tokens against the capacity of its own tokens,
which is not the data-parallel share ``shard_capacity`` gives.

Tolerances and why:
  * loss rtol 1e-5 and each gradient leaf within 1e-5 of its largest
    entry (the reference's own ``_assert_grads_close``), against the
    reference's accumulation and its pipeline program: the same
    operations, fp32 products summed in other orders (the stage sum of
    the shared leaves, the data reduction, the row-parallel partials);
  * GPipe against 1F1B, the ranks' losses, the refresh of each stage's
    factors against the one-rank refresh's blocks and a restored
    checkpoint: bitwise (the same operations in the same microbatch
    order; each block inverted alone; a checkpoint only moves bits);
  * each stage's statistics against the one-rank statistics step: each
    factor within 1e-6 of its Frobenius norm (fp32 Grams of the same
    tokens);
  * the 4-step trajectory: ``tests/test_torch_dist_tp_train.py``'s
    (losses rtol 1e-5 against the reference at ``train_accum`` M and
    the port's one rank; the last refresh's inverses within 1e-3 of the
    reference's inverse of the port's own factors; final parameters
    within 1% of each leaf's largest entry, with
    ``tests/_torch_families.check_params``'s rule for the Adam leaves);
  * the CLI: the gathered params bitwise equal on both ranks, the
    replayed steps' losses bitwise the first pass's.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dist_ranks as ranks_mod
import _torch_families as fam
from _torch_families import one_thread  # noqa: F401 (autouse)
from repro.configs import get_smoke_config
from repro.core import kfac as jkfac
from repro.core.kfac import KFACConfig as JKFACConfig
from repro.data import SyntheticTokens as JTokens
from repro.launch import steps as jsteps
from repro_torch import convert
from repro_torch import pipeline as tpipe
from repro_torch.checkpoint import restore
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.core import soi
from repro_torch.data import SyntheticTokens
from repro_torch.dist.spawn import start_ranks
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

QWEN, MOE, HYB = "qwen1.5-0.5b", "phi3.5-moe-42b-a6.6b", "recurrentgemma-9b"
WH, SSM, VLM = "whisper-tiny", "falcon-mamba-7b", "qwen2-vl-7b"
B, T, N_MICRO, N_STEPS = 8, 16, 2, 4
KCFG = ranks_mod.PP_KCFG
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CLI = ["--arch", QWEN, "--smoke", "--device", "cpu", "--batch", "4",
       "--seq", "16", "--stats-every", "1", "--inv-every", "2",
       "--pp", "2", "--dist-inv"]

#: (key, arch, cfg overrides, mesh (stage, data, model), uniform
#: partition) of the loss-and-gradient cases
GRADS = [("qwen_uniform", QWEN, {}, (2, 1, 1), True),
         ("qwen_free", QWEN, {"n_layers": 5}, (2, 1, 1), False),
         ("ssm", SSM, {}, (2, 1, 1), False),
         ("vlm", VLM, {}, (2, 1, 1), False),
         ("qwen_tp", QWEN, {}, (2, 1, 2), False),
         ("qwen_dp", QWEN, {}, (2, 2, 1), False),
         ("moe_ep", MOE, {}, (2, 1, 2), False),
         ("moe_dp", MOE, {}, (2, 2, 1), False),
         ("hybrid", HYB, {"n_layers": 10}, (2, 1, 2), False),
         ("whisper", WH, {}, (2, 2, 1), False)]
#: the cases the reference's pipeline program also runs (its Auto mesh)
REFERENCE = ("moe_dp", "hybrid", "whisper")
GRAMS = [("grams_qwen", QWEN, {}, (2, 1, 1)),
         ("grams_moe", MOE, {}, (2, 2, 1))]
BY_KEY = {k: (a, o, s) for k, a, o, s, *_ in GRADS + GRAMS}


def _cfgs(arch, **over):
    return (dataclasses.replace(get_smoke_config(arch), dtype="float32",
                                **over),
            dataclasses.replace(t_get_smoke_config(arch), dtype="float32",
                                **over))


def _params(arch, **over):
    _, tcfg = _cfgs(arch, **over)
    p = tsteps.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    return {k: v.numpy() for k, v in p.items()}


def _batch(arch, **over):
    """``B`` x ``T`` tokens, half of them one id (routing that fills
    experts), with the family's extras."""
    _, tcfg = _cfgs(arch, **over)
    r = np.random.default_rng(5)
    t = r.integers(0, tcfg.vocab, (B, T))
    t[r.random((B, T)) < 0.5] = 7
    out = {"tokens": t.astype(np.int32)}
    if tcfg.family == "vlm":
        out.update(fam.vlm_extras(tcfg, B, T, 5))
    if tcfg.family == "audio":
        out["enc_embeds"] = r.standard_normal(
            (B, 12, tcfg.d_model)).astype(np.float32)
    return out


INPUTS = {k: (_params(a, **o), _batch(a, **o)) for k, (a, o, _) in
          BY_KEY.items()}


def _cases(world, ck):
    out = []
    for key, arch, over, shape, uniform in GRADS:
        if math.prod(shape) == world:
            out.append((key, "grads", arch, over, shape,
                        (*INPUTS[key], uniform)))
    for key, arch, over, shape in GRAMS:
        if math.prod(shape) == world:
            out.append((key, "grams", arch, over, shape, INPUTS[key]))
    if world == 2:
        out.append(("train", "train", QWEN, {}, (2, 1, 1),
                    (N_STEPS, os.path.join(ck, "train"))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port results by key: one entry a rank, reference pipeline
    results, the temporary dir)``; the CLI's torchrun run starts beside
    them (:func:`cli_run`), and this process computes the one-device
    oracles (:data:`_ORACLES`) while they run."""
    tmp = tmp_path_factory.mktemp("pp")
    inp = {}
    for key in REFERENCE:
        arch, over, shape = BY_KEY[key]
        params, batch = INPUTS[key]
        inp[f"{key}/arch_over"] = np.array(json.dumps({"arch": arch,
                                                        **over}))
        inp[f"{key}/spec"] = np.array([*shape, N_MICRO])
        inp.update({f"{key}/p/{k}": v for k, v in params.items()})
        inp.update({f"{key}/b/{k}": v for k, v in batch.items()})
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_pp_reference.py"),
         str(tmp / "in.npz"), str(tmp / "out.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _CLI["proc"] = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
         "--steps", "5", "--ckpt-dir", str(tmp / "ck"), "--ckpt-every",
         "2", "--inject-failure-at", "3", "--out", str(tmp / "cli.json")],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _CLI["out"] = tmp / "cli.json"
    four = start_ranks(ranks_mod.pp_rank, 4, args=(_cases(4, str(tmp)),),
                       timeout=300)
    two = start_ranks(ranks_mod.pp_rank, 2, args=(_cases(2, str(tmp)),),
                      timeout=300)
    _ORACLES.update(accum={g[0]: _reference_accum(g[0]) for g in GRADS},
                    trajectory=_reference_trajectory(), one=_one_rank())
    try:
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    res = [*two.results(), *four.results()]
    assert ref.returncode == 0, log[-3000:]
    port = {}
    for r in (res[:2], res[2:]):
        port.update({k: [rank[k] for rank in r] for k in r[0]})
    with np.load(tmp / "out.npz") as d:
        jref = {k: d[k] for k in d.files}
    return port, jref, str(tmp)


#: the CLI's torchrun process, started by :func:`runs`
_CLI: dict = {}
#: the one-device oracles, computed by :func:`runs`: ``accum`` (the
#: reference's accumulation by case), ``trajectory`` and ``one``
_ORACLES: dict = {}


@pytest.fixture(scope="module")
def cli_run(runs):
    proc = _CLI["proc"]
    try:
        log, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, log[-3000:]
    with open(_CLI["out"]) as f:
        return json.load(f)


def _jax_params(params_np):
    return jax.tree_util.tree_map(jnp.asarray, convert.params_to_jax(
        {k: torch.from_numpy(v) for k, v in params_np.items()}))


def _reference_accum(key):
    """The reference's one-device loss and gradients, accumulated over
    ``N_MICRO`` x data-rank blocks of contiguous rows."""
    arch, over, shape = BY_KEY[key]
    jcfg, _ = _cfgs(arch, **over)
    params, batch = INPUTS[key]
    mod = jsteps.model_module(jcfg)
    f = jax.jit(jax.value_and_grad(lambda p, b: mod.loss_fn(jcfg, p, b)[0]))
    jp = _jax_params(params)
    n = N_MICRO * shape[1]
    micro = tpipe.split_microbatches(
        {k: torch.from_numpy(v) for k, v in batch.items()}, n)
    loss, grads = 0.0, None
    for i in range(n):
        l_i, g_i = f(jp, {k: jnp.asarray(v[i].numpy())
                          for k, v in micro.items()})
        g_i = convert._flatten(jax.device_get(g_i))
        loss += float(l_i) / n
        grads = ({k: np.asarray(v) / n for k, v in g_i.items()}
                 if grads is None else
                 {k: grads[k] + np.asarray(g_i[k]) / n for k in grads})
    return loss, grads


def _close_grads(got_loss, got, want_loss, want):
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.max(np.abs(got[k] - w))
        assert err <= 1e-5 * max(np.max(np.abs(w)), 1e-12), (k, err)


def _first_moe_input(key):
    """The first MoE layer's (nt, D) input over the whole batch, and its
    router."""
    arch, over, _ = BY_KEY[key]
    _, tcfg = _cfgs(arch, **over)
    params, batch = INPUTS[key]
    seen = []
    orig = tmoe.route

    def spy(cfg, router, xf, *rest):
        seen.append((xf, router))
        return orig(cfg, router, xf, *rest)

    tmoe.route = spy
    try:
        with torch.no_grad():
            tlm.loss_fn(tcfg, {k: torch.from_numpy(v)
                               for k, v in params.items()},
                        {"tokens": torch.from_numpy(batch["tokens"])})
    finally:
        tmoe.route = orig
    return tcfg, seen[0]


@pytest.mark.parametrize("key", [g[0] for g in GRADS])
def test_pipelined_grads_match_reference_accumulation(runs, key):
    """Every family and mesh: each rank's loss equal, and the loss and
    the gathered gradients the reference's one-device accumulation's."""
    port, _, _ = runs
    res = port[key]
    assert len({r["loss"] for r in res}) == 1
    _close_grads(res[0]["loss"], res[0]["grads"], *_ORACLES["accum"][key])


@pytest.mark.parametrize("key", REFERENCE)
def test_pipelined_grads_match_reference_pipeline(runs, key):
    """The reference's own pipeline program on its ``Auto`` mesh of the
    same shape: the non-uniform hybrid and whisper stacks, MoE with
    whole experts at data 2."""
    port, jref, _ = runs
    pre = f"{key}/g/"
    want = {k[len(pre):]: v for k, v in jref.items() if k.startswith(pre)}
    _close_grads(port[key][0]["loss"], port[key][0]["grads"],
                 float(jref[f"{key}/loss"]), want)


@pytest.mark.parametrize("key", [g[0] for g in GRADS])
def test_gpipe_bitwise_1f1b_and_stash_depth(runs, key):
    """On every rank GPipe's loss and gradients are bitwise 1F1B's, and
    each schedule's peak of stashed stage inputs is its stash plan's
    depth for the rank's stage."""
    port, _, _ = runs
    _, _, shape = BY_KEY[key]
    for rank, r in enumerate(port[key]):
        assert r["gpipe_bitwise"], rank
        stage = rank // (shape[1] * shape[2])
        for kind, peak in r["peak_stash"].items():
            plan = tpipe.make_schedule(kind, 2, N_MICRO).stash_plan
            assert peak == plan.act_depth[stage], (rank, kind)


@pytest.mark.parametrize("key", ["moe_ep", "moe_dp"])
def test_moe_in_stage_capacity(runs, key):
    """Capacity binds in each data shard's microbatch, at the in-stage
    rule's capacity: experts sliced over ``model`` (``moe_ep``) route
    against the data share ``shard_capacity``, whole experts
    (``moe_dp``) against the capacity of the shard's own tokens, which
    at data 2 is not the share (24 slots against 20)."""
    _, _, shape = BY_KEY[key]
    tcfg, (xf, router) = _first_moe_input(key)
    n_data = shape[1]
    nt = xf.shape[0] // (N_MICRO * n_data)
    c = (tmoe.shard_capacity(tcfg, nt, n_data) if shape[2] > 1
         else tmoe.capacity(tcfg, nt))
    if n_data > 1:
        assert tmoe.capacity(tcfg, nt) != tmoe.shard_capacity(tcfg, nt,
                                                              n_data)
    for i in range(N_MICRO * n_data):
        keep = tmoe.route(tcfg, router, xf[i * nt:(i + 1) * nt], c)[2]
        assert not bool(keep.all()), f"block {i} drops nothing"


@pytest.mark.parametrize("key", [g[0] for g in GRAMS])
def test_stage_grams_match_one_rank_statistics(runs, key):
    """The statistics pass through the stages: each stage holds the
    factors of its own layers only, and the Grams gathered whole are the
    one-rank statistics step's (MoE at data 2: its global queue). Each
    stage's distributed refresh (over its two data ranks at ``(2, 2,
    1)``, through their registered group) is bitwise the local
    refresh."""
    port, _, _ = runs
    arch, over, shape = BY_KEY[key]
    _, tcfg = _cfgs(arch, **over)
    params, batch = INPUTS[key]
    kcfg = tkfac.KFACConfig(**{**KCFG, "ema_decay": 0.0})
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    state = tsteps.TrainState(tp, tkfac.init(tp, tsteps.kfac_specs(tcfg),
                                             kcfg))
    state, _ = tsteps.make_stats_step(tcfg, kcfg)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    part = tpipe.partition_stages(tcfg, shape[0])
    per_stage = tpipe.kfac_glue.stage_specs(tsteps.kfac_specs(tcfg), part)
    for rank, r in enumerate(port[key]):
        stage = rank // (shape[1] * shape[2])
        assert r["refresh_bitwise"], rank
        assert set(r["shapes"]) == set(per_stage[stage])
        for n, d in r["shapes"].items():
            for side, s in d.items():
                assert s[0] == per_stage[stage][n].stack[0], (n, side)
    got = port[key][0]["factors"]
    for n, d in state.kfac.factors.items():
        for side, w in d.items():
            w = w.numpy()
            err = np.linalg.norm(got[n][side] - w)
            assert err <= 1e-6 * np.linalg.norm(w), (n, side, err)


def _one_rank():
    """The port's one-rank run of the trajectory's program at
    ``train_accum`` M."""
    _, tcfg = _cfgs(QWEN, train_accum=N_MICRO)
    return ttrain.run(ttrain.KFACProgram(tcfg, tkfac.KFACConfig(**KCFG),
                                         device="cpu"),
                      SyntheticTokens(tcfg.vocab, KCFG["stats_seq"],
                                      KCFG["stats_batch"],
                                      seed=ranks_mod.PP_DATA_SEED),
                      N_STEPS)


def _reference_trajectory():
    """The reference's program (one device, ``train_accum`` M) on the
    port's seed-0 weights."""
    jcfg, tcfg = _cfgs(QWEN, train_accum=N_MICRO)
    kcfg = JKFACConfig(**KCFG)
    params = _jax_params({k: v.numpy() for k, v in ttrain.KFACProgram(
        tcfg, tkfac.KFACConfig(**KCFG), device="cpu").init_state()
        .params.items()})
    state = jsteps.TrainState(params, jkfac.init(
        params, jsteps.kfac_specs(jcfg), kcfg))
    stats = jax.jit(jsteps.make_stats_step(jcfg, kcfg))
    train = jax.jit(jsteps.make_train_step(jcfg, kcfg))
    refresh = jax.jit(jsteps.make_inv_refresh(jcfg, kcfg))
    ds = JTokens(jcfg.vocab, KCFG["stats_seq"], KCFG["stats_batch"],
                 seed=ranks_mod.PP_DATA_SEED)
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


def test_trajectory_matches_reference_and_one_rank(runs):
    """4 K-FAC steps under ``--pp 2`` (stats and refresh every 2 steps,
    ``--dist-inv``): the ranks' losses equal, within 1e-5 of the one
    rank's and the reference's at ``train_accum`` M; the inverses and
    final parameters as ``tests/test_torch_dist_tp_train.py`` holds
    them."""
    port, _, _ = runs
    res = port["train"]
    r0 = res[0]
    assert all(r["losses"] == r0["losses"] for r in res)
    _, hist = _ORACLES["one"]
    np.testing.assert_allclose(r0["losses"], [h["loss"] for h in hist],
                               rtol=1e-5)
    j_losses, j_state, j_refresh = _ORACLES["trajectory"]
    np.testing.assert_allclose(r0["losses"], j_losses, rtol=1e-5)
    got = r0["state"]
    j_of_t = jax.device_get(j_refresh({
        n: {s: jnp.asarray(f) for s, f in d.items()}
        for n, d in got["factors"].items()}))
    for n, d in j_state.kfac.inverses.items():
        for side, v in d.items():
            own = np.max(np.abs(got["inverses"][n][side] - j_of_t[n][side]))
            assert own <= 1e-3 * np.max(np.abs(v)), (n, side, own)
    port_state = types.SimpleNamespace(
        params={k: torch.from_numpy(v) for k, v in got["params"].items()},
        kfac=types.SimpleNamespace(adam_mu={
            k: torch.from_numpy(v) for k, v in got["adam_mu"].items()}))
    _, tcfg = _cfgs(QWEN)
    fam.check_params(port_state, j_state, tsteps.kfac_specs(tcfg),
                     lr=JKFACConfig(**KCFG).lr, n_steps=N_STEPS,
                     bound=lambda v: 1e-2 * np.max(np.abs(v)))


def test_each_stage_holds_its_own_blocks(runs):
    """Each stage rank holds its layers' params, factors, inverses and WU
    tiles only: the stacks cut to its atoms, the blocks and tiles of the
    two ranks summing to the one-rank program's, and its refresh bitwise
    the one-rank refresh's blocks."""
    port, _, _ = runs
    res = port["train"]
    _, tcfg = _cfgs(QWEN)
    part = tpipe.partition_stages(tcfg, 2)
    kcfg = tkfac.KFACConfig(**KCFG)
    specs = tsteps.kfac_specs(tcfg)
    one = ttrain.KFACProgram(tcfg, kcfg, device="cpu").init_state()
    one_blocks = sum(math.prod(shape[:-2]) for s in specs.values()
                     for shape in soi.factor_shapes(
                         s, kcfg.block_size).values())
    assert sum(r["blocks"] for r in res) == one_blocks
    assert sum(r["wu_tiles"] for r in res) == tsteps.make_wu_plan_for(
        tcfg, one).total_tiles
    for stage, r in enumerate(res):
        assert r["refresh_bitwise"]
        count = part.layer_counts()[stage]
        assert set(r["factor_shapes"]) == set(specs)
        for n, d in r["factor_shapes"].items():
            for side, s in d.items():
                assert s[0] == count, (n, side, s)
                assert r["inverse_shapes"][n][side + "_inv"] == s
        assert set(r["leaves"]) == set(one.params)


def test_checkpoint_restores_on_one_rank(runs):
    """The loop's last checkpoint, written from the state gathered over
    the stages, restores into a one-rank program bitwise, and its params'
    digest is every rank's."""
    port, _, tmp = runs
    res = port["train"]
    r0 = res[0]
    assert all(r["digest"] == r0["digest"] for r in res)
    _, tcfg = _cfgs(QWEN)
    like = ttrain.KFACProgram(tcfg, tkfac.KFACConfig(**KCFG),
                              device="cpu").init_state()
    state, manifest = restore(os.path.join(tmp, "train"), like)
    assert manifest["step"] == N_STEPS
    got = r0["state"]
    for k, v in state.params.items():
        assert np.array_equal(v.numpy(), got["params"][k]), k
    for k, v in state.kfac.momentum.items():
        assert np.array_equal(v.numpy(), got["momentum"][k]), k
    for tree, name in ((state.kfac.factors, "factors"),
                       (state.kfac.inverses, "inverses")):
        for n, d in tree.items():
            for s, v in d.items():
                assert np.array_equal(v.numpy(), got[name][n][s]), (n, s)
    assert r0["digest"] == ttrain.params_digest(state.params)


def test_cli_pipeline_recovers_every_rank(cli_run):
    """``launch.train --pp 2 --dist-inv`` under torchrun with a device
    loss at step 3: one recovery from the checkpoint after step 1 on both
    ranks, the replayed steps' losses bitwise the first pass's, the
    gathered params equal on both ranks."""
    s = cli_run
    assert s["ranks"] == 2 and s["pp"] == 2 and s["pp_schedule"] == "1f1b"
    assert s["recoveries"] == 1 and s["steps"] == 5
    assert s["pipeline_parallel"] == 2
    assert s["params_digest"][0] == s["params_digest"][1]
    assert [h["step"] for h in s["history"]] == [0, 1, 2, 2, 3, 4]
    first = {}
    for h in s["history"]:
        assert first.setdefault(h["step"], h["loss"]) == h["loss"], h
    assert all(map(math.isfinite, s["losses"]))
