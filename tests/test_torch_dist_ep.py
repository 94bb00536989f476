"""MoE under data and expert parallelism on gloo CPU ranks: the
moonshot-v1-16b-a3b smoke model (4 experts, top-2, capacity factor
1.25) at fp32 compute through ``KFACProgram`` on ``(data, model)``
meshes, against the JAX reference and the port's one rank.

Ranks are spawned once per world size (``tests/_torch_dist_ranks.
ep_rank``): world 2 at ``(2, 1)`` (data parallelism) and ``(1, 2)``
(expert parallelism: 2 experts a rank), world 4 at ``(2, 2)``. The
reference's train step takes its ``shard_map`` fast path on a mesh, so
its data-parallel numbers come from one subprocess on a forced 4-device
CPU platform (``tests/_torch_ep_reference.py``, ``Auto`` axes); its
statistics step runs the global scatter path, which one device in this
process computes, as does its train step at data 1.

The reference's fast path with a ``model`` axis of 2 computes the right
loss but wrong gradients (on jax 0.9.0; ``test_reference_fast_path_
gradients_at_model_2``): its expert and upstream gradients differ from
its own one-device ones by 25-60%. Routing and capacity do not depend on
the model axis (each data shard's queue is the same whichever rank holds
an expert), so the port at ``(2, 2)`` is held to the reference at
``(2, 1)``, and at ``(1, 2)`` to the reference on one device.

Every input makes capacity bind: the batches draw half their tokens
from one id (``_tokens``), and each test checks that the first MoE
layer drops pairs at the capacity the case uses, and, at data 2, that
a rank's share of the global capacity differs from the capacity of its
own tokens (20 slots against 24 at 2 x 16 tokens a rank), so that no
case passes without the repair it holds.

Tolerances and why:
  * the train path at data 2 and the EP paths, against the reference:
    the loss rtol 1e-5 and each gradient leaf within 1e-5 of its
    largest entry. The same routing decisions and capacities (checked
    equal), and fp32 products summed in another order (the ranks'
    reductions, the experts' partial outputs over the model ranks);
  * the statistics, against the reference's global queue: each factor
    within 1e-6 of its Frobenius norm (fp32 Grams of the same slots,
    each rank's part summed over the data ranks);
  * the 4-step trajectory at ``(1, 2)``: ``tests/test_torch_dist_tp_
    train.py``'s (losses rtol 1e-5 against the reference and the one
    rank; the last refresh's inverses within 1e-3 of the reference's
    inverse of the port's own factors; final parameters within 1% of the
    leaf's largest entry), with ``tests/_torch_families.check_params``'s
    rule for the Adam-updated leaves (their first moment within 1%, and
    the entries with rounding-level gradients within 2 lr a step: the
    embedding's, as on one rank). At ``(2, 2)`` against the port's
    ``(2, 1)`` run: losses rtol 1e-5, since slicing the experts changes
    only the summation order;
  * the router on every rank after every step, a restored checkpoint
    and the split refresh against the one-rank refresh's blocks:
    bitwise (every rank applies the same reduced values; a gather and a
    checkpoint only move bits; each block is inverted alone).
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
from repro.models import lm as jlm
from repro_torch import convert
from repro_torch.checkpoint import restore
from repro_torch.configs import get_smoke_config as t_get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.data import SyntheticTokens
from repro_torch.dist import sharding
from repro_torch.dist.spawn import start_ranks
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe

ARCH = "moonshot-v1-16b-a3b"
N_STEPS = 4
KCFG = ranks_mod.EP_KCFG
DATA_SEED = ranks_mod.EP_DATA_SEED
HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
CLI = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
       "--seq", "16", "--stats-every", "1", "--inv-every", "2",
       "--steps", "2"]


def _cfgs(**over):
    return (dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                                **over),
            dataclasses.replace(t_get_smoke_config(ARCH), dtype="float32",
                                **over))


def _params(**over):
    _, tcfg = _cfgs(**over)
    p = tlm.init(tcfg, generator=torch.Generator().manual_seed(0),
                 device="cpu")
    return {k: v.numpy() for k, v in p.items()}


def _tokens(b, seed):
    """``b`` x 16 tokens, half of them one id: routing that fills
    experts."""
    r = np.random.default_rng(seed)
    t = r.integers(0, 256, (b, 16))
    t[r.random((b, 16)) < 0.5] = 7
    return t.astype(np.int32)


B4 = _tokens(4, 0)
B8 = _tokens(8, 1)

# (key, kind, cfg overrides, mesh shape, batch) of the loss-and-gradient
# cases; the stats cases take B4's rows [:4] and [:2] (at data 2 the
# second rank then holds none)
GRADS = [("dp", {}, (2, 1), B4), ("dp_accum", {"train_accum": 2}, (2, 1), B8),
         ("ep12", {}, (1, 2), B4), ("ep22", {}, (2, 2), B4),
         ("e3", {"n_experts": 3}, (1, 2), B4)]
#: the reference's forced-mesh runs: ``{key: (mesh shape, train_accum,
#: batch)}``
REFERENCE = {"dp": ((2, 1), 1, B4), "dp_accum": ((2, 1), 2, B8),
             "ep12": ((1, 2), 1, B4)}
GRAMS = [(f"grams{rows}_{d}x{m}", (d, m), rows)
         for d, m in ((2, 1), (1, 2), (2, 2)) for rows in (4, 2)]


def _cases(world, params, ck):
    out = []
    for key, over, shape, batch in GRADS:
        if math.prod(shape) == world:
            p = params["e3"] if "n_experts" in over else params["e4"]
            out.append((key, "grads", ARCH, over, shape,
                        (p, {"tokens": batch})))
    for key, shape, rows in GRAMS:
        if math.prod(shape) == world:
            out.append((key, "grams", ARCH, {}, shape,
                        (params["e4"], {"tokens": B4}, rows)))
    for shape in ((2, 1), (1, 2), (2, 2)):
        if math.prod(shape) == world:
            out.append((f"train{shape[0]}x{shape[1]}", "train", ARCH, {},
                        shape, (N_STEPS, os.path.join(
                            ck, f"{shape[0]}x{shape[1]}"))))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(port results by key, reference subprocess results, the
    weights, the temporary dir)``; the CLI's run under torchrun starts
    beside them (:func:`cli_run`)."""
    tmp = tmp_path_factory.mktemp("ep")
    params = {"e4": _params(), "e3": _params(n_experts=3)}
    inp = {"arch": np.array(ARCH),
           **{f"p/{k}": v for k, v in params["e4"].items()}}
    for key, (shape, accum, batch) in REFERENCE.items():
        inp[f"{key}/tokens"] = batch
        inp[f"{key}/spec"] = np.array([*shape, accum])
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(HERE, "_torch_ep_reference.py"),
         str(tmp / "in.npz"), str(tmp / "out.npz")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _CLI["proc"] = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train", *CLI,
         "--model-parallel", "2", "--dist-inv", "--out",
         str(tmp / "cli.json")],
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    _CLI["out"] = tmp / "cli.json"
    four = start_ranks(ranks_mod.ep_rank, 4,
                       args=(_cases(4, params, str(tmp)),), timeout=300)
    two = start_ranks(ranks_mod.ep_rank, 2,
                      args=(_cases(2, params, str(tmp)),), timeout=300)
    try:
        log, _ = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
    res = [*two.results(), *four.results()]
    assert ref.returncode == 0, log[-3000:]
    port = {}
    for r, world in ((res[:2], 2), (res[2:], 4)):
        port.update({k: [rank[k] for rank in r] for k in r[0]})
    with np.load(tmp / "out.npz") as d:
        jref = {k: d[k] for k in d.files}
    return port, jref, params, str(tmp)


#: the CLI's torchrun process, started by :func:`runs`
_CLI: dict = {}


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


def test_cli_expert_parallel_under_torchrun(cli_run):
    """``launch.train --model-parallel 2 --dist-inv`` on the moe smoke
    config under torchrun (2 ranks, bf16 compute): the gathered params
    equal on both ranks, finite losses, and step 0 (the same weights and
    rows) within 1e-5 of the one-rank CLI's: the experts' partial
    outputs sum in fp32 and round once."""
    s = cli_run
    assert s["ranks"] == 2 and s["model_parallel"] == 2 and s["dist_inv"]
    assert s["params_digest"][0] == s["params_digest"][1]
    assert len(s["losses"]) == 2 and all(map(math.isfinite, s["losses"]))
    one = ttrain.main(CLI)["losses"]
    np.testing.assert_allclose(s["losses"][0], one[0], rtol=1e-5)


def _grads_of(jref, key):
    pre = f"{key}/g/"
    return float(jref[f"{key}/loss"]), {
        k[len(pre):]: v for k, v in jref.items() if k.startswith(pre)}


def _jax_params(params_np):
    return jax.tree_util.tree_map(jnp.asarray, convert.params_to_jax(
        {k: torch.from_numpy(v) for k, v in params_np.items()}))


def _one_device_grads(params_np, batch, **over):
    """The reference's loss and gradients on one device (its global
    path)."""
    jcfg, _ = _cfgs(**over)
    params = _jax_params(params_np)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss_fn(jcfg, p, b)[0]))(
            params, {"tokens": jnp.asarray(batch)})
    return float(loss), convert._flatten(jax.device_get(g))


def _close_grads(got_loss, got, want_loss, want):
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-5)
    assert set(got) == set(want)
    for k, w in want.items():
        err = np.max(np.abs(got[k] - w))
        assert err <= 1e-5 * np.max(np.abs(w)), (k, err)


def _first_layer_input(params_np, batch):
    """The first MoE layer's (nt, D) input on one rank, and its router."""
    _, tcfg = _cfgs()
    seen = []
    orig = tmoe.route

    def spy(cfg, router, xf, *rest):
        seen.append((xf, router))
        return orig(cfg, router, xf, *rest)

    tmoe.route = spy
    try:
        with torch.no_grad():
            tlm.loss_fn(tcfg, {k: torch.from_numpy(v)
                               for k, v in params_np.items()},
                        {"tokens": torch.from_numpy(batch)})
    finally:
        tmoe.route = orig
    return seen[0]


def _assert_capacity_binds(params_np, batch, n_data, rows=None):
    """Pairs are dropped at the capacity each data shard takes, and at
    data 2 a shard's share of the global capacity is not the capacity of
    its own tokens."""
    _, tcfg = _cfgs()
    xf, router = _first_layer_input(params_np, batch)
    nt = xf.shape[0] // n_data
    if rows is None:        # the train path: each shard its share
        c = tmoe.shard_capacity(tcfg, nt, n_data)
        if n_data > 1:
            assert c != tmoe.capacity(tcfg, nt), (c, nt)
        for d in range(n_data):
            keep = tmoe.route(tcfg, router, xf[d * nt:(d + 1) * nt], c)[2]
            assert not bool(keep.all()), f"shard {d} drops nothing"
    else:                   # the stats path: one queue over the rows
        n = rows * batch.shape[1]
        keep = tmoe.route(tcfg, router, xf[:n], tmoe.capacity(tcfg, n))[2]
        assert not bool(keep.all())
        if n_data > 1:
            assert tmoe.capacity(tcfg, n) != tmoe.capacity(tcfg, n // 2)


@pytest.mark.parametrize("key", ["dp", "dp_accum"])
def test_data_parallel_train_path_matches_reference(runs, key):
    """Data 2: each rank routes its rows against its share of the global
    capacity, as the reference's fast path on the forced mesh (with
    ``train_accum`` 2 each microbatch's shards, the same blocks of rows
    in both)."""
    port, jref, params, _ = runs
    batch = B4 if key == "dp" else B8
    _assert_capacity_binds(params["e4"], batch[:4] if key == "dp_accum"
                           else batch, 2)
    assert int(jref[f"{key}/fast_calls"]) > 0
    r0, r1 = port[key]
    assert r0["loss"] == r1["loss"]
    _close_grads(r0["loss"], r0["grads"], *_grads_of(jref, key))


@pytest.fixture(scope="module")
def reference_grams(runs):
    """The reference's statistics on one device (its global scatter
    path, EMA decay 0: the factors are the Grams) of B4's rows [:4] and
    [:2]."""
    _, _, params, _ = runs
    jcfg, _ = _cfgs()
    kcfg = JKFACConfig(**{**KCFG, "ema_decay": 0.0})
    jp = _jax_params(params["e4"])
    state = jsteps.TrainState(jp, jkfac.init(jp, jlm.kfac_specs(jcfg), kcfg))
    stats = jax.jit(jsteps.make_stats_step(jcfg, kcfg))
    out = {}
    for rows in (4, 2):
        st, _ = stats(state, {"tokens": jnp.asarray(B4[:rows])})
        out[rows] = jax.device_get(st.kfac.factors)
    return out


def _close_grams(got, want):
    assert set(got) == set(want)
    for n, d in want.items():
        for side, w in d.items():
            w = np.asarray(w)
            assert got[n][side].shape == w.shape, (n, side)
            err = np.linalg.norm(got[n][side] - w)
            assert err <= 1e-6 * np.linalg.norm(w), (n, side, err)


@pytest.mark.parametrize("shape", [(2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("rows", [4, 2])
def test_stats_grams_match_reference_global_queue(runs, reference_grams,
                                                  shape, rows):
    """One queue over the global subsample: each rank's pairs at the
    slots after those of the data ranks before it, the expert A-Grams
    summed with weight 1. At rows 2 and data 2 the second rank holds no
    subsample rows and adds zero counts."""
    port, _, params, _ = runs
    _assert_capacity_binds(params["e4"], B4, shape[0], rows=rows)
    got = port[f"grams{rows}_{shape[0]}x{shape[1]}"][0]
    _close_grams(got, reference_grams[rows])


@pytest.mark.parametrize("key", ["ep12", "ep22"])
def test_expert_parallel_loss_and_grads_match_reference(runs, key):
    """Each rank its half of the experts: the loss and the gathered
    gradients against the reference (one device at data 1, its ``(2,
    1)`` forced mesh at data 2), and every rank's loss equal."""
    port, jref, params, _ = runs
    n_data = 2 if key == "ep22" else 1
    _assert_capacity_binds(params["e4"], B4, n_data)
    losses = {r["loss"] for r in port[key]}
    assert len(losses) == 1
    r0 = port[key][0]
    if n_data == 1:
        want = _one_device_grads(params["e4"], B4)
    else:
        assert int(jref["dp/fast_calls"]) > 0
        want = _grads_of(jref, "dp")
    _close_grads(r0["loss"], r0["grads"], *want)


def test_reference_fast_path_gradients_at_model_2(runs):
    """The reference's caveat the module docstring names: at ``(1, 2)``
    its fast path's loss is its one-device loss, its gradients are not
    (the port's ``(1, 2)`` gradients are, above)."""
    _, jref, params, _ = runs
    assert int(jref["ep12/fast_calls"]) > 0
    loss, grads = _grads_of(jref, "ep12")
    want_loss, want = _one_device_grads(params["e4"], B4)
    np.testing.assert_allclose(loss, want_loss, rtol=1e-6)
    off = {k: float(np.max(np.abs(grads[k] - w)) / np.max(np.abs(w)))
           for k, w in want.items()}
    assert off["lm_head"] < 1e-5, off
    assert min(off[f"layers/moe/{k}"] for k in
               ("router", "wg", "wu", "wd")) > 0.1, off


@pytest.fixture(scope="module")
def one_rank():
    """The port's one-rank run of the trajectory's program."""
    _, tcfg = _cfgs()
    return ttrain.run(ttrain.KFACProgram(tcfg, tkfac.KFACConfig(**KCFG),
                                         device="cpu"),
                      SyntheticTokens(tcfg.vocab, KCFG["stats_seq"],
                                      KCFG["stats_batch"], seed=DATA_SEED),
                      N_STEPS)


@pytest.fixture(scope="module")
def reference_trajectory():
    """The reference's program (one device) on the port's seed-0
    weights."""
    jcfg, tcfg = _cfgs()
    kcfg = JKFACConfig(**KCFG)
    params = _jax_params({k: v.numpy() for k, v in ttrain.KFACProgram(
        tcfg, tkfac.KFACConfig(**KCFG), device="cpu").init_state()
        .params.items()})
    state = jsteps.TrainState(params, jkfac.init(
        params, jlm.kfac_specs(jcfg), kcfg))
    stats = jax.jit(jsteps.make_stats_step(jcfg, kcfg))
    train = jax.jit(jsteps.make_train_step(jcfg, kcfg))
    refresh = jax.jit(jsteps.make_inv_refresh(jcfg, kcfg))
    ds = JTokens(jcfg.vocab, KCFG["stats_seq"], KCFG["stats_batch"],
                 seed=DATA_SEED)
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


def _trajectory_binds():
    """Each of the trajectory's batches drops pairs at its capacities
    (on the initial weights)."""
    _, tcfg = _cfgs()
    ds = SyntheticTokens(tcfg.vocab, KCFG["stats_seq"], KCFG["stats_batch"],
                         seed=DATA_SEED)
    params = {k: v.numpy() for k, v in ttrain.KFACProgram(
        tcfg, tkfac.KFACConfig(**KCFG), device="cpu").init_state()
        .params.items()}
    for step in range(N_STEPS):
        toks = ds.batch_slice(step, 0, KCFG["stats_batch"])
        _assert_capacity_binds(params, toks, 2)
        _assert_capacity_binds(params, toks, 1)


def test_expert_parallel_trajectory_1x2_matches_reference_and_one_rank(
        runs, one_rank, reference_trajectory):
    port, _, _, _ = runs
    _trajectory_binds()
    res = port["train1x2"]
    r0 = res[0]
    assert all(r["losses"] == r0["losses"] for r in res)
    _, hist = one_rank
    np.testing.assert_allclose(r0["losses"], [h["loss"] for h in hist],
                               rtol=1e-5)
    j_losses, j_state, j_refresh = reference_trajectory
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
    port_state = types.SimpleNamespace(
        params={k: torch.from_numpy(v) for k, v in got["params"].items()},
        kfac=types.SimpleNamespace(adam_mu={
            k: torch.from_numpy(v) for k, v in got["adam_mu"].items()}))
    _, tcfg = _cfgs()
    fam.check_params(port_state, j_state, tsteps.kfac_specs(tcfg),
                     lr=JKFACConfig(**KCFG).lr, n_steps=N_STEPS,
                     bound=lambda v: 1e-2 * np.max(np.abs(v)))


def test_expert_parallel_trajectory_2x2_matches_data_parallel(runs):
    port, _, _, _ = runs
    _trajectory_binds()
    dp, ep = port["train2x1"], port["train2x2"]
    assert all(r["losses"] == ep[0]["losses"] for r in ep)
    np.testing.assert_allclose(ep[0]["losses"], dp[0]["losses"], rtol=1e-5)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_each_rank_holds_its_experts_blocks(runs, shape):
    """Each rank's expert factors, inverses and WU tiles are those of
    its E/mp experts; the split refresh is bitwise the one-rank
    refresh's blocks."""
    port, _, _, _ = runs
    _, tcfg = _cfgs()
    res = port[f"train{shape[0]}x{shape[1]}"]
    full = res[0]["state"]["factors"]
    e_loc = tcfg.n_experts // shape[1]
    for r in res:
        assert r["refresh_bitwise"]
        assert set(r["factor_shapes"]) == {
            n for n in full if "/moe/" in n} == set(r["inverse_shapes"])
        for n, d in r["factor_shapes"].items():
            for side, s in d.items():
                f = full[n][side].shape
                assert s == (f[0], e_loc) + f[2:], (n, side, s)
                assert r["inverse_shapes"][n][side + "_inv"] == s
        assert r["wu_stacks"] == {n: (tcfg.n_layers, e_loc)
                                  for n in r["factor_shapes"]
                                  if n.endswith(("wg", "wu", "wd"))}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_router_bitwise_and_checkpoint_restores_on_one_rank(runs, shape):
    """The router (and every replicated leaf) bitwise equal on every rank
    after every step; the loop's last checkpoint, written from the
    gathered state, restores into a one-rank program bitwise."""
    port, _, _, tmp = runs
    res = port[f"train{shape[0]}x{shape[1]}"]
    r0 = res[0]
    assert len(r0["routers"]) == N_STEPS
    for r in res:
        assert r["routers"] == r0["routers"]
        assert r["replicated"] == r0["replicated"]
        assert r["digest"] == r0["digest"]
    _, tcfg = _cfgs()
    like = ttrain.KFACProgram(tcfg, tkfac.KFACConfig(**KCFG),
                              device="cpu").init_state()
    state, manifest = restore(os.path.join(tmp, f"{shape[0]}x{shape[1]}"),
                              like)
    assert manifest["step"] == N_STEPS
    got = r0["state"]
    for k, v in state.params.items():
        assert np.array_equal(v.numpy(), got["params"][k]), k
    for tree, name in ((state.kfac.factors, "factors"),
                       (state.kfac.inverses, "inverses")):
        for n, d in tree.items():
            for s, v in d.items():
                assert np.array_equal(v.numpy(), got[name][n][s]), (n, s)
    assert r0["digest"] == ttrain.params_digest(state.params)


def test_indivisible_experts_stay_replicated(runs):
    """3 experts over 2 model ranks: the experts replicated (the
    reference's rule), attention still sliced, and the loss and gathered
    gradients those of one rank."""
    port, _, params, _ = runs
    _, tcfg = _cfgs(n_experts=3)
    shapes = tsteps.init_params(tcfg, generator=None, device="meta")
    dims = {k: sharding.model_spec_dim(tcfg, k, len(v.shape), 2,
                                       ranks_mod.TP_BLOCK)
            for k, v in shapes.items()}
    assert all(d is None for k, d in dims.items() if "/moe/" in k)
    assert dims["layers/attn/wq"] == 2
    r0 = port["e3"][0]
    want = _one_device_grads(params["e3"], B4, n_experts=3)
    _close_grads(r0["loss"], r0["grads"], *want)
