"""The port's pipeline package on one process: the host-side schedules,
stash plans, partitions, ``stage_specs``, microbatch splitter, slot
allocator, weight-version ledger and bubble policy held equal to the
reference's (``repro.pipeline``); ``make_pipeline_step(pp=1)`` is the
monolithic step; and the model's stage pieces composed in order are
bitwise its ``forward`` (losses, gradients and K-FAC statistics) in
every family the reference pipelines.

The host-side pieces are pure Python and numpy on both sides, so every
comparison is exact. The stage pieces run the same operations as the
monolithic forward, so they are held bitwise. The multi-rank executor
is ``tests/test_torch_dist_pp.py``'s.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_families as fam
from _torch_families import one_thread  # noqa: F401 (autouse)
from repro import pipeline as jpipe
from repro.configs import ARCHS as J_ARCHS
from repro.configs import get_config as j_get_config
from repro.configs import get_smoke_config as j_get_smoke_config
from repro.launch import steps as jsteps
from repro.pipeline import kfac_glue as jglue
from repro_torch import pipeline as tpipe
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.core import kfac as tkfac
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm
from repro_torch.models import whisper as tw
from repro_torch.pipeline import kfac_glue as tglue

GRID = [(1, 1), (2, 1), (2, 2), (2, 4), (3, 5), (4, 8), (4, 2)]
SLOTS = ("op", "mb", "stash_wr", "stash_rd", "recv_st", "recv_rd",
         "grad_st", "grad_rd")


@pytest.mark.parametrize("kind", ["gpipe", "1f1b"])
@pytest.mark.parametrize("S,M", GRID)
def test_schedule_equals_reference(kind, S, M):
    """The tick grid, every slot map and the stash plan."""
    j, t = jpipe.make_schedule(kind, S, M), tpipe.make_schedule(kind, S, M)
    for name in SLOTS:
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name),
                                      err_msg=name)
    assert dataclasses.asdict(t.stash_plan) == \
        dataclasses.asdict(j.stash_plan)
    assert t.summary() == j.summary()
    assert t.bubble_fraction == j.bubble_fraction
    assert [t.idle_ticks(s) for s in range(S)] == \
        [j.idle_ticks(s) for s in range(S)]
    with pytest.raises(ValueError, match="unknown schedule"):
        tpipe.make_schedule("zigzag", S, M)


def _widths():
    assert ARCHS == J_ARCHS
    for arch in ARCHS:
        for smoke in (False, True):
            yield arch, smoke


def _cfg_pair(arch, smoke):
    if smoke:
        return j_get_smoke_config(arch), get_smoke_config(arch)
    return j_get_config(arch), get_config(arch)


def _spec_dicts(specs):
    return {n: dataclasses.asdict(s) for n, s in specs.items()}


@pytest.mark.parametrize("arch,smoke", list(_widths()))
def test_partitions_and_stage_specs_equal_reference(arch, smoke):
    """Free and uniform partitions over S in {2, 3, 4} where they fit,
    their summaries, ``stage_specs``, and the errors the reference
    raises (too many stages, an indivisible uniform cut; the hybrid
    smoke config's one unit fits no S here)."""
    jcfg, tcfg = _cfg_pair(arch, smoke)
    jspecs = jsteps.kfac_specs(jcfg)
    tspecs = tsteps.kfac_specs(tcfg)
    assert _spec_dicts(tspecs) == _spec_dicts(jspecs)
    checked = 0
    for S in (2, 3, 4):
        for uniform in (False, True):
            try:
                jp = jpipe.partition_stages(jcfg, S, require_uniform=uniform)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    tpipe.partition_stages(tcfg, S, require_uniform=uniform)
                assert str(got.value) == str(e)
                continue
            tp = tpipe.partition_stages(tcfg, S, require_uniform=uniform)
            assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
            assert tp.summary() == jp.summary() and tp.uniform == jp.uniform
            got = tglue.stage_specs(tspecs, tp)
            want = jglue.stage_specs(jspecs, jp)
            assert [_spec_dicts(d) for d in got] == \
                [_spec_dicts(d) for d in want]
            checked += 1
    assert checked or tpipe.partition_stages(tcfg, 1).n_layers < 2


def test_published_partitions():
    """The partitions of the published widths the pipeline's card phase
    and ROADMAP name: qwen1.5-0.5b's head pins 6 of 24 layers to the
    last stage."""
    want = {"qwen1.5-0.5b": (18, 6), "moonshot-v1-16b-a3b": (26, 22),
            "falcon-mamba-7b": (33, 31), "qwen2-vl-7b": (15, 13),
            "recurrentgemma-9b": (7, 5)}
    for arch, counts in want.items():
        assert tpipe.partition_stages(get_config(arch), 2).layer_counts() \
            == counts, arch


def _mrope_batch():
    return {"tokens": np.arange(8 * 6).reshape(8, 6),
            "positions": np.arange(3 * 8 * 6).reshape(3, 8, 6),
            "img_embeds": np.arange(8 * 2 * 4, dtype=np.float32)
            .reshape(8, 2, 4)}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_split_microbatches_equals_reference(n):
    """Every leaf's microbatch layout, M-RoPE planes included, and the
    accumulation's microbatches are those slices."""
    b = _mrope_batch()
    j = jpipe.split_microbatches({k: jnp.asarray(v) for k, v in b.items()},
                                 n)
    t = tpipe.split_microbatches({k: torch.from_numpy(v)
                                  for k, v in b.items()}, n)
    assert set(t) == set(j)
    for k in b:
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(j[k]))
    assert t["positions"].shape == (n, 3, 8 // n, 6)
    rows = tsteps.batch_rows({k: torch.from_numpy(v) for k, v in b.items()},
                             0, 8 // n)
    for k in b:
        assert torch.equal(rows[k], t[k][0]), k


def test_split_microbatches_error_equals_reference():
    b = {"tokens": np.zeros((6, 4), np.int32)}
    with pytest.raises(ValueError) as want:
        jpipe.split_microbatches({"tokens": jnp.asarray(b["tokens"])}, 4)
    with pytest.raises(ValueError) as got:
        tpipe.split_microbatches({"tokens": torch.from_numpy(b["tokens"])},
                                 4)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="n_micro must be"):
        tpipe.split_microbatches({"tokens": torch.from_numpy(b["tokens"])},
                                 0)


def _drive(mod, ops):
    """Run ``ops`` on a fresh SlotAllocator of ``mod``: the results, or
    the error's text where one raises."""
    al = mod.SlotAllocator()
    out = []
    for op, arg in ops:
        try:
            out.append(al.alloc() if op == "alloc" else al.free(arg))
        except ValueError as e:
            out.append(str(e))
        out.append((al.peak, al.n_live))
    return out


def test_slot_allocator_equals_reference():
    ops = [("alloc", None)] * 3 + [("free", 1), ("alloc", None),
                                   ("free", 0), ("free", 0),
                                   ("alloc", None), ("alloc", None),
                                   ("free", 7)]
    assert _drive(tpipe, ops) == _drive(jpipe, ops)


def _ledger(mod, ops, depth=1):
    ws = mod.WeightStash(depth=depth)
    out = []
    for op, mb in ops:
        try:
            if op == "f":
                out.append(ws.forward(mb))
            elif op == "b":
                out.append(ws.backward(mb))
            elif op == "u":
                out.append(ws.commit_update())
            else:
                ws.reset()
                out.append("reset")
        except mod.ExactlyOnceViolation as e:
            out.append(str(e))
        out.append(ws.in_flight)
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_weight_stash_equals_reference(depth):
    """Forwards, backwards, updates with microbatches in flight, a
    version gap, a double forward, a backward without a forward, and a
    reset."""
    ops = [("f", 0), ("f", 1), ("u", None), ("b", 0), ("b", 1),
           ("u", None), ("f", 2), ("u", None), ("f", 3), ("b", 2),
           ("f", 3), ("b", 5), ("r", None), ("u", None), ("f", 0),
           ("b", 0), ("u", None)]
    assert _ledger(tpipe, ops, depth) == _ledger(jpipe, ops, depth)


class _Refresher:
    """A stand-in refresher: counts its steps and tags the state."""

    def __init__(self):
        self.n = 0

    def step(self, kstate):
        self.n += 1
        return {"refreshed": self.n, "was": kstate}


@pytest.mark.parametrize("kind", ["gpipe", "1f1b"])
@pytest.mark.parametrize("S,M", [(2, 2), (4, 8)])
def test_bubble_refresh_equals_reference(kind, S, M):
    """One inv trigger under a pipelined step on one rank: the refresher
    stepped once, the bubble budget reported as the reference's, and the
    bubble accounting functions alike."""
    out = {}
    for name, pipe, glue in (("port", tpipe, tglue),
                             ("ref", jpipe, jglue)):
        sched = pipe.make_schedule(kind, S, M)
        r = _Refresher()
        kst, info = glue.bubble_refresh(r, "state", sched)
        out[name] = (kst, info, r.n, glue.bubble_ticks(sched),
                     [glue.inv_fits_bubbles(sched, f, 10.0)
                      for f in (10.0, 20.0, 40.0, 80.0)])
    assert out["port"] == out["ref"]
    assert out["port"][0] == {"refreshed": 1, "was": "state"}


def test_pipeline_step_pp1_is_make_train_step():
    """``make_pipeline_step(pp=1)`` is the monolithic step: bitwise the
    same state and metrics; ``pp`` > 1 needs a stage mesh."""
    cfg = dataclasses.replace(get_smoke_config("qwen1.5-0.5b"),
                              dtype="float32")
    kcfg = tkfac.KFACConfig(block_size=32, stats_batch=4, stats_seq=16)
    params = tlm.init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    specs = tsteps.kfac_specs(cfg)
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 16)))}
    outs = []
    for make in (tsteps.make_train_step,
                 lambda c, k: tsteps.make_pipeline_step(c, k, pp=1)):
        st = tsteps.TrainState(dict(params),
                               tkfac.init(params, specs, kcfg))
        outs.append(make(cfg, kcfg)(st, batch))
    (s0, m0), (s1, m1) = outs
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(s0.params[k], s1.params[k]) for k in s0.params)
    assert all(torch.equal(s0.kfac.momentum[k], s1.kfac.momentum[k])
               for k in s0.kfac.momentum)
    with pytest.raises(ValueError, match="stage"):
        tsteps.make_pipeline_step(cfg, kcfg, pp=2)


# ---------------------------------------------------------------------------
# the stage pieces composed are the forward
# ---------------------------------------------------------------------------

FAMILIES = [("qwen1.5-0.5b", {}), ("phi3.5-moe-42b-a6.6b", {}),
            ("falcon-mamba-7b", {}), ("qwen2-vl-7b", {}),
            ("recurrentgemma-9b", {"n_layers": 10}), ("whisper-tiny", {})]


def _family_inputs(arch, over, dtype):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype, **over)
    mod = tsteps.model_module(cfg)
    params = mod.init(cfg, generator=torch.Generator().manual_seed(0),
                      device="cpu")
    rng = np.random.default_rng(1)
    b, t = 4, 16
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, (b, t)).astype(np.int64))}
    if cfg.family == "vlm":
        batch.update(fam.tbatch(fam.vlm_extras(cfg, b, t, 1)))
    if cfg.family == "audio":
        batch["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, 12, cfg.d_model)).astype(np.float32))
    return cfg, params, batch


def _piecewise(cfg, params, batch, part, taps=None, collect=False,
               block=None):
    """The loss (and statistics) through the stage pieces, each stage on
    its own leaves (``dist.sharding.StageShards``' cut)."""
    from repro_torch.dist import sharding

    stats: dict = {}
    x = None
    kw = dict(taps=taps, collect=collect, soi_block=block)
    for s in range(part.n_stages):
        st = sharding.stage_layout(cfg, part, s)
        p = sharding.stage_local_params(params, st)
        tp = None if taps is None else {
            n: v[slice(*st.ranges[n.split("/")[0]])]
            if st.kind(n) == "stacked" else v
            for n, v in taps.items() if st.holds(n)}
        kw["taps"] = tp
        if cfg.family == "audio":
            t_enc = batch["enc_embeds"].shape[1]
            x0 = tw.stage_channel_init(cfg, p, batch) if s == 0 else x
            x, got = tw.stage_slice_forward(cfg, p, x0, t_enc, **kw)
        else:
            pos = tlm.batch_positions(batch)
            x0 = tlm.embed_inputs(cfg, p, batch) if s == 0 else x
            x, got = tlm.stage_slice_forward(cfg, p, x0, pos, **kw)
            if st.last:
                x, tail = tlm.tail_forward(cfg, p, x, pos, **kw)
                got = {**tail, **got}
        for n, v in got.items():
            stats.setdefault(n, []).append(v)
    mod = tsteps.model_module(cfg)
    loss = mod.head_loss(cfg, p, x, batch)
    return loss, {n: v[0] if len(v) == 1 else torch.cat(v)
                  for n, v in stats.items()}


@pytest.mark.parametrize("arch,over", FAMILIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stage_pieces_compose_to_forward_bitwise(arch, over, dtype):
    """Embedding, each stage's slice (the free partition over 2 stages
    and the uniform one over every atom), the hybrid tail and the head:
    the loss and every gradient bitwise ``loss_fn``'s. Whisper's every
    stage with decoder layers recomputes ``enc_out`` from the channel
    (the reference's design), so with several decoder stages (the
    per-atom partition) the encoder's gradients sum each stage's
    cotangent of ``enc_out`` apart: there they are held within 1e-5 of
    each leaf's largest entry (fp32) or 2% (bf16), the loss bitwise."""
    cfg, params, batch = _family_inputs(arch, over, dtype)
    mod = tsteps.model_module(cfg)
    leaves = list(params)

    def grads_of(fn):
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = fn(p)
        return loss.detach(), torch.autograd.grad(
            loss, [p[k] for k in leaves], allow_unused=True)

    want_loss, want = grads_of(lambda p: mod.loss_fn(cfg, p, batch)[0])
    n_atoms = tpipe.partition_stages(cfg, 1).n_layers
    for part in (tpipe.partition_stages(cfg, 2),
                 tpipe.partition_stages(cfg, n_atoms)):
        loss, got = grads_of(lambda p: _piecewise(cfg, p, batch, part)[0])
        assert torch.equal(loss, want_loss), part
        dec_stages = sum(part.enc_dec_counts(s)[1] > 0
                         for s in range(part.n_stages)) \
            if part.atom == "encdec" else 1
        tol = (1e-5 if dtype == "float32" else 2e-2) \
            if dec_stages > 1 else 0.0
        for k, g, w in zip(leaves, got, want):
            assert (g is None) == (w is None), k
            if g is None:
                continue
            err = float(torch.max(torch.abs(g.float() - w.float())))
            assert err <= tol * float(torch.max(torch.abs(w.float()))), \
                (k, part, err)


@pytest.mark.parametrize("arch,over", FAMILIES)
def test_stage_pieces_statistics_bitwise(arch, over):
    """With taps and ``collect``: every A statistic and tap gradient of
    the stages together bitwise the monolithic pass's."""
    cfg, params, batch = _family_inputs(arch, over, "float32")
    specs = tsteps.kfac_specs(cfg)
    mod = tsteps.model_module(cfg)

    def run(fn):
        taps = tsteps.build_taps(cfg, specs, batch)
        with torch.enable_grad():
            loss, stats = fn(taps)
            g = torch.autograd.grad(loss, list(taps.values()))
        return loss, stats, dict(zip(taps, g))

    want = run(lambda tp: mod.loss_fn(cfg, params, batch, taps=tp,
                                      collect=True, soi_block=32))
    got = run(lambda tp: _piecewise(cfg, params, batch,
                                    tpipe.partition_stages(cfg, 2), tp,
                                    True, 32))
    assert torch.equal(got[0], want[0])
    for i in (1, 2):
        assert set(got[i]) == set(want[i])
        for n in want[i]:
            assert torch.equal(got[i][n], want[i][n]), (i, n)
