"""repro_torch.obs against the JAX reference's ``repro.obs``: the same
metric operations, events and spans give the same Prometheus text,
console summary, JSONL lines and Chrome-trace events (times, process
and thread ids aside). Then what the port does its own way: fences are
``torch.cuda.synchronize`` on the target's card, annotations are
``torch.profiler.record_function``, a tap drain is one ``.cpu()``, and
the training CLI's drill writes the three artifacts."""

from __future__ import annotations

import json
import math
import os

import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.obs as tobs
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as ttrain
from repro_torch.obs import trace as ttrace

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


def _drive_registry(mod):
    reg = mod.MetricsRegistry()
    reg.counter("req_total", "requests").inc(3, mode="paged")
    reg.counter("req_total").inc(mode="static")
    reg.counter("idle_total", "never touched")
    reg.gauge("train_loss", "last loss").set(2.5)
    h = reg.histogram("lat_s", "latency", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    ph = reg.histogram("train_phase_s", "per-phase wall")
    for v, p in ((0.01, "wu"), (0.2, "train"), (0.003, "inv"), (3.0, "wu")):
        ph.observe(v, phase=p)
    return reg


def test_registry_and_exporters_match_reference():
    t, j = _drive_registry(tobs), _drive_registry(jobs)
    assert t.snapshot() == j.snapshot()
    assert tobs.prometheus_text(t) == jobs.prometheus_text(j)
    assert tobs.console_summary(t, title="s") == \
        jobs.console_summary(j, title="s")
    q = t.histogram("train_phase_s").quantile(0.5, phase="wu")
    assert q == j.histogram("train_phase_s").quantile(0.5, phase="wu")


def test_jsonl_matches_reference(tmp_path):
    records = [{"kind": "step", "t": 1.0 + i, "i": i,
                "v": np.float32(0.5) * i, "nested": {"a": [i, None]}}
               for i in range(12)]
    for mod, name in ((tobs, "t"), (jobs, "j")):
        with mod.JsonlWriter(str(tmp_path / f"{name}.jsonl"),
                             max_bytes=400) as w:
            for r in records:
                w.write(dict(r))
    for suffix in ("", ".1"):
        assert (tmp_path / f"t.jsonl{suffix}").read_bytes() == \
            (tmp_path / f"j.jsonl{suffix}").read_bytes()


def _drive_tracer(mod, **kw):
    tr = mod.Tracer(max_events=5, **kw)
    with tr.span("outer", args={"step": 1}):
        with tr.span("inner", cat="compute"):
            pass
    with pytest.raises(RuntimeError):
        with tr.span("boom", fence=lambda: 1 / 0):   # fence skipped
            raise RuntimeError("inner failure")
    tr.instant("recovery", args={"step": 4, "lost": 0})
    for i in range(3):
        with tr.span(f"s{i}"):
            pass
    return tr.to_chrome()


def test_tracer_events_match_reference():
    t, j = _drive_tracer(ttrace), _drive_tracer(jobs.trace)
    strip = ("ts", "dur", "pid", "tid")
    assert [{k: v for k, v in e.items() if k not in strip}
            for e in t["traceEvents"]] == \
        [{k: v for k, v in e.items() if k not in strip}
         for e in j["traceEvents"]]
    assert t["displayTimeUnit"] == j["displayTimeUnit"]
    for k in ("n_events", "n_dropped"):
        assert t["otherData"][k] == j["otherData"][k]
    assert t["otherData"]["n_dropped"] == 2     # s1, s2 past the cap


def test_span_fence_synchronizes_the_targets_card(monkeypatch):
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    tr = tobs.Tracer()
    with tr.span("cpu", fence=torch.ones(2)):
        pass
    assert synced == []                 # a CPU target needs no fence
    card = torch.device("cuda", 0)
    with tr.span("card", fence=lambda: {"a": [card, torch.ones(1)]}):
        pass
    assert synced == [card]
    with tr.span("no_fence"):
        pass
    assert synced == [card]
    cats = [e["cat"] for e in tr.to_chrome()["traceEvents"]]
    assert cats == ["compute", "compute", "dispatch"]


def test_span_annotation_is_a_profiler_range():
    from torch.profiler import ProfilerActivity, profile

    tr = tobs.Tracer(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tr.span("phase:train"):
            torch.ones(4).sum()
    assert "phase:train" in {e.name for e in prof.events()}


def test_tapbuffer_one_transfer_per_drain(monkeypatch):
    calls = []
    real = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    buf = tobs.TapBuffer()
    expect = {}
    for step in range(5):
        m = {"loss": torch.tensor(step * 1.5),
             "gnorm": torch.tensor(step + 0.25),
             "aux": torch.tensor(step, dtype=torch.int32),
             "phase_s": {"train": 0.1 * step}, "flag": 1.0}
        expect[step] = {"loss": step * 1.5, "gnorm": step + 0.25,
                        "aux": float(step), "phase_s": {"train": 0.1 * step},
                        "flag": 1.0}
        buf.push(step, m)
    assert len(buf) == 5
    rows = buf.drain()
    assert len(calls) == 1              # ONE transfer for 15 tensors
    assert len(buf) == 0 and buf.n_drains == 1
    assert dict(rows) == expect
    assert all(isinstance(r["loss"], float) for _, r in rows)
    assert buf.drain() == [] and buf.n_drains == 1   # empty: no transfer
    assert len(calls) == 1


def test_tapbuffer_clear_drops_without_reading(monkeypatch):
    def boom(self, *a, **k):
        raise AssertionError("clear must not read the tensors")

    buf = tobs.TapBuffer()
    buf.push(0, {"m": torch.tensor(1.0)})
    monkeypatch.setattr(torch.Tensor, "cpu", boom)
    buf.clear()
    assert len(buf) == 0 and buf.drain() == []


def test_with_taps_bitwise_parity_and_collision():
    def step(state, batch):
        w = state["w"] + batch.sum(0)
        return {"w": w, "t": state["t"] + 1}, {"loss": (w * w).sum()}

    taps = {"w_norm": lambda st, m: torch.sqrt((st["w"] ** 2).sum()),
            "loss_sq": lambda st, m: m["loss"] ** 2}
    state0 = {"w": torch.arange(8, dtype=torch.float32) / 7.0,
              "t": torch.tensor(0)}
    batch = torch.randn(4, 8, generator=torch.Generator().manual_seed(0))
    s_base, m_base = step(state0, batch)
    s_tap, m_tap = tobs.with_taps(step, taps)(state0, batch)
    for k in s_base:
        assert torch.equal(s_base[k], s_tap[k])
    assert set(m_tap) == {"loss", "w_norm", "loss_sq"}
    assert float(m_tap["w_norm"]) == pytest.approx(
        float(torch.sqrt((s_base["w"] ** 2).sum())))
    with pytest.raises(ValueError, match="collides"):
        tobs.with_taps(step, {"loss": lambda st, m: m["loss"]})(
            state0, batch)


def test_null_obs_is_inert(tmp_path):
    assert not tobs.NULL.enabled
    tobs.NULL.counter("x_total").inc()
    with tobs.NULL.span("s", fence=torch.device("cuda", 0)):
        pass                            # disabled: no fence either
    tobs.NULL.event("e", a=1)
    tobs.NULL.write({"kind": "r"})
    assert tobs.NULL.flush() == {}
    assert len(tobs.NULL.tracer) == 0
    assert list(tmp_path.iterdir()) == []


def test_flush_writes_the_reference_artifacts(tmp_path):
    paths = {}
    for mod, name in ((tobs, "t"), (jobs, "j")):
        o = mod.Observability(out_dir=str(tmp_path / name))
        o.counter("a_total").inc()
        with o.span("s"):
            pass
        o.event("ev", x=1)
        paths[name] = o.flush(summary={"kind": "run_summary", "n": 3})
        o.close()
    assert {k: os.path.basename(v) for k, v in paths["t"].items()} == \
        {k: os.path.basename(v) for k, v in paths["j"].items()} == \
        {"jsonl": "events.jsonl", "prom": "metrics.prom",
         "trace": "trace.json"}

    def lines(p):
        return [{k: v for k, v in json.loads(l).items() if k != "t"}
                for l in open(p)]

    assert lines(paths["t"]["jsonl"]) == lines(paths["j"]["jsonl"])
    assert open(paths["t"]["prom"]).read() == open(paths["j"]["prom"]).read()


def test_from_args():
    class A:
        obs = False
        obs_dir = None
        obs_annotate = False

    assert tobs.from_args(A()) is tobs.NULL
    a = A()
    a.obs, a.obs_annotate = True, True
    o = tobs.from_args(a)
    assert o.enabled and o.out_dir is None and o.tracer.annotate


def test_program_phase_spans_and_histogram():
    obs = tobs.Observability()
    prog = ttrain.KFACProgram(get_smoke_config(ARCH),
                              ttrain.KFACConfig(block_size=32,
                                                stats_batch=2, stats_seq=16),
                              device="cpu", obs=obs)
    state = prog.init_state()
    toks = torch.randint(0, 100, (2, 16),
                         generator=torch.Generator().manual_seed(0))
    _, m = prog.make_step(state)(state, {"tokens": toks})
    names = [e["name"] for e in obs.tracer.to_chrome()["traceEvents"]]
    # wu is timed inside train, so its span closes first
    assert names == ["phase:stats", "phase:inv", "phase:wu", "phase:train"]
    h = obs.histogram("train_phase_s")
    for phase, secs in m["phase_s"].items():
        assert h.count(phase=phase) == 1
        assert h.sum(phase=phase) == pytest.approx(secs)


def _events(path):
    return [json.loads(l) for l in open(path)]


@pytest.mark.parametrize("smw", [False, True])
def test_cli_drill_writes_the_three_artifacts(tmp_path, smw):
    """The CPU drill of the README: 12 steps, a failure at step 6 with
    no checkpoint yet (the default cadence is 20), so the loop restarts
    from the initial state and replays steps 0-5."""
    obs_dir = tmp_path / "obs"
    s = ttrain.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                     "--steps", "12", "--batch", "2", "--seq", "16",
                     "--ckpt-dir", str(tmp_path / "ck"),
                     "--inject-failure-at", "6", "--obs-dir", str(obs_dir)]
                    + (["--smw"] if smw else []))
    assert s["recoveries"] == 1 and s["steps"] == 12
    assert [h["step"] for h in s["history"]] == \
        list(range(6)) + list(range(12))
    assert s["losses"][:6] == s["losses"][6:12]     # the replay
    assert all(math.isfinite(x) for x in s["losses"])
    rows = _events(obs_dir / "events.jsonl")
    kinds = [r["kind"] for r in rows]
    assert kinds.count("train_step") == 18          # one an executed step
    assert [r for r in rows if r["kind"] == "recovery"] == [
        {**r, "step": 6, "error": "DeviceLoss", "lost": 0}
        for r in rows if r["kind"] == "recovery"]
    assert kinds.count("recovery") == 1
    assert kinds[-1] == "train_summary" and rows[-1]["recoveries"] == 1
    trace = json.load(open(obs_dir / "trace.json"))["traceEvents"]
    spans = {e["name"] for e in trace}
    assert {"phase:train", "phase:wu", "train_step",
            "ckpt_save_dispatch"} <= spans
    assert ({"phase:smw"} if smw else {"phase:stats", "phase:inv"}) <= spans
    prom = (obs_dir / "metrics.prom").read_text()
    need = ["train_steps_total 18", "train_recoveries_total 1",
            "train_checkpoints_total 1", "train_step_wall_s_count 18",
            'train_phase_s_count{phase="train"} 18']
    if smw:
        need += ["solve_smw_drift", "solve_smw_fallback_total"]
    for n in need:
        assert n in prom, n
