"""repro_torch.checkpoint: round trip, atomicity, the async manager and
its garbage collection, and the on-disk format across packages (a
checkpoint the reference's ``repro.checkpoint.save`` wrote is read by
the port's ``restore``, and the reverse). Values are held bitwise: the
files carry the arrays as they are."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore as j_restore, save as j_save
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.checkpoint.store import _flatten
from repro_torch.configs import get_smoke_config
from repro_torch.core import kfac
from repro_torch.launch import train as ttrain


@dataclasses.dataclass
class TState:
    step: int
    params: Any
    opt: Any


class JState(NamedTuple):
    step: Any
    params: Any
    opt: Any


def _arrays(seed):
    r = np.random.default_rng(seed)
    return dict(w=r.standard_normal((8, 16)).astype(np.float32),
                b=r.standard_normal(16).astype(np.float32),
                m=r.standard_normal((2, 3)).astype(np.float32),
                i=r.integers(0, 100, (5,)).astype(np.int32))


def _tstate(seed, step=3):
    a = _arrays(seed)
    return TState(step=step,
                  params={"layers/attn/wq": torch.from_numpy(a["w"]),
                          "nested": {"b": torch.from_numpy(a["b"])}},
                  opt=[torch.from_numpy(a["m"]), (torch.from_numpy(a["i"]),)])


def _jstate(seed, step=3):
    a = _arrays(seed)
    return JState(step=jnp.asarray(step, jnp.int32),
                  params={"layers/attn/wq": jnp.asarray(a["w"]),
                          "nested": {"b": jnp.asarray(a["b"])}},
                  opt=[jnp.asarray(a["m"]), (jnp.asarray(a["i"]),)])


KEYS = [".opt|0", ".opt|1|0", ".params|layers/attn/wq", ".params|nested|b",
        ".step"]


def _assert_same(t: TState, ref: TState):
    assert isinstance(t.step, int) and t.step == ref.step
    for got, want in ((t.params["layers/attn/wq"], ref.params["layers/attn/wq"]),
                      (t.params["nested"]["b"], ref.params["nested"]["b"]),
                      (t.opt[0], ref.opt[0]), (t.opt[1][0], ref.opt[1][0])):
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    path = save(d, 7, _tstate(0), meta={"cursor": {"step": 7}})
    assert path == os.path.join(d, "step_0000000007")
    assert latest_step(d) == 7
    got, manifest = restore(d, _tstate(1, step=0))
    assert manifest == {"step": 7, "meta": {"cursor": {"step": 7}},
                        "keys": KEYS}
    _assert_same(got, _tstate(0))
    assert isinstance(got.opt[1], tuple) and isinstance(got, TState)


def test_restore_places_leaves_on_the_like_device(tmp_path):
    d = str(tmp_path / "ck")
    save(d, 1, {"a": torch.ones(3), "m": np.arange(4)})
    got, _ = restore(d, {"a": torch.zeros(3, device="meta"),
                         "m": np.zeros(4)})
    assert got["a"].device.type == "meta"
    assert isinstance(got["m"], np.ndarray)
    np.testing.assert_array_equal(got["m"], np.arange(4))


def test_train_state_roundtrip(tmp_path):
    """The K-FAC program's whole state, its host-int step included."""
    prog = ttrain.KFACProgram(get_smoke_config("qwen1.5-0.5b"),
                              kfac.KFACConfig(block_size=32), device="cpu")
    state = prog.init_state()
    state.kfac.step = 5
    d = str(tmp_path / "ck")
    save(d, 5, state)
    got, _ = restore(d, prog.init_state())
    assert got.kfac.step == 5 and isinstance(got.kfac.step, int)
    want = _flatten(state)
    assert _flatten(got).keys() == want.keys()
    for k, v in _flatten(got).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_latest_of_many_and_gc(tmp_path):
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d, keep=2)
    for s in (5, 10, 15, 20):
        mgr.save_async(s, _tstate(s, step=s), meta={"cursor": {"step": s}})
    mgr.wait()
    assert latest_step(d) == 20
    assert sorted(os.listdir(d)) == ["step_0000000015", "step_0000000020"]
    got, _ = restore(d, _tstate(0), step=15)
    _assert_same(got, _tstate(15, step=15))


def test_async_save_snapshots_before_returning(tmp_path):
    """The snapshot is taken on the call: writing to the live tensors
    afterwards does not reach the checkpoint."""
    d = str(tmp_path / "ck")
    mgr = CheckpointManager(d)
    live = _tstate(0)
    mgr.save_async(1, live)
    live.params["nested"]["b"].add_(1.0)
    live.opt[0].zero_()
    mgr.wait()
    got, _ = restore(d, _tstate(2))
    _assert_same(got, _tstate(0))


def test_async_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(str(blocker))
    mgr.save_async(1, _tstate(0))
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()                      # the error is raised once


def test_atomic_no_partial_visible(tmp_path):
    d = str(tmp_path / "ck")
    save(d, 1, _tstate(0))
    os.makedirs(os.path.join(d, "step_0000000002.tmp"))
    os.makedirs(os.path.join(d, "step_0000000003"))   # no manifest yet
    assert latest_step(d) == 1
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore(str(tmp_path / "none"), _tstate(0))


def test_restore_missing_leaf_raises(tmp_path):
    d = str(tmp_path / "ck")
    save(d, 1, {"a": torch.ones(3)})
    with pytest.raises(KeyError, match="extra"):
        restore(d, {"a": torch.ones(3), "extra": torch.ones(2)})


def test_unsupported_leaf_raises(tmp_path):
    with pytest.raises(TypeError):
        save(str(tmp_path / "ck"), 1, {"a": "text"})


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    d = str(tmp_path / "ck")
    j_save(d, 9, _jstate(4, step=9), meta={"cursor": {"step": 9}})
    got, manifest = restore(d, _tstate(0, step=0))
    with open(os.path.join(d, "step_0000000009", "manifest.json")) as f:
        assert manifest == json.load(f)
    assert manifest["keys"] == KEYS and manifest["step"] == 9
    _assert_same(got, _tstate(4, step=9))


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    d = str(tmp_path / "ck")
    save(d, 11, _tstate(6, step=11), meta={"cursor": {"step": 11}})
    got, manifest = j_restore(d, _jstate(0, step=0))
    assert manifest["keys"] == KEYS and manifest["meta"] == {
        "cursor": {"step": 11}}
    assert int(got.step) == 11
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(_jstate(6, 11))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the files themselves: the reference's reader sees the same arrays
    with np.load(os.path.join(d, "step_0000000011", "arrays.npz")) as z:
        assert sorted(z.files) == KEYS
        np.testing.assert_array_equal(z[".params|nested|b"],
                                      _arrays(6)["b"])
