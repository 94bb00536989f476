"""The JAX reference's MoE train path on a forced multi-device CPU mesh,
for ``tests/test_torch_dist_ep.py``.

The device count is fixed when JAX starts, so the test runs this file
once in a subprocess:

  JAX_PLATFORMS=cpu OMP_NUM_THREADS=1 \\
  XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
      python tests/_torch_ep_reference.py IN.npz OUT.npz

``IN.npz`` holds ``arch``, the weights (``p/<path>``, the port's flat
paths) and, for each case ``<name>``, ``<name>/tokens`` and
``<name>/spec`` (data ranks, model ranks, ``train_accum``). Each case
runs the reference's train step (``launch.steps.make_train_step``,
fp32 compute) on an ``Auto`` ``(data, model)`` mesh of that shape, where
its MoE layers take the ``shard_map`` fast path (each data shard routes
its own tokens against its share of the capacity, the experts over
``model``). ``OUT.npz`` holds ``<name>/loss``, ``<name>/g/<path>`` (the
gradients the step hands its WU) and ``<name>/fast_calls`` (the fast
path's traced calls).
"""

from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config
from repro.core import kfac as jkfac
from repro.core.kfac import KFACConfig
from repro.launch import steps as jsteps
from repro.models import lm, moe


def _nest(flat):
    out: dict = {}
    for path, v in flat.items():
        *head, leaf = path.split("/")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[leaf] = jnp.asarray(v)
    return out


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def main(inp: str, out_path: str) -> None:
    d = np.load(inp)
    cfg = dataclasses.replace(get_smoke_config(str(d["arch"])),
                              dtype="float32")
    params = _nest({k[2:]: d[k] for k in d.files if k.startswith("p/")})
    names = sorted({k.split("/")[0] for k in d.files if k.endswith("/spec")})

    # the WU is not compared: hand back the gradients it would take
    jsteps._wu_tail = lambda state, loss, grads, *a: (
        state, {"loss": loss, "grads": grads})
    calls = []
    fast = moe._moe_fast

    def counting(*a, **k):
        calls.append(1)
        return fast(*a, **k)

    moe._moe_fast = counting
    out = {}
    for name in names:
        n_data, n_model, accum = (int(x) for x in d[f"{name}/spec"])
        c = dataclasses.replace(cfg, train_accum=accum)
        kcfg = KFACConfig(block_size=c.soi_block)
        mesh = jax.make_mesh(
            (n_data, n_model), ("data", "model"),
            axis_types=(jax.sharding.AxisType.Auto,) * 2)
        state = jsteps.TrainState(params, jkfac.init(
            params, lm.kfac_specs(c), kcfg))
        del calls[:]
        with jax.set_mesh(mesh):
            _, m = jax.jit(jsteps.make_train_step(c, kcfg))(
                state, {"tokens": jnp.asarray(d[f"{name}/tokens"])})
        out[f"{name}/loss"] = np.asarray(m["loss"])
        out[f"{name}/fast_calls"] = np.asarray(len(calls))
        for k, v in _flatten(jax.device_get(m["grads"])).items():
            out[f"{name}/g/{k}"] = v
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
