"""The JAX reference's pipeline program on a forced multi-device CPU mesh,
for ``tests/test_torch_dist_pp.py``.

The device count is fixed when JAX starts, so the test runs this file
once in a subprocess:

  JAX_PLATFORMS=cpu OMP_NUM_THREADS=1 \\
  XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
      python tests/_torch_pp_reference.py IN.npz OUT.npz

``IN.npz`` holds, for each case ``<name>``: ``<name>/arch_over`` (JSON:
``arch`` and the smoke config's overrides), ``<name>/spec``
(stage, data and model ranks, microbatches), the weights
(``<name>/p/<path>``, the port's flat paths) and the batch
(``<name>/b/<leaf>``). Each case runs the reference's
``pipeline.make_pipeline_grads_fn`` (the free partition, 1F1B, fp32
compute) on a ``(stage, data, model)`` mesh of ``Auto`` axes, built here
with ``jax.make_mesh``: ``launch.mesh.make_pipeline_mesh``'s default
axes are Explicit under jax 0.9.0, where the non-uniform and MoE cases
fail (ROADMAP, "Reference caveats"). ``OUT.npz`` holds ``<name>/loss``
and ``<name>/g/<path>``.
"""

from __future__ import annotations

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from repro import pipeline
from repro.configs import get_smoke_config
from repro_torch.convert import _flatten, _nest


def main(inp: str, out_path: str) -> None:
    d = np.load(inp)
    names = sorted({k.split("/")[0] for k in d.files if k.endswith("/spec")})
    out = {}
    for name in names:
        over = json.loads(str(d[f"{name}/arch_over"]))
        cfg = dataclasses.replace(get_smoke_config(over.pop("arch")),
                                  dtype="float32", **over)
        n_stage, n_data, n_model, n_micro = (int(x)
                                             for x in d[f"{name}/spec"])
        pre_p, pre_b = f"{name}/p/", f"{name}/b/"
        params = jax.tree.map(jnp.asarray, _nest(
            {k[len(pre_p):]: d[k] for k in d.files if k.startswith(pre_p)}))
        batch = {k[len(pre_b):]: jnp.asarray(d[k]) for k in d.files
                 if k.startswith(pre_b)}
        mesh = jax.make_mesh(
            (n_stage, n_data, n_model), ("stage", "data", "model"),
            axis_types=(jax.sharding.AxisType.Auto,) * 3)
        fn = pipeline.make_pipeline_grads_fn(
            cfg, pipeline.partition_stages(cfg, n_stage),
            pipeline.make_schedule("1f1b", n_stage, n_micro), mesh)
        with jax.set_mesh(mesh):
            loss, grads = jax.jit(fn)(
                params, pipeline.split_microbatches(batch, n_micro))
        out[f"{name}/loss"] = np.asarray(loss)
        for k, v in _flatten(jax.device_get(grads)).items():
            out[f"{name}/g/{k}"] = np.asarray(v)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
