"""Name-pattern sharding rules for params, K-FAC state and batches, as
pure spec functions (counterpart of ``repro.dist.sharding``).

A spec is a tuple with one entry per dim: None, an axis name, or a tuple
of axis names, cleaned for a mesh by :func:`repro_torch.dist.api.clean_spec`
(dims that do not divide degrade to replication). The layout scheme is
the reference's:

* **column-parallel** linears (wq/wk/wv, wg/wu, w1, the SSM and RG-LRU
  input projections, img_proj): ``(*stack, d_in/'data', d_out/'model')``;
* **row-parallel** linears (wo, wd, w2, out_proj, out): the transpose;
* **MoE expert weights** put the expert dim on ``model``;
* ``embed (V, D) -> ('model', 'data')``, ``lm_head (D, V) -> ('data',
  'model')``; 1-D params replicate; scanned stacks ride ``stage``;
* **K-FAC factors** ``(*stack, nb, bs, bs)``: the block-index dim
  follows the mesh axis of the weight dim it preconditions (A -> d_in's,
  G -> d_out's), the image of "each SOI block on its own INV crossbar
  group".

The port's data-parallel trainer replicates the params (each rank holds
them whole); these specs are the layout that tensor-parallel placement
will map onto DTensor placements (``--model-parallel``, ROADMAP Queue 1
item 8). The reference's cache and pool shardings wait for serving on a
mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.dist.api import (
    BATCH_AXES,
    DATA,
    MODEL,
    STAGE,
    clean_spec,
    mesh_axes,
)

# trailing path component -> parallelism class
_COL = {
    "wq", "wk", "wv",                    # attention inputs
    "wg", "wu", "w1",                    # MLP up/gate
    "in_proj", "x_proj", "dt_proj",      # mamba
    "in_x", "in_gate", "w_a", "w_x",     # rg-lru
    "img_proj",                          # VLM frontend
}
_ROW = {"wo", "wd", "w2", "out_proj", "out"}

_MOE_EXPERT = {"wg", "wu", "wd"}


def _param_pspec(name: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Spec of the weight at path ``name`` with ``ndim`` dims. The leading
    dim of a scanned stack (``layers/``, ``units/``, ``enc/``, ``dec/``)
    rides ``stage``; other stack dims replicate, except the MoE expert
    dim, which rides ``model``."""
    base = name.rsplit("/", 1)[-1]

    def staged(spec: Tuple[Optional[str], ...]):
        stacked = name.startswith(("layers/", "units/", "enc/", "dec/"))
        if stacked and ndim >= 2 and spec[0] is None:
            return (STAGE,) + spec[1:]
        return spec

    if ndim < 2:
        return (None,) * ndim
    if "moe/" in name and base in _MOE_EXPERT and ndim >= 3:
        lead = (None,) * (ndim - 3)
        if base in _ROW:
            return staged(lead + (MODEL, None, DATA))
        return staged(lead + (MODEL, DATA, None))
    if base == "embed":
        two = (MODEL, DATA)
    elif base == "lm_head" or base in _COL:
        two = (DATA, MODEL)
    elif base in _ROW:
        two = (MODEL, DATA)
    else:
        return staged((None,) * ndim)
    return staged((None,) * (ndim - 2) + two)


def _factor_pspec(shape: Tuple[int, ...], side: str,
                  name: str) -> Tuple[Optional[str], ...]:
    """Spec of one K-FAC factor or inverse ``(*stack, nb, bs, bs)``;
    ``side`` is "A"(_inv) or "G"(_inv)."""
    stack = shape[:-3]
    wspec = _param_pspec(name, len(stack) + 2)
    ax = wspec[-2] if side.startswith("A") else wspec[-1]
    return tuple(wspec[:-2]) + (ax, None, None)


def param_sharding(params: Dict[str, Any], mesh) -> Dict[str, tuple]:
    """``{path: spec}`` for a flat param dict (tensors, meta tensors or
    anything with a ``.shape``)."""
    return {k: clean_spec(_param_pspec(k, len(v.shape)), v.shape, mesh)
            for k, v in params.items()}


def kfac_sharding(kstate, params, mesh):
    """The spec tree of a ``KFACState`` (the state with each tensor
    replaced by its spec): factors and inverses follow
    :func:`_factor_pspec`; momentum and Adam moments follow the params,
    from each state leaf's own shape; the host step replicates."""
    del params

    def factor_tree(tree: Dict[str, Dict[str, Any]]) -> Dict:
        return {name: {k: clean_spec(_factor_pspec(tuple(v.shape), k, name),
                                     v.shape, mesh)
                       for k, v in d.items()}
                for name, d in tree.items()}

    return dataclasses.replace(
        kstate, step=(),
        factors=factor_tree(kstate.factors),
        inverses=factor_tree(kstate.inverses),
        momentum=param_sharding(kstate.momentum, mesh),
        adam_mu=param_sharding(kstate.adam_mu, mesh),
        adam_nu=param_sharding(kstate.adam_nu, mesh))


def batch_sharding(batch: Dict[str, Any], mesh) -> Dict[str, tuple]:
    """The batch dim over (pod, data); M-RoPE ``positions`` (3, B, T)
    carry the batch on dim 1."""
    out = {}
    for k, v in batch.items():
        ndim = len(v.shape)
        spec = [None] * ndim
        if k == "positions" and ndim == 3:
            spec[1] = BATCH_AXES
        elif ndim >= 1:
            spec[0] = BATCH_AXES
        out[k] = clean_spec(tuple(spec), v.shape, mesh)
    return out


def solve_pool_sharding(mesh) -> tuple:
    """Spec of the block-parallel solver's device-major pools ``(ndev, m,
    bs, bs)``: the leading dim is one row per rank over every mesh axis
    combined (``solve.block_solver`` hands each rank its own row); one
    axis is a name, several a tuple, as in every spec."""
    axes = mesh_axes(mesh)
    return (axes[0] if len(axes) == 1 else axes,)
