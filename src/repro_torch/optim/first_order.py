"""First-order baseline optimizers (the paper's GPU-1st / PipeLayer
side; counterpart of ``repro.optim.first_order``).

Pure-functional, on flat dicts of tensors ``{path: tensor}``: ``update``
returns new dicts and leaves its inputs untouched, the same shape as
``core.kfac`` so launchers can swap them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Protocol, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class Optimizer(Protocol):
    def init(self, params: Tensors): ...

    def update(self, grads: Tensors, state, params: Tensors
               ) -> Tuple[Tensors, object]: ...


@dataclasses.dataclass(frozen=True)
class SGD:
    """Heavy-ball SGD: ``m <- momentum m + g + wd p``, then ``p <- p -
    lr m`` (or, with ``nesterov``, ``p - lr (g + momentum m)``)."""

    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 0.0
    nesterov: bool = False

    def init(self, params: Tensors) -> Tensors:
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(self, grads: Tensors, state: Tensors, params: Tensors
               ) -> Tuple[Tensors, Tensors]:
        new_m = {k: self.momentum * state[k] + grads[k]
                 + self.weight_decay * params[k] for k in params}
        if self.nesterov:
            new_p = {k: params[k] - self.lr * (grads[k]
                                               + self.momentum * new_m[k])
                     for k in params}
        else:
            new_p = {k: params[k] - self.lr * new_m[k] for k in params}
        return new_p, new_m


@dataclasses.dataclass
class AdamState:
    """``step`` is a host int, as ``KFACState.step``."""

    step: int
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass(frozen=True)
class Adam:
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params: Tensors) -> AdamState:
        return AdamState(
            step=0,
            mu={k: torch.zeros_like(p) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()})

    def update(self, grads: Tensors, state: AdamState, params: Tensors
               ) -> Tuple[Tensors, AdamState]:
        step = state.step + 1
        dev = next(iter(params.values())).device
        # the bias corrections in fp32, as the reference's b ** t on an
        # fp32 step count
        t = torch.tensor(float(step), dtype=torch.float32, device=dev)
        bc1 = 1 - torch.tensor(self.b1, dtype=torch.float32, device=dev) ** t
        bc2 = 1 - torch.tensor(self.b2, dtype=torch.float32, device=dev) ** t
        mu = {k: self.b1 * state.mu[k] + (1 - self.b1) * grads[k]
              for k in params}
        nu = {k: self.b2 * state.nu[k] + (1 - self.b2) * grads[k] * grads[k]
              for k in params}
        new_p = {}
        for k, p in params.items():
            mh = mu[k] / bc1
            vh = nu[k] / bc2
            new_p[k] = p - self.lr * (mh / (torch.sqrt(vh) + self.eps)
                                      + self.weight_decay * p)
        return new_p, AdamState(step=step, mu=mu, nu=nu)
