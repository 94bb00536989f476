"""On-device token sampling for serving (counterpart of
``repro.serve.sampling``).

``make_sampler`` returns ``sample(logits, generator) -> (B,) int32``
for (B, vocab) logits: no host read, so a decode chunk samples on the
card. The random draws come from the ``torch.Generator`` passed in (the
engine seeds one from its seed); they cannot match ``jax.random``'s.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

METHODS = ("greedy", "temperature", "top_k")


def _categorical(logits: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row from ``softmax(logits)``, by Gumbel-max (as
    ``jax.random.categorical``); ``torch.multinomial`` checks its input
    on the host."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp(u, min=tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def make_sampler(method: str = "greedy", temperature: float = 1.0,
                 top_k: int = 0) -> Callable:
    """``sample(logits, generator)``:

    * ``greedy``      argmax (the first index on ties; no draw);
    * ``temperature`` a draw from ``softmax(logits / temperature)``;
    * ``top_k``       a draw among the ``top_k`` highest logits'
      *indices* (not every logit at or above the k-th value, which
      would keep all of a tie), chosen by a stable descending sort, so
      ties go to the lower index.
    """
    if method not in METHODS:
        raise ValueError(f"unknown sampling method {method!r}; "
                         f"one of {METHODS}")
    if method != "greedy" and temperature <= 0.0:
        raise ValueError("temperature must be > 0 for stochastic "
                         "sampling (use method='greedy' instead)")
    if method == "top_k" and top_k < 1:
        raise ValueError("top_k sampling needs top_k >= 1")

    def sample(logits: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        lg = logits.to(torch.float32)
        if method == "greedy":
            return torch.argmax(lg, dim=-1).to(torch.int32)
        if method == "top_k":
            vals, idx = torch.sort(lg, dim=-1, descending=True, stable=True)
            vals, idx = vals[..., :top_k], idx[..., :top_k]
            choice = _categorical(vals / temperature, generator)
            return torch.gather(idx, -1, choice[..., None])[..., 0].to(
                torch.int32)
        return _categorical(lg / temperature, generator).to(torch.int32)

    return sample
