"""Sampling from LM logits — including the paper's cumulative-threshold
semantics as top-p (the CDF^-1(t) query applied to the model distribution).

Counterpart of ``repro.serve.sampling``.  ``greedy`` is the reference's
bit for bit (``torch.argmax`` keeps the first maximal index, as
``jnp.argmax`` does).  ``temperature`` and ``top_p`` draw from an explicit
``torch.Generator`` on the logits' device instead of a JAX key: the keep
rule is the reference's, the random draws are not.
"""

from __future__ import annotations

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def _categorical(generator: torch.Generator,
                 logits: torch.Tensor) -> torch.Tensor:
    """A draw from softmax(logits) along the last axis by the Gumbel-max
    trick, as ``jax.random.categorical`` draws."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits.to(torch.float32) - torch.log(-torch.log(u)),
                        dim=-1)


def temperature(generator: torch.Generator, logits: torch.Tensor,
                temp: float = 1.0) -> torch.Tensor:
    return _categorical(generator, logits / max(temp, 1e-6)).to(torch.int32)


def top_p(generator: torch.Generator, logits: torch.Tensor, p: float = 0.9,
          temp: float = 1.0) -> torch.Tensor:
    """Nucleus sampling == the paper's threshold query on the model's own
    distribution: keep items in descending probability until cumsum >= p.
    A stable descending sort orders ties by index, as ``lax.top_k``."""
    logits = logits / max(temp, 1e-6)
    probs = torch.softmax(logits, dim=-1)
    sorted_p, sorted_idx = torch.sort(probs, dim=-1, descending=True,
                                      stable=True)
    cum = torch.cumsum(sorted_p, dim=-1)
    keep = (cum - sorted_p) < p          # same "before < t" rule as cdf_query
    masked = torch.where(keep, sorted_p, 0.0)
    masked = masked / masked.sum(dim=-1, keepdim=True)
    pick = _categorical(generator, torch.log(masked + 1e-30))
    return torch.gather(sorted_idx, -1, pick[..., None])[..., 0].to(
        torch.int32)
