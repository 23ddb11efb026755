"""Common building blocks: norms, embeddings, init, chunked cross-entropy.

Counterpart of ``repro.models.common``.  Parameters are drawn with an
explicit ``torch.Generator`` (on the generator's device, then moved to the
device asked for) at the reference's scales; the draws differ from JAX's,
so parity tests feed both packages the same numpy parameters
(``repro_torch.convert.model_params_from_numpy``).  ``lead`` gives a leaf
leading dimensions (the periods of a stacked layer scan) while the scale is
still the one block's.  Every function here is differentiable by
``torch.autograd`` (``train/train_step.py``); ``chunked_cross_entropy``
recomputes each chunk's logits in the backward, as the reference's
``jax.checkpoint`` does.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.param_dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _truncated_normal(generator: torch.Generator, shape, std: float, dtype,
                      device) -> torch.Tensor:
    """Normal(0, 1) truncated to [-3, 3], times ``std``, drawn in float32
    on the generator's device, then cast and moved.  On the meta device,
    the shape only (``Model.abstract_params``)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return out.mul_(std).to(device=device, dtype=dtype)


def dense_init(generator: torch.Generator, shape, dtype,
               scale: Optional[float] = None, *, device=None,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """Truncated-normal fan-in init (He-ish, stddev 1/sqrt(fan_in)); the
    fan-in is ``shape``'s, whatever ``lead`` is."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return _truncated_normal(generator, tuple(lead) + tuple(shape), std,
                             dtype, device)


def embed_init(generator: torch.Generator, shape, dtype, *, device=None,
               lead: Tuple[int, ...] = ()) -> torch.Tensor:
    return _truncated_normal(generator, tuple(lead) + tuple(shape), 0.02,
                             dtype, device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def make_norm(cfg: ModelConfig, d: Optional[int] = None, *, device=None,
              lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    d = d or cfg.d_model
    shape = tuple(lead) + (d,)
    p = {"scale": torch.ones(shape, dtype=pdtype_of(cfg), device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=pdtype_of(cfg), device=device)
    return p


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": torch.nn.functional.silu, "gelu": _gelu}[name]


# ---------------------------------------------------------------------------
# embeddings / LM head
# ---------------------------------------------------------------------------


def make_embeddings(cfg: ModelConfig, generator: torch.Generator, *,
                    device=None) -> Dict[str, torch.Tensor]:
    pd = pdtype_of(cfg)
    p = {"tok": embed_init(generator, (cfg.vocab_size, cfg.d_model), pd,
                           device=device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(generator, (cfg.d_model, cfg.vocab_size), pd,
                               device=device)
    if not cfg.use_rope:
        p["pos"] = embed_init(generator, (cfg.max_position_actual(),
                                          cfg.d_model), pd, device=device)
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig,
                 positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    x = p["tok"][tokens.long()].to(dtype_of(cfg))
    if not cfg.use_rope:
        if positions is None:
            positions = torch.arange(tokens.shape[-1], device=tokens.device)
        x = x + p["pos"][positions.long()].to(dtype_of(cfg))
    return x


def lm_logits(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    w = p["tok"].T if cfg.tie_embeddings else p["head"]
    return torch.matmul(x, w.to(x.dtype))


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal table [length, d] (float32), computed on the
    CPU and moved to ``device``, so the card's table is the CPU's bit for
    bit (within an ulp of XLA's ``exp``/``sin``/``cos``)."""
    pos = torch.arange(length, dtype=torch.float32)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32)[None, :]
    inv = torch.exp(-math.log(10_000.0) * dim / (d // 2 - 1))
    ang = pos * inv
    table = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    return table if device is None else table.to(device)


# ---------------------------------------------------------------------------
# chunked cross-entropy: never materialise (B, S, V)
# ---------------------------------------------------------------------------


def _chunk_nll(emb_params, xc: torch.Tensor, tc: torch.Tensor,
               mc: torch.Tensor, cfg: ModelConfig):
    """One chunk's summed masked NLL and its token count."""
    logits = lm_logits(emb_params, xc, cfg).to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tc.long().unsqueeze(-1))[..., 0]
    return ((logz - gold) * mc).sum(), mc.sum()


def chunked_cross_entropy(emb_params, x: torch.Tensor, targets: torch.Tensor,
                          mask: torch.Tensor, cfg: ModelConfig,
                          chunk: int = 512) -> torch.Tensor:
    """Mean CE over valid tokens, computing logits in sequence chunks.

    x: [B, S, D] final hidden states; targets/mask: [B, S].  Each step of
    the reference's scan sees (B, chunk, V) and reduces it at once; under
    autograd each chunk is recomputed in the backward (the reference's
    ``@jax.checkpoint``), so the (B, chunk, V) logits are never stored.
    """
    s = x.shape[1]
    if s % chunk:
        chunk = s  # fallback for tiny smoke shapes
    remat = torch.is_grad_enabled()
    tot_nll = torch.zeros((), dtype=torch.float32, device=x.device)
    tot_cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for start in range(0, s, chunk):
        args = (emb_params, x[:, start:start + chunk],
                targets[:, start:start + chunk], mask[:, start:start + chunk],
                cfg)
        nll, cnt = (checkpoint(_chunk_nll, *args, use_reentrant=False)
                    if remat else _chunk_nll(*args))
        tot_nll = tot_nll + nll
        tot_cnt = tot_cnt + cnt
    return tot_nll / torch.clamp(tot_cnt, min=1.0)
