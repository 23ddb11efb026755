"""RG-LRU recurrence block (Griffin / RecurrentGemma).

Counterpart of ``repro.models.rglru``: gate branch (GeLU, tanh form) times
the recurrence branch (conv4 -> RG-LRU) -> out projection, with
``r_t = sigmoid(block-diag gate)``, ``i_t = sigmoid(block-diag gate)``,
``a_t = a^{c r_t}`` (``a = sigmoid(Lambda)``) and
``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t * u_t)``.

A whole sequence (the prefill) runs the reference's associative scan,
``associative_scan`` being ``jax.lax.associative_scan``'s recursion
(pairs, the odd half recursively, then the even half).  As in ``ssm``,
``step_rglru`` runs the first ``real`` rows of a call one at a time with
the decode step's arithmetic, so an extension (speculative verification)
computes each token as a decode does; pad rows never touch the state or
the conv buffer (ROADMAP queue C 29).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import _gelu, dense_init, pdtype_of
from repro_torch.models.ssm import softplus


class RGLRUCache(NamedTuple):
    h: torch.Tensor          # [B, W] recurrent state (float32)
    conv_buf: torch.Tensor   # [B, K-1, W]


def make_rglru(cfg: ModelConfig, generator: torch.Generator, *, device=None,
               lead: Tuple[int, ...] = ()) -> Dict:
    d, w, heads = cfg.d_model, cfg.rnn_width, cfg.num_heads
    bw = w // heads
    pd = pdtype_of(cfg)
    shape = tuple(lead) + (w,)
    if device is not None and torch.device(device).type == "meta":
        lam = torch.empty(shape, dtype=torch.float32, device="meta")
    else:
        # Lambda so that a = sigmoid(Lambda) lies in (0.9, 0.999)
        u = 0.9 + 0.099 * torch.rand(shape, dtype=torch.float32,
                                     device=generator.device,
                                     generator=generator)
        lam = (torch.log(u) - torch.log1p(-u)).to(device)
    return {
        "wx": dense_init(generator, (d, w), pd, device=device, lead=lead),
        "wgate": dense_init(generator, (d, w), pd, device=device, lead=lead),
        "conv_w": dense_init(generator, (cfg.ssm_conv, w), pd,
                             scale=1.0 / math.sqrt(cfg.ssm_conv),
                             device=device, lead=lead),
        "conv_b": torch.zeros(shape, dtype=pd, device=device),
        "ga_w": dense_init(generator, (heads, bw, bw), pd, device=device,
                           lead=lead),
        "ga_b": torch.zeros(tuple(lead) + (heads, bw), dtype=pd,
                            device=device),
        "gi_w": dense_init(generator, (heads, bw, bw), pd, device=device,
                           lead=lead),
        "gi_b": torch.zeros(tuple(lead) + (heads, bw), dtype=pd,
                            device=device),
        "lambda_p": lam,
        "out_proj": dense_init(generator, (w, d), pd,
                               scale=1.0 / math.sqrt(w * 2 * cfg.num_layers),
                               device=device, lead=lead),
    }


def _conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    k = w.shape[0]
    pad = torch.nn.functional.pad(u, (0, 0, k - 1, 0))
    out = torch.zeros_like(u)
    for i in range(k):
        out = out + pad[:, i:i + u.shape[1], :] * w[i][None, None, :]
    return out + b[None, None, :]


def _gates(p: Dict, u: torch.Tensor, cfg: ModelConfig):
    """Block-diagonal r/i gates + log recurrence weight. u: [B, S, W]."""
    b, s, w = u.shape
    heads = cfg.num_heads
    uh = u.reshape(b, s, heads, w // heads)
    f32 = torch.float32

    def gate(wt, bias):
        return torch.sigmoid(
            torch.einsum("bshi,hij->bshj", uh, p[wt].to(u.dtype)).to(f32)
            + p[bias].to(f32)).reshape(b, s, w)

    r, i = gate("ga_w", "ga_b"), gate("gi_w", "gi_b")
    log_a = -cfg.rglru_c * r * softplus(-p["lambda_p"])   # log sigmoid
    return i, log_a


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """a[0], b[0], a[1], b[1], ... along ``dim`` (len(a) - len(b) in {0, 1})."""
    n = a.shape[dim] + b.shape[dim]
    shape = list(a.shape)
    shape[dim] = n
    out = a.new_empty(shape)
    idx = [slice(None)] * a.dim()
    idx[dim] = slice(0, n, 2)
    out[tuple(idx)] = a
    idx[dim] = slice(1, n, 2)
    out[tuple(idx)] = b
    return out


def associative_scan(fn: Callable, elems: List[torch.Tensor],
                     dim: int) -> List[torch.Tensor]:
    """``jax.lax.associative_scan(fn, elems, axis=dim)``, the same
    recursion and so the same combines."""

    def sl(x, start, stop, step=1):
        idx = [slice(None)] * x.dim()
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]

    def scan(elems):
        num = elems[0].shape[dim]
        if num < 2:
            return elems
        reduced = fn([sl(e, 0, num - 1, 2) for e in elems],
                     [sl(e, 1, None, 2) for e in elems])
        odd = scan(reduced)
        if num % 2 == 0:
            even = fn([sl(e, 0, -1) for e in odd],
                      [sl(e, 2, None, 2) for e in elems])
        else:
            even = fn(odd, [sl(e, 2, None, 2) for e in elems])
        even = [torch.cat([sl(e, 0, 1), r], dim=dim)
                for e, r in zip(elems, even)]
        return [_interleave(e, o, dim) for e, o in zip(even, odd)]

    return scan(list(elems))


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return [a1 * a2, b1 * a2 + b2]


def apply_rglru(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                return_state: bool = False,
                initial: "RGLRUCache | None" = None):
    """Full-sequence forward. x: [B, S, D] -> [B, S, D] (plus an
    RGLRUCache when ``return_state``); ``initial`` threads a previous
    cache (the conv's left context and ``h0``)."""
    gate = _gelu(torch.matmul(x, p["wgate"].to(x.dtype)))
    u_new = torch.matmul(x, p["wx"].to(x.dtype))
    if initial is not None:
        u_raw = torch.cat([initial.conv_buf.to(u_new.dtype), u_new], dim=1)
    else:
        u_raw = u_new
    u = _conv(u_raw, p["conv_w"].to(x.dtype), p["conv_b"].to(x.dtype))
    k = p["conv_w"].shape[0]
    if initial is not None:
        u = u[:, k - 1:, :]
    i, log_a = _gates(p, u, cfg)
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bt = beta * (i * u.to(torch.float32))
    a_cum, h = associative_scan(_combine, [a, bt], dim=1)
    if initial is not None:
        h = h + a_cum * initial.h[:, None, :]
    y = h.to(x.dtype) * gate
    out = torch.matmul(y, p["out_proj"].to(x.dtype))
    if return_state:
        return out, RGLRUCache(h=h[:, -1],
                               conv_buf=u_raw[:, u_raw.shape[1] - (k - 1):])
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_rglru_cache(cfg: ModelConfig, b: int, dtype, *, device=None
                     ) -> RGLRUCache:
    return RGLRUCache(
        h=torch.zeros((b, cfg.rnn_width), dtype=torch.float32, device=device),
        conv_buf=torch.zeros((b, cfg.ssm_conv - 1, cfg.rnn_width),
                             dtype=dtype, device=device),
    )


def _step(p: Dict, u: torch.Tensor, cache: RGLRUCache, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, RGLRUCache]:
    """One token's recurrence: u [B, W] (the wx projection's row) ->
    (h [B, W] float32; cache')."""
    window = torch.cat([cache.conv_buf, u[:, None, :]], dim=1)       # [B,K,W]
    w = p["conv_w"].to(u.dtype)
    u1 = (torch.einsum("bkw,kw->bw", window, w)
          + p["conv_b"].to(u.dtype))[:, None, :]
    i, log_a = _gates(p, u1, cfg)
    a = torch.exp(log_a[:, 0])
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a[:, 0]),
                                  min=1e-12))
    h = cache.h * a + beta * (i[:, 0] * u1[:, 0].to(torch.float32))
    return h, RGLRUCache(h=h, conv_buf=window[:, 1:, :])


def step_rglru(p: Dict, x: torch.Tensor, cache: RGLRUCache, cfg: ModelConfig,
               real: int) -> Tuple[torch.Tensor, RGLRUCache]:
    """x: [B, R, D], of which the first ``real`` rows are tokens: each one
    through the decode step in turn (the projections on all R rows at
    once).  Returns ([B, R, D], the cache after the real rows)."""
    b, rows, _ = x.shape
    gate = _gelu(torch.matmul(x, p["wgate"].to(x.dtype)))
    u = torch.matmul(x, p["wx"].to(x.dtype))
    hs = []
    for j in range(real):
        h, cache = _step(p, u[:, j], cache, cfg)
        hs.append(h)
    pad = torch.zeros((b, cfg.rnn_width), dtype=torch.float32,
                      device=x.device)
    h = torch.stack(hs + [pad] * (rows - real), dim=1)
    y = h.to(x.dtype) * gate
    return torch.matmul(y, p["out_proj"].to(x.dtype)), cache


def decode_rglru(p: Dict, x: torch.Tensor, cache: RGLRUCache,
                 cfg: ModelConfig) -> Tuple[torch.Tensor, RGLRUCache]:
    """Single-token step. x: [B, 1, D]."""
    return step_rglru(p, x, cache, cfg, real=1)
