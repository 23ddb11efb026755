"""Mamba-2 SSD (state-space duality) layer: chunked scan + O(1) decode.

Counterpart of ``repro.models.ssm``: the intra-chunk quadratic term plus
the inter-chunk state recurrence for a whole sequence (``apply_ssm``, the
prefill), and the single-token step against a ``(B, H, P, N)`` state and
a depthwise-conv buffer (``decode_ssm``).

One addition: ``step_ssm`` runs the first ``real`` rows of a call one at a
time with the decode step's arithmetic (``_step``), at the call's fixed
shape.  An extension of warm caches (speculative verification) is computed
so, not with the chunked form: the chunked form sums earlier rows in
another order than the recurrence does, so a token verified at row j of an
extension would round differently from the same token decoded alone, and
greedy speculation would no longer give plain greedy's tokens.  Rows after
``real`` (pad rows) never touch the state or the conv buffer.  Against the
reference's ``extend_step`` (the chunked form from ``initial``) this
differs by rounding only (ROADMAP queue C 29).

The chunked form masks the intra-chunk decay's exponent (``exp`` of
-inf above the diagonal) where the reference masks its exponential: the
values are the same, and the backward stays finite where an exponent
above the diagonal overflows (a chunk of 128 at full width), which makes
the reference's gradient NaN (ROADMAP queue C).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, pdtype_of


class SSMCache(NamedTuple):
    state: torch.Tensor      # [B, H, P, N] running SSM state (float32)
    conv_buf: torch.Tensor   # [B, K-1, conv_dim] last inputs for the conv


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def _meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def _lead(a: torch.Tensor, lead: Tuple[int, ...]) -> torch.Tensor:
    return a.expand(tuple(lead) + tuple(a.shape)).contiguous()


def make_ssm(cfg: ModelConfig, generator: torch.Generator, *, device=None,
             lead: Tuple[int, ...] = ()) -> Dict:
    d, din, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    g, n, kk = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    pd = pdtype_of(cfg)
    in_dim = 2 * din + 2 * g * n + h   # z, x, B, C, dt
    shape = tuple(lead) + (h,)
    if _meta(device):
        a_log = dt_bias = torch.empty(shape, dtype=torch.float32,
                                      device="meta")
    else:
        # dt log-uniform in [1e-3, 1e-1]; dt_bias its softplus inverse
        u = torch.rand(shape, dtype=torch.float32, device=generator.device,
                       generator=generator)
        lo, hi = math.log(1e-3), math.log(1e-1)
        dt = torch.exp(lo + (hi - lo) * u)
        dt_bias = (dt + torch.log(-torch.expm1(-dt))).to(device)
        a_log = _lead(torch.log(torch.linspace(1.0, 16.0, h,
                                               dtype=torch.float32)),
                      lead).to(device)
    return {
        "in_proj": dense_init(generator, (d, in_dim), pd, device=device,
                              lead=lead),
        "conv_w": dense_init(generator, (kk, conv_dim(cfg)), pd,
                             scale=1.0 / math.sqrt(kk), device=device,
                             lead=lead),
        "conv_b": torch.zeros(tuple(lead) + (conv_dim(cfg),), dtype=pd,
                              device=device),
        "A_log": a_log,
        "dt_bias": dt_bias,
        "ssm_D": torch.ones(shape, dtype=torch.float32, device=device),
        "norm_scale": torch.ones(tuple(lead) + (din,), dtype=pd,
                                 device=device),
        "out_proj": dense_init(generator, (din, d), pd,
                               scale=1.0 / math.sqrt(din * 2 * cfg.num_layers),
                               device=device, lead=lead),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.silu(x)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over seq. xbc: [B, S, C], w: [K, C]."""
    k = w.shape[0]
    pad = torch.nn.functional.pad(xbc, (0, 0, k - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(k):
        out = out + pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
    return _silu(out + b[None, None, :])


def _split_proj(p, x, cfg: ModelConfig):
    din = cfg.d_inner
    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z = zxbcdt[..., :din]
    xbc = zxbcdt[..., din:din + conv_dim(cfg)]
    dt = zxbcdt[..., din + conv_dim(cfg):]
    assert dt.shape[-1] == cfg.ssm_heads
    return z, xbc, dt


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    y = y * _silu(z.to(torch.float32))
    var = y.square().mean(dim=-1, keepdim=True)
    return y * torch.rsqrt(var + eps) * scale.to(torch.float32)


def _out(p, y, z, x, cfg: ModelConfig) -> torch.Tensor:
    y = _gated_norm(y, z, p["norm_scale"], cfg.norm_eps)
    return torch.matmul(y.to(x.dtype), p["out_proj"].to(x.dtype))


def apply_ssm(p: Dict, x: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False, initial: "SSMCache | None" = None):
    """Full-sequence SSD forward. x: [B, S, D] -> [B, S, D] (plus an
    SSMCache when ``return_state``).  ``initial`` threads a previous cache
    through (the conv's left context and the recurrence's start); a zero
    cache reproduces the fresh prefill."""
    b, s, _ = x.shape
    din, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    h, pdim, q = cfg.ssm_heads, cfg.ssm_headdim, min(cfg.ssm_chunk, s)
    if s % q:
        raise ValueError(f"apply_ssm: a sequence of {s} does not split into "
                         f"chunks of {q} (ssm_chunk {cfg.ssm_chunk})")
    nc = s // q
    f32 = torch.float32

    z, xbc_new, dt = _split_proj(p, x, cfg)
    if initial is not None:
        xbc_raw = torch.cat([initial.conv_buf.to(xbc_new.dtype), xbc_new], 1)
    else:
        xbc_raw = xbc_new
    xbc = _causal_conv(xbc_raw, p["conv_w"].to(x.dtype),
                       p["conv_b"].to(x.dtype))
    if initial is not None:
        xbc = xbc[:, cfg.ssm_conv - 1:, :]   # drop the context rows
    xs = xbc[..., :din].reshape(b, s, h, pdim)
    bmat = xbc[..., din:din + g * n].reshape(b, s, g, n)
    cmat = xbc[..., din + g * n:].reshape(b, s, g, n)

    dt = softplus(dt.to(f32) + p["dt_bias"])                         # [b,s,h]
    a = -torch.exp(p["A_log"])                                        # [h]
    da = dt * a

    xs_c = xs.reshape(b, nc, q, h, pdim).to(f32)
    b_c = bmat.reshape(b, nc, q, g, n).to(f32)
    c_c = cmat.reshape(b, nc, q, g, n).to(f32)
    dt_c = dt.reshape(b, nc, q, h)
    da_cs = torch.cumsum(da.reshape(b, nc, q, h), dim=2)             # [b,nc,q,h]

    # intra-chunk: L[i, j] = exp(da_cs[i] - da_cs[j]) for i >= j.  The
    # exponent is masked, not the exponential: above the diagonal it can
    # pass 88 and overflow, and the backward of a masked exp(inf) is
    # 0 * inf = NaN (the reference's gradient; ROADMAP queue C)
    li = da_cs[:, :, :, None, :]
    lj = da_cs[:, :, None, :, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.exp(torch.where(mask[None, None, :, :, None], li - lj,
                                  float("-inf")))
    hg = h // g
    c_h = torch.repeat_interleave(c_c, hg, dim=3)                    # [b,nc,q,h,n]
    b_h = torch.repeat_interleave(b_c, hg, dim=3)
    cb = torch.einsum("bcihn,bcjhn->bcijh", c_h, b_h)                # [b,nc,q,q,h]
    y_diag = torch.einsum("bcijh,bcjh,bcjhp->bcihp", cb * decay, dt_c, xs_c)

    # chunk states: S_c = sum_j exp(da_cs[last] - da_cs[j]) dt_j x_j B_j^T
    seg = torch.exp(da_cs[:, :, -1:, :] - da_cs)                     # [b,nc,q,h]
    states = torch.einsum("bcjh,bcjh,bcjhp,bcjhn->bchpn", seg, dt_c, xs_c,
                          b_h)
    chunk_decay = torch.exp(da_cs[:, :, -1, :])                       # [b,nc,h]
    carry = (initial.state if initial is not None else
             torch.zeros((b, h, pdim, n), dtype=f32, device=x.device))
    prev = []
    for c in range(nc):   # the state entering each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                            # [b,nc,h,p,n]

    y_off = torch.einsum("bcihn,bchpn,bcih->bcihp", c_h, prev_states,
                         torch.exp(da_cs))
    y = (y_diag + y_off).reshape(b, s, h, pdim)
    y = y + xs.to(f32) * p["ssm_D"][None, None, :, None]
    out = _out(p, y.reshape(b, s, din), z, x, cfg)
    if return_state:
        k = cfg.ssm_conv
        return out, SSMCache(state=carry,
                             conv_buf=xbc_raw[:, xbc_raw.shape[1] - (k - 1):])
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, b: int, dtype, *, device=None
                   ) -> SSMCache:
    return SSMCache(
        state=torch.zeros((b, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                          dtype=torch.float32, device=device),
        conv_buf=torch.zeros((b, cfg.ssm_conv - 1, conv_dim(cfg)),
                             dtype=dtype, device=device),
    )


def _step(p: Dict, xbc: torch.Tensor, dt: torch.Tensor, cache: SSMCache,
          cfg: ModelConfig) -> Tuple[torch.Tensor, SSMCache]:
    """One token's recurrence: xbc [B, C], dt [B, H] (the projection's
    rows) -> (y [B, din] in float32, before the gated norm; cache')."""
    b = xbc.shape[0]
    din, g, n, h, pdim = (cfg.d_inner, cfg.ssm_groups, cfg.ssm_state,
                          cfg.ssm_heads, cfg.ssm_headdim)
    f32 = torch.float32
    window = torch.cat([cache.conv_buf, xbc[:, None, :]], dim=1)     # [B,K,C]
    w = p["conv_w"].to(xbc.dtype)
    conv = torch.einsum("bkc,kc->bc", window, w) + p["conv_b"].to(xbc.dtype)
    xbc1 = _silu(conv)

    xs = xbc1[:, :din].reshape(b, h, pdim).to(f32)
    bm = xbc1[:, din:din + g * n].reshape(b, g, n).to(f32)
    cm = xbc1[:, din + g * n:].reshape(b, g, n).to(f32)
    hg = h // g
    bm = torch.repeat_interleave(bm, hg, dim=1)                      # [b,h,n]
    cm = torch.repeat_interleave(cm, hg, dim=1)

    dt1 = softplus(dt.to(f32) + p["dt_bias"])                        # [b,h]
    a = -torch.exp(p["A_log"])
    da = torch.exp(dt1 * a)
    state = (cache.state * da[:, :, None, None]
             + dt1[:, :, None, None] * xs[:, :, :, None] * bm[:, :, None, :])
    y = torch.einsum("bhn,bhpn->bhp", cm, state)
    y = y + xs * p["ssm_D"][None, :, None]
    return y.reshape(b, din), SSMCache(state=state, conv_buf=window[:, 1:])


def step_ssm(p: Dict, x: torch.Tensor, cache: SSMCache, cfg: ModelConfig,
             real: int) -> Tuple[torch.Tensor, SSMCache]:
    """x: [B, R, D], of which the first ``real`` rows are tokens: each one
    through the decode step in turn (the projections and the gated norm on
    all R rows at once).  Returns ([B, R, D], the cache after the real
    rows)."""
    b, rows, _ = x.shape
    z, xbc, dt = _split_proj(p, x, cfg)
    ys = []
    for j in range(real):
        y, cache = _step(p, xbc[:, j], dt[:, j], cache, cfg)
        ys.append(y)
    pad = torch.zeros((b, cfg.d_inner), dtype=torch.float32, device=x.device)
    y = torch.stack(ys + [pad] * (rows - real), dim=1)
    return _out(p, y, z, x, cfg), cache


def decode_ssm(p: Dict, x: torch.Tensor, cache: SSMCache, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, SSMCache]:
    """Single-token step. x: [B, 1, D] -> ([B, 1, D], cache')."""
    return step_ssm(p, x, cache, cfg, real=1)
