"""GQA attention: chunked flash-style forward, KV caches, RoPE, local window.

Counterpart of ``repro.models.attention``, in plain PyTorch matmuls and
softmax arithmetic written as the reference writes it (the reference keeps
attention out of Pallas too, so no kernel is owed):

  * ``attend``        — full-sequence forward, online softmax over KV chunks
                        (a Python loop where the reference scans);
  * ``decode_attend`` — queries against a preallocated cache;
  * caches            — ``init_cache``, linear or ring (window W).

Caches are never written in place: ``cache_insert`` returns new tensors, so
a caller that keeps a cache (speculative rollback) still holds its values
after an extension.  ``sp_insert_attend`` (sequence parallelism over a
mesh) is not ported: one device holds the whole cache (ROADMAP queue A 4b).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, pdtype_of

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def make_attention(cfg: ModelConfig, generator: torch.Generator, *,
                   device=None, lead: Tuple[int, ...] = ()) -> Dict:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = pdtype_of(cfg)
    p = {
        "wq": dense_init(generator, (d, h, hd), pd, device=device, lead=lead),
        "wk": dense_init(generator, (d, kv, hd), pd, device=device, lead=lead),
        "wv": dense_init(generator, (d, kv, hd), pd, device=device, lead=lead),
        "wo": dense_init(generator, (h, hd, d), pd,
                         scale=1.0 / math.sqrt(h * hd * 2 * cfg.num_layers),
                         device=device, lead=lead),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", h), ("bk", kv), ("bv", kv)):
            p[name] = torch.zeros(tuple(lead) + (heads, hd), dtype=pd,
                                  device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [B, S, H, Dh], positions: [B, S] (absolute)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].to(torch.float32) * freqs   # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------


def project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe")`` as one matmul over the flattened heads."""
    d, heads, hd = w.shape
    out = torch.matmul(x, w.to(x.dtype).reshape(d, heads * hd))
    return out.reshape(*x.shape[:-1], heads, hd)


def project_qkv(p: Dict, x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """x: [B, S, D] -> q [B,S,H,Dh], k,v [B,S,KV,Dh] (roped if configured)."""
    q, k, v = (project(x, p[name]) for name in ("wq", "wk", "wv"))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    if cfg.use_rope and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def project_out(p: Dict, o: torch.Tensor, x_dtype) -> torch.Tensor:
    """o: [B, S, H, Dh] -> [B, S, D]."""
    h, hd, d = p["wo"].shape
    return torch.matmul(o.reshape(*o.shape[:-2], h * hd),
                        p["wo"].to(x_dtype).reshape(h * hd, d))


# ---------------------------------------------------------------------------
# chunked online-softmax attention
# ---------------------------------------------------------------------------


def _flash_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: int, q_positions: torch.Tensor,
                 kv_positions: torch.Tensor,
                 kv_valid_len: Optional[torch.Tensor], kv_chunk: int):
    """Online-softmax statistics (m, lsum, acc) — acc is the un-normalised
    numerator — over KV chunks of ``kv_chunk`` (one chunk for a single
    query, as the reference: no chunk copies of the cache per decode).

    The two products take their operands in the compute dtype and give
    float32 (float32 sums; a product of two bfloat16 values is exact in
    float32, so the operands are upcast).  The reference rounds each
    product to the compute dtype and converts it to float32 at once; the
    port keeps float32.  Scores of randomly initialised models reach
    +-100, where a bfloat16 ulp is 0.5-1: rounded, the softmax would follow
    the last bit of a library's summation order, and the card's answer
    would not be the CPU's (ROADMAP queue C 21)."""
    b, sq, h, hd = q.shape
    t, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    scale = 1.0 / math.sqrt(hd)

    qg = q.reshape(b, sq, kvh, g, hd) * scale
    if sq == 1:
        kv_chunk = t
    n_chunks = max(1, t // kv_chunk)
    # one chunk is the whole of T, as in the reference (whisper's 1,500
    # encoder frames at kv_chunk 1,024); past it, chunks of kv_chunk and a
    # last one that takes the rest: a ``local_attn`` ring of window +
    # STEP_ROWS positions (2,056 for recurrentgemma) is no multiple of
    # 1,024, where the reference's ring of the window is (queue C 30)
    ck = kv_chunk if n_chunks > 1 else t

    m = torch.full((b, sq, kvh, g), NEG_INF, dtype=torch.float32,
                   device=q.device)
    lsum = torch.zeros((b, sq, kvh, g), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, kvh, g, hd), dtype=torch.float32,
                      device=q.device)
    for c in range(n_chunks):
        end = t if c == n_chunks - 1 else (c + 1) * ck
        kc, vc = k[:, c * ck:end], v[:, c * ck:end]
        pc = kv_positions[:, c * ck:end]
        s = torch.einsum("bqkgd,bckd->bqkgc", qg.to(torch.float32),
                         kc.to(torch.float32))
        mask = torch.ones((b, sq, end - c * ck), dtype=torch.bool,
                          device=q.device)
        if causal:
            mask &= pc[:, None, :] <= q_positions[:, :, None]
        if window > 0:
            mask &= pc[:, None, :] > q_positions[:, :, None] - window
        if kv_valid_len is not None:
            mask &= pc < kv_valid_len[:, None]
        mask &= pc[:, None, :] >= 0
        s = torch.where(mask[:, :, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqkgc,bckd->bqkgd", p.to(vc.dtype).to(torch.float32),
            vc.to(torch.float32))
        m = m_new
    return m, lsum, acc


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int = 0,
           q_positions: Optional[torch.Tensor] = None,
           kv_positions: Optional[torch.Tensor] = None,
           kv_valid_len: Optional[torch.Tensor] = None,
           kv_chunk: int = 1024) -> torch.Tensor:
    """Memory-efficient attention.

    q: [B, Sq, H, Dh]; k, v: [B, T, KV, Dh]; H = KV * G.
    q_positions/kv_positions: absolute positions [B, Sq] / [B, T] (default
    aranges).  window > 0 masks kv_pos <= q_pos - window (sliding window).
    kv_valid_len: [B] — cache fill level for decode.
    Returns [B, Sq, H, Dh].
    """
    b, sq, h, hd = q.shape
    t = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device).expand(b, sq)
    if kv_positions is None:
        kv_positions = torch.arange(t, device=q.device).expand(b, t)
    _, lsum, acc = _flash_stats(
        q, k, v, causal=causal, window=window, q_positions=q_positions,
        kv_positions=kv_positions, kv_valid_len=kv_valid_len,
        kv_chunk=kv_chunk)
    out = acc / torch.clamp(lsum, min=1e-30)[..., None]
    return out.reshape(b, sq, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    k: torch.Tensor          # [B, T, KV, Dh]
    v: torch.Tensor          # [B, T, KV, Dh]
    positions: torch.Tensor  # [B, T] int32 absolute positions (-1 empty)
    ring: bool               # ring (slot = position % T) vs linear


def init_cache(b: int, t: int, kvh: int, hd: int, dtype, ring: bool = False,
               *, device=None) -> KVCache:
    return KVCache(
        k=torch.zeros((b, t, kvh, hd), dtype=dtype, device=device),
        v=torch.zeros((b, t, kvh, hd), dtype=dtype, device=device),
        positions=torch.full((b, t), -1, dtype=torch.int32, device=device),
        ring=bool(ring),
    )


def cache_insert(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 positions: torch.Tensor) -> KVCache:
    """Write S new entries into a copy. positions: [B, S] absolute token
    positions.  Linear cache: slot == position.  Ring cache: slot ==
    position % T."""
    t = cache.k.shape[1]
    slots = (positions % t if cache.ring else positions).long()
    b_idx = torch.arange(k_new.shape[0], device=slots.device)[:, None]
    b_idx = b_idx.expand_as(slots)
    k = cache.k.index_put((b_idx, slots), k_new.to(cache.k.dtype))
    v = cache.v.index_put((b_idx, slots), v_new.to(cache.v.dtype))
    pos = cache.positions.index_put((b_idx, slots),
                                    positions.to(torch.int32))
    return KVCache(k, v, pos, cache.ring)


def decode_attend(q: torch.Tensor, cache: KVCache, *, window: int = 0,
                  q_positions: torch.Tensor,
                  kv_chunk: int = 1024) -> torch.Tensor:
    """q: [B, S, H, Dh] against the cache; positions make masking exact for
    both linear and ring layouts (empty slots carry position -1)."""
    return attend(
        q, cache.k, cache.v, causal=True, window=window,
        q_positions=q_positions, kv_positions=cache.positions,
        kv_chunk=min(kv_chunk, cache.k.shape[1]))
