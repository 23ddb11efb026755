"""Block assembly: pre-norm residual blocks + a loop over stacked periods.

Counterpart of ``repro.models.transformer`` for every layer kind: ``attn``
(with a dense MLP, or with experts when ``cfg.num_experts``),
``local_attn``, ``dense_mlp`` (deepseek's first layer: attention and a
wide MLP), ``ssm``, ``rglru``, and whisper's ``enc_attn`` (non-causal
self-attention and a plain MLP, no cache) and ``cross`` (causal
self-attention, then ``norm_x`` and ``xattn`` over the encoder's memory).  A config's ``pattern`` defines the
cycled layer kinds; parameters are stacked with a leading ``num_periods``
dim, as in the reference, and a Python loop over that dim takes the place
of ``lax.scan``.  Each block's float32 weights (every leaf of two or more
dims) are cast to the compute dtype at block entry (``cast_block_params``),
one block at a time, so the peak holds one block's cast copy, not the
whole stack's (the reference's ``cast_stacked_params`` would cast the
stack at once).

Caches of the stack are a list with one cache tree per period (the
reference's per-layer list layout), so a step writes new per-period tensors
and never restacks.  With a cache, ``insert`` says how many leading rows of
each sequence are tokens (the rest are pad rows of a fixed-shape call,
``models.model.STEP_ROWS``): attention inserts only those into its cache,
the experts dispatch only those, and the recurrent kinds step through them
one at a time with the decode arithmetic.  A ``cross`` cache is
``{"self", "mem_k", "mem_v"}``: only the tokens enter ``self``, every row
(pad rows too) is a query against ``mem_k``/``mem_v``, which the prefill
writes (the memory projected by ``xattn.wk``/``wv``) and an extension only
reads.

Without a cache and under autograd, each period of a stack is recomputed
in the backward when ``cfg.remat`` is not ``"none"``
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint`` of the
scan body); ``"dots"`` recomputes everything too (ROADMAP queue C).  The
values do not change.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.ckpt import tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_norm, dtype_of, make_norm

PyTree = Any

ATTN_KINDS = ("attn", "local_attn", "dense_mlp", "enc_attn", "cross")
KINDS = ATTN_KINDS + ("ssm", "rglru")


def check_kind(cfg: ModelConfig, kind: str) -> None:
    """Raise ``ValueError`` for a layer kind that no model has."""
    if kind not in KINDS:
        raise ValueError(f"unknown layer kind {kind!r}; have {KINDS}")


def cast_block_params(p: PyTree, cfg: ModelConfig) -> PyTree:
    """Cast >=2-D float32 weights to the compute dtype once at block entry
    (the per-matmul casts then do nothing); 1-D parameters (norm scales,
    ``A_log``, biases) stay float32.  The 2-D gate biases of ``rglru``
    pass through the compute dtype, as in the reference."""
    dt = dtype_of(cfg)

    def one(a):
        if a.dim() >= 2 and a.dtype == torch.float32:
            return a.to(dt)
        return a

    return tree_map(one, p)


def period_params(stack: PyTree, i: int) -> PyTree:
    """Period ``i`` of stacked parameters: views, no copy."""
    return tree_map(lambda a: a[i], stack)


def num_periods(stack: PyTree) -> int:
    leaf = stack
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


# ---------------------------------------------------------------------------
# single-block param construction
# ---------------------------------------------------------------------------


def make_block(cfg: ModelConfig, kind: str, generator: torch.Generator, *,
               device=None, lead: Tuple[int, ...] = ()) -> PyTree:
    check_kind(cfg, kind)
    kw = dict(device=device, lead=lead)
    p: Dict[str, PyTree] = {"norm1": make_norm(cfg, **kw)}
    if kind in ATTN_KINDS:
        p["attn"] = attn.make_attention(cfg, generator, **kw)
        p["norm2"] = make_norm(cfg, **kw)
        if kind == "cross":
            p["norm_x"] = make_norm(cfg, **kw)
            p["xattn"] = attn.make_attention(cfg, generator, **kw)
        if kind == "dense_mlp":
            p["mlp"] = mlp_mod.make_mlp(
                cfg, generator, d_ff=cfg.first_dense_d_ff or cfg.d_ff, **kw)
        elif kind == "attn" and cfg.num_experts:
            p["moe"] = moe_mod.make_moe(cfg, generator, **kw)
        else:
            p["mlp"] = mlp_mod.make_mlp(cfg, generator, **kw)
    elif kind == "ssm":
        p["ssm"] = ssm_mod.make_ssm(cfg, generator, **kw)
    else:   # rglru
        p["rglru"] = rglru_mod.make_rglru(cfg, generator, **kw)
        p["norm2"] = make_norm(cfg, **kw)
        p["mlp"] = mlp_mod.make_mlp(cfg, generator, **kw)
    return p


# ---------------------------------------------------------------------------
# forward (full sequence, or an extension of warm caches)
# ---------------------------------------------------------------------------


def _recurrent(apply, step, p, h, cfg, cache, insert):
    """A recurrent kind's mixer: the whole-sequence form without a cache or
    with one and every row a token (prefill), the decode step over the
    first ``insert`` rows otherwise.  Returns (y, cache')."""
    if cache is None:
        return apply(p, h, cfg), None
    if insert is None:
        return apply(p, h, cfg, return_state=True, initial=cache)
    return step(p, h, cache, cfg, real=insert)


def _cross_attend(p: PyTree, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor, memory: Optional[torch.Tensor],
                  cache: Optional[PyTree]):
    """A ``cross`` block's attention over the encoder's memory: projected
    here when ``memory`` is given (returned for the cache), read from the
    cache otherwise.  Every row is a query.  Returns (x', mem_k, mem_v)."""
    hx = apply_norm(p["norm_x"], x, cfg)
    qx, _, _ = attn.project_qkv(p["xattn"], hx, cfg, None)
    if memory is not None:
        # project the encoder memory into this layer's K/V space
        mk = attn.project(memory.to(x.dtype), p["xattn"]["wk"])
        mv = attn.project(memory.to(x.dtype), p["xattn"]["wv"])
    else:   # extension: reuse the projected memory in the cache
        mk, mv = cache["mem_k"], cache["mem_v"]
    ox = attn.attend(qx, mk, mv, causal=False, q_positions=positions,
                     kv_chunk=1024)
    return x + attn.project_out(p["xattn"], ox, x.dtype), mk, mv


def block_forward(p: PyTree, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                  positions: torch.Tensor, cache: Optional[PyTree] = None,
                  insert: Optional[int] = None,
                  memory: Optional[torch.Tensor] = None):
    """Returns (x', aux, cache').  cache' is None unless ``cache`` given.

    With a cache and ``insert`` None this is the prefill: every row is a
    token (a ``local_attn`` prefill attends over the prompt itself, then
    keeps the prompt's last window in its ring: a ring that the prompt
    overfills no longer holds the keys of the prompt's first rows).  With
    ``insert`` it is an *extension* (or a decode): the first ``insert``
    rows of each sequence are tokens and the rows after them are computed
    as queries only — attention puts the tokens' K/V into (a copy of) the
    cache and every query attends over the whole cache (empty slots carry
    position -1 and mask out), the experts dispatch the tokens
    only, and ``ssm`` / ``rglru`` step through the tokens one at a time.
    ``memory`` is the encoder's output for a ``cross`` block (training and
    the prefill); an extension reads the cache's projection of it."""
    check_kind(cfg, kind)
    aux: Dict[str, torch.Tensor] = {}
    new_cache = cache
    p = cast_block_params(p, cfg)
    h = apply_norm(p["norm1"], x, cfg)
    if kind in ATTN_KINDS:
        window = cfg.local_window if kind == "local_attn" else 0
        q, k, v = attn.project_qkv(p["attn"], h, cfg,
                                   positions if cfg.use_rope else None)
        ring_prefill = kind == "local_attn" and insert is None
        sc = cache["self"] if kind == "cross" and cache is not None else cache
        if cache is not None:
            n = k.shape[1] if insert is None else insert
            lo = n - min(cfg.local_window, n) if kind == "local_attn" else 0
            sc = attn.cache_insert(sc, k[:, lo:n], v[:, lo:n],
                                   positions[:, lo:n])
            new_cache = dict(cache, self=sc) if kind == "cross" else sc
        if cache is not None and not ring_prefill:
            o = attn.decode_attend(q, sc, window=window,
                                   q_positions=positions)
        else:   # a ring's prefill attends over the prompt itself (C 30)
            o = attn.attend(q, k, v, causal=kind != "enc_attn", window=window,
                            q_positions=positions, kv_positions=positions,
                            kv_chunk=1024)
        x = x + attn.project_out(p["attn"], o, x.dtype)
        if kind == "cross":
            x, mk, mv = _cross_attend(p, x, cfg, positions, memory, cache)
            if cache is not None and memory is not None:
                new_cache = dict(new_cache, mem_k=mk, mem_v=mv)
        h2 = apply_norm(p["norm2"], x, cfg)
        if "moe" in p:
            y, aux = moe_mod.apply_moe(p["moe"], h2, cfg,
                                       real=None if cache is None else insert)
        else:
            y = mlp_mod.apply_mlp(p["mlp"], h2, cfg)
        x = x + y
    elif kind == "ssm":
        y, new_cache = _recurrent(ssm_mod.apply_ssm, ssm_mod.step_ssm,
                                  p["ssm"], h, cfg, cache, insert)
        x = x + y
    else:   # rglru
        y, new_cache = _recurrent(rglru_mod.apply_rglru, rglru_mod.step_rglru,
                                  p["rglru"], h, cfg, cache, insert)
        x = x + y
        h2 = apply_norm(p["norm2"], x, cfg)
        x = x + mlp_mod.apply_mlp(p["mlp"], h2, cfg)
    return x, aux, new_cache


def block_decode(p: PyTree, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                 positions: torch.Tensor, cache: PyTree,
                 memory: Optional[torch.Tensor] = None):
    """x: [B, S, D] (S = 1 in the reference); positions: [B, S] absolute.
    Returns (x', cache'): every row a token, stepped as a decode."""
    x, _, new_cache = block_forward(p, x, cfg, kind, positions=positions,
                                    cache=cache, insert=x.shape[1],
                                    memory=memory)
    return x, new_cache


def add_aux(total: Dict[str, torch.Tensor], aux: Dict[str, torch.Tensor]
            ) -> None:
    """Sum the floating aux entries into ``total`` (the reference sums only
    those over periods, so ``moe_dropped`` and ``moe_expert_counts`` drop
    out of a stack's aux)."""
    for k2, v in aux.items():
        if v.is_floating_point():
            total[k2] = total[k2] + v if k2 in total else v


# ---------------------------------------------------------------------------
# stacked periods
# ---------------------------------------------------------------------------


def stack_forward(stack_params: PyTree, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: torch.Tensor,
                  caches: Optional[List[PyTree]] = None,
                  memory: Optional[torch.Tensor] = None,
                  kinds: Optional[Tuple[str, ...]] = None,
                  insert: Optional[int] = None):
    """Loop over stacked periods (``stack_params[f"pos{j}"]`` leaves have a
    leading num_periods dim; ``caches`` is a list with one tree per period).
    Returns (x, aux_sums, caches').  Without caches, under autograd and
    with ``cfg.remat`` not ``"none"``, each period is recomputed in the
    backward."""
    pattern = kinds or cfg.pattern

    def period(x, params_i, cache_i):
        new_caches: Dict[str, PyTree] = {}
        aux_i: Dict[str, torch.Tensor] = {}
        for j, kind in enumerate(pattern):
            c = None if cache_i is None else cache_i[f"pos{j}"]
            x, aux, nc = block_forward(params_i[f"pos{j}"], x, cfg, kind,
                                       positions=positions, cache=c,
                                       insert=insert, memory=memory)
            new_caches[f"pos{j}"] = nc
            add_aux(aux_i, aux)
        return x, aux_i, new_caches

    remat = (caches is None and cfg.remat != "none"
             and torch.is_grad_enabled())
    outs: Optional[List[PyTree]] = None if caches is None else []
    aux_all: Dict[str, torch.Tensor] = {}
    for i in range(num_periods(stack_params)):
        params_i = period_params(stack_params, i)
        cache_i = None if caches is None else caches[i]
        if remat:
            x, aux_i, new_caches = checkpoint(period, x, params_i, cache_i,
                                              use_reentrant=False)
        else:
            x, aux_i, new_caches = period(x, params_i, cache_i)
        add_aux(aux_all, aux_i)
        if outs is not None:
            outs.append(new_caches)
    return x, aux_all, outs


def stack_decode(stack_params: PyTree, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor, caches: List[PyTree],
                 kinds: Optional[Tuple[str, ...]] = None,
                 memory: Optional[torch.Tensor] = None):
    pattern = kinds or cfg.pattern
    outs = []
    for i in range(num_periods(stack_params)):
        params_i = period_params(stack_params, i)
        new_caches = {}
        for j, kind in enumerate(pattern):
            x, nc = block_decode(params_i[f"pos{j}"], x, cfg, kind,
                                 positions=positions,
                                 cache=caches[i][f"pos{j}"], memory=memory)
            new_caches[f"pos{j}"] = nc
        outs.append(new_caches)
    return x, outs
