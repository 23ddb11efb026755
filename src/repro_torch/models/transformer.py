"""Block assembly: pre-norm residual blocks + a loop over stacked periods.

Counterpart of ``repro.models.transformer`` for the decoder kinds
``attn`` (with a dense MLP, or with experts when ``cfg.num_experts``),
``local_attn``, ``dense_mlp`` (deepseek's first layer: attention and a
wide MLP), ``ssm`` and ``rglru``.  A config's ``pattern`` defines the
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
one at a time with the decode arithmetic.  The encoder kinds (``enc_attn``,
``cross``) are not ported yet and raise ``NotImplementedError`` (ROADMAP
queue A 8d, the encoder slice).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import apply_norm, dtype_of, make_norm

PyTree = Any

ATTN_KINDS = ("attn", "local_attn", "dense_mlp")
PORTED_KINDS = ATTN_KINDS + ("ssm", "rglru")


def check_kind(cfg: ModelConfig, kind: str) -> None:
    """Raise unless this package runs layer kind ``kind`` of ``cfg``."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported to repro_torch yet "
            f"(ROADMAP queue A 8d: the encoder and the patch prefix)")


def tree_map(fn, tree: PyTree) -> PyTree:
    """``fn`` on every tensor leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


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


def block_forward(p: PyTree, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                  positions: torch.Tensor, cache: Optional[PyTree] = None,
                  insert: Optional[int] = None):
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
    only, and ``ssm`` / ``rglru`` step through the tokens one at a time."""
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
        if cache is not None:
            n = k.shape[1] if insert is None else insert
            lo = n - min(cfg.local_window, n) if kind == "local_attn" else 0
            new_cache = attn.cache_insert(cache, k[:, lo:n], v[:, lo:n],
                                          positions[:, lo:n])
        if cache is not None and not ring_prefill:
            o = attn.decode_attend(q, new_cache, window=window,
                                   q_positions=positions)
        else:   # a ring's prefill attends over the prompt itself (C 30)
            o = attn.attend(q, k, v, causal=True, window=window,
                            q_positions=positions, kv_positions=positions,
                            kv_chunk=1024)
        x = x + attn.project_out(p["attn"], o, x.dtype)
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
                 positions: torch.Tensor, cache: PyTree):
    """x: [B, S, D] (S = 1 in the reference); positions: [B, S] absolute.
    Returns (x', cache'): every row a token, stepped as a decode."""
    x, _, new_cache = block_forward(p, x, cfg, kind, positions=positions,
                                    cache=cache, insert=x.shape[1])
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
                  kinds: Optional[Tuple[str, ...]] = None,
                  insert: Optional[int] = None):
    """Loop over stacked periods (``stack_params[f"pos{j}"]`` leaves have a
    leading num_periods dim; ``caches`` is a list with one tree per period).
    Returns (x, aux_sums, caches')."""
    pattern = kinds or cfg.pattern
    outs: Optional[List[PyTree]] = None if caches is None else []
    aux_all: Dict[str, torch.Tensor] = {}
    for i in range(num_periods(stack_params)):
        params_i = period_params(stack_params, i)
        new_caches: Dict[str, PyTree] = {}
        aux_i: Dict[str, torch.Tensor] = {}
        for j, kind in enumerate(pattern):
            c = None if caches is None else caches[i][f"pos{j}"]
            x, aux, nc = block_forward(params_i[f"pos{j}"], x, cfg, kind,
                                       positions=positions, cache=c,
                                       insert=insert)
            new_caches[f"pos{j}"] = nc
            add_aux(aux_i, aux)
        add_aux(aux_all, aux_i)
        if outs is not None:
            outs.append(new_caches)
    return x, aux_all, outs


def stack_decode(stack_params: PyTree, x: torch.Tensor, cfg: ModelConfig, *,
                 positions: torch.Tensor, caches: List[PyTree],
                 kinds: Optional[Tuple[str, ...]] = None):
    pattern = kinds or cfg.pattern
    outs = []
    for i in range(num_periods(stack_params)):
        params_i = period_params(stack_params, i)
        new_caches = {}
        for j, kind in enumerate(pattern):
            x, nc = block_decode(params_i[f"pos{j}"], x, cfg, kind,
                                 positions=positions,
                                 cache=caches[i][f"pos{j}"])
            new_caches[f"pos{j}"] = nc
        outs.append(new_caches)
    return x, outs
