"""Block assembly: pre-norm residual blocks + a loop over stacked periods.

Counterpart of ``repro.models.transformer`` for the layer kinds of the
dense family, ``attn`` and ``local_attn``.  A config's ``pattern`` defines
the cycled layer kinds; parameters are stacked with a leading
``num_periods`` dim, as in the reference, and a Python loop over that dim
takes the place of ``lax.scan``.  Each block's float32 weights are cast to
the compute dtype at block entry (``cast_block_params``), one block at a
time, so the peak holds one block's cast copy, not the whole stack's.

Caches of the stack are a list with one cache tree per period (the
reference's per-layer list layout), so a step writes new per-period tensors
and never restacks.  The other kinds (``dense_mlp``, ``ssm``, ``rglru``,
``enc_attn``, ``cross``, and ``attn`` with experts) are not ported yet and
raise ``NotImplementedError`` (ROADMAP queue A 8d).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import apply_norm, dtype_of, make_norm

PyTree = Any

PORTED_KINDS = ("attn", "local_attn")


def check_kind(cfg: ModelConfig, kind: str) -> None:
    """Raise unless this package runs layer kind ``kind`` of ``cfg``."""
    if kind not in PORTED_KINDS:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported to repro_torch yet "
            f"(ROADMAP queue A 8d)")
    if kind == "attn" and cfg.num_experts:
        raise NotImplementedError(
            "mixture-of-experts blocks are not ported to repro_torch yet "
            "(ROADMAP queue A 8d)")


def tree_map(fn, tree: PyTree) -> PyTree:
    """``fn`` on every tensor leaf of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def cast_block_params(p: PyTree, cfg: ModelConfig) -> PyTree:
    """Cast >=2-D float32 weights to the compute dtype once at block entry
    (the per-matmul casts then do nothing); 1-D parameters (norm scales)
    stay float32."""
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
    return {
        "norm1": make_norm(cfg, device=device, lead=lead),
        "attn": attn.make_attention(cfg, generator, device=device, lead=lead),
        "norm2": make_norm(cfg, device=device, lead=lead),
        "mlp": mlp_mod.make_mlp(cfg, generator, device=device, lead=lead),
    }


# ---------------------------------------------------------------------------
# forward (full sequence, or an extension of warm caches)
# ---------------------------------------------------------------------------


def block_forward(p: PyTree, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                  positions: torch.Tensor, cache: Optional[PyTree] = None,
                  insert: Optional[int] = None):
    """Returns (x', aux, cache').  cache' is None unless ``cache`` given.

    With a cache this is an *extension*: the new K/V go into (a copy of)
    the cache, then every query attends over the whole cache (empty slots
    carry position -1 and mask out).  ``insert`` (default: all) is how many
    leading positions of ``x`` enter the cache; the rows after them are
    computed as queries only."""
    check_kind(cfg, kind)
    new_cache = cache
    p = cast_block_params(p, cfg)
    h = apply_norm(p["norm1"], x, cfg)
    window = cfg.local_window if kind == "local_attn" else 0
    q, k, v = attn.project_qkv(p["attn"], h, cfg,
                               positions if cfg.use_rope else None)
    if cache is not None:
        n = k.shape[1] if insert is None else insert
        lo = n - min(cfg.local_window, n) if kind == "local_attn" else 0
        new_cache = attn.cache_insert(cache, k[:, lo:n], v[:, lo:n],
                                      positions[:, lo:n])
        o = attn.decode_attend(q, new_cache, window=window,
                               q_positions=positions)
    else:
        o = attn.attend(q, k, v, causal=True, window=window,
                        q_positions=positions, kv_positions=positions,
                        kv_chunk=1024)
    x = x + attn.project_out(p["attn"], o, x.dtype)
    h2 = apply_norm(p["norm2"], x, cfg)
    x = x + mlp_mod.apply_mlp(p["mlp"], h2, cfg)
    return x, {}, new_cache


def block_decode(p: PyTree, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                 positions: torch.Tensor, cache: PyTree):
    """x: [B, 1, D]; positions: [B, 1] absolute. Returns (x', cache').  For
    the ported kinds a decode step is the extension by one token."""
    x, _, new_cache = block_forward(p, x, cfg, kind, positions=positions,
                                    cache=cache)
    return x, new_cache


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
    for i in range(num_periods(stack_params)):
        params_i = period_params(stack_params, i)
        new_caches: Dict[str, PyTree] = {}
        for j, kind in enumerate(pattern):
            c = None if caches is None else caches[i][f"pos{j}"]
            x, _, nc = block_forward(params_i[f"pos{j}"], x, cfg, kind,
                                     positions=positions, cache=c,
                                     insert=insert)
            new_caches[f"pos{j}"] = nc
        if outs is not None:
            outs.append(new_caches)
    return x, {}, outs


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
