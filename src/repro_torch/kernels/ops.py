"""Public entry points of the kernel layer: backend dispatch.

Counterpart of ``repro.kernels.ops``.  ``impl='cuda'`` launches the
hand-written CUDA kernel (and raises on CPU tensors), ``impl='ref'`` runs the
plain PyTorch version on whatever device the tensors are on, ``impl='auto'``
picks the kernel for CUDA tensors and the plain version for CPU tensors.
A kernel that fails to build or launch raises; nothing falls back to the
plain version.

Each write kernel has two forms.  The functional one returns new tensors
and writes nothing it is given (an ``EpochStore`` reader may hold it).  The
in-place one (a trailing underscore) writes into the tensors it is given —
for the state's owner — and takes ``dirty`` (None, or uint8 [N], one flag
per row), which it sets for every row whose ``cnt``, ``dst``, ``tot`` or
``order`` it changed.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.analysis.invariants import kernel_op
from repro_torch.core.hashtable import EMPTY
from repro_torch.kernels import cdf_gather as _cg
from repro_torch.kernels import cdf_query as _cdf
from repro_torch.kernels import copy_rows as _cr
from repro_torch.kernels import decay_sort as _ds
from repro_torch.kernels import dh_rebuild as _dr
from repro_torch.kernels import oddeven as _oe
from repro_torch.kernels import probe as _pr
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import slab_update as _su
from repro_torch.kernels import slow_path as _sp
from repro_torch.kernels import topn_merge as _tm
from repro_torch.kernels import walk as _wk
from repro_torch.obs import tracing as _obs_tracing

_IMPLS = ("auto", "ref", "cuda")


def _use_ref(impl: str, x: torch.Tensor) -> bool:
    """Validate ``impl`` and decide the dispatch from where ``x`` lives."""
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(
            f"impl='cuda' needs CUDA tensors, got a tensor on {x.device}")
    return impl == "ref" or not x.is_cuda


def _annotate(fn):
    """Opt-in profiler annotation around a dispatcher: when
    ``obs.tracing.KERNEL_ANNOTATE`` is on, the call runs under
    ``torch.profiler.record_function("mcq.<op>")``, so the op's name spans
    its launches (or its plain version's ops) in a profiler timeline; off,
    the gate costs one module-global read per call."""
    @functools.wraps(fn)
    def dispatch(*args, **kwargs):
        if _obs_tracing.KERNEL_ANNOTATE:
            with torch.profiler.record_function(f"mcq.{fn.__name__}"):
                return fn(*args, **kwargs)
        return fn(*args, **kwargs)
    return dispatch


# ---------------------------------------------------------------------------


@kernel_op(ref="oddeven_sort_ref", pallas="oddeven_pallas")
@_annotate
def oddeven_sort(cnt: torch.Tensor, order: torch.Tensor, *, passes: int = 1,
                 impl: str = "auto") -> torch.Tensor:
    """k odd-even passes over every slab row; returns the new order
    permutation (slabs themselves never move)."""
    if _use_ref(impl, cnt):
        return _ref.oddeven_sort_ref(cnt, order, passes)
    return _oe.oddeven_cuda(cnt, order, passes=passes)


@kernel_op(ref="oddeven_sort_ref_")
@_annotate
def oddeven_sort_(cnt: torch.Tensor, order: torch.Tensor, *, passes: int = 1,
                  dirty=None, impl: str = "auto") -> None:
    """The passes written into ``order``: only the rows that changed are
    written, and flagged."""
    if _use_ref(impl, cnt):
        _ref.oddeven_sort_ref_(cnt, order, passes, dirty)
    else:
        _oe.oddeven_cuda_(cnt, order, passes=passes, dirty=dirty)


@kernel_op(ref="slab_update_ref", pallas="slab_update_pallas")
@_annotate
def slab_update(rows: torch.Tensor, dsts: torch.Tensor, w: torch.Tensor,
                dst_slab: torch.Tensor, cnt: torch.Tensor, tot: torch.Tensor,
                *, impl: str = "auto"):
    """Fast-path batched increments; returns (cnt', tot').
    rows < 0 = padding/inactive items."""
    if _use_ref(impl, cnt):
        _, cnt2, tot2, _ = _ref.slab_update_ref(rows, dsts, w, dst_slab, cnt, tot)
        return cnt2, tot2
    return _su.slab_update_cuda(rows, dsts, w, dst_slab, cnt, tot)


@kernel_op(ref="slab_update_ref_")
@_annotate
def slab_update_(rows: torch.Tensor, dsts: torch.Tensor, w: torch.Tensor,
                 dst_slab: torch.Tensor, cnt: torch.Tensor, tot: torch.Tensor,
                 *, dirty=None, impl: str = "auto") -> None:
    """Fast-path batched increments written into ``cnt``/``tot``; every row
    an item hit is flagged."""
    if _use_ref(impl, cnt):
        _ref.slab_update_ref_(rows, dsts, w, dst_slab, cnt, tot, dirty)
    else:
        _su.slab_update_cuda_(rows, dsts, w, dst_slab, cnt, tot, dirty=dirty)


@kernel_op(ref="decay_sort_ref")
@_annotate
def decay_sort(cnt: torch.Tensor, dst: torch.Tensor, order: torch.Tensor,
               *, dh_keys=None, dh_vals=None, impl: str = "auto"):
    """§II.C decay: halve counters, evict dead edges, fully re-sort.

    On CUDA tensors one launch of the fused decay kernel; the plain version
    composes the halving with C/2+1 odd-even passes (a full odd-even
    transposition network sorts any input).  Returns (cnt', dst', order',
    tot') with evicted slots at the order tail; given the row hashes
    ``dh_keys/dh_vals [N, H]``, also a copy of ``dh_keys`` with every lane
    whose slot died made TOMB, and their number (0-dim int32).
    """
    if _use_ref(impl, cnt):
        return _ref.decay_sort_ref(cnt, dst, order, dh_keys, dh_vals)
    return _ds.decay_sort_cuda(cnt, dst, order, dh_keys=dh_keys,
                               dh_vals=dh_vals)


@kernel_op(ref="decay_sort_ref_")
@_annotate
def decay_sort_(cnt: torch.Tensor, dst: torch.Tensor, order: torch.Tensor,
                tot: torch.Tensor, *, fire=None, dirty=None, dh_keys=None,
                dh_vals=None, tombstones=None, impl: str = "auto") -> None:
    """The decay of every row written into ``cnt, dst, order, tot``, every
    row flagged; nothing at all when the 0-dim bool tensor ``fire`` is
    false (read on the device, never on the host).  Given the row hashes,
    their lanes whose slot died become TOMB in ``dh_keys`` and their number
    is added to ``tombstones`` (0-dim int32)."""
    dh = dict(dh_keys=dh_keys, dh_vals=dh_vals, tombstones=tombstones)
    if _use_ref(impl, cnt):
        _ref.decay_sort_ref_(cnt, dst, order, tot, fire, dirty, **dh)
    else:
        _ds.decay_sort_cuda_(cnt, dst, order, tot, fire=fire, dirty=dirty, **dh)


@kernel_op(ref="decay_sort_rolling_ref")
@_annotate
def decay_sort_rolling(cnt: torch.Tensor, dst: torch.Tensor,
                       order: torch.Tensor, tot: torch.Tensor,
                       cursor: torch.Tensor, *, block_rows: int,
                       dh_keys=None, dh_vals=None, tombstones=None,
                       impl: str = "auto"):
    """Rolling §II.C decay of the ``block_rows``-row block the device-side
    ``cursor`` selects (the reference's clamped last block included), with
    no device->host synchronisation.  Returns ``(cnt', dst', order', tot',
    cursor')``: copies of the inputs with that block decayed, and the next
    cursor; given the row hashes, also copies of ``dh_keys`` and
    ``tombstones`` with the block's hashes repaired; the inputs are not
    written."""
    dh = dict(dh_keys=dh_keys, dh_vals=dh_vals, tombstones=tombstones)
    if _use_ref(impl, cnt):
        return _ref.decay_sort_rolling_ref(cnt, dst, order, tot, cursor,
                                           block_rows, **dh)
    return _ds.decay_sort_rolling_cuda(cnt, dst, order, tot, cursor,
                                       block_rows=block_rows, **dh)


@kernel_op(ref="decay_sort_rolling_ref_")
@_annotate
def decay_sort_rolling_(cnt: torch.Tensor, dst: torch.Tensor,
                        order: torch.Tensor, tot: torch.Tensor,
                        cursor: torch.Tensor, *, block_rows: int, fire=None,
                        dirty=None, dh_keys=None, dh_vals=None,
                        tombstones=None, impl: str = "auto") -> None:
    """The rolling decay written into ``cnt, dst, order, tot`` (the block's
    rows, flagged) and ``cursor`` (moved to the next block); nothing at all
    when the 0-dim bool tensor ``fire`` is false.  Given the row hashes,
    the block's are repaired as in :func:`decay_sort_`.  No device->host
    synchronisation."""
    dh = dict(dh_keys=dh_keys, dh_vals=dh_vals, tombstones=tombstones)
    if _use_ref(impl, cnt):
        _ref.decay_sort_rolling_ref_(cnt, dst, order, tot, cursor, block_rows,
                                     fire, dirty, **dh)
    else:
        _ds.decay_sort_rolling_cuda_(cnt, dst, order, tot, cursor,
                                     block_rows=block_rows, fire=fire,
                                     dirty=dirty, **dh)


@kernel_op(ref="dh_rebuild_ref_")
@_annotate
def dh_rebuild_(cnt: torch.Tensor, dst: torch.Tensor, dh_keys: torch.Tensor,
                dh_vals: torch.Tensor, counters: torch.Tensor, *,
                threshold: int, max_probes: int = 64, fire=None, dirty=None,
                impl: str = "auto") -> None:
    """Rebuild every row hash ``dh_keys/dh_vals [N, H]`` from the slab
    ``cnt/dst [N, C]`` when ``counters[1]`` (``dh_tombstones``) is above
    ``threshold`` (and the 0-dim bool ``fire``, if given, holds): decided on
    the device, no device->host synchronisation.  Then ``counters``
    (``dh_rebuilds``, ``dh_tombstones``) becomes ``(+1, 0)`` and every row
    is flagged."""
    if _use_ref(impl, cnt):
        _ref.dh_rebuild_ref_(cnt, dst, dh_keys, dh_vals, counters, threshold,
                             max_probes, fire, dirty)
    else:
        _dr.dh_rebuild_cuda_(cnt, dst, dh_keys, dh_vals, counters,
                             threshold=threshold, max_probes=max_probes,
                             fire=fire, dirty=dirty)


@kernel_op(ref="dh_find_ref", pallas="probe_find_pallas")
@_annotate
def dh_find(rows: torch.Tensor, dsts: torch.Tensor,
            dh_keys: torch.Tensor, dh_vals: torch.Tensor,
            *, max_probes: int = 64, impl: str = "auto"):
    """Batched per-row dst-hash lookup: ``(slots[B], found[B] bool)``.

    The paper's §II.2 dst -> slot tables through the shared probe kernel;
    rows < 0 are padding.  Semantics are the core linear probe
    (``hashtable.lookup``).
    """
    if _use_ref(impl, dh_keys):
        return _ref.dh_find_ref(rows, dsts, dh_keys, dh_vals, max_probes)
    return _pr.probe_find_cuda(rows, dsts, dh_keys, dh_vals,
                               max_probes=max_probes)


@kernel_op(ref="probe_find_ref", pallas="probe_find_pallas")
@_annotate
def ht_find(keys_q: torch.Tensor, tab_keys: torch.Tensor,
            tab_vals: torch.Tensor, *, max_probes: int = 64,
            miss: int = EMPTY, impl: str = "auto"):
    """Batched flat-table lookup: ``(vals[B], found[B] bool)``, ``miss``
    (EMPTY unless the caller picks another value) where not found.

    The src node-id -> row probe at the head of every query and update
    (paper §II.1), the flat mode of the shared probe kernel: on CUDA tensors
    one launch, outputs already in their final type and value.
    ``hashtable.lookup_batch`` routes here when an impl is given.
    """
    if _use_ref(impl, tab_keys):
        return _ref.probe_find_ref(None, keys_q, tab_keys, tab_vals,
                                   max_probes, miss)
    return _pr.probe_find_cuda(None, keys_q, tab_keys, tab_vals,
                               max_probes=max_probes, miss=miss)


@kernel_op(ref="cdf_query_ref", pallas="cdf_query_pallas")
@_annotate
def cdf_query(c_ord: torch.Tensor, d_ord: torch.Tensor, tot: torch.Tensor,
              threshold, *, max_items: int = 16, chunks: int = 0,
              topk: bool = False, impl: str = "auto"):
    """Threshold inference over pre-ordered rows (cdf_query.py).

    ``c_ord/d_ord[B, C]`` are counts/dsts already in priority order (zeros
    for unknown srcs), ``tot[B]`` the row totals.  ``threshold=None`` (or
    ``topk=True``) is top-k mode.  ``chunks`` is validated and otherwise
    changes nothing: every chunking of the integer walk gives the same bits.
    """
    topk = topk or threshold is None
    _cdf.auto_chunks(c_ord.shape[1], chunks)
    threshold = None if topk else threshold
    if _use_ref(impl, c_ord):
        return _ref.cdf_query_ref(c_ord, d_ord, tot, threshold, max_items)
    return _cdf.cdf_query_cuda(c_ord, d_ord, tot, threshold,
                               max_items=max_items)


@kernel_op(ref="cdf_query_fused_ref", pallas="cdf_query_fused_pallas")
@_annotate
def cdf_query_fused(rows: torch.Tensor, found: torch.Tensor,
                    cnt: torch.Tensor, dst: torch.Tensor, order: torch.Tensor,
                    tot: torch.Tensor, threshold, *, max_items: int = 16,
                    chunks: int = 0, topk: bool = False, impl: str = "auto"):
    """Fused inference: in-kernel row gather + CDF walk (cdf_gather.py).

    Takes pre-resolved rows[B] (0 where missing) + found[B] (bool, as
    ``ht_find`` returns it) and the raw slab arrays; only queried rows are
    touched.  ``threshold=None`` (or ``topk=True``) is top-k mode.
    ``chunks`` is validated and otherwise changes nothing: every chunking of
    the integer walk gives the same bits.
    """
    topk = topk or threshold is None
    _cdf.auto_chunks(cnt.shape[1], chunks)
    threshold = None if topk else threshold
    if _use_ref(impl, cnt):
        return _ref.cdf_query_fused_ref(rows, found, cnt, dst, order, tot,
                                        threshold, max_items)
    return _cg.cdf_query_fused_cuda(rows, found, cnt, dst, order, tot,
                                    threshold, max_items=max_items)


@kernel_op(ref="topn_merge_ref", pallas=None)
@_annotate
def topn_merge(probs: torch.Tensor, dsts: torch.Tensor, srcs: torch.Tensor,
               *, n: int, impl: str = "auto"):
    """Cross-shard top-n merge: ``(srcs[n], dsts[n], probs[n])``.

    Merges S per-shard top lists (``probs`` float32, ``dsts/srcs`` int32
    ``[S, M]``, descending on the sharded read's path) into one list of n
    by the reference's head-pointer steps — the reduce step of
    ``core/sharded.py``'s global top-n.  On CUDA tensors one launch of a
    one-block kernel for S <= 32, a round more per factor of 32 above.
    """
    if _use_ref(impl, probs):
        return _ref.topn_merge_ref(probs, dsts, srcs, n)
    return _tm.topn_merge_cuda(probs, dsts, srcs, n=n)


@kernel_op(ref="draft_walk_ref", pallas="draft_walk_pallas")
@_annotate
def draft_walk(window: torch.Tensor, ht_keys: torch.Tensor,
               ht_vals: torch.Tensor, cnt: torch.Tensor, dst: torch.Tensor,
               ord0: torch.Tensor, *, k: int = 4, max_probes: int = 64,
               impl: str = "auto"):
    """One-shot k-step greedy draft walk (walk.py).

    window[B, order] recent tokens; the chain snapshot (src table + slabs +
    order heads ``ord0[N]``, e.g. the strided view ``slabs.order[:, 0]``) is
    read-only during a draft, so the whole k-step walk is one launch.
    Returns ``(toks[B, k], ok[B, k] bool)``.
    """
    if _use_ref(impl, cnt):
        toks, oks = _ref.draft_walk_ref(window, ht_keys, ht_vals, cnt, dst,
                                        ord0, k=k, max_probes=max_probes)
    else:
        toks, oks = _wk.draft_walk_cuda(window, ht_keys, ht_vals, cnt, dst,
                                        ord0, k=k, max_probes=max_probes)
    return toks, oks.to(torch.bool)


@kernel_op(composes=("slow_path_",))
@_annotate
def slow_path(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
              dst_slab: torch.Tensor, cnt: torch.Tensor, tot: torch.Tensor,
              order: torch.Tensor, counters: torch.Tensor,
              src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
              active: torch.Tensor, *, max_probes: int = 64, dh_keys=None,
              dh_vals=None, impl: str = "auto"):
    """The new-edge pass (row allocation, slot allocation, Space-Saving
    replacement) over items ``src/dst/w[L]`` where ``active``, with the
    result of a sequential walk in item order; ``counters[4]`` = (n_rows,
    dropped_rows, dropped_probes, evictions).  Given the row hashes
    ``dh_keys/dh_vals [N, H]``, each item also deletes the dst it evicted
    and inserts its own.  Returns ``(tab_keys, tab_vals, dst_slab, cnt,
    tot, counters)``, and ``(dh_keys, dh_vals)`` after them when given, all
    fresh."""
    if _use_ref(impl, cnt):
        return _ref.slow_path_ref(tab_keys, tab_vals, dst_slab, cnt, tot,
                                  order, counters, src, dst, w, active,
                                  max_probes, dh_keys, dh_vals)
    return _sp.slow_path_cuda(tab_keys, tab_vals, dst_slab, cnt, tot, order,
                              counters, src, dst, w, active.to(torch.int32),
                              max_probes=max_probes, dh_keys=dh_keys,
                              dh_vals=dh_vals)


@kernel_op(ref="slow_path_ref_")
@_annotate
def slow_path_(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
               dst_slab: torch.Tensor, cnt: torch.Tensor, tot: torch.Tensor,
               order: torch.Tensor, counters: torch.Tensor,
               src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
               active: torch.Tensor, *, max_probes: int = 64, dirty=None,
               dh_keys=None, dh_vals=None, impl: str = "auto") -> None:
    """The new-edge pass written into the src table, ``dst_slab``, ``cnt``,
    ``tot``, ``counters`` and, when given, the row hashes; every row
    written is flagged."""
    if _use_ref(impl, cnt):
        _ref.slow_path_ref_(tab_keys, tab_vals, dst_slab, cnt, tot, order,
                            counters, src, dst, w, active, max_probes, dirty,
                            dh_keys, dh_vals)
    else:
        _sp.slow_path_cuda_(tab_keys, tab_vals, dst_slab, cnt, tot, order,
                            counters, src, dst, w, active.to(torch.int32),
                            max_probes=max_probes, dirty=dirty,
                            dh_keys=dh_keys, dh_vals=dh_vals)


@kernel_op(ref="copy_dirty_rows_ref")
@_annotate
def copy_dirty_rows(front, back, dirty: torch.Tensor, *,
                    impl: str = "auto") -> None:
    """Catch ``back`` up with ``front``, each ``(cnt, dst, order, tot,
    table keys, table vals, scalars)`` and optionally ``(dh_keys,
    dh_vals)`` after them: the rows flagged in ``dirty`` (the row hashes'
    rows too) and the rest whole; then clear the flags."""
    row_hashes = tuple(front[7:]) + tuple(back[7:]) or None
    copy = _ref.copy_dirty_rows_ref if _use_ref(impl, dirty) \
        else _cr.copy_dirty_rows_cuda
    copy(*front[:7], *back[:7], dirty, row_hashes=row_hashes)
