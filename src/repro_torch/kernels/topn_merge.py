"""CUDA kernel: cross-shard top-n merge (the global top-n read).

Replaces ``repro/kernels/ref.py::topn_merge_ref`` (``ops.topn_merge``), the
reduce step of ``core/sharded.py``'s top-n: a ``lax.scan`` of n steps that
the reference runs on every backend, no Pallas kernel (``ops.py:243-257``).
Each step reads the S list heads (a pointer past the end reads 0.0), takes
the first maximum (the lowest shard on ties, NaN above every number), emits
it when it is ``> 0`` (else EMPTY/EMPTY/0.0) and advances that shard's
pointer.  The same steps on any input, descending or not.

Bound on this card: latency.  The work is a few KB in and n·12 bytes out,
nanoseconds at the memory rate, and n dependent steps of an L-way argmax.
So a step must not wait on DRAM, and must be short: one block takes up to
1,024 lists in two levels — a warp per group of
32 lists, each lane holding its list's next four heads in registers (the
fourth's load in flight while it waits for its next win), then warp 0 over
the groups' steps kept in shared memory — and each step is one warp-wide
``__reduce_max_sync`` of a 32-bit key that orders floats as ``jnp.argmax``
does, and one ballot.  The recorded steps are written out by the whole
block.

More lists than one block takes (1,024 for n <= 256, fewer above, as
:func:`ref.merge_lists_per_launch` says) merge in launches: each writes
its blocks' steps raw, the heads as read and their positions, and the last
(one block) emits.  ``launches`` counts each.  The plain mirror of the
launches is :func:`topn_merge_rounds_ref`.

:func:`merge_windows_cuda` is the same merge over the window kernel's block
lists (``topn_windows.py``) with their dsts and the dropped count, then
:func:`label_srcs_cuda`, one pass over the src tables for the winners'
srcs (the reference's row -> src scatter, read for n rows only).

Source: ``csrc/topn_merge.cu`` (entries ``mcq_topn_merge``,
``mcq_topn_merge_windows``, ``mcq_topn_label``).  Plain versions:
:func:`topn_merge_ref`, :func:`topn_merge_windows_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (merge_lists_per_launch, topn_merge_ref,
                                     topn_merge_rounds_ref,
                                     topn_merge_windows_ref)

# the plain versions are re-exported beside their kernel
__all__ = ["topn_merge_cuda", "merge_windows_cuda", "label_srcs_cuda",
           "topn_merge_ref", "topn_merge_rounds_ref", "topn_merge_windows_ref",
           "launches"]

launches = 0  # kernel launches made by this module's wrappers in this process


def _launch(name, dev, *args):
    global launches
    _build.launch(name, dev, *args)
    launches += 1


def topn_merge_cuda(probs: torch.Tensor, dsts: torch.Tensor,
                    srcs: torch.Tensor, *, n: int):
    """probs float32 / dsts / srcs int32 [S, M] on the GPU, any S >= 1.
    Returns fresh ``(srcs[n], dsts[n], probs[n])``."""
    _build.require_cuda_int32("topn_merge_cuda", floats=("probs",),
                              probs=probs, dsts=dsts, srcs=srcs)
    if probs.dim() != 2 or dsts.shape != probs.shape or srcs.shape != probs.shape:
        raise ValueError("topn_merge_cuda: probs/dsts/srcs must be [S, M]")
    s, m = probs.shape
    if s < 1 or m < 1 or n < 0:
        raise ValueError(f"topn_merge_cuda: needs S >= 1, M >= 1 and n >= 0, "
                         f"got S={s}, M={m}, n={n}")
    dev = probs.device
    # the kernel writes every output: no fill (each would be a launch)
    out_s = torch.empty((n,), dtype=torch.int32, device=dev)
    out_d = torch.empty((n,), dtype=torch.int32, device=dev)
    out_p = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out_s, out_d, out_p
    per = merge_lists_per_launch(n)
    lists, width, pos = probs, m, None
    while True:   # launches of raw block merges, then the one that emits
        last = lists.shape[0] <= per
        if last:
            outs = (out_s, out_d, out_p, None)
        else:
            blocks = -(-lists.shape[0] // per)
            heads = torch.empty((blocks, n), dtype=torch.float32, device=dev)
            at = torch.empty((blocks, n), dtype=torch.int64, device=dev)
            outs = (None, None, heads, at)
        _launch("mcq_topn_merge", dev, lists.data_ptr(), _build.ptr(pos),
                dsts.data_ptr(), srcs.data_ptr(), lists.shape[0], width, n,
                per, int(last), *map(_build.ptr, outs))
        if last:
            return out_s, out_d, out_p
        lists, width, pos = heads, n, at


def merge_windows_cuda(lists: torch.Tensor, counts: torch.Tensor,
                       order: torch.Tensor, dst: torch.Tensor,
                       tab_keys: torch.Tensor, tab_vals: torch.Tensor, *,
                       n: int, blocks: int):
    """The merge of the window kernel's lists (int64 ``[S·blocks, n]``, as
    ``topn_windows.window_lists_cuda`` writes them, ``counts`` int64 ``[S,
    2]`` a view of its scratch) with their labels: dsts from ``order``/``dst``
    int32 ``[S, N, C]``, srcs from the src tables ``tab_keys/tab_vals``
    int32 ``[S, T]`` (:func:`label_srcs_cuda`).  Returns fresh ``(srcs[n],
    dsts[n], probs[n], dropped)``, ``dropped`` 0-dim int32.  Two launches."""
    _build.require_cuda_int32("merge_windows_cuda", order=order, dst=dst)
    s, rows, c = order.shape
    if (lists.dtype != torch.int64 or counts.dtype != torch.int64
            or not lists.is_contiguous() or not counts.is_contiguous()
            or lists.shape != (s * blocks, n) or counts.shape != (s, 2)
            or dst.shape != order.shape or lists.device != order.device
            or counts.device != order.device):
        raise ValueError("merge_windows_cuda: lists must be int64 [S*blocks, "
                         "n], counts int64 [S, 2] and dst [S, N, C] beside "
                         "order, contiguous")
    dev = order.device
    win = torch.empty((3 * n,), dtype=torch.int32, device=dev)
    out_s = torch.empty((n,), dtype=torch.int32, device=dev)
    out_d = torch.empty((n,), dtype=torch.int32, device=dev)
    out_p = torch.empty((n,), dtype=torch.float32, device=dev)
    dropped = torch.empty((), dtype=torch.int32, device=dev)
    _launch("mcq_topn_merge_windows", dev, lists.data_ptr(), counts.data_ptr(),
            s, blocks, n, min(n, c), rows, c, order.data_ptr(), dst.data_ptr(),
            win.data_ptr(), out_s.data_ptr(), out_d.data_ptr(),
            out_p.data_ptr(), dropped.data_ptr())
    label_srcs_cuda(tab_keys, tab_vals, win, out_s, rows=rows)
    return out_s, out_d, out_p, dropped


def label_srcs_cuda(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                    win: torch.Tensor, out_src: torch.Tensor, *,
                    rows: int) -> None:
    """The winners' srcs into ``out_src`` [n] (left EMPTY by the merge):
    one pass over the src tables ``tab_keys/tab_vals`` int32 ``[S, T]``; a
    valid lane whose row (``s·rows + value``) is a winner's, by ``win`` int32
    ``[3 n]`` as the merge wrote it, writes its key."""
    _build.require_cuda_int32("label_srcs_cuda", tab_keys=tab_keys,
                              tab_vals=tab_vals, win=win, out_src=out_src)
    s, table = tab_keys.shape
    n = out_src.shape[0]
    if (tab_vals.shape != tab_keys.shape or win.shape != (3 * n,)
            or s * rows >= 2 ** 31 - 1):
        raise ValueError("label_srcs_cuda: the src tables must be [S, T], "
                         "win [3 n], and S * rows below 2^31 - 1")
    _launch("mcq_topn_label", tab_keys.device, tab_keys.data_ptr(),
            tab_vals.data_ptr(), s, table, rows, win.data_ptr(), n,
            out_src.data_ptr())
