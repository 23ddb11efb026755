"""CUDA kernel: the sharded chain's global top-n in one pass over the slabs.

Replaces, on the card, the plain torch of ``core/sharded.py::topn_lists``
— every row's ``min(n, C)``-item window gathered, a stable descending
``torch.sort`` of all S·N·k window entries, a ``count_nonzero`` over the
whole slab — which stands for the reference's per-shard body
``repro/core/sharded.py:270 _topn_local`` (``take_along_axis``,
``lax.top_k``, the live count) before its ``ops.topn_merge``.  No Pallas
kernel.

Bound on this card: bytes.  Each row's counts, its k order heads and its
total are read once, 2.43 GB at S = 4, N = 2^20, C = 128, n = 16 (0.73 ms
at 3.35 TB/s); everything else is a few KB.  So one launch streams the
stacked slab (``csrc/topn_windows.cu``): blocks own contiguous row tiles of
one shard (two blocks an SM), each warp takes its rows a group at a time
(about 64 window entries, 4 rows at k = 16) and keeps groups in flight
through a ``cp.async`` ring in shared memory, each row gives its live
count and its window probabilities from the copy it already holds, and each warp keeps its best n window entries
under one 64-bit key, ``(prob bits << 32) | (0xFFFFFFFF - (row·k + j))``,
which orders (prob desc, flat position asc) as ``lax.top_k`` does; almost
every entry is rejected by one compare against the warp's n-th.  The block
writes its n best keys (list ``s·B + b``), and adds its live edges and live
window entries to its shard's counts by one atomic each.  The lists, in
(shard, block) order, are each descending with the lower position first,
so their flat head-pointer merge by probability, the lowest list on ties,
takes the entries in (prob desc, shard, row, window position) order — the
reference's per-shard ``lax.top_k`` then its cross-shard merge.

The merge of the block lists is the next launch
(``topn_merge.merge_windows_cuda``), and one pass over the src tables
labels the winners' srcs (``topn_merge.label_srcs_cuda``).  The counts are
per-call scratch, so two readers may run the read at once.

Limits of the CUDA path (it raises, naming them; the plain path has none):
n <= :data:`MAX_N`, C <= :data:`MAX_CAPACITY`, N·k <= 2^32, S·N < 2^31 -
1, and S <= ``ref.merge_lists_per_launch(n)`` (1,024 for n <= 256).

Source: ``csrc/topn_windows.cu`` (entry ``mcq_topn_windows``).  Plain
version: :func:`topn_windows_ref` (its parts :func:`topn_window_lists_ref`
and :func:`topn_merge_windows_ref`).
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import topn_merge as _tm
from repro_torch.kernels.ref import (merge_lists_per_launch,
                                     topn_merge_windows_ref,
                                     topn_window_lists_ref, topn_windows_ref)

# the plain versions are re-exported beside their kernel
__all__ = ["topn_windows_cuda", "window_lists_cuda", "blocks_for",
           "topn_windows_ref", "topn_window_lists_ref",
           "topn_merge_windows_ref", "launches", "MAX_N", "MAX_CAPACITY"]

launches = 0  # kernel launches made by this module's wrappers in this process

MAX_N = 1024         # the warps' lists live in shared memory
MAX_CAPACITY = 1024  # a row's counts take one slot of the ring


def _check(cnt, order, tot, n, dst=None, tab_keys=None, tab_vals=None):
    """Shapes, then the limits of the CUDA path, then types and device."""
    if (cnt.dim() != 3 or order.shape != cnt.shape
            or tot.shape != cnt.shape[:2]
            or (dst is not None and dst.shape != cnt.shape)
            or (tab_keys is not None and (
                tab_keys.dim() != 2 or tab_vals.shape != tab_keys.shape
                or tab_keys.shape[0] != cnt.shape[0]))):
        raise ValueError("topn_windows_cuda: cnt/order/dst must be [S, N, C], "
                         "tot [S, N] and the src tables [S, T]")
    s, rows, c = cnt.shape
    k = min(n, c)
    if not 1 <= n <= rows * k:
        raise ValueError(f"top-n of {n} over {rows * k} entries per shard")
    if n > MAX_N:
        raise ValueError(f"topn_windows_cuda: n = {n} is above MAX_N = "
                         f"{MAX_N}")
    if c > MAX_CAPACITY:
        raise ValueError(f"topn_windows_cuda: C = {c} is above MAX_CAPACITY "
                         f"= {MAX_CAPACITY}")
    if rows * k > 2 ** 32:
        raise ValueError(f"topn_windows_cuda: N * k = {rows * k} is above "
                         f"2^32 (the key's position word)")
    if s > merge_lists_per_launch(n):
        raise ValueError(f"topn_windows_cuda: S = {s} is above the "
                         f"{merge_lists_per_launch(n)} lists one merge block "
                         f"takes at n = {n}")
    if s * rows >= 2 ** 31 - 1:
        raise ValueError(f"topn_windows_cuda: S * N = {s * rows} is not below "
                         f"2^31 - 1 (a winner's flat row)")
    _build.require_cuda_int32("topn_windows_cuda", cnt=cnt, order=order,
                              tot=tot, dst=dst, tab_keys=tab_keys,
                              tab_vals=tab_vals)


def blocks_for(cnt: torch.Tensor, n: int) -> int:
    """Blocks per shard the kernel runs on this card for ``cnt`` [S, N, C]
    and n (lists ``s·B + b`` of :func:`window_lists_cuda`): enough to fill
    it, at most ``merge_lists_per_launch(n) // S``."""
    return _blocks(cnt.device, *cnt.shape, n)


@functools.lru_cache(maxsize=64)
def _blocks(device, s, rows, c, n):
    lib = _build.load()
    with torch.cuda.device(device):
        got = lib.mcq_topn_windows_blocks(s, rows, c, min(n, c), n,
                                          merge_lists_per_launch(n))
    if got < 1:
        raise RuntimeError(f"mcq_topn_windows_blocks refused S={s} N={rows} "
                           f"C={c} n={n}")
    return got


def _lists(cnt, order, tot, n):
    """The kernel: ``(lists, counts, blocks)``."""
    global launches
    s, rows, c = cnt.shape
    blocks = blocks_for(cnt, n)
    lists = torch.empty((s * blocks, n), dtype=torch.int64, device=cnt.device)
    counts = torch.zeros((s, 2), dtype=torch.int64, device=cnt.device)
    _build.launch("mcq_topn_windows", cnt.device, cnt.data_ptr(),
                  order.data_ptr(), tot.data_ptr(), s, rows, c, min(n, c), n,
                  blocks, lists.data_ptr(), counts.data_ptr())
    launches += 1
    return lists, counts, blocks


def window_lists_cuda(cnt: torch.Tensor, order: torch.Tensor,
                      tot: torch.Tensor, *, n: int):
    """The kernel alone (no merge): cnt/order int32 ``[S, N, C]``, tot
    ``[S, N]``, contiguous, on the GPU.  Returns ``(lists int64 [S·B, n],
    counts int64 [S, 2])``, B = :func:`blocks_for`, as
    :func:`topn_window_lists_ref` at B blocks."""
    _check(cnt, order, tot, n)
    return _lists(cnt, order, tot, n)[:2]


def topn_windows_cuda(cnt: torch.Tensor, order: torch.Tensor,
                      tot: torch.Tensor, dst: torch.Tensor,
                      tab_keys: torch.Tensor, tab_vals: torch.Tensor, *,
                      n: int):
    """The global top-n of a stacked state's slabs (cnt/order/dst int32
    ``[S, N, C]``, tot ``[S, N]``, contiguous, on the GPU) labelled through
    its src tables ``tab_keys/tab_vals`` int32 ``[S, T]``: fresh ``(srcs[n],
    dsts[n], probs[n], dropped)``, ``dropped`` 0-dim int32.  This kernel,
    the merge of its lists (``topn_merge.merge_windows_cuda``), then the
    srcs' pass over the tables (``topn_merge.label_srcs_cuda``)."""
    _check(cnt, order, tot, n, dst, tab_keys, tab_vals)
    lists, counts, blocks = _lists(cnt, order, tot, n)
    return _tm.merge_windows_cuda(lists, counts, order, dst, tab_keys,
                                  tab_vals, n=n, blocks=blocks)
