"""CUDA kernel: odd-even transposition passes (the paper's lock-free bubble
sort, §II.2).

Replaces the TPU kernel ``repro/kernels/oddeven.py::oddeven_pallas``
(``_oddeven_kernel``, ``_compare_exchange``) together with the order gather
that ``ops.oddeven_sort`` does in front of it: from the raw ``cnt`` and
``order`` it returns the new ``order`` after ``passes`` x (even, odd)
compare-exchange sweeps, descending, strict ``<`` (equal counts never swap).

Bound on this card: bytes — ``cnt`` and ``order`` read, ``order`` written,
3·N·C·4 B whatever ``passes`` is.  The design holds a row in shared memory
for ALL passes, so extra passes cost shared-memory sweeps and no global
traffic.  A row takes only the lanes it uses (:func:`geometry`: a lane per
compare-exchange pair up to C = 64, so a warp holds four rows at C = 16),
loads its ``cnt`` and ``order`` together as independent 16-byte vectors
and gathers the counts into priority order from shared memory, so no load
waits on another (up to C = 64 a lane then sorts its pair in registers,
its neighbour's by shuffles); a grid of the card's resident blocks walks the rows, a
lane keeping the loads of the next one or two rows in flight while a row
sorts, so no block is launched for a handful of rows.  In place (``oddeven_cuda_``, the state's owner) a row
in which no pair swapped is not written back, and a row that changed sets
its dirty flag, so the writes fall to the rows that changed.

Source: ``csrc/oddeven.cu`` (entry ``mcq_oddeven``).  Plain versions:
:func:`oddeven_sort_ref` (= order gather + :func:`oddeven_ref`) and
:func:`oddeven_sort_ref_`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import oddeven_ref, oddeven_sort_ref, oddeven_sort_ref_

# the plain versions are re-exported beside their kernel
__all__ = ["oddeven_cuda", "oddeven_cuda_", "oddeven_ref", "oddeven_sort_ref",
           "oddeven_sort_ref_", "geometry", "MAX_CAPACITY", "launches"]

launches = 0  # kernel launches made by this module's wrappers in this process

_MAX_SHARED_BYTES = 232448  # dynamic shared memory one block can ask for
_WARP = 32
_WARPS_PER_BLOCK = 8        # MCQ_OE_WARPS in csrc/oddeven.cu
#: the widest row: one row of cnt + order in a block's shared memory
MAX_CAPACITY = _MAX_SHARED_BYTES // (2 * 4)


def geometry(capacity: int):
    """``(lanes, rows_per_warp, warps_per_block)`` of ``csrc/oddeven.cu``
    for rows of ``capacity`` slots: a row takes next_pow2(ceil(C/2)) lanes,
    at most 32, a warp holds 32 / lanes rows, and a block as many warps (up
    to 8) as its rows' cnt and order fit in its shared memory."""
    half, lanes = (capacity + 1) // 2, 1
    while lanes < half and lanes < _WARP:
        lanes *= 2
    per_warp = _WARP // lanes
    warps = min(_WARPS_PER_BLOCK,
                _MAX_SHARED_BYTES // (2 * capacity * 4 * per_warp))
    return lanes, per_warp, warps


def _launch(name, cnt, order, order_out, passes, dirty):
    global launches
    _build.require_cuda_int32(name, flags=("dirty",), cnt=cnt, order=order,
                              dirty=dirty)
    if cnt.dim() != 2 or cnt.shape != order.shape:
        raise ValueError(f"{name}: cnt/order must both be [N, C]")
    if passes < 0:
        raise ValueError(f"{name}: passes must be >= 0")
    n, cap = cnt.shape
    if cap > MAX_CAPACITY:
        raise ValueError(f"{name}: capacity {cap} does not fit a row "
                         f"in shared memory (at most {MAX_CAPACITY})")
    if n > 2 ** 31 - 1:
        raise ValueError(f"{name}: too many rows for one launch")
    _build.require_flags(name, dirty, n)
    if n == 0 or cap == 0:
        return
    _build.launch("mcq_oddeven", cnt.device, cnt.data_ptr(), order.data_ptr(),
                  order_out.data_ptr(), _build.ptr(dirty), n, cap, passes)
    launches += 1


def oddeven_cuda(cnt: torch.Tensor, order: torch.Tensor, *, passes: int = 1):
    """``passes`` odd-even passes over every row on the GPU; cnt/order
    [N, C].  Returns the new order permutation (a fresh tensor)."""
    order_out = torch.empty_like(order)
    _launch("oddeven_cuda", cnt, order, order_out, passes, None)
    return order_out


def oddeven_cuda_(cnt: torch.Tensor, order: torch.Tensor, *, passes: int = 1,
                  dirty=None) -> None:
    """The same passes written into ``order`` itself: only the rows that
    changed are written, and their ``dirty`` (uint8 [N]) flags set."""
    _launch("oddeven_cuda_", cnt, order, order, passes, dirty)
