"""CUDA kernel: odd-even transposition passes (the paper's lock-free bubble
sort, §II.2).

Replaces the TPU kernel ``repro/kernels/oddeven.py::oddeven_pallas``
(``_oddeven_kernel``, ``_compare_exchange``) together with the order gather
that ``ops.oddeven_sort`` does in front of it: from the raw ``cnt`` and
``order`` it returns the new ``order`` after ``passes`` x (even, odd)
compare-exchange sweeps, descending, strict ``<`` (equal counts never swap).

Bound on this card: bytes — ``cnt`` and ``order`` read, ``order`` written,
3·N·C·4 B whatever ``passes`` is.  The design holds a row in shared memory
for ALL passes (one warp per row, a lane per pair, ``__syncwarp`` between
half-passes), so extra passes cost shared-memory sweeps and no global
traffic.  In place (``oddeven_cuda_``, the state's owner) a row in which no
pair swapped is not written back, and a row that changed sets its dirty
flag, so the writes fall to the rows that changed.

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
           "oddeven_sort_ref_", "launches"]

launches = 0  # kernel launches made by this module's wrappers in this process

_MAX_SHARED_BYTES = 232448  # dynamic shared memory one block can ask for
_WARPS_PER_BLOCK = 4        # rows per block in csrc/oddeven.cu


def _launch(name, cnt, order, order_out, passes, dirty):
    global launches
    _build.require_cuda_int32(name, flags=("dirty",), cnt=cnt, order=order,
                              dirty=dirty)
    if cnt.dim() != 2 or cnt.shape != order.shape:
        raise ValueError(f"{name}: cnt/order must both be [N, C]")
    if passes < 0:
        raise ValueError(f"{name}: passes must be >= 0")
    n, cap = cnt.shape
    if _WARPS_PER_BLOCK * 2 * cap * 4 > _MAX_SHARED_BYTES:
        raise ValueError(f"{name}: capacity {cap} does not fit a row "
                         f"block in shared memory")
    if n > (2 ** 31 - 1) * _WARPS_PER_BLOCK:
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
