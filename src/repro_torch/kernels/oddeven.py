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
half-passes), so extra passes cost shared-memory sweeps and no global traffic.
``ops.decay_sort`` runs it with ``C//2 + 1`` passes as a full sort.

Source: ``csrc/oddeven.cu`` (entry ``mcq_oddeven``).  Plain version:
:func:`oddeven_sort_ref` (= order gather + :func:`oddeven_ref`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import oddeven_ref, oddeven_sort_ref

# the plain version is re-exported beside its kernel
__all__ = ["oddeven_cuda", "oddeven_ref", "oddeven_sort_ref", "launches"]

launches = 0  # kernel launches made by oddeven_cuda in this process

_MAX_SHARED_BYTES = 232448  # dynamic shared memory one block can ask for
_WARPS_PER_BLOCK = 4        # rows per block in csrc/oddeven.cu


def oddeven_cuda(cnt: torch.Tensor, order: torch.Tensor, *, passes: int = 1):
    """``passes`` odd-even passes over every row on the GPU; cnt/order
    [N, C].  Returns the new order permutation (a fresh tensor)."""
    global launches
    _build.require_cuda_int32("oddeven_cuda", cnt=cnt, order=order)
    if cnt.dim() != 2 or cnt.shape != order.shape:
        raise ValueError("oddeven_cuda: cnt/order must both be [N, C]")
    if passes < 0:
        raise ValueError("oddeven_cuda: passes must be >= 0")
    n, cap = cnt.shape
    if _WARPS_PER_BLOCK * 2 * cap * 4 > _MAX_SHARED_BYTES:
        raise ValueError(f"oddeven_cuda: capacity {cap} does not fit a row "
                         f"block in shared memory")
    if n > (2 ** 31 - 1) * _WARPS_PER_BLOCK:
        raise ValueError("oddeven_cuda: too many rows for one launch")
    order_out = torch.empty_like(order)
    if n == 0 or cap == 0:
        return order_out
    _build.launch("mcq_oddeven", cnt.device, cnt.data_ptr(), order.data_ptr(),
                  order_out.data_ptr(), n, cap, passes)
    launches += 1
    return order_out
