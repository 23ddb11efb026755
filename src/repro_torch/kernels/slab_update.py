"""CUDA kernel: fused batched edge increment (paper §II.A, the fast path).

Replaces the TPU kernel ``repro/kernels/slab_update.py::slab_update_pallas``
(``_slab_update_kernel``).  For item ``(row, dst, w)`` the FIRST slot of
``dst_slab[row, :]`` equal to ``dst`` gets ``cnt += w`` and ``tot[row] += w``;
an absent edge or ``row < 0`` is a no-op; duplicate items add up.

Bound on this card: bytes — the B items in (3·B·4 B), each found edge's row
prefix scanned up to its slot, and two int32 atomics per found edge: at
2^20 x 128 and 65,536 items some 10 us.  The design parallelises over ITEMS,
one warp each, with int32 atomics (exact, order-free), so it touches only
the rows the batch names instead of sweeping the slab, and writes in place:
the state's owner hands its own ``cnt``/``tot`` (``slab_update_cuda_``), and
lane 0 of a hit sets the row's dirty flag when the caller keeps them.  The
functional wrapper copies ``cnt``/``tot`` first (2·N·C·4 B read + written),
then launches the same kernel on the copies.

Source: ``csrc/slab_update.cu`` (entry ``mcq_slab_update``).  Plain versions:
:func:`slab_update_ref` and :func:`slab_update_ref_`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slab_update_ref, slab_update_ref_

# the plain versions are re-exported beside their kernel
__all__ = ["slab_update_cuda", "slab_update_cuda_", "slab_update_ref",
           "slab_update_ref_", "launches"]

launches = 0  # kernel launches made by slab_update_cuda_ in this process


def slab_update_cuda_(rows: torch.Tensor, dsts: torch.Tensor, w: torch.Tensor,
                      dst_slab: torch.Tensor, cnt: torch.Tensor,
                      tot: torch.Tensor, *, dirty=None) -> None:
    """Apply fast-path increments on the GPU, in place. rows[B] (< 0 =
    padding), dsts[B], w[B]; dst_slab/cnt[N, C], tot[N]; ``dirty`` (uint8
    [N]): the flag of every row an item hit set."""
    global launches
    _build.require_cuda_int32("slab_update_cuda_", flags=("dirty",), rows=rows,
                              dsts=dsts, w=w, dst_slab=dst_slab, cnt=cnt,
                              tot=tot, dirty=dirty)
    if cnt.dim() != 2 or dst_slab.shape != cnt.shape or tot.shape != cnt.shape[:1]:
        raise ValueError("slab_update_cuda_: dst_slab/cnt must be [N, C], tot [N]")
    if rows.dim() != 1 or not (rows.shape == dsts.shape == w.shape):
        raise ValueError("slab_update_cuda_: rows/dsts/w must be [B]")
    _build.require_flags("slab_update_cuda_", dirty, cnt.shape[0])
    batch = rows.shape[0]
    if batch == 0 or cnt.shape[1] == 0:
        return
    _build.launch("mcq_slab_update", rows.device, rows.data_ptr(),
                  dsts.data_ptr(), w.data_ptr(), dst_slab.data_ptr(),
                  cnt.data_ptr(), tot.data_ptr(), _build.ptr(dirty), batch,
                  cnt.shape[1])
    launches += 1


def slab_update_cuda(rows: torch.Tensor, dsts: torch.Tensor, w: torch.Tensor,
                     dst_slab: torch.Tensor, cnt: torch.Tensor,
                     tot: torch.Tensor):
    """Apply fast-path increments on the GPU to copies of cnt/tot; the
    inputs are not written.  Returns fresh (cnt', tot')."""
    cnt_out, tot_out = cnt.clone(), tot.clone()
    slab_update_cuda_(rows, dsts, w, dst_slab, cnt_out, tot_out)
    return cnt_out, tot_out
