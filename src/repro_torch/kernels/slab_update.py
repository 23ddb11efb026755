"""CUDA kernel: fused batched edge increment (paper §II.A, the fast path).

Replaces the TPU kernel ``repro/kernels/slab_update.py::slab_update_pallas``
(``_slab_update_kernel``).  For item ``(row, dst, w)`` the FIRST slot of
``dst_slab[row, :]`` equal to ``dst`` gets ``cnt += w`` and ``tot[row] += w``;
an absent edge or ``row < 0`` is a no-op; duplicate items add up.

Bound on this card: bytes, and almost all of them are the functional copy —
the outputs are fresh ``cnt'``/``tot'`` tensors (2·N·C·4 B read + written),
beside which the B row scans (B·C·4 B) and B atomics are small.  The design
copies with ``clone`` and then parallelises over ITEMS, one warp each, with
int32 atomics (exact, order-free), so it touches only the rows the batch
names instead of sweeping the slab.

Source: ``csrc/slab_update.cu`` (entry ``mcq_slab_update``).  Plain version:
:func:`slab_update_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slab_update_ref

# the plain version is re-exported beside its kernel
__all__ = ["slab_update_cuda", "slab_update_ref", "launches"]

launches = 0  # kernel launches made by slab_update_cuda in this process


def slab_update_cuda(rows: torch.Tensor, dsts: torch.Tensor, w: torch.Tensor,
                     dst_slab: torch.Tensor, cnt: torch.Tensor,
                     tot: torch.Tensor):
    """Apply fast-path increments on the GPU. rows[B] (< 0 = padding),
    dsts[B], w[B]; dst_slab/cnt[N, C], tot[N]. Returns fresh (cnt', tot')."""
    global launches
    _build.require_cuda_int32("slab_update_cuda", rows=rows, dsts=dsts, w=w,
                              dst_slab=dst_slab, cnt=cnt, tot=tot)
    if cnt.dim() != 2 or dst_slab.shape != cnt.shape or tot.shape != cnt.shape[:1]:
        raise ValueError("slab_update_cuda: dst_slab/cnt must be [N, C], tot [N]")
    if rows.dim() != 1 or not (rows.shape == dsts.shape == w.shape):
        raise ValueError("slab_update_cuda: rows/dsts/w must be [B]")
    cnt_out, tot_out = cnt.clone(), tot.clone()
    batch = rows.shape[0]
    if batch == 0 or cnt.shape[1] == 0:
        return cnt_out, tot_out
    _build.launch("mcq_slab_update", rows.device, rows.data_ptr(),
                  dsts.data_ptr(), w.data_ptr(), dst_slab.data_ptr(),
                  cnt_out.data_ptr(), tot_out.data_ptr(), batch, cnt.shape[1])
    launches += 1
    return cnt_out, tot_out
