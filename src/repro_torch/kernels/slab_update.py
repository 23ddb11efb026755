"""CUDA kernel: fused batched edge increment (paper §II.A, the fast path).

Replaces the TPU kernel ``repro/kernels/slab_update.py::slab_update_pallas``
(``_slab_update_kernel``).  For item ``(row, dst, w)`` the FIRST slot of
``dst_slab[row, :]`` equal to ``dst`` gets ``cnt += w`` and ``tot[row] += w``;
an absent edge or ``row < 0`` is a no-op; duplicate items add up.

Bound on this card: bytes — the B items in (3·B·4 B), each found edge's
row prefix scanned up to its slot, and two int32 atomics and a flag per
found edge: 0.0009 ms at 2^20 x 128 and 65,536 items (``chip_smoke.py``'s
``bound_ms`` for phase main), far below the launch floor (~0.005 ms).  The
time is random DRAM accesses — per found item one row read and one ``cnt``
and one ``tot`` read-modify-write, scattered over the whole state — and the
round trips between them, so the design keeps many loads in flight: a warp loads a tile of 32 items in one coalesced trip, then each
group of 8 lanes scans 8 items' rows, 32 slots per step (one 16-B load per
lane per row where rows are 16-B aligned, scalar loads otherwise), all 8
rows' loads issued before any compare; rows wider than 32 slots take more
steps only for the items not found yet.  The lowest matching slot wins.
Found edges add to ``cnt`` with int32 atomics; the items of one row
combine their ``tot`` increments in the warp (``__match_any_sync``), so a
row costs one ``tot`` atomic and one dirty flag per warp — the update's
items arrive sorted by (src, dst), a row's items side by side.  int32
wrap-around sums are exact in any order.  It touches only the rows the
batch names and writes in place: the state's owner hands its own
``cnt``/``tot`` (``slab_update_cuda_``).  The functional wrapper copies
``cnt``/``tot`` first (2·N·C·4 B read + written), then launches the same
kernel on the copies.

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
