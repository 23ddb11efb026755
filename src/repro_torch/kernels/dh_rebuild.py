"""CUDA kernel: rebuild every row's dst hash from the slab, decided on the
device (paper §II.2).

Replaces ``repro/core/mcprioq.py:196`` ``_dh_rebuild_all`` under the
``lax.cond`` of ``:608-616`` — in the reference a vmap over rows of a
``fori_loop`` of ``hashtable.insert``, not a Pallas kernel.  When the
state's ``dh_tombstones`` is above the threshold (``int32(
dh_rebuild_fraction * num_rows * H)``), every row's table becomes a fresh
EMPTY table with ``dst[r, i] -> i`` inserted for i ascending wherever
``cnt[r, i] > 0``; then ``dh_tombstones = 0`` and ``dh_rebuilds += 1``.

Bound on this card: bytes — ``cnt``/``dst`` read once (8·C B per row) and
the row hashes written once (8·H B per row): 1 GiB + 4 GiB at 2^20 rows,
C = 128, H = 512, about 1.6 ms at 3.35 TB/s.  The design gives each row one
warp that stages the row's table in shared memory (H·8 B), inserts the live
slots in slot order, each insert one warp-wide ballot over its probe window
(``csrc/probe_window.cuh``, shared with the new-edge pass), and writes the
table out once, coalesced; device memory sees nothing of the probes.  The
decision never reaches the host: the row launch reads ``dh_tombstones`` and
``fire`` on the device and returns at once when either says no, and a
one-thread launch after it moves the two counters (every warp reads
``dh_tombstones``, so none may reset it).  Every row is flagged in
``dirty`` when it runs.

Source: ``csrc/dh_rebuild.cu`` (entry ``mcq_dh_rebuild``).  Plain version:
:func:`dh_rebuild_ref_`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dh_rebuild_ref_

# the plain version is re-exported beside its kernel
__all__ = ["dh_rebuild_cuda_", "dh_rebuild_ref_", "launches", "MAX_TABLE"]

launches = 0  # kernel launches made by dh_rebuild_cuda_ in this process

# 4 warps per block, each staging H keys and H values: 4 * 8 * 4096 B =
# 128 KiB, within the 227 KiB a block may use (csrc/dh_rebuild.cu)
MAX_TABLE = 4096


def dh_rebuild_cuda_(cnt: torch.Tensor, dst: torch.Tensor,
                     dh_keys: torch.Tensor, dh_vals: torch.Tensor,
                     counters: torch.Tensor, *, threshold: int,
                     max_probes: int = 64, fire=None, dirty=None) -> None:
    """The rebuild on the GPU, in place: cnt/dst [N, C] the slab,
    dh_keys/dh_vals [N, H] the row hashes, counters int32[2] =
    (dh_rebuilds, dh_tombstones); it runs when ``counters[1] > threshold``
    and the device bool ``fire`` (if given) holds, and then flags every row
    in ``dirty`` (uint8 [N]).  Two launches, no device->host
    synchronisation."""
    global launches
    _build.require_cuda_int32("dh_rebuild_cuda_", bools=("fire",),
                              flags=("dirty",), cnt=cnt, dst=dst,
                              dh_keys=dh_keys, dh_vals=dh_vals,
                              counters=counters, fire=fire, dirty=dirty)
    if cnt.dim() != 2 or dst.shape != cnt.shape or cnt.shape[1] < 1:
        raise ValueError("dh_rebuild_cuda_: cnt/dst must be [N, C]")
    h = _build.require_row_hashes("dh_rebuild_cuda_", dh_keys, dh_vals,
                                  cnt.shape[0])
    if h > MAX_TABLE:
        raise ValueError(f"dh_rebuild_cuda_: H {h} is above {MAX_TABLE}, the "
                         f"widest table a warp stages in shared memory")
    if counters.shape != (2,):
        raise ValueError("dh_rebuild_cuda_: counters must be int32[2]")
    if fire is not None and fire.dim() != 0:
        raise ValueError("dh_rebuild_cuda_: fire must be a 0-dim bool tensor")
    if max_probes < 1 or not -2 ** 31 <= threshold < 2 ** 31:
        raise ValueError("dh_rebuild_cuda_: max_probes must be >= 1 and the "
                         "threshold an int32")
    _build.require_flags("dh_rebuild_cuda_", dirty, cnt.shape[0])
    _build.launch("mcq_dh_rebuild", cnt.device, cnt.data_ptr(), dst.data_ptr(),
                  dh_keys.data_ptr(), dh_vals.data_ptr(), counters.data_ptr(),
                  _build.ptr(fire), _build.ptr(dirty), cnt.shape[0],
                  cnt.shape[1], h, max_probes, threshold)
    launches += 1
