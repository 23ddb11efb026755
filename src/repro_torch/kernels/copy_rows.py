"""CUDA kernel: catch a back buffer up with its front, row by row.

Replaces nothing of the reference, whose states are immutable arrays: it is
the device code of the port's back-buffer learner
(:class:`repro_torch.core.epoch.BackBufferLearner`).  The learner writes in
place into a private *back* state while readers hold the published *front*;
before a write, the back takes over what the last write changed in the
front: every row flagged in ``dirty`` (its ``cnt``/``dst``/``order`` rows
and ``tot``, and with the per-row dst hash its ``dh_keys``/``dh_vals``
rows), the src table and the scalar leaves.  The flags are cleared.

Bound on this card: bytes — the N flags read, each flagged row read and
written once (2·(3·C + 1 + 2·H)·4 B, H the row hash's width, 1 without the
dst hash), the src table read and written whole (2·2·T·4 B: 67 MB at T =
2^22 slots, 0.02 ms).  The design reads 32 flags per warp
in one load and lets the warp copy each flagged row together (coalesced),
so the launch moves the rows a batch touched, not the table.  It is one
kernel, not a ``nonzero`` to compact the flags and a gather: that would be
a device->host synchronisation.

Source: ``csrc/copy_rows.cu`` (entry ``mcq_copy_dirty_rows``).  Plain
version: :func:`copy_dirty_rows_ref`.
"""

from __future__ import annotations

from repro_torch.kernels import _build
from repro_torch.kernels.ref import copy_dirty_rows_ref

# the plain version is re-exported beside its kernel
__all__ = ["copy_dirty_rows_cuda", "copy_dirty_rows_ref", "launches"]

launches = 0  # kernel launches made by copy_dirty_rows_cuda in this process

_NAMES = ("cnt", "dst", "order", "tot", "keys", "vals", "scalars")
MAX_SCALARS = 256   # one block's threads copy the scalars (csrc/copy_rows.cu)


def copy_dirty_rows_cuda(f_cnt, f_dst, f_order, f_tot, f_keys, f_vals,
                         f_scalars, b_cnt, b_dst, b_order, b_tot, b_keys,
                         b_vals, b_scalars, dirty, row_hashes=None) -> None:
    """Copy front -> back on the GPU: the ``cnt``/``dst``/``order`` [N, C]
    rows and ``tot`` [N] entries of every row flagged in ``dirty`` (uint8
    [N]) and, given ``row_hashes`` (front ``dh_keys, dh_vals``, back
    ``dh_keys, dh_vals``, each [N, H]), their row-hash rows; the src table
    ``keys``/``vals`` [T] and the ``scalars`` [S] whole; then clear the
    flags."""
    global launches
    if dirty is None:
        raise ValueError("copy_dirty_rows_cuda: dirty is required")
    names = _NAMES + (("dh_keys", "dh_vals") if row_hashes else ())
    front = (f_cnt, f_dst, f_order, f_tot, f_keys, f_vals, f_scalars,
             *(row_hashes or ())[:2])
    back = (b_cnt, b_dst, b_order, b_tot, b_keys, b_vals, b_scalars,
            *(row_hashes or ())[2:])
    _build.require_cuda_int32(
        "copy_dirty_rows_cuda", flags=("dirty",), dirty=dirty,
        **{f"front_{k}": x for k, x in zip(names, front)},
        **{f"back_{k}": x for k, x in zip(names, back)})
    for name, f, b in zip(names, front, back):
        if f.shape != b.shape:
            raise ValueError(f"copy_dirty_rows_cuda: front and back {name} "
                             f"differ in shape")
        if f.data_ptr() == b.data_ptr():
            raise ValueError(f"copy_dirty_rows_cuda: front and back {name} "
                             f"are one tensor")
    n = f_tot.shape[0]
    if f_cnt.dim() != 2 or not (f_cnt.shape == f_dst.shape == f_order.shape) \
            or f_tot.shape != f_cnt.shape[:1] or f_cnt.shape[1] < 1:
        raise ValueError("copy_dirty_rows_cuda: cnt/dst/order must be [N, C], "
                         "tot [N]")
    if f_keys.dim() != 1 or f_vals.shape != f_keys.shape or f_scalars.dim() != 1:
        raise ValueError("copy_dirty_rows_cuda: keys/vals must be [T], "
                         "scalars [S]")
    if f_scalars.shape[0] > MAX_SCALARS:
        raise ValueError(f"copy_dirty_rows_cuda: at most {MAX_SCALARS} scalars")
    _build.require_flags("copy_dirty_rows_cuda", dirty, n)
    dh_size = _build.require_row_hashes("copy_dirty_rows_cuda", *front[7:], n) \
        if row_hashes else 0
    _build.launch("mcq_copy_dirty_rows", dirty.device,
                  *(x.data_ptr() for x in front[:7] + back[:7]),
                  *map(_build.ptr, row_hashes or (None,) * 4),
                  dirty.data_ptr(), n, f_cnt.shape[1], f_keys.shape[0],
                  f_scalars.shape[0], dh_size)
    launches += 1
