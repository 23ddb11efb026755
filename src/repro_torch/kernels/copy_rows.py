"""CUDA kernel: catch a back buffer up with its front, by what changed.

Replaces nothing of the reference, whose states are immutable arrays: it is
the device code of the port's back-buffer learner
(:class:`repro_torch.core.epoch.BackBufferLearner`).  The learner writes in
place into a private *back* state while readers hold the published *front*;
before a write, the back takes over what the last write changed in the
front: every row flagged in ``dirty`` (its ``cnt``/``dst``/``order`` rows
and ``tot``, and with the per-row dst hash its ``dh_keys``/``dh_vals``
rows), every group of src-table slots flagged in ``table_dirty``
(``hashtable.flag_group``: the new-edge pass, the table's one writer, flags
the slots it inserts) and the scalar leaves.  The flags are cleared.

Bound on this card: bytes — the N row flags and the T/32 table flags read,
each flagged row read and written once (2·(3·C + 1 + 2·H)·4 B, H the row
hash's width, 1 without the dst hash), each flagged table group read and
written once (2·2·32·4 B), the scalars.  The design compacts each block's
flagged rows in shared memory and shares them among its 16 warps, lanes
moving 16-byte vectors with two rows in flight, so clustered new rows
spread over a block and the launch moves what changed, not the table.  It
is one kernel, not a ``nonzero`` to compact the flags and a gather: that
would be a device->host synchronisation.

Two ways in.  :func:`copy_dirty_rows_cuda` checks its tensors at every call
(the functional ``ops.copy_dirty_rows``).  :class:`BoundCatchUp` checks them
once and keeps the kernel's arguments packed: the learner binds one per
direction (front -> back, and back -> front after the swap), and each write
is one C call, no check and no view built (``ops.copy_bound_rows``).

Source: ``csrc/copy_rows.cu`` (entry ``mcq_copy_dirty_rows``).  Plain
version: :func:`copy_dirty_rows_ref`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import copy_dirty_rows_ref

# the plain version is re-exported beside its kernel
__all__ = ["copy_dirty_rows_cuda", "copy_dirty_rows_ref", "BoundCatchUp",
           "launches"]

launches = 0  # kernel launches made by this module in this process

_NAMES = ("cnt", "dst", "order", "tot", "keys", "vals", "scalars")
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class _Args(ctypes.Structure):
    """``struct McqCatchUp`` of ``csrc/copy_rows.cu``, field for field."""
    _fields_ = ([(f"f_{k}", _P) for k in _NAMES + ("dhk", "dhv")]
                + [(f"b_{k}", _P) for k in _NAMES + ("dhk", "dhv")]
                + [("dirty", _P), ("table_dirty", _P), ("num_rows", _LL),
                   ("table_size", _LL), ("capacity", _I), ("dh_size", _I),
                   ("n_scalars", _I), ("group", _I), ("device", _I),
                   ("pad_", _I)])


def _pack(front, back, dirty, table_dirty, row_hashes) -> _Args:
    """Check the tensors of one catch-up and pack the kernel's arguments
    (the tensors must outlive the pack)."""
    name = "copy_dirty_rows_cuda"
    if dirty is None or table_dirty is None:
        raise ValueError(f"{name}: dirty and table_dirty are required")
    names = _NAMES + (("dh_keys", "dh_vals") if row_hashes else ())
    front = (*front, *(row_hashes or ())[:2])
    back = (*back, *(row_hashes or ())[2:])
    _build.require_cuda_int32(
        name, flags=("dirty", "table_dirty"), dirty=dirty,
        table_dirty=table_dirty,
        **{f"front_{k}": x for k, x in zip(names, front)},
        **{f"back_{k}": x for k, x in zip(names, back)})
    for what, f, b in zip(names, front, back):
        if f.shape != b.shape:
            raise ValueError(f"{name}: front and back {what} differ in shape")
        if f.data_ptr() == b.data_ptr():
            raise ValueError(f"{name}: front and back {what} are one tensor")
    f_cnt, f_keys, f_scalars = front[0], front[4], front[6]
    n = front[3].shape[0]
    if f_cnt.dim() != 2 or not (f_cnt.shape == front[1].shape
                                == front[2].shape) \
            or front[3].shape != f_cnt.shape[:1] or f_cnt.shape[1] < 1:
        raise ValueError(f"{name}: cnt/dst/order must be [N, C], tot [N]")
    if f_keys.dim() != 1 or front[5].shape != f_keys.shape \
            or f_scalars.dim() != 1:
        raise ValueError(f"{name}: keys/vals must be [T], scalars [S]")
    _build.require_flags(name, dirty, n)
    t, g = f_keys.shape[0], table_dirty.numel()
    if table_dirty.dim() != 1 or g < 1 or t % g or not 1 <= t // g <= 32:
        raise ValueError(f"{name}: table_dirty must be uint8, one flag per "
                         f"group of 1 to 32 of the {t} table slots")
    dh_size = _build.require_row_hashes(name, *front[7:], n) \
        if row_hashes else 0
    return _Args(*(x.data_ptr() for x in front[:7]),
                 *map(_build.ptr, front[7:9] if row_hashes else (None,) * 2),
                 *(x.data_ptr() for x in back[:7]),
                 *map(_build.ptr, back[7:9] if row_hashes else (None,) * 2),
                 dirty.data_ptr(), table_dirty.data_ptr(), n, t,
                 f_cnt.shape[1], dh_size, f_scalars.shape[0], t // g,
                 dirty.device.index, 0)


def copy_dirty_rows_cuda(f_cnt, f_dst, f_order, f_tot, f_keys, f_vals,
                         f_scalars, b_cnt, b_dst, b_order, b_tot, b_keys,
                         b_vals, b_scalars, dirty, table_dirty,
                         row_hashes=None) -> None:
    """Copy front -> back on the GPU: the ``cnt``/``dst``/``order`` [N, C]
    rows and ``tot`` [N] entries of every row flagged in ``dirty`` (uint8
    [N]) and, given ``row_hashes`` (front ``dh_keys, dh_vals``, back
    ``dh_keys, dh_vals``, each [N, H]), their row-hash rows; the
    ``keys``/``vals`` [T] slots of every group flagged in ``table_dirty``
    (uint8 [G], a flag per T/G slots, 1 to 32); the ``scalars`` [S] whole;
    then clear both flags.  Checks every tensor."""
    BoundCatchUp((f_cnt, f_dst, f_order, f_tot, f_keys, f_vals, f_scalars),
                 (b_cnt, b_dst, b_order, b_tot, b_keys, b_vals, b_scalars),
                 dirty, table_dirty, row_hashes)()


class BoundCatchUp:
    """One direction of a learner's catch-up (the arguments of
    :func:`copy_dirty_rows_cuda`), checked once and packed: each call is
    one launch on the stream that was current when it was bound, with no
    check and no view built.  It holds its tensors."""

    def __init__(self, front, back, dirty, table_dirty, row_hashes=None):
        self._tensors = (front, back, dirty, table_dirty, row_hashes)
        self._args = _pack(front, back, dirty, table_dirty, row_hashes)
        self._addr = ctypes.addressof(self._args)
        self._stream = torch.cuda.current_stream(dirty.device).cuda_stream

    def __call__(self) -> None:
        global launches
        _build.launch("mcq_copy_dirty_rows", None, self._addr,
                      stream=self._stream)
        launches += 1
