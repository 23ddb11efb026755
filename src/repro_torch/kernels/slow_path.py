"""CUDA kernel: the sequential new-edge pass of ``update_batch``.

Replaces ``repro/core/mcprioq.py::_slow_path`` — in the reference a
``lax.scan`` over the new-edge prefix, not a Pallas kernel; a Python loop of
tiny launches would not be a port of a scan, so here it is one kernel.  Per
active item, in order: look the src up or allocate the next row (hash insert
with tombstone reuse; ``dropped_rows`` / ``dropped_probes`` on failure), then
the slot holding the dst, else the first free slot, else Space-Saving
replacement of the order tail (the newcomer inherits the victim's count;
``evictions``).  A later item sees what an earlier one wrote.

Bound on this card: bytes for the functional copies (src table, ``dst``,
``cnt``, ``tot`` are returned as fresh tensors: 2·(2·H + 2·N·C + N)·4 B), and
beyond them latency — the items form one dependent chain of a few global
round trips each.  The design runs the chain on ONE warp whose lanes share
every scan (probe window, row scan: ballot + ffs, lowest index wins), warms
the L2 cache for 32 items at a time (each lane looks its own item up and
prefetches the lines it will touch), starts independent loads together, reads
the active mask from device memory (all warps of the block find the last
active item; the walk ends there) so that an empty pass costs one short launch
and no device->host synchronisation, and leaves the copies to ``clone``.

Source: ``csrc/slow_path.cu`` (entry ``mcq_slow_path``).  Plain version:
:func:`slow_path_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slow_path_ref

# the plain version is re-exported beside its kernel
__all__ = ["slow_path_cuda", "slow_path_ref", "launches"]

launches = 0  # kernel launches made by slow_path_cuda in this process


def slow_path_cuda(tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                   dst_slab: torch.Tensor, cnt: torch.Tensor,
                   tot: torch.Tensor, order: torch.Tensor,
                   counters: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, w: torch.Tensor, active: torch.Tensor,
                   *, max_probes: int = 64):
    """Sequential insert pass on the GPU.  tab_keys/tab_vals[H] the src table,
    dst_slab/cnt/order[N, C], tot[N], counters[4] = (n_rows, dropped_rows,
    dropped_probes, evictions), items src/dst/w/active[L] (active int32,
    non-zero = apply).  Returns fresh ``(tab_keys, tab_vals, dst_slab, cnt,
    tot, counters)``; the inputs are not written."""
    global launches
    _build.require_cuda_int32(
        "slow_path_cuda", tab_keys=tab_keys, tab_vals=tab_vals,
        dst_slab=dst_slab, cnt=cnt, tot=tot, order=order, counters=counters,
        src=src, dst=dst, w=w, active=active)
    size = tab_keys.shape[0]
    if tab_keys.dim() != 1 or tab_vals.shape != tab_keys.shape or size < 1 \
            or size & (size - 1):
        raise ValueError("slow_path_cuda: tab_keys/tab_vals must be [H], H a "
                         "power of two")
    if cnt.dim() != 2 or not (cnt.shape == dst_slab.shape == order.shape) \
            or tot.shape != cnt.shape[:1] or cnt.shape[1] < 1:
        raise ValueError("slow_path_cuda: dst_slab/cnt/order must be [N, C], "
                         "tot [N]")
    if counters.shape != (4,):
        raise ValueError("slow_path_cuda: counters must be int32[4]")
    if src.dim() != 1 or not (src.shape == dst.shape == w.shape == active.shape):
        raise ValueError("slow_path_cuda: src/dst/w/active must be [L]")
    if max_probes < 1:
        raise ValueError("slow_path_cuda: max_probes must be >= 1")
    out = [x.clone() for x in (tab_keys, tab_vals, dst_slab, cnt, tot, counters)]
    _build.launch("mcq_slow_path", src.device, src.data_ptr(), dst.data_ptr(),
                  w.data_ptr(), active.data_ptr(), src.shape[0],
                  out[0].data_ptr(), out[1].data_ptr(), size,
                  out[2].data_ptr(), out[3].data_ptr(), out[4].data_ptr(),
                  order.data_ptr(), out[5].data_ptr(), cnt.shape[0],
                  cnt.shape[1], max_probes)
    launches += 1
    return tuple(out)
