"""CUDA kernel: shared open-addressing probe (paper §II.1-2).

Replaces the TPU kernel ``repro/kernels/probe.py::probe_find_pallas``
(``_probe_kernel``).  One kernel serves every hash lookup: the table layout
is always ``keys/vals[N, H]``, a stack of N open-addressing tables probed
independently — the per-row dst hash (N = slab rows, ``ops.dh_find``) and the
flat src table (N = 1, ``ops.ht_find``, the head of every update and query).

Bound on this card: bytes.  A query needs its key, its row id, the slots of
its own probe chain (usually one or two 4-byte reads at load factor <= 0.25)
and one value; the table itself is far larger than the cache, so these are
random 32-byte sector reads.  The design parallelises over queries, one
thread each, and reads only the chain — it never sweeps the table, so the
cost is O(B) and independent of N and H.

Source: ``csrc/probe.cu`` (entry ``mcq_probe_find``).  Plain version:
:func:`probe_find_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import probe_find_ref

# the plain version is re-exported beside its kernel
__all__ = ["probe_find_cuda", "probe_find_ref", "launches"]

launches = 0  # kernel launches made by probe_find_cuda in this process


def probe_find_cuda(rows: torch.Tensor, keys_q: torch.Tensor,
                    tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                    *, max_probes: int = 64):
    """Batched open-addressing probe on the GPU.  rows[B] select a table out
    of ``tab_keys/tab_vals[N, H]`` (rows < 0 = padding); keys_q[B] are the
    probed keys.  Returns ``(slots[B], found[B] int32)`` with slot EMPTY where
    not found."""
    global launches
    _build.require_cuda_int32("probe_find_cuda", rows=rows, keys_q=keys_q,
                              tab_keys=tab_keys, tab_vals=tab_vals)
    if tab_keys.dim() != 2 or tab_keys.shape != tab_vals.shape:
        raise ValueError("probe_find_cuda: tab_keys/tab_vals must be [N, H]")
    if rows.dim() != 1 or rows.shape != keys_q.shape:
        raise ValueError("probe_find_cuda: rows/keys_q must be [B]")
    h = tab_keys.shape[1]
    if h < 1 or h & (h - 1):
        raise ValueError(f"probe_find_cuda: H must be a power of two, got {h}")
    if max_probes < 1:
        raise ValueError("probe_find_cuda: max_probes must be >= 1")
    batch = rows.shape[0]
    slots = torch.empty_like(rows)
    found = torch.empty_like(rows)
    if batch == 0:
        return slots, found
    _build.launch("mcq_probe_find", rows.device, rows.data_ptr(),
                  keys_q.data_ptr(), tab_keys.data_ptr(), tab_vals.data_ptr(),
                  slots.data_ptr(), found.data_ptr(), batch, h, max_probes)
    launches += 1
    return slots, found
