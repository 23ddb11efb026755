"""CUDA kernel: shared open-addressing probe (paper §II.1-2).

Replaces the TPU kernel ``repro/kernels/probe.py::probe_find_pallas``
(``_probe_kernel``).  One kernel serves every hash lookup: the flat src table
``keys/vals[H]`` (``rows=None``: ``ops.ht_find`` and ``lookup_rows``, the
head of every update and query) and a stack of N tables ``keys/vals[N, H]``
probed independently, one picked per query by ``rows[B]`` (the per-row dst
hash, ``ops.dh_find``).

Bound on this card: latency and launches, not bytes.  A query moves a few
bytes of its own probe chain out of a table far larger than the cache, so
its time is its dependent DRAM round trips, and a batch's time is a launch
plus those trips.  The design gives each query one thread that reads only
its chain (never the table), issues each slot's key and value loads together
(one round trip for a home-slot hit, the usual case at load factor <= 0.25),
reads the key -1 as a miss without touching the table, and writes its
outputs in the caller's final form — ``found`` as bool, ``miss`` in the slots
not found — so a lookup is one launch with nothing around it.

Source: ``csrc/probe.cu`` (entry ``mcq_probe_find``), probe loop
``csrc/probe.cuh``.  Plain version: :func:`probe_find_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.hashtable import EMPTY
from repro_torch.kernels import _build
from repro_torch.kernels.ref import probe_find_ref

# the plain version is re-exported beside its kernel
__all__ = ["probe_find_cuda", "probe_find_ref", "launches"]

launches = 0  # kernel launches made by probe_find_cuda in this process


def probe_find_cuda(rows: Optional[torch.Tensor], keys_q: torch.Tensor,
                    tab_keys: torch.Tensor, tab_vals: torch.Tensor,
                    *, max_probes: int = 64, miss: int = EMPTY):
    """Batched open-addressing probe on the GPU.  ``rows=None``: one flat
    table ``tab_keys/tab_vals[H]``; else rows[B] select a table out of
    ``tab_keys/tab_vals[N, H]`` (rows < 0 = padding).  keys_q[B] are the
    probed keys.  Returns ``(slots[B] int32, found[B] bool)`` with slot
    ``miss`` where not found."""
    global launches
    tensors = dict(keys_q=keys_q, tab_keys=tab_keys, tab_vals=tab_vals)
    if rows is not None:
        tensors["rows"] = rows
    _build.require_cuda_int32("probe_find_cuda", **tensors)
    want_dim = 1 if rows is None else 2
    if tab_keys.dim() != want_dim or tab_keys.shape != tab_vals.shape:
        raise ValueError(f"probe_find_cuda: tab_keys/tab_vals must be "
                         f"{'[H]' if rows is None else '[N, H]'}")
    if keys_q.dim() != 1 or (rows is not None and rows.shape != keys_q.shape):
        raise ValueError("probe_find_cuda: rows/keys_q must be [B]")
    h = tab_keys.shape[-1]
    if h < 1 or h & (h - 1):
        raise ValueError(f"probe_find_cuda: H must be a power of two, got {h}")
    if max_probes < 1:
        raise ValueError("probe_find_cuda: max_probes must be >= 1")
    batch = keys_q.shape[0]
    slots = torch.empty_like(keys_q)
    found = torch.empty(keys_q.shape, dtype=torch.bool, device=keys_q.device)
    if batch == 0:
        return slots, found
    _build.launch("mcq_probe_find", keys_q.device,
                  None if rows is None else rows.data_ptr(), keys_q.data_ptr(),
                  tab_keys.data_ptr(), tab_vals.data_ptr(), slots.data_ptr(),
                  found.data_ptr(), batch, h, max_probes, miss)
    launches += 1
    return slots, found
