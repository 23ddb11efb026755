"""CUDA kernel: CDF threshold walk over pre-ordered rows (paper §II.B), and
the chunking rule of the walk.

Replaces the TPU kernel ``repro/kernels/cdf_query.py::cdf_query_pallas``
(``_cdf_kernel`` with ``walk_chunks``): the unfused read
(``MCConfig.fused_query=False``), whose rows ``c_ord/d_ord[B, C]`` were
already gathered into priority order by ``mcprioq._ordered_rows``.  Per
query, with an exact int32 running prefix,
``needed[j] = (f32(prefix_before_j) < t * f32(max(tot, 1))) & (c_j > 0)``
(top-k mode: ``c_j > 0``); emit ``d_j`` and ``c_j / tot`` for needed
positions ``< max_items`` (EMPTY / 0.0 elsewhere); ``n_needed`` = needed
positions over all C.

Bound on this card: bytes, and few of them — a query needs the counts up to
where its prefix crosses the threshold (all C in top-k mode, and for an
unknown src whose zeroed row never crosses), the dsts it emits, its ``tot``,
and (8·max_items + 4) B of output.  The time is round trips: the rows arrive
contiguous, so the design gives each query a warp that issues ``tot``, the
counts of the first 32·V positions (V = ceil(C / 32) up to 8: the whole row
for C <= 256, rounds of 256 above) and the dsts below ``max_items`` as
independent loads before any arithmetic — 16-B loads where the rows are
16-B aligned, scalar loads otherwise — and then walks in registers with
the scan shared with the fused kernel (``csrc/cdf_walk.cuh``): a uint32
prefix, an exit once it has crossed the threshold.  The TPU kernel leaves a
chunk only when every query of its 128-query block is done; here each query
leaves on its own, and by the integer-walk contract the bits are the same.

:func:`auto_chunks` resolves and validates ``MCConfig.query_chunks``.  On
the GPU a warp walks 32·V positions at a time whatever ``chunks`` says:
every chunking gives the same bits, so the value only has to be valid.

Source: ``csrc/cdf_query.cu`` (entry ``mcq_cdf_query``), walk in
``csrc/cdf_walk.cuh``.  Plain version: :func:`cdf_query_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cdf_query_ref

# the plain version is re-exported beside its kernel
__all__ = ["auto_chunks", "cdf_query_cuda", "cdf_query_ref", "launches"]

LANE_WIDTH = 128  # the reference's chunk unit: one chunk per 128 positions

launches = 0  # kernel launches made by cdf_query_cuda in this process


def auto_chunks(capacity: int, chunks: int) -> int:
    """Resolve ``chunks=0`` (auto) from C and the lane width: one chunk per
    128-position tile when C is a multiple of it, else a single chunk.
    Explicit chunk counts are validated here — once, for every backend — so
    a bad ``MCConfig.query_chunks`` fails identically on every path."""
    if chunks:
        if capacity % chunks:
            raise ValueError(
                f"chunks={chunks} must divide capacity={capacity} "
                f"(MCConfig.query_chunks)")
        return chunks
    if capacity % LANE_WIDTH == 0 and capacity > LANE_WIDTH:
        return capacity // LANE_WIDTH
    return 1


def cdf_query_cuda(c_ord: torch.Tensor, d_ord: torch.Tensor,
                   tot: torch.Tensor, threshold, *, max_items: int = 16):
    """c_ord/d_ord: [B, C] counts/dsts in priority order (zeros where the
    src is unknown), tot: [B].  ``threshold=None`` is top-k mode (the kernel
    gets t = 0).  Returns (dsts[B, max_items], probs[B, max_items],
    n_needed[B])."""
    global launches
    _build.require_cuda_int32("cdf_query_cuda", c_ord=c_ord, d_ord=d_ord,
                              tot=tot)
    if c_ord.dim() != 2 or c_ord.shape != d_ord.shape:
        raise ValueError("cdf_query_cuda: c_ord/d_ord must be [B, C]")
    if tot.shape != c_ord.shape[:1]:
        raise ValueError("cdf_query_cuda: tot must be [B]")
    if max_items < 1:
        raise ValueError("cdf_query_cuda: max_items must be >= 1")
    batch = c_ord.shape[0]
    dev = c_ord.device
    dk = torch.empty((batch, max_items), dtype=torch.int32, device=dev)
    pk = torch.empty((batch, max_items), dtype=torch.float32, device=dev)
    nn = torch.empty((batch,), dtype=torch.int32, device=dev)
    if batch == 0:
        return dk, pk, nn
    topk = threshold is None
    _build.launch("mcq_cdf_query", dev, c_ord.data_ptr(), d_ord.data_ptr(),
                  tot.data_ptr(), 0.0 if topk else float(threshold), int(topk),
                  dk.data_ptr(), pk.data_ptr(), nn.data_ptr(), batch,
                  c_ord.shape[1], max_items)
    launches += 1
    return dk, pk, nn
