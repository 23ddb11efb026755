"""CUDA kernel: fused row-gather + CDF threshold walk (paper §II.B).

Replaces the TPU kernel ``repro/kernels/cdf_gather.py::
cdf_query_fused_pallas`` (``_fused_kernel``) with the walk it shares,
``repro/kernels/cdf_query.py::walk_chunks``.  Per query: gather
``cnt/dst[row, order[row, :]]``, keep an exact int32 running prefix,
``needed[j] = (f32(prefix_before_j) < t * f32(max(tot, 1))) & (cnt_j > 0)``
(top-k mode: ``cnt_j > 0``), emit ``dst`` and ``cnt/tot`` for needed
positions ``< max_items`` (EMPTY / 0.0 elsewhere), ``n_needed`` = needed
positions over all C; an unknown src gives all EMPTY / 0 / 0.

Bound on this card: bytes in principle, 3·C·4 B of a known src's row (order,
cnt, dst) plus (8·max_items + 4) B of output per query; in practice the DRAM
sectors a few thousand scattered rows touch and the dependent round trips
between them.  The design gives each query a warp that loads its own
``rows[q]``/``found[q]`` and reads as little of the row as its walk needs,
in rounds of priority positions: the round's order positions, then ``cnt``
and (below ``max_items``) ``dst`` gathered together, and one warp scan of
the round in registers.  Threshold mode walks 32 positions per round and
stops once the prefix crosses ``t * tot``, so the traffic follows
CDF^-1(t); top-k mode walks every position, the whole row in one round up
to 256 positions.

Source: ``csrc/cdf_gather.cu`` (entry ``mcq_cdf_query_fused``), walk step in
``csrc/cdf_walk.cuh``.  Plain version: :func:`cdf_query_fused_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cdf_query_fused_ref

# the plain version is re-exported beside its kernel
__all__ = ["cdf_query_fused_cuda", "cdf_query_fused_ref", "launches"]

launches = 0  # kernel launches made by cdf_query_fused_cuda in this process


def cdf_query_fused_cuda(rows: torch.Tensor, found: torch.Tensor,
                         cnt: torch.Tensor, dst: torch.Tensor,
                         order: torch.Tensor, tot: torch.Tensor,
                         threshold, *, max_items: int = 16):
    """rows[B] (pre-resolved, 0 where missing), found[B] bool,
    cnt/dst/order: [N, C] slab arrays, tot: [N].  ``threshold=None`` is top-k
    mode.  Returns (dsts[B, max_items], probs[B, max_items], n_needed[B])."""
    global launches
    _build.require_cuda_int32("cdf_query_fused_cuda", bools=("found",),
                              rows=rows, found=found, cnt=cnt, dst=dst,
                              order=order, tot=tot)
    if cnt.dim() != 2 or not (cnt.shape == dst.shape == order.shape):
        raise ValueError("cdf_query_fused_cuda: cnt/dst/order must be [N, C]")
    if tot.shape != cnt.shape[:1]:
        raise ValueError("cdf_query_fused_cuda: tot must be [N]")
    if rows.dim() != 1 or rows.shape != found.shape:
        raise ValueError("cdf_query_fused_cuda: rows/found must be [B]")
    if max_items < 1:
        raise ValueError("cdf_query_fused_cuda: max_items must be >= 1")
    batch = rows.shape[0]
    dev = rows.device
    dk = torch.empty((batch, max_items), dtype=torch.int32, device=dev)
    pk = torch.empty((batch, max_items), dtype=torch.float32, device=dev)
    nn = torch.empty((batch,), dtype=torch.int32, device=dev)
    if batch == 0:
        return dk, pk, nn
    topk = threshold is None
    _build.launch("mcq_cdf_query_fused", dev, rows.data_ptr(),
                  found.data_ptr(), cnt.data_ptr(), dst.data_ptr(),
                  order.data_ptr(), tot.data_ptr(),
                  0.0 if topk else float(threshold), int(topk),
                  dk.data_ptr(), pk.data_ptr(), nn.data_ptr(), batch,
                  cnt.shape[1], max_items)
    launches += 1
    return dk, pk, nn
