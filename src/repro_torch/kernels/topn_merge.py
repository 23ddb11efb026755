"""CUDA kernel: cross-shard top-n merge (the global top-n read).

Replaces ``repro/kernels/ref.py::topn_merge_ref`` (``ops.topn_merge``), the
reduce step of ``core/sharded.py``'s top-n: a ``lax.scan`` of n steps that
the reference runs on every backend, no Pallas kernel (``ops.py:243-257``).
Each step reads the S list heads (a pointer past the end reads 0.0), takes
the first maximum (the lowest shard on ties, NaN above every number), emits
it when it is ``> 0`` (else EMPTY/EMPTY/0.0) and advances that shard's
pointer.  The same steps on any input, descending or not.

Bound on this card: latency.  The work is S·M·12 bytes in and n·12 out —
at S = 4 shards and n = 16 well under 1 KB, nanoseconds at the memory
rate — and n dependent steps of an S-way argmax.  So one block, one launch,
and no step waits on DRAM: the block stages the part of every list's
probabilities the merge can reach (the first ``min(M, n)`` heads) into
shared memory in one round trip; warp 0 merges, lane s holding shard s's
pointer, each step a five-round shuffle reduction on ``(prob desc, shard
asc)`` after which the winning lane records the step in shared memory and
reads its next head there; then the whole block writes the recorded steps
out, their srcs and dsts gathered in parallel — a second round trip.  A
first design wrote each step from the winning lane, which waited on the
load of its src and dst every step; both designs took 0.020 ms by events
at n = 16 while the wrapper filled its three outputs first, three more
launches, so the outputs are now allocated unfilled (``PERF.md`` §6).
A warp holds at most 32 heads: more than ``MAX_LISTS`` shards is refused,
with no fallback.

Source: ``csrc/topn_merge.cu`` (entry ``mcq_topn_merge``).  Plain version:
:func:`topn_merge_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import topn_merge_ref

# the plain version is re-exported beside its kernel
__all__ = ["topn_merge_cuda", "topn_merge_ref", "MAX_LISTS", "launches"]

launches = 0  # kernel launches made by topn_merge_cuda in this process

MAX_LISTS = 32   # one warp's lanes: one list head each


def topn_merge_cuda(probs: torch.Tensor, dsts: torch.Tensor,
                    srcs: torch.Tensor, *, n: int):
    """probs float32 / dsts / srcs int32 [S, M] on the GPU, S <= 32.
    Returns fresh ``(srcs[n], dsts[n], probs[n])``."""
    global launches
    _build.require_cuda_int32("topn_merge_cuda", floats=("probs",),
                              probs=probs, dsts=dsts, srcs=srcs)
    if probs.dim() != 2 or dsts.shape != probs.shape or srcs.shape != probs.shape:
        raise ValueError("topn_merge_cuda: probs/dsts/srcs must be [S, M]")
    s, m = probs.shape
    if not 1 <= s <= MAX_LISTS:
        raise ValueError(
            f"topn_merge_cuda: {s} lists; the kernel merges 1 to {MAX_LISTS} "
            f"(one warp's lanes hold the heads)")
    if m < 1 or n < 0:
        raise ValueError(f"topn_merge_cuda: needs M >= 1 and n >= 0, got "
                         f"M={m}, n={n}")
    # the kernel writes every output: no fill (each would be a launch)
    out_s = torch.empty((n,), dtype=torch.int32, device=probs.device)
    out_d = torch.empty((n,), dtype=torch.int32, device=probs.device)
    out_p = torch.empty((n,), dtype=torch.float32, device=probs.device)
    if n == 0:
        return out_s, out_d, out_p
    _build.launch("mcq_topn_merge", probs.device, probs.data_ptr(),
                  dsts.data_ptr(), srcs.data_ptr(), s, m, n, out_s.data_ptr(),
                  out_d.data_ptr(), out_p.data_ptr())
    launches += 1
    return out_s, out_d, out_p
