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
rate — and n dependent steps of an S-way argmax.  So one block per group
of 32 lists, and no step waits on DRAM: the block stages the part of every
list's probabilities the merge can reach (the first ``min(M, n)`` heads)
into shared memory in one round trip; warp 0 merges, lane s holding list
s's pointer, each step a five-round shuffle reduction on ``(prob desc,
list asc)`` after which the winning lane records the step in shared memory
and reads its next head there; then the whole block writes the recorded
steps out — a second round trip.  A first design wrote each step from the
winning lane, which waited on the load of its src and dst every step; both
designs took 0.020 ms by events at n = 16 while the wrapper filled its
three outputs first, three more launches, so the outputs are now allocated
unfilled (``PERF.md`` §6).

More than 32 lists (a warp's lanes) merge in rounds: each round merges
groups of 32 lists into one list of n steps per group, the heads as read
and their positions (``csrc/topn_merge.cu`` says why that is the flat
merge), and the last round (32 lists or fewer) emits.  One launch for S <=
32, two up to 1,024, and so on; ``launches`` counts each.  The plain
mirror of the rounds is :func:`topn_merge_rounds_ref`.

Source: ``csrc/topn_merge.cu`` (entry ``mcq_topn_merge``).  Plain version:
:func:`topn_merge_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (MERGE_GROUP, topn_merge_ref,
                                    topn_merge_rounds_ref)

# the plain versions are re-exported beside their kernel
__all__ = ["topn_merge_cuda", "topn_merge_ref", "topn_merge_rounds_ref",
           "GROUP", "launches"]

launches = 0  # kernel launches made by topn_merge_cuda in this process

GROUP = MERGE_GROUP   # lists one warp merges in a round (the .cu's MCQ_WARP)


def topn_merge_cuda(probs: torch.Tensor, dsts: torch.Tensor,
                    srcs: torch.Tensor, *, n: int):
    """probs float32 / dsts / srcs int32 [S, M] on the GPU, any S >= 1.
    Returns fresh ``(srcs[n], dsts[n], probs[n])``."""
    global launches
    _build.require_cuda_int32("topn_merge_cuda", floats=("probs",),
                              probs=probs, dsts=dsts, srcs=srcs)
    if probs.dim() != 2 or dsts.shape != probs.shape or srcs.shape != probs.shape:
        raise ValueError("topn_merge_cuda: probs/dsts/srcs must be [S, M]")
    s, m = probs.shape
    if s < 1 or m < 1 or n < 0:
        raise ValueError(f"topn_merge_cuda: needs S >= 1, M >= 1 and n >= 0, "
                         f"got S={s}, M={m}, n={n}")
    dev = probs.device
    # the kernel writes every output: no fill (each would be a launch)
    out_s = torch.empty((n,), dtype=torch.int32, device=dev)
    out_d = torch.empty((n,), dtype=torch.int32, device=dev)
    out_p = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out_s, out_d, out_p
    lists, width, pos = probs, m, None
    while True:   # rounds of raw group merges, then the one that emits
        last = lists.shape[0] <= GROUP
        if last:
            outs = (out_s, out_d, out_p, None)
        else:
            groups = -(-lists.shape[0] // GROUP)
            heads = torch.empty((groups, n), dtype=torch.float32, device=dev)
            at = torch.empty((groups, n), dtype=torch.int64, device=dev)
            outs = (None, None, heads, at)
        _build.launch("mcq_topn_merge", dev, lists.data_ptr(), _build.ptr(pos),
                      dsts.data_ptr(), srcs.data_ptr(), lists.shape[0], width,
                      n, int(last), *map(_build.ptr, outs))
        launches += 1
        if last:
            return out_s, out_d, out_p
        lists, width, pos = heads, n, at
