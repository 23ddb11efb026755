"""CUDA kernel: one-shot k-step greedy draft walk (``speculative.draft``).

Replaces the TPU kernel ``repro/kernels/walk.py::draft_walk_pallas``
(``_walk_kernel``).  Drafting k tokens from the n-gram chain is k dependent
iterations of (rolling context hash of the window -> src-table probe -> top-1
gather at the order head ``order[row, 0]``, the approximate argmax).  The
chain snapshot is read-only for the whole draft (``EpochStore`` contract), so
the k steps run in one launch.  A lane whose step finds no transition emits
token 0 / ok 0 for every later step and stops probing.

Bound on this card: latency, neither bytes nor operations.  A step moves
a few bytes — its probe chain (usually the home slot at load factor <=
0.25), the order head, one ``cnt``/``dst`` pair — out of tables far larger
than the cache, each read depending on the one before, so a draft costs k
times a step's dependent DRAM round trips plus one launch.  The TPU kernel
loads the whole src table and the slabs into VMEM for every 128-query
block, which is upside down here (the table alone is 16 MiB at 2^22 slots).
The design reads only each sequence's own chain and slab entries, keeps the
window in registers (its tokens' hashes, shifted at each step: the emitted
tokens are never read back from memory), and gives each sequence
``LANES`` lanes, which cut a step to two round trips: they probe ``LANES``
slots of the chain at once, then load the order head together with the
row's whole ``cnt`` and ``dst`` (coalesced, C = 64 is 2 x 256 B) and pick
the slot by shuffle — C x 8 bytes per step instead of 8.  One thread per
sequence takes three trips (slot, order head, ``cnt``/``dst``); it was
slower where a server meets a draft, right after a learner step, and is not
kept (``PERF.md`` §6 has both designs' times).  The order head is read with
its row stride, so the strided view ``slabs.order[:, 0]`` goes in without a
copy.  The window is held in registers up to ``MAX_ORDER`` tokens; a longer
one is refused.

Source: ``csrc/walk.cu`` (entry ``mcq_draft_walk``).  Plain version:
:func:`draft_walk_ref`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import draft_walk_ref

# the plain version is re-exported beside its kernel
__all__ = ["draft_walk_cuda", "draft_walk_ref", "launches"]

launches = 0  # kernel launches made by draft_walk_cuda in this process

LANES = 16       # MCQ_WALK_LANES in csrc/walk.cu: lanes per sequence
MAX_ORDER = 16   # MCQ_WALK_MAX_ORDER in csrc/walk.cu


def draft_walk_cuda(window: torch.Tensor, ht_keys: torch.Tensor,
                    ht_vals: torch.Tensor, cnt: torch.Tensor, dst: torch.Tensor,
                    ord0: torch.Tensor, *, k: int = 4, max_probes: int = 64):
    """window[B, order] recent tokens (rows may be strided); ht_keys/ht_vals
    [T] the flat src table; cnt/dst[N, C] the slabs; ord0[N] the order head
    of every row (may be strided, e.g. ``slabs.order[:, 0]``).  Returns
    ``(toks[B, k] int32, ok[B, k] bool)``."""
    global launches
    _build.require_cuda_int32("draft_walk_cuda", strided=("window", "ord0"),
                              window=window, ht_keys=ht_keys, ht_vals=ht_vals,
                              cnt=cnt, dst=dst, ord0=ord0)
    dev = cnt.device
    if window.dim() != 2 or not 1 <= window.shape[1] <= MAX_ORDER:
        raise ValueError(f"draft_walk_cuda: window must be [B, order] with "
                         f"1 <= order <= {MAX_ORDER}")
    if ht_keys.dim() != 1 or ht_keys.shape != ht_vals.shape:
        raise ValueError("draft_walk_cuda: ht_keys/ht_vals must be [T]")
    t_size = ht_keys.shape[0]
    if t_size < 1 or t_size & (t_size - 1):
        raise ValueError(f"draft_walk_cuda: T must be a power of two, got {t_size}")
    if cnt.dim() != 2 or cnt.shape != dst.shape or ord0.shape != cnt.shape[:1]:
        raise ValueError("draft_walk_cuda: cnt/dst must be [N, C], ord0 [N]")
    if k < 0 or max_probes < 1:
        raise ValueError("draft_walk_cuda: needs k >= 0 and max_probes >= 1")
    batch = window.shape[0]
    toks = torch.empty((batch, k), dtype=torch.int32, device=dev)
    oks = torch.empty((batch, k), dtype=torch.bool, device=dev)
    if batch == 0 or k == 0:
        return toks, oks
    _build.launch("mcq_draft_walk", dev, window.data_ptr(), window.stride(0),
                  window.shape[1], ht_keys.data_ptr(), ht_vals.data_ptr(),
                  t_size, cnt.data_ptr(), dst.data_ptr(), ord0.data_ptr(),
                  ord0.stride(0), cnt.shape[0], cnt.shape[1], k, max_probes,
                  toks.data_ptr(), oks.data_ptr(), batch)
    launches += 1
    return toks, oks
