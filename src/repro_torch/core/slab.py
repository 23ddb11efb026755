"""Edge slabs: the array form of the paper's sorted doubly-linked list.

Counterpart of ``repro.core.slab``.  Edge *slots* are stable (``dst``/``cnt``
never move once allocated) and a separate permutation ``order[r, :]`` lists
slot ids in (approximately) descending count order.  The paper's lock-free
adjacent-node swap becomes an **odd-even transposition pass over the
permutation**: one compare-exchange on even-aligned pairs, one on odd-aligned
pairs.  Slots never move, so slot references survive every swap.

Invariants (checked in tests):
  * ``cnt >= 0``;  ``cnt[r, s] == 0  <=>`` slot ``s`` of row ``r`` is free
    (``dst == EMPTY``).
  * ``order[r]`` is a permutation of ``range(C)`` at all times.
  * ``tot[r] == sum(cnt[r])`` after every public op.
  * k odd-even passes never increase the number of inversions.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.hashtable import EMPTY, first_true


class Slabs(NamedTuple):
    dst: torch.Tensor  # int32[N, C]  dst node-id per slot, EMPTY if free
    cnt: torch.Tensor  # int32[N, C]  transition counter per slot (0 == free)
    tot: torch.Tensor  # int32[N]     per-row total transitions
    order: torch.Tensor  # int32[N, C] slot ids, approx. descending by cnt


def make(num_rows: int, capacity: int, device=None) -> Slabs:
    """Empty slabs on ``device`` (default: the current CUDA device; raises
    when there is none)."""
    device = resolve_device(device)
    return Slabs(
        dst=torch.full((num_rows, capacity), EMPTY, dtype=torch.int32,
                       device=device),
        cnt=torch.zeros((num_rows, capacity), dtype=torch.int32, device=device),
        tot=torch.zeros((num_rows,), dtype=torch.int32, device=device),
        order=torch.arange(capacity, dtype=torch.int32, device=device)
        .repeat(num_rows, 1),
    )


def gather_cols(x: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``x[r, order[r, j]]`` — values of ``x`` in priority order."""
    return torch.gather(x, 1, order.to(torch.int64))


# ---------------------------------------------------------------------------
# odd-even transposition: the lock-free bubble sort of the paper, vectorised
# ---------------------------------------------------------------------------


def _half_pass(cnt: torch.Tensor, order: torch.Tensor, start: int) -> torch.Tensor:
    """One compare-exchange sweep over pairs (start, start+1), (start+2, ...).

    Descending order target: swap when left < right. Operates on the
    permutation only; the slabs themselves never move (stable slots).
    """
    c = gather_cols(cnt, order)
    m = (order.shape[1] - start) // 2
    if m <= 0:
        return order
    left = slice(start, start + 2 * m, 2)
    right = slice(start + 1, start + 1 + 2 * m, 2)
    swap = c[:, left] < c[:, right]
    new_left = torch.where(swap, order[:, right], order[:, left])
    new_right = torch.where(swap, order[:, left], order[:, right])
    order = order.clone()
    order[:, left] = new_left
    order[:, right] = new_right
    return order


def oddeven_passes(cnt: torch.Tensor, order: torch.Tensor, passes: int) -> torch.Tensor:
    """``passes`` full odd-even passes (each = even sweep + odd sweep).

    C passes sort fully; 1 pass fixes the "single small increment" case that
    the paper argues is the normal case.  Between passes the order is
    *approximately correct* — the paper's own reader-visible guarantee.
    """
    for _ in range(passes):
        order = _half_pass(cnt, order, 0)
        order = _half_pass(cnt, order, 1)
    return order


def full_sort(cnt: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Exact descending argsort (used by decay/compaction, not the hot path).

    Stable sort on -cnt keeps free slots (cnt 0) at the tail deterministically.
    """
    del order
    return torch.sort(-cnt, dim=1, stable=True).indices.to(torch.int32)


def inversions(cnt: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Number of adjacent inversions per row (0 == perfectly sorted)."""
    c = gather_cols(cnt, order)
    return (c[:, :-1] < c[:, 1:]).sum(dim=1).to(torch.int32)


def sorted_fraction(cnt: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Fraction of adjacent pairs in correct (non-increasing) order."""
    c = gather_cols(cnt, order)
    ok = c[:, :-1] >= c[:, 1:]
    # the reference's compiled mean is sum * (1/n) in float32, which differs
    # from sum / n in the last bit; reproduced so the two agree exactly
    inv_n = torch.full((), 1.0 / max(ok.numel(), 1), dtype=torch.float32,
                       device=ok.device)
    return ok.sum().to(torch.float32) * inv_n


# ---------------------------------------------------------------------------
# row-level find / allocate
# ---------------------------------------------------------------------------


def find_slot(slabs: Slabs, row, dst) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan row ``row`` for ``dst``; returns ``(slot, found)``.

    ``row``/``dst`` may be scalars or ``[B]`` batches.  The lowest matching
    slot wins; slot 0 when there is none.
    """
    hits = slabs.dst[row] == torch.as_tensor(dst, device=slabs.dst.device).unsqueeze(-1)
    return _first_or_zero(hits)


def free_slot(slabs: Slabs, row) -> Tuple[torch.Tensor, torch.Tensor]:
    """First free slot (cnt == 0) of ``row``; ``(slot, has_free)``."""
    return _first_or_zero(slabs.cnt[row] == 0)


def _first_or_zero(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    idx, found = first_true(mask, dim=-1)
    return torch.where(found, idx, 0).to(torch.int32), found


def tail_slot(slabs: Slabs, row) -> torch.Tensor:
    """Slot currently holding the (approximate) minimum count: order tail."""
    return slabs.order[row, -1]


# ---------------------------------------------------------------------------
# decay (paper §II.C): halve counters, evict zeros, compact via sort
# ---------------------------------------------------------------------------


def decay(slabs: Slabs) -> Tuple[Slabs, torch.Tensor]:
    """Multiply every counter by 0.5 (integer shift), evict cnt==0 edges.

    Semantic oracle for the kernel path (``ops.decay_sort``), which
    ``mcprioq.decay`` dispatches through.  Returns ``(slabs, n_evicted)``.
    ``tot`` is recomputed as the exact row sum so the two-counter probability
    stays consistent.  Compaction = one exact sort, putting the newly freed
    slots at the order tail where allocation finds them.
    """
    new_cnt = slabs.cnt >> 1
    died = (new_cnt == 0) & (slabs.dst != EMPTY)
    new_dst = torch.where(new_cnt == 0, EMPTY, slabs.dst).to(torch.int32)
    new_tot = new_cnt.sum(dim=1).to(slabs.tot.dtype)
    new_order = full_sort(new_cnt, slabs.order)
    return (
        Slabs(dst=new_dst, cnt=new_cnt, tot=new_tot, order=new_order),
        died.sum().to(torch.int32),
    )
