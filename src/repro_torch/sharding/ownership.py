"""Two-level ownership map: node id -> virtual bucket -> shard.

Counterpart of ``repro.sharding.ownership``.  Nodes hash into
``num_buckets`` **virtual buckets** (far more buckets than shards) and an
explicit ``assignment[bucket] -> shard`` table maps buckets to owners.
Reassigning one bucket moves ~1/num_buckets of the key space; restoring a
state onto M shards is the default assignment at M.

The default assignment ``bucket % num_shards`` reproduces the static hash
``(hash(src) >> 8) % S`` whenever ``num_shards`` divides ``num_buckets``.

Frozen and hashable: the assignment is a tuple, so an ``Ownership`` rides
inside the frozen ``ShardedConfig``.  The bucket -> shard table a lookup
reads is built once per ``(Ownership, device)`` and kept: building it from
the tuple on every call would be a host-to-device copy in every routed
call.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.core.hashtable import hash_u32


@functools.lru_cache(maxsize=None)
def _table(assignment: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(assignment, dtype=torch.int32, device=device)


@dataclasses.dataclass(frozen=True)
class Ownership:
    """hash -> virtual bucket -> shard map.  ``assignment=()`` means the
    default ``bucket % num_shards``."""

    num_shards: int
    num_buckets: int = 256
    assignment: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {self.num_shards}")
        if self.num_buckets & (self.num_buckets - 1) or self.num_buckets < 1:
            raise ValueError(
                f"num_buckets must be a power of two, got {self.num_buckets}")
        if self.assignment:
            if len(self.assignment) != self.num_buckets:
                raise ValueError(
                    f"assignment has {len(self.assignment)} entries for "
                    f"{self.num_buckets} buckets")
            bad = [s for s in self.assignment
                   if not 0 <= s < self.num_shards]
            if bad:
                raise ValueError(
                    f"assignment targets out-of-range shards {sorted(set(bad))} "
                    f"(num_shards={self.num_shards})")

    # ------------------------------------------------------------------
    def resolved_assignment(self) -> Tuple[int, ...]:
        if self.assignment:
            return self.assignment
        return tuple(b % self.num_shards for b in range(self.num_buckets))

    def table(self, device=None) -> torch.Tensor:
        """The bucket -> shard table as an int32 tensor on ``device``
        (default: the CPU), built once per device and kept."""
        return _table(self.resolved_assignment(),
                      torch.device("cpu" if device is None else device))

    # ------------------------------------------------------------------
    def bucket_of(self, src: torch.Tensor) -> torch.Tensor:
        """Virtual bucket of a node id (int32, on ``src``'s device).  Uses
        the high mix bits so the src hash table inside each shard (low
        bits) stays well distributed."""
        return ((hash_u32(src) >> 8) % self.num_buckets).to(torch.int32)

    def owner_of(self, src: torch.Tensor) -> torch.Tensor:
        """Owner shard of a node id: total and static for a fixed map."""
        return self.table(src.device)[self.bucket_of(src).to(torch.int64)]

    # ------------------------------------------------------------------
    def reassign(self, bucket: int, shard: int) -> "Ownership":
        """Move one virtual bucket to ``shard`` (the rebalancing primitive:
        ~1/num_buckets of the key space migrates)."""
        if not 0 <= bucket < self.num_buckets:
            raise ValueError(f"bucket {bucket} out of range")
        assign = list(self.resolved_assignment())
        assign[bucket] = shard
        return dataclasses.replace(self, assignment=tuple(assign))

    def with_num_shards(self, num_shards: int) -> "Ownership":
        """Default map at a different shard count (N -> M reshard-on-restore:
        the bucket level is shard-count-invariant, only the table changes)."""
        return Ownership(num_shards=num_shards, num_buckets=self.num_buckets)

    def shards_of_buckets(self) -> Tuple[Tuple[int, ...], ...]:
        """Buckets grouped per shard — the inspection view rebalancers use."""
        groups: list = [[] for _ in range(self.num_shards)]
        for b, s in enumerate(self.resolved_assignment()):
            groups[s].append(b)
        return tuple(tuple(g) for g in groups)
