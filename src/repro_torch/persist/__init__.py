"""Durability & elasticity for MCPrioQ chains (DESIGN.md §10).

Counterpart of ``repro.persist``, with the same file formats.  Three pieces
compose into crash recovery and N -> M elastic restore:

* :mod:`repro_torch.persist.snapshot` — snapshots of ``MCState`` (single or
  shard-stacked), in the ``checkpoint/ckpt.py`` manifest+npz layout plus a
  ``chain.json`` sidecar (config, shard count, WAL position).
* :mod:`repro_torch.persist.wal` — append-only segmented write-ahead log of
  observed ``(src, dst, w)`` batches with CRC-framed records, torn-tail
  detection and an explicit fsync policy.
* :mod:`repro_torch.persist.reshard` — restores a snapshot taken at N
  shards onto M shards: the live edges are extracted on the state's device
  and re-routed through the sharded update path
  (:mod:`repro_torch.core.sharded`) under the two-level
  :class:`repro_torch.sharding.Ownership` map.

Recovery contract: ``state = restore(latest complete snapshot)`` then replay
WAL records with ``seq > snapshot.wal_seq`` through the same owner calls —
bit-exact on the unsharded path (the kernels are deterministic and held
equal to their plain versions), exact-modulo-approximate-order on an
elastic reshard.
"""

from repro_torch.persist.snapshot import (
    latest_complete_step,
    load_meta,
    restore_snapshot,
    save_snapshot,
    save_snapshot_async,
)
from repro_torch.persist.wal import WriteAheadLog
from repro_torch.persist.reshard import (
    extract_edges,
    plan_batches,
    settle_order,
    settle_order_,
)

__all__ = [
    "latest_complete_step", "load_meta", "restore_snapshot", "save_snapshot",
    "save_snapshot_async", "WriteAheadLog", "extract_edges", "plan_batches",
    "settle_order", "settle_order_",
]
