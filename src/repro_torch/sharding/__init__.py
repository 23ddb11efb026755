"""Node-space sharding of the chain: the two-level ownership map, and the
process ranks that hold one shard each.

  * :mod:`repro_torch.sharding.ownership` — node id -> virtual bucket ->
    shard (:class:`Ownership`)
  * :mod:`repro_torch.sharding.ranks` — a ``torch.distributed`` group, one
    shard a rank (:class:`RankGroup`, :func:`init_ranks`): the reference's
    mesh axis and its ``all_to_all`` / ``all_gather`` / ``psum``
"""

from repro_torch.sharding.ownership import Ownership
from repro_torch.sharding.ranks import RankGroup, init_ranks

__all__ = ["Ownership", "RankGroup", "init_ranks"]
