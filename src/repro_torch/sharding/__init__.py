"""Node-space sharding of the chain: the two-level ownership map.

  * :mod:`repro_torch.sharding.ownership` — node id -> virtual bucket ->
    shard (:class:`Ownership`)
"""

from repro_torch.sharding.ownership import Ownership

__all__ = ["Ownership"]
