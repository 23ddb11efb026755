"""MCPrioQ core: the paper's contribution as a composable PyTorch library.

Public API:
  * :mod:`repro_torch.core.mcprioq`     — single-device structure
    (init/update/query/decay)
  * :mod:`repro_torch.core.speculative` — online n-gram drafter for
    speculative decoding (observe/maintain/draft/candidates)
  * :mod:`repro_torch.core.epoch`       — RCU-style snapshot store
"""

from repro_torch.core import epoch, speculative  # noqa: F401
from repro_torch.core.device import resolve_device  # noqa: F401
from repro_torch.core.epoch import EpochStore, Snapshot  # noqa: F401

from repro_torch.core.hashtable import EMPTY, TOMB  # noqa: F401
from repro_torch.core.mcprioq import (  # noqa: F401
    MCConfig,
    MCState,
    check_invariants,
    counter_stats,
    decay,
    init,
    maintenance_stats,
    maybe_decay,
    query_threshold,
    query_topk,
    update_batch,
    update_batch_reference,
)
