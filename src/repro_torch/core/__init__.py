"""MCPrioQ core: the paper's contribution as a composable PyTorch library.

Public API:
  * :mod:`repro_torch.core.mcprioq` — single-device structure
    (init/update/query/decay)
"""

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
