"""MCPrioQ core: the paper's contribution as a composable PyTorch library.

Public API:
  * :mod:`repro_torch.core.mcprioq`     — single-device structure
    (init/update/query/decay)
  * :mod:`repro_torch.core.speculative` — online n-gram drafter for
    speculative decoding (observe/maintain/draft/candidates)
  * :mod:`repro_torch.core.epoch`       — RCU-style snapshot store, and
    the learner that writes in place into a back buffer
  * :mod:`repro_torch.core.sharded`     — S logical shards of the chain on
    one device: bucket routing, per-shard update/query/maintain, the
    global top-n
  * :mod:`repro_torch.core.expert_monitor` — MoE expert-popularity monitor
    built on the chain
"""

from repro_torch.core import epoch, expert_monitor, sharded, speculative  # noqa: F401
from repro_torch.core.device import resolve_device  # noqa: F401
from repro_torch.core.epoch import (  # noqa: F401
    BackBufferLearner,
    EpochStore,
    Snapshot,
)

from repro_torch.core.hashtable import EMPTY, TOMB  # noqa: F401
from repro_torch.core.mcprioq import (  # noqa: F401
    SCALAR_FIELDS,
    MCConfig,
    MCState,
    check_cuda_limits,
    check_invariants,
    counter_stats,
    decay,
    decay_,
    init,
    maintenance_stats,
    maybe_decay,
    maybe_decay_,
    private_copy,
    query_threshold,
    query_topk,
    scalars_of,
    update_batch,
    update_batch_,
    update_batch_reference,
)
