"""Fault injection for the persist/serving stack (DESIGN.md §12).

Counterpart of ``repro.faults``: the same catalog, names and semantics,
with a registry (and arming state) of its own.

Public surface::

    from repro_torch.faults import failpoint          # the injection site
    from repro_torch import faults                    # arming / test control
    with faults.armed("wal.append.fsync", OSError(28, "no space")):
        ...

See :mod:`repro_torch.faults.registry` for the catalog and semantics.
"""

from repro_torch.faults.registry import (
    FAILPOINT_CATALOG,
    FaultInjected,
    arm,
    arm_from_env,
    armed,
    disarm,
    failpoint,
    fired,
    hits,
    reset,
    set_observer,
    snapshot,
)

__all__ = [
    "FAILPOINT_CATALOG", "FaultInjected", "arm", "arm_from_env", "armed",
    "disarm", "failpoint", "fired", "hits", "reset", "set_observer",
    "snapshot",
]
