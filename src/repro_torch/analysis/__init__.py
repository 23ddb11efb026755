"""Static/dynamic analysis substrate, the port's own copy of what it needs
from ``repro.analysis``: ``invariants`` holds the annotation decorators the
engine declares its concurrency contract with (``@requires_lock``,
``@kernel_op``); ``explorer`` checks the interleaving behaviour of the
serving engine.  This ``__init__`` imports nothing heavyweight: it is on
the serving import path."""

from repro_torch.analysis.invariants import kernel_op, requires_lock

__all__ = ["kernel_op", "requires_lock"]
