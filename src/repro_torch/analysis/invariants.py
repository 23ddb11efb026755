"""Machine-checkable concurrency/kernel contract annotations.

The port's own copy of ``repro.analysis.invariants`` (the port imports
nothing of the reference package).  ``tools/mcqlint`` finds the decorators
by their names and reads them statically, so the names and the class-
attribute conventions are the reference's:

* :func:`requires_lock` — annotates a function whose **caller** must hold the
  named lock(s).  Zero-cost by default (returns the function unchanged after
  attaching metadata); with ``MCQ_RUNTIME_LOCK_CHECKS=1`` in the environment
  at import time it wraps the function with a ``lock.locked()`` assertion so
  test runs fail loudly on a violated contract.
* :func:`kernel_op` — registers a kernel dispatcher's plain version / TPU
  kernel pair (or its composition in terms of other ops): the parity
  invariant's declaration.  In the port, ``ref`` names the plain PyTorch
  version in ``kernels/ref.py`` that the CUDA kernel is held against, and
  ``pallas`` the reference's TPU kernel that the CUDA kernel ports.
* class-attribute conventions ``_MCQ_LOCK_ORDER`` / ``_MCQ_LOCK_PROTECTS`` —
  a class owning ``threading.Lock``s declares the total acquisition order and
  which attributes/operations each lock guards.

The interleaving explorer (``repro_torch.analysis.explorer``) reuses the
named-lock declarations to place its schedule-controlled yield points.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Optional, Sequence, Tuple

#: Attribute carrying the tuple of lock attribute names a function requires.
REQUIRES_ATTR = "__mcq_requires_locks__"

#: Attribute carrying the (ref, pallas, composes) registration of a kernel op.
KERNEL_OP_ATTR = "__mcq_kernel_op__"

#: Class attribute naming the normative lock acquisition order (a tuple of
#: lock attribute names, outermost first).  Acquiring a lock while holding a
#: later-ranked one is a lock-order inversion (rule MCQ-L003).
LOCK_ORDER_ATTR = "_MCQ_LOCK_ORDER"

#: Class attribute mapping lock attribute name -> tuple of protected
#: resources.  A resource is either an instance attribute name (``"stats"``:
#: any mutation of ``self.stats`` needs the lock) or a dotted call pattern
#: (``"store.publish"``: any call of ``self.store.publish`` needs the lock).
LOCK_PROTECTS_ATTR = "_MCQ_LOCK_PROTECTS"

_RUNTIME_CHECKS = os.environ.get("MCQ_RUNTIME_LOCK_CHECKS", "") not in (
    "", "0", "false")


def requires_lock(*names: str) -> Callable:
    """Declare that callers must hold ``self.<name>`` for every name.

    The declaration is the contract the static analyzer enforces at every
    call site (rule MCQ-L002) and seeds the callee's held-lock set with
    (rule MCQ-L001), so a helper like ``_apply_locked`` can mutate
    write-lock-protected state without re-acquiring the lock.
    """
    if not names or not all(isinstance(n, str) and n for n in names):
        raise ValueError("requires_lock needs one or more lock names")

    def deco(fn: Callable) -> Callable:
        if not _RUNTIME_CHECKS:
            setattr(fn, REQUIRES_ATTR, tuple(names))
            return fn

        @functools.wraps(fn)
        def checked(self, *args, **kwargs):
            for name in names:
                lock = getattr(self, name)
                # threading.Lock has .locked(); instrumented locks mirror it
                if hasattr(lock, "locked") and not lock.locked():
                    raise AssertionError(
                        f"{type(self).__name__}.{fn.__name__} requires "
                        f"{name} held (MCQ_RUNTIME_LOCK_CHECKS)")
            return fn(self, *args, **kwargs)

        setattr(checked, REQUIRES_ATTR, tuple(names))
        return checked

    return deco


def kernel_op(*, ref: Optional[str] = None, pallas: Optional[str] = None,
              composes: Sequence[str] = ()) -> Callable:
    """Register a kernel dispatcher's parity contract.

    ``ref`` names the plain version in ``kernels/ref.py`` that the kernel is
    held equal to; ``pallas`` the reference's TPU kernel this op's CUDA
    kernel ports (``None`` for an op with no TPU counterpart); ``composes``
    names other registered ops an op is built from, inheriting their parity.
    The static analyzer checks that every declared name exists, that every
    ``*_pallas`` kernel is reachable from some registration, and that a test
    mentions the op.
    """
    if ref is None and not composes:
        raise ValueError("kernel_op needs a ref oracle or a composes list")

    def deco(fn: Callable) -> Callable:
        setattr(fn, KERNEL_OP_ATTR,
                {"ref": ref, "pallas": pallas, "composes": tuple(composes)})
        return fn

    return deco


def declared_locks(cls) -> Tuple[str, ...]:
    """The class's normative lock order (empty when undeclared)."""
    return tuple(getattr(cls, LOCK_ORDER_ATTR, ()))
