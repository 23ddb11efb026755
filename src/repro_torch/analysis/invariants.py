"""Concurrency contract annotations, checked statically by ``tools/mcqlint``.

The port's own copy of ``repro.analysis.invariants.requires_lock`` (the port
imports nothing of the reference package).  The class-attribute conventions
it goes with are the same: a class owning ``threading.Lock``s declares the
acquisition order in ``_MCQ_LOCK_ORDER`` and what each lock guards in
``_MCQ_LOCK_PROTECTS``.  ``tools/mcqlint`` finds the decorator by its name,
so the name stays ``requires_lock``.
"""

from __future__ import annotations

from typing import Callable

#: Attribute carrying the tuple of lock attribute names a function requires.
REQUIRES_ATTR = "__mcq_requires_locks__"


def requires_lock(*names: str) -> Callable:
    """Declare that callers must hold ``self.<name>`` for every name.

    Zero-cost: the function comes back unchanged, with the names attached.
    """
    if not names or not all(isinstance(n, str) and n for n in names):
        raise ValueError("requires_lock needs one or more lock names")

    def deco(fn: Callable) -> Callable:
        setattr(fn, REQUIRES_ATTR, tuple(names))
        return fn

    return deco
