"""Spans and the flight recorder (DESIGN.md §13).

A :class:`Span` is a nestable monotonic-clock context manager: entering
pushes its name onto a thread-local stack (so a child records its parent),
exiting records the duration into the registry histogram of the same name
and appends a compact record to the registry's fixed-size ring.  Exit is
exception-safe — a raising body still closes the span (flagged
``error=True``) and re-raises.

``dump_incident`` is the flight recorder's readout: on a fault event
(write-path poison, shard strike-out, degraded read) the engine calls
``registry.incident(reason, **ctx)`` which snapshots the last N spans plus
the scalar deltas since the previous incident and writes one JSON file —
tmp + ``os.replace`` so a crash mid-dump never leaves a torn incident —
making a chaos-soak kill diagnosable post-mortem.

``KERNEL_ANNOTATE`` gates the opt-in trace annotation around each
dispatcher of ``kernels/ops.py``: when on, a call runs under
``torch.profiler.record_function("mcq.<op>")`` (the reference's
``jax.named_scope``), so profiler timelines name the op.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Optional

#: module-bool gate for trace annotations around kernel dispatch
KERNEL_ANNOTATE = False


def enable_kernel_annotations(on: bool = True) -> None:
    global KERNEL_ANNOTATE
    KERNEL_ANNOTATE = on


def _span_stack(registry) -> list:
    stack = getattr(registry._local, "span_stack", None)
    if stack is None:
        stack = []
        registry._local.span_stack = stack
    return stack


class Span:
    """One timed region; created armed-only via ``Registry.span``."""

    __slots__ = ("_registry", "name", "attrs", "parent", "_t0")

    def __init__(self, registry, name: str, attrs: Optional[dict] = None):
        self._registry = registry
        self.name = name
        self.attrs = dict(attrs) if attrs else None
        self.parent = None
        self._t0 = 0.0

    def __enter__(self):
        stack = _span_stack(self._registry)
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self._t0 = time.monotonic()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.monotonic() - self._t0
        stack = _span_stack(self._registry)
        if stack and stack[-1] == self.name:
            stack.pop()
        self._registry.hist_record(self.name, dur)
        rec = {"name": self.name, "dur_s": dur, "parent": self.parent,
               "thread": threading.current_thread().name,
               "error": exc_type is not None}
        if self.attrs:
            rec["attrs"] = self.attrs
        self._registry._spans.append(rec)
        return False   # never swallow the exception


def dump_incident(registry, reason: str, ctx: dict) -> Optional[str]:
    """Write one incident file; returns its path (None when no incident
    dir is configured or the per-process cap is exhausted — the counter
    still bumps so the scrape shows suppressed incidents)."""
    registry.counter_add("incidents")
    seq = registry._next_incident()
    directory = registry.incident_dir
    if directory is None or seq > registry.max_incidents:
        return None
    spans = registry.spans()
    scalars = registry.scalars()
    deltas = registry.incident_delta(scalars)
    payload = {
        "schema": "mcq-incident-v1",
        "reason": reason,
        "ctx": {k: repr(v) if not isinstance(
            v, (int, float, str, bool, type(None))) else v
            for k, v in ctx.items()},
        "seq": seq,
        "pid": os.getpid(),
        "unix_time": time.time(),
        "spans": spans,
        "scalars": scalars,
        "deltas": deltas,
    }
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"incident_{seq:04d}_{os.getpid()}.json")
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=2, default=repr)
        os.replace(tmp, final)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return None
    return final
