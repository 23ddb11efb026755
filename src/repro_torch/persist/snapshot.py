"""Epoch-consistent chain snapshots (DESIGN.md §10).

A snapshot is one ``step_<n>/`` directory in the ``checkpoint/ckpt.py``
manifest+npz layout plus a ``chain.json`` sidecar carrying what arrays alone
cannot: the ``MCConfig`` the shapes were built from, the shard count the
leading state dim encodes, the ownership assignment, and ``wal_seq`` — the
WAL position the arrays are consistent with (replay starts *after* it).

Counterpart of ``repro.persist.snapshot``, with the same files and commit
protocol; ``restore_snapshot`` takes a ``device`` where the reference takes
``shardings`` (one device here).

Consistency point.  The reference snapshots an immutable published pytree.
The port's owner calls (``update_batch_``, ``maybe_decay_``, the sharded
``update_``, ``BackBufferLearner``'s catch-up) write a state in place, so
the caller must hold the state still while it is captured: it holds it as
a reader (``EpochStore.acquire`` ... ``release``) or it is the state's
owner, on the owner's thread.  The device->host gather (``ckpt._gather``, a
blocking copy) is complete when ``save_snapshot`` / ``save_snapshot_async``
return, so the owner may write the state again at once; only file IO runs
on the async worker.

Commit protocol (crash-safe): ``chain.json`` and ``arrays.npz`` are written
and fsynced first, ``manifest.json`` is renamed into place last (the atomic
commit, ``ckpt._write``), and the rename is fsynced before the save returns
or ``on_complete`` runs, so the commit survives a power loss, not only a
process kill (the reference does not fsync: the same bytes, a weaker
commit).  A crash mid-snapshot leaves a directory without a valid manifest,
so readers must use :func:`latest_complete_step`, which verifies every
array actually loads before trusting a step, and falls back to the
previous complete one.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import ckpt
from repro_torch.faults import failpoint
from repro_torch.obs import metrics as obs_metrics

PyTree = Any

META_NAME = "chain.json"


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _write_meta(path: str, meta: dict) -> None:
    """Write the sidecar, fsynced before its rename; the step directory's
    fsync before the manifest's commit (``ckpt._write``) makes the name
    durable."""
    failpoint("snapshot.meta_write", path=path)
    tmp = os.path.join(path, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
    ckpt.fsync_path(tmp)
    os.replace(tmp, os.path.join(path, META_NAME))


def save_snapshot(state: PyTree, directory: str, step: int,
                  meta: dict,
                  metrics: Optional[obs_metrics.Registry] = None) -> str:
    """Write ``step_<n>/{chain.json, arrays.npz, manifest.json}``.

    ``chain.json`` lands before ``ckpt.save`` commits the manifest, so a
    committed manifest implies the sidecar exists.  Returns the step path.
    """
    metrics = metrics if metrics is not None else obs_metrics.GLOBAL
    with metrics.span("snapshot.save", step=step):
        path = step_dir(directory, step)
        os.makedirs(path, exist_ok=True)
        _write_meta(path, meta)
        return ckpt.save(state, directory, step)


def save_snapshot_async(state: PyTree, directory: str, step: int,
                        meta: dict,
                        on_complete: Optional[Any] = None,
                        on_error: Optional[Any] = None,
                        metrics: Optional[obs_metrics.Registry] = None
                        ) -> threading.Thread:
    """Background-cadence variant: the device->host gather happens on the
    caller thread and is complete when this returns (the caller holds the
    state still until then: see the module docstring), file IO on a worker
    thread with the same commit ordering.
    ``on_complete`` runs on the worker thread after the manifest's rename
    and its fsync — the engine hangs WAL truncation off it, so segments are
    only GC'd once the snapshot that supersedes them is on the disk.  ``on_error`` receives IO
    faults from the worker (see ``ckpt.save_async``)."""
    metrics = metrics if metrics is not None else obs_metrics.GLOBAL
    t0 = time.monotonic()

    def _complete():
        # capture-to-commit wall time: the number that matters for the
        # cadence budget is when the manifest is on the disk (fsynced), not
        # when the worker was spawned
        metrics.hist_record("snapshot.save", time.monotonic() - t0)
        if on_complete is not None:
            on_complete()

    path = step_dir(directory, step)
    os.makedirs(path, exist_ok=True)
    _write_meta(path, meta)
    return ckpt.save_async(state, directory, step, on_complete=_complete,
                           on_error=on_error)


# ---------------------------------------------------------------------------
# completeness checking (crash-during-snapshot recovery)
# ---------------------------------------------------------------------------


def _step_is_complete(path: str, *, require_meta: bool = True) -> bool:
    """A step is complete iff the manifest parses, the sidecar parses (when
    required) and every manifest key loads from the npz with its recorded
    shape.  Anything else — missing files, torn json, truncated zip — is an
    aborted snapshot and must be skipped, never half-restored."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        keys = manifest["keys"]
        shapes = manifest["shapes"]
        if require_meta:
            with open(os.path.join(path, META_NAME)) as f:
                json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for i, (key, shape) in enumerate(zip(keys, shapes)):
                arr = data[f"a{i}"]  # forces the read; truncation raises
                if tuple(arr.shape) != tuple(shape):
                    return False
        return True
    except Exception:
        return False


def latest_complete_step(directory: str,
                         require_meta: bool = True) -> Optional[int]:
    """Newest step whose snapshot is fully readable (see
    :func:`_step_is_complete`); ``None`` when no complete snapshot exists."""
    if not os.path.isdir(directory):
        return None
    steps = sorted(
        (int(name.split("_")[1]) for name in os.listdir(directory)
         if name.startswith("step_")),
        reverse=True)
    for step in steps:
        if _step_is_complete(step_dir(directory, step),
                             require_meta=require_meta):
            return step
    return None


def load_meta(directory: str, step: int) -> dict:
    with open(os.path.join(step_dir(directory, step), META_NAME)) as f:
        return json.load(f)


def restore_snapshot(tree_like: PyTree, directory: str,
                     step: Optional[int] = None,
                     device=None,
                     metrics: Optional[obs_metrics.Registry] = None
                     ) -> Tuple[PyTree, dict, int]:
    """Restore the newest *complete* snapshot (or ``step``) into the
    structure of ``tree_like``, each leaf on ``device`` or on the device of
    its ``tree_like`` leaf; a chain's scalar leaves come back as views of
    one tensor, as the owner calls need them (``ckpt.restore``).  Returns
    ``(state, meta, step)``."""
    metrics = metrics if metrics is not None else obs_metrics.GLOBAL
    with metrics.span("snapshot.restore", step=step):
        if step is None:
            step = latest_complete_step(directory)
            if step is None:
                raise FileNotFoundError(
                    f"no complete snapshot under {directory}")
        elif not _step_is_complete(step_dir(directory, step)):
            raise FileNotFoundError(
                f"snapshot step {step} under {directory} is incomplete")
        meta = load_meta(directory, step)
        state, _ = ckpt.restore(tree_like, directory, step, device=device)
        return state, meta, step
