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
so readers must skip it: :func:`read_step` (behind ``restore_snapshot``
and the engine's ``restore``) reads the newest step's sidecar and arrays
once and falls back to the previous step when any of it fails to read, and
:func:`latest_complete_step` names the step it would land on.  The
reference reads every array three times per restore (the completeness
check, the given step's check again, the restore); the port once.

A rank group (``sharding.ranks``: one shard a process, ``core.sharded``'s
rank forms) snapshots in the stacked layout of the one-card chain: with
``ranks``, ``save_snapshot`` gathers every shard to rank 0, which writes
(the same commit, the same fsyncs), and ``restore_snapshot`` reads on rank
0 and scatters shard r to rank r.  The files are those of the one-card
stacked chain in the same state, byte for byte, so either restores the
other's and ``persist/reshard.py`` takes both.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np

import torch

from repro_torch import convert
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
                  metrics: Optional[obs_metrics.Registry] = None, *,
                  ranks=None) -> str:
    """Write ``step_<n>/{chain.json, arrays.npz, manifest.json}``.

    ``chain.json`` lands before ``ckpt.save`` commits the manifest, so a
    committed manifest implies the sidecar exists.  Returns the step path.
    With ``ranks`` (a ``sharding.ranks.RankGroup``; ``state`` this rank's
    shard of a sharded chain; every rank calls): the shards gathered to
    rank 0 (``convert.gather_sharded``), rank 0 writes the stacked chain,
    and every rank returns once rank 0's commit is durable, or raises when
    rank 0's write failed.
    """
    if ranks is not None:
        return _save_ranks(state, directory, step, meta, metrics, ranks)
    metrics = metrics if metrics is not None else obs_metrics.GLOBAL
    with metrics.span("snapshot.save", step=step):
        path = step_dir(directory, step)
        os.makedirs(path, exist_ok=True)
        _write_meta(path, meta)
        return ckpt.save(state, directory, step)


def _save_ranks(state, directory, step, meta, metrics, ranks) -> str:
    stacked = convert.gather_sharded(state, ranks, 0)
    failed = None
    if ranks.rank == 0:
        try:
            save_snapshot(stacked, directory, step, meta, metrics)
        except Exception as exc:   # every rank must hear of it, then raise
            failed = exc
    said = ranks.broadcast_object(None if failed is None else repr(failed))
    if failed is not None:
        raise failed
    if said is not None:
        raise RuntimeError(f"rank 0 failed to write snapshot step {step}: "
                           f"{said}")
    return step_dir(directory, step)


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


def _read(path: str, *, require_meta: bool = True
          ) -> Tuple[Optional[dict], Dict[str, np.ndarray]]:
    """The sidecar (when required) and each array of the step at ``path``,
    read once (``ckpt.read_arrays``): ``(meta, arrays)``.  Raises when the
    manifest or the sidecar does not parse, the npz is missing or truncated,
    or an array's shape is not the manifest's: an aborted snapshot."""
    meta = None
    if require_meta:
        with open(os.path.join(path, META_NAME)) as f:
            meta = json.load(f)
    _, arrays = ckpt.read_arrays(path)
    return meta, arrays


def _step_is_complete(path: str, *, require_meta: bool = True) -> bool:
    """A step is complete iff :func:`_read` reads it: anything else —
    missing files, torn json, truncated zip — is an aborted snapshot and
    must be skipped, never half-restored."""
    try:
        _read(path, require_meta=require_meta)
        return True
    except Exception:
        return False


def _steps_newest_first(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(
        (int(name.split("_")[1]) for name in os.listdir(directory)
         if name.startswith("step_")),
        reverse=True)


def latest_complete_step(directory: str,
                         require_meta: bool = True) -> Optional[int]:
    """Newest step whose snapshot is fully readable (see
    :func:`_step_is_complete`); ``None`` when no complete snapshot exists."""
    for step in _steps_newest_first(directory):
        if _step_is_complete(step_dir(directory, step),
                             require_meta=require_meta):
            return step
    return None


def load_meta(directory: str, step: int) -> dict:
    with open(os.path.join(step_dir(directory, step), META_NAME)) as f:
        return json.load(f)


def read_step(directory: str, step: Optional[int] = None
              ) -> Tuple[int, dict, Dict[str, np.ndarray]]:
    """``(step, meta, arrays)`` of the newest complete snapshot (or of
    ``step``), its sidecar first and then each array read once into host
    memory (:func:`_read`).  With ``step=None`` a step whose
    manifest, sidecar or arrays fail to read, or whose array shapes differ
    from its manifest, is skipped for the next older one: the step
    :func:`latest_complete_step` chooses.  A given ``step`` that fails to
    read raises ``FileNotFoundError``, as does a directory with no complete
    step."""
    candidates = ([step] if step is not None
                  else _steps_newest_first(directory))
    if candidates:
        failpoint("snapshot.restore_read",
                  path=step_dir(directory, candidates[0]),
                  step=candidates[0])
    for s in candidates:
        path = step_dir(directory, s)
        try:
            meta, arrays = _read(path)
        except Exception:
            continue   # an aborted snapshot: never half-restored
        return s, meta, arrays
    if step is not None:
        raise FileNotFoundError(
            f"snapshot step {step} under {directory} is incomplete")
    raise FileNotFoundError(f"no complete snapshot under {directory}")


def restore_snapshot(tree_like: PyTree, directory: str,
                     step: Optional[int] = None,
                     device=None,
                     metrics: Optional[obs_metrics.Registry] = None, *,
                     ranks=None) -> Tuple[PyTree, dict, int]:
    """Restore the newest *complete* snapshot (or ``step``) into the
    structure of ``tree_like``, each leaf on ``device`` or on the device of
    its ``tree_like`` leaf; a chain's scalar leaves come back as views of
    one tensor, as the owner calls need them (``ckpt.place``).  Each array
    is read from the disk once (:func:`read_step`).  Returns
    ``(state, meta, step)``.  With ``ranks`` (every rank calls;
    ``tree_like`` this rank's shard, leading dim 1): rank 0 reads the
    stacked snapshot and sends shard r to rank r; a snapshot that does not
    read, or whose leaves are not ``world`` shards of ``tree_like``'s,
    raises on every rank."""
    metrics = metrics if metrics is not None else obs_metrics.GLOBAL
    with metrics.span("snapshot.restore", step=step):
        if ranks is not None:
            return _restore_ranks(tree_like, directory, step, device, ranks)
        step, meta, arrays = read_step(directory, step)
        state = ckpt.place(tree_like, arrays, device=device)
        return state, meta, step


def _restore_ranks(tree_like, directory, step, device, ranks):
    keys, likes, _ = ckpt._paths_and_leaves(tree_like)
    arrays, found = {}, None
    if ranks.rank == 0:
        try:
            step, meta, arrays = read_step(directory, step)
            for key, like in zip(keys, likes):
                want = (ranks.world * like.shape[0], *like.shape[1:])
                have = arrays[key] if key in arrays else None
                if have is None or have.shape != want or \
                        have.dtype != ckpt._np_dtype(like):
                    raise ValueError(
                        f"snapshot leaf {key} is "
                        f"{None if have is None else (have.dtype, have.shape)}"
                        f", {ranks.world} shards of "
                        f"{(ckpt._np_dtype(like), tuple(like.shape))} wanted")
            found = (step, meta, None)
        except (OSError, ValueError) as exc:
            found = (None, None, f"{type(exc).__name__}: {exc}")
    step, meta, failed = ranks.broadcast_object(found)
    if failed is not None:
        raise FileNotFoundError(f"rank 0 could not restore a {ranks.world}-"
                                f"shard snapshot from {directory}: {failed}")
    local = {key: ranks.scatter(
        torch.from_numpy(arrays[key]) if ranks.rank == 0 else None,
        like).cpu().numpy() for key, like in zip(keys, likes)}
    return ckpt.place(tree_like, local, device=device), meta, step
