"""Checkpointing: save/restore a tree of tensors with a manifest, async save.

Counterpart of ``repro.checkpoint.ckpt``, with the same files:

Layout:  <dir>/step_<n>/manifest.json + arrays.npz

The manifest's rename is the commit, and it is durable: every file is
fsynced before the rename and the directories around it after (``_write``).
The reference commits with no fsync; the files are the same bytes.

Each leaf is keyed by its '/'-joined tree path, spelled as the reference
spells a jax tree path, and the leaves are listed in jax's flattening
order: a NamedTuple field is ``.field`` (``.src_table/.keys`` for an
``MCState``), a dict key is the key itself (keys in sorted order), a list or
tuple element its index; ``None`` holds no leaf.  So either package
restores a checkpoint the other wrote.

The port has one device, so ``restore`` takes no ``shardings``: each leaf
goes to ``device`` when given, else to the device of the matching leaf of
``tree_like``, and a leaf that is not a tensor there (a numpy array, a
Python scalar) to the GPU, as every entry point of the port does
(``device='cpu'`` is the opt-out).  Leaves of ``tree_like`` that share one storage — the ten
scalar leaves of a chain are views of one int32 tensor, the columns of one
``[S, 10]`` tensor in a stacked state, and the owner calls need them so —
come back sharing one new storage, at the same offsets and strides.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.faults import failpoint

PyTree = Any


def _flatten(tree: PyTree, path: Tuple[str, ...], keys: List[str],
             leaves: List[Any]) -> Callable[[Any], PyTree]:
    """Append ``tree``'s leaves (jax's order) and their path strings; return
    a function that rebuilds the tree from an iterator of new leaves."""
    if tree is None:
        return lambda it: None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        subs = [_flatten(v, path + (f".{f}",), keys, leaves)
                for f, v in zip(tree._fields, tree)]
        return lambda it: type(tree)(*(sub(it) for sub in subs))
    if isinstance(tree, dict):
        names = sorted(tree)
        subs = [_flatten(tree[k], path + (str(k),), keys, leaves)
                for k in names]
        return lambda it: {k: sub(it) for k, sub in zip(names, subs)}
    if isinstance(tree, (list, tuple)):
        subs = [_flatten(v, path + (str(i),), keys, leaves)
                for i, v in enumerate(tree)]
        return lambda it: type(tree)(sub(it) for sub in subs)
    keys.append("/".join(path))
    leaves.append(tree)
    return lambda it: next(it)


def _paths_and_leaves(tree: PyTree):
    """``(keys, leaves, rebuild)``: the reference's key strings and leaf
    order; ``rebuild(new_leaves)`` gives the tree back with them."""
    keys: List[str] = []
    leaves: List[Any] = []
    build = _flatten(tree, (), keys, leaves)
    return keys, leaves, lambda new: build(iter(new))


def tree_map(fn, tree: PyTree) -> PyTree:
    """``fn`` on every leaf, the tree's structure kept."""
    _, leaves, rebuild = _paths_and_leaves(tree)
    return rebuild([fn(x) for x in leaves])


def _gather(x) -> np.ndarray:
    """A host copy of one leaf, complete when this returns (a blocking
    device->host copy; a CPU tensor or an array is copied too), so the
    caller may write the leaf again at once."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


def fsync_path(path: str) -> None:
    """Flush a file's or a directory's contents and metadata to the disk
    (a directory: the names it holds), through a descriptor of its own."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write(path: str, step: int, keys, host) -> None:
    """Write ``arrays.npz`` and commit ``manifest.json`` in ``path``, the
    commit durable when this returns: the npz is fsynced, the manifest's
    temp file is fsynced and renamed into place only once every other name
    in ``path`` (and ``path``'s own in its parent) is on the disk, and the
    rename is fsynced in turn.  So a manifest that survives a power loss
    names arrays that survived it too."""
    failpoint("snapshot.arrays_write", path=path, step=step)
    arrays = os.path.join(path, "arrays.npz")
    np.savez(arrays, **{f"a{i}": a for i, a in enumerate(host)})
    fsync_path(arrays)
    fsync_path(os.path.dirname(path))   # the step directory's own name
    manifest = {"step": step, "keys": list(keys),
                "dtypes": [str(a.dtype) for a in host],
                "shapes": [list(a.shape) for a in host]}
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    fsync_path(tmp)
    fsync_path(path)   # the npz's and the sidecar's names, before the commit
    failpoint("snapshot.manifest_commit", path=path, step=step)
    os.replace(tmp, os.path.join(path, "manifest.json"))  # atomic commit
    fsync_path(path)   # the commit itself


def save(tree: PyTree, directory: str, step: int) -> str:
    path = os.path.join(directory, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    keys, leaves, _ = _paths_and_leaves(tree)
    _write(path, step, keys, [_gather(x) for x in leaves])
    return path


def save_async(tree: PyTree, directory: str, step: int,
               on_complete: Optional[Any] = None,
               on_error: Optional[Any] = None) -> threading.Thread:
    """Non-blocking save: the device->host copy happens on the caller
    thread and is complete when this returns, so the state's owner may
    write the state again at once (the port's owner calls write in place);
    file IO runs on a worker thread.  ``on_complete`` (a zero-arg callable)
    runs on the worker thread strictly after the manifest rename commits
    and that rename is fsynced (``_write``) — the hook for actions that are
    only safe once the checkpoint is on the disk, e.g. WAL truncation.  ``on_error`` receives any exception the worker
    hits (IO faults, a failing ``on_complete``); without it the exception
    propagates and the thread dies with a stderr traceback.

    The thread is deliberately NOT a daemon: interpreter shutdown must wait
    for the commit rather than abandoning a half-written step."""
    keys, leaves, _ = _paths_and_leaves(tree)
    host = [_gather(x) for x in leaves]

    def work():
        try:
            failpoint("snapshot.io_thread", step=step)
            path = os.path.join(directory, f"step_{step:08d}")
            os.makedirs(path, exist_ok=True)
            _write(path, step, keys, host)
            if on_complete is not None:
                on_complete()
        except Exception as exc:
            if on_error is None:
                raise
            on_error(exc)

    t = threading.Thread(target=work, daemon=False)
    t.start()
    return t


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
                os.path.join(directory, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _np_dtype(like) -> np.dtype:
    if isinstance(like, torch.Tensor):
        return torch.empty((), dtype=like.dtype).numpy().dtype
    return np.asarray(like).dtype


def _storage_key(x: torch.Tensor):
    return (x.device, x.untyped_storage().data_ptr())


def _shared_storages(leaves) -> set:
    """Storages that two or more tensor leaves view: the layout ``restore``
    reproduces."""
    seen, shared = set(), set()
    for x in leaves:
        if isinstance(x, torch.Tensor):
            key = _storage_key(x)
            (shared if key in seen else seen).add(key)
    return shared


def _put(arr: np.ndarray, like, device, shared: set, bases: dict):
    """``arr`` as a tensor on ``device`` (default: ``like``'s device, the
    GPU for a leaf that is not a tensor); a view into one new storage per
    storage of ``shared``, at ``like``'s offset and strides."""
    if device is None:
        device = (like.device if isinstance(like, torch.Tensor)
                  else resolve_device(None))
    host = torch.from_numpy(arr)
    if not (isinstance(like, torch.Tensor) and _storage_key(like) in shared):
        return host.to(device)
    key = _storage_key(like)
    if key not in bases:
        bases[key] = torch.zeros(like.untyped_storage().nbytes(),
                                 dtype=torch.uint8,
                                 device=device).untyped_storage()
    out = torch.empty((0,), dtype=like.dtype, device=device)
    out.set_(bases[key], like.storage_offset(), like.shape, like.stride())
    return out.copy_(host)


def read_arrays(path: str) -> Tuple[dict, Dict[str, np.ndarray]]:
    """Read a step's manifest and each of its arrays once, from the disk
    into host memory: ``(manifest, {key: array})``.  A torn manifest, a
    missing or truncated npz, or an array whose shape is not the manifest's
    raises."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for i, (key, shape) in enumerate(zip(manifest["keys"],
                                             manifest["shapes"])):
            arr = data[f"a{i}"]   # the whole read: a truncated zip raises
            if tuple(arr.shape) != tuple(shape):
                raise ValueError(f"{path}: {key} has shape {arr.shape}, "
                                 f"the manifest says {tuple(shape)}")
            arrays[key] = arr
    return manifest, arrays


def place(tree_like: PyTree, arrays: Dict[str, np.ndarray],
          device=None) -> PyTree:
    """The arrays of :func:`read_arrays` in the structure of ``tree_like``:
    each leaf on ``device`` when given, else on the device of the matching
    leaf of ``tree_like`` (the GPU for a leaf that is not a tensor, an
    error without one); leaves that share a storage there share a new one
    (see the module docstring).  ``tree_like`` itself is not written."""
    keys, leaves, rebuild = _paths_and_leaves(tree_like)
    shared, bases = _shared_storages(leaves), {}
    out = []
    for k, like in zip(keys, leaves):
        if k not in arrays:
            raise KeyError(f"checkpoint missing leaf {k}")
        arr = arrays[k]
        if tuple(arr.shape) != tuple(np.shape(like)):
            raise ValueError(f"{k}: shape {arr.shape} != {tuple(np.shape(like))}")
        # cast only within a kind (f64 ckpt -> f32 leaf, i64 -> i32): a
        # float array restoring into an integer leaf (or vice versa) means
        # the checkpoint and the template disagree about what the leaf IS,
        # and a silent astype would truncate/round values instead of
        # failing.
        like_dtype = _np_dtype(like)
        if arr.dtype != like_dtype and (
                arr.dtype.kind != like_dtype.kind
                or not np.can_cast(arr.dtype, like_dtype,
                                   casting="same_kind")):
            raise ValueError(
                f"{k}: checkpoint dtype {arr.dtype} cannot restore into "
                f"{like_dtype} without changing kind")
        out.append(_put(arr.astype(like_dtype, copy=False), like, device,
                        shared, bases))
    return rebuild(out)


def restore(tree_like: PyTree, directory: str, step: Optional[int] = None,
            device=None) -> Tuple[PyTree, int]:
    """Restore into the structure of ``tree_like`` (see :func:`place`),
    each array read once (:func:`read_arrays`)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    failpoint("snapshot.restore_read", path=path, step=step)
    _, arrays = read_arrays(path)
    return place(tree_like, arrays, device), step
