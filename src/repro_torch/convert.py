"""Carry state between packages: ``MCState`` <-> numpy leaves, and a
model's parameter tree <-> numpy arrays.

The chain dict's keys are the leaf names of the reference's ``MCState``
pytree (``src_table.keys``, ``slabs.cnt``, ``n_rows``, ...), 18 int32 arrays
in all, so a state learned by either package can be continued by the other.
The stacked pair does the same for a sharded chain (``core.sharded``): the
same 18 leaves, each with a leading ``[S]``; and a sharded chain held one
shard a process rank (``sharding.ranks``) goes to and from that layout by
:func:`rank_state_from_numpy` and :func:`gather_sharded`.  The model pair carries the
tree of the reference's ``Model.init`` (nested dicts and lists of numpy
arrays: ``emb``, ``final_norm``, ``pre``, ``stack``, ``tail``; the
``moe``, ``ssm`` and ``rglru`` leaves among them) to the port's
parameters and back, bit for bit.  This module sees numpy arrays only,
never another framework's types.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core.hashtable import HashTable
from repro_torch.core.mcprioq import (MCConfig, MCState, map_leaves,
                                      private_copy, resolve_device,
                                      stack_states)
from repro_torch.core.slab import Slabs

_NESTED = {"src_table": HashTable, "slabs": Slabs}

LEAF_NAMES = tuple(
    f"{field}.{sub}" if field in _NESTED else field
    for field in MCState._fields
    for sub in (_NESTED[field]._fields if field in _NESTED else (None,))
)


def state_to_numpy(state: MCState) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` as a numpy array, keyed by leaf name."""
    out = {}
    for name in LEAF_NAMES:
        leaf = state
        for part in name.split("."):
            leaf = getattr(leaf, part)
        out[name] = leaf.detach().cpu().numpy().copy()
    return out


def state_from_numpy(leaves: Dict[str, np.ndarray], cfg: MCConfig,
                     device=None) -> MCState:
    """Build an ``MCState`` on ``device`` (default: the GPU, as ``init``)
    from numpy leaves, checking names, dtypes and shapes against ``cfg``.
    As in ``init``, the scalar leaves are views of one int32 tensor."""
    dev = resolve_device(device)
    missing = sorted(set(LEAF_NAMES) - set(leaves))
    extra = sorted(set(leaves) - set(LEAF_NAMES))
    if missing or extra:
        raise ValueError(f"state leaves do not match: missing {missing}, "
                         f"unexpected {extra}")
    n, c = cfg.num_rows, cfg.capacity
    h = cfg.resolved_dst_table_size() if cfg.use_dst_hash else 1
    table = (cfg.resolved_table_size(),)
    shapes = {"src_table.keys": table, "src_table.vals": table,
              "slabs.dst": (n, c), "slabs.cnt": (n, c), "slabs.tot": (n,),
              "slabs.order": (n, c), "dh_keys": (n, h), "dh_vals": (n, h)}

    def leaf(name: str) -> torch.Tensor:
        arr = np.asarray(leaves[name])
        if arr.dtype != np.int32:
            raise TypeError(f"leaf {name} must be int32, got {arr.dtype}")
        want = shapes.get(name, ())
        if arr.shape != want:
            raise ValueError(f"leaf {name} has shape {arr.shape}, "
                             f"config wants {want}")
        return torch.from_numpy(np.array(arr, order="C", copy=True)).to(dev)

    fields = {}
    for field in MCState._fields:
        if field in _NESTED:
            cls = _NESTED[field]
            fields[field] = cls(*(leaf(f"{field}.{sub}") for sub in cls._fields))
        else:
            fields[field] = leaf(field)
    return private_copy(MCState(**fields), table=False, slabs=())


def sharded_state_to_numpy(state: MCState) -> Dict[str, np.ndarray]:
    """Every leaf of a stacked state (leading ``[S]``) as a numpy array,
    keyed by leaf name: :func:`state_to_numpy` itself, named to pair with
    :func:`sharded_state_from_numpy`."""
    return state_to_numpy(state)


def sharded_state_from_numpy(leaves: Dict[str, np.ndarray], scfg,
                             device=None) -> MCState:
    """Build a stacked state of ``scfg.num_shards`` chains (``scfg`` a
    ``core.sharded.ShardedConfig``) on ``device`` (default: the GPU) from
    numpy leaves with a leading ``[S]``, each shard checked as
    :func:`state_from_numpy` checks a chain."""
    _check_leading(leaves, scfg.num_shards)
    return stack_states([
        state_from_numpy({k: np.asarray(v)[i] for k, v in leaves.items()},
                         scfg.base, device) for i in range(scfg.num_shards)])


def _check_leading(leaves: Dict[str, np.ndarray], s: int) -> None:
    for name, arr in leaves.items():
        if np.ndim(arr) < 1 or np.shape(arr)[0] != s:
            raise ValueError(f"leaf {name} has shape {np.shape(arr)}, a "
                             f"sharded state wants a leading {s}")


def rank_state_from_numpy(leaves: Dict[str, np.ndarray], scfg, rank: int,
                          device=None) -> MCState:
    """Shard ``rank`` of stacked numpy leaves (``[S, ...]``, the layout of
    :func:`sharded_state_to_numpy`) as a rank's state of one shard
    (leading dim 1) on ``device`` (default: the GPU), checked as
    :func:`sharded_state_from_numpy` checks a stacked state."""
    if not 0 <= rank < scfg.num_shards:
        raise ValueError(f"rank {rank} is not a shard of {scfg.num_shards}")
    _check_leading(leaves, scfg.num_shards)
    return stack_states([state_from_numpy(
        {k: np.asarray(v)[rank] for k, v in leaves.items()}, scfg.base,
        device)])


def gather_sharded(state: MCState, ranks, dst: int = 0) -> Optional[MCState]:
    """The whole sharded chain of a rank group (``ranks`` a
    ``sharding.ranks.RankGroup``, ``state`` this rank's one shard) as one
    stacked state on the CPU on rank ``dst`` — the layout of the one-card
    chain, its scalars the columns of one ``[S, 10]`` tensor — and None on
    the other ranks.  Every rank calls it."""
    stacked = map_leaves(lambda leaf: ranks.gather(leaf, dst), state)
    if ranks.rank != dst:
        return None
    return private_copy(stacked, table=False, slabs=(), dh=False)


def model_params_from_numpy(cfg, tree, device=None) -> Any:
    """The port's parameters of ``models.Model(cfg)`` on ``device`` (default:
    the GPU) from a tree of numpy arrays laid out as the reference's
    ``Model.init`` lays out its parameters; every key, list length, shape
    and dtype checked against ``Model(cfg).abstract_params()``."""
    from repro_torch.models.model import Model
    dev = resolve_device(device)

    def one(want, got, path: str):
        if isinstance(want, dict):
            if not isinstance(got, dict) or set(got) != set(want):
                have = sorted(got) if isinstance(got, dict) else type(got)
                raise ValueError(f"params{path}: keys {have} != "
                                 f"{sorted(want)}")
            return {k: one(want[k], got[k], f"{path}.{k}") for k in want}
        if isinstance(want, list):
            if not isinstance(got, (list, tuple)) or len(got) != len(want):
                raise ValueError(f"params{path}: a list of {len(want)} "
                                 f"blocks wanted")
            return [one(w, g, f"{path}[{i}]")
                    for i, (w, g) in enumerate(zip(want, got))]
        arr = np.asarray(got)
        want_np = torch.empty((), dtype=want.dtype).numpy().dtype
        if arr.dtype != want_np or arr.shape != tuple(want.shape):
            raise ValueError(f"params{path}: {arr.dtype}{arr.shape}, the "
                             f"config wants {want_np}{tuple(want.shape)}")
        return torch.from_numpy(np.array(arr, order="C", copy=True)).to(dev)

    return one(Model(cfg).abstract_params(), tree, "")


def model_params_to_numpy(params) -> Any:
    """A parameter tree of tensors (on any device) as the same tree of numpy
    arrays."""
    if isinstance(params, dict):
        return {k: model_params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [model_params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy().copy()
