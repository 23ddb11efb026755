"""Process ranks: the counterpart of the reference's mesh axis.

The reference runs one shard of the sharded chain per device: its state
lies under ``NamedSharding(mesh, P(axis))``, a ``shard_map`` body sees its
own shard, and the shards exchange buckets with ``jax.lax`` collectives over
the axis.  The port runs one shard per process rank.  :func:`init_ranks`
joins a ``torch.distributed`` group; a :class:`RankGroup` carries the group,
the rank, the world size, the rank's device and the backend, and offers
the reference's three collectives:

  * :meth:`RankGroup.all_to_all` — ``jax.lax.all_to_all(x, axis, 0, 0,
    tiled=True)``: ``x[S, ...]`` sends ``x[r]`` to rank r and returns
    ``[S_send, ...]``, sender 0's block first;
  * :meth:`RankGroup.all_gather` — ``jax.lax.all_gather``: ``[S, ...]``;
  * :meth:`RankGroup.psum` — ``jax.lax.psum``.

and, for carrying a state to one process and back (``convert``,
``persist/snapshot.py``), ``gather``, ``scatter`` and
``broadcast_object``.

Backends.  NCCL: one rank per card (NCCL refuses two ranks on one GPU in
one communicator); the rank's card tensors are exchanged directly, ordered
on the current stream, with no host read.  gloo: CPU tensors.  A rank whose
tensors are on a card and whose group is gloo — several ranks sharing one
card — stages every exchange through pinned host memory: the device->host
copy (a synchronisation), the exchange, the host->device copy.  That is the
only rule by which a card's tensors go through the host here, and
:attr:`RankGroup.staged` names it.

Contract: every rank makes the same collectives in the same order with the
same shapes, as ``shard_map``'s ``P(axis)`` guarantees the reference (a
rank handed a local batch of another length would make the sizes disagree;
nothing checks it per call, which would cost a synchronisation).  A group
is joined with a bounded timeout, so that a lost rank fails the others'
collectives instead of hanging them.
"""

from __future__ import annotations

import datetime
from typing import Any, Optional

import torch
import torch.distributed as dist

__all__ = ["BACKENDS", "RankGroup", "init_ranks"]

BACKENDS = ("nccl", "gloo")
P2P_PIECE_BYTES = 8 << 20   # one point-to-point message of gather / scatter


class RankGroup:
    """One rank's view of a process group: ``group``, ``rank``, ``world``,
    ``device`` (where this rank's state lives) and ``backend``."""

    def __init__(self, group: Any, rank: int, world: int,
                 device: torch.device, backend: str):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{backend!r}")
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} is not in a world of {world}")
        if backend == "nccl" and torch.device(device).type != "cuda":
            raise ValueError(f"an NCCL rank needs a CUDA device, got {device}")
        self.group = group
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend

    @property
    def staged(self) -> bool:
        """True where the card's tensors go through pinned host memory: a
        gloo group whose ranks keep their state on a card."""
        return self.backend == "gloo" and self.device.type == "cuda"

    # -- staging ------------------------------------------------------------

    def _out(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the backend exchanges it: a pinned host copy when
        staged (a blocking copy: the device has written ``x``), else ``x``
        contiguous."""
        if not self.staged:
            return x.contiguous()
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        return host.copy_(x)

    def _empty(self, shape, dtype) -> torch.Tensor:
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _back(self, x: torch.Tensor) -> torch.Tensor:
        """An exchanged tensor on the rank's device (from pinned memory the
        copy is queued on the current stream)."""
        return x.to(self.device, non_blocking=True) if self.staged else x

    # -- the reference's collectives ----------------------------------------

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled all-to-all on dim 0: ``x[world, ...]`` sends block ``x[r]``
        to rank r; returns ``[world, ...]`` holding sender j's block for
        this rank at ``[j]``, as ``jax.lax.all_to_all(x, axis, 0, 0,
        tiled=True)`` with one block a sender."""
        if x.dim() < 1 or x.shape[0] != self.world:
            raise ValueError(f"all_to_all of {tuple(x.shape)}: dim 0 must be "
                             f"the world size {self.world}")
        send = self._out(x)
        recv = self._empty(send.shape, send.dtype)
        dist.all_to_all_single(recv, send, group=self.group)
        return self._back(recv)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """``[world, *x.shape]``: every rank's ``x`` in rank order."""
        send = self._out(x)
        out = self._empty((self.world, *send.shape), send.dtype)
        dist.all_gather(list(out.unbind(0)), send, group=self.group)
        return self._back(out)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x`` (``x`` itself is not written)."""
        out = self._out(x) if self.staged else x.clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return self._back(out)

    # -- carrying a state to one process and back ---------------------------

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` where a gather or scatter moves it: on the card for NCCL,
        on the CPU for gloo."""
        where = self.device if self.backend == "nccl" else "cpu"
        return x.to(where).contiguous()

    def _p2p(self, sends, recvs) -> None:
        """Post every send and receive (``(tensor, peer)`` pairs, each
        tensor contiguous) at once, in pieces of ``P2P_PIECE_BYTES``, and
        wait for them: gloo moves a large tensor between two processes of
        one host several times faster in pieces than whole."""
        def pieces(x):
            flat = x.view(-1)
            return flat.split(max(1, P2P_PIECE_BYTES // flat.element_size()))

        ops = [dist.P2POp(op, piece, peer, self.group)
               for op, pairs in ((dist.isend, sends), (dist.irecv, recvs))
               for x, peer in pairs for piece in pieces(x)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()

    def gather(self, x: torch.Tensor, dst: int = 0) -> Optional[torch.Tensor]:
        """Every rank's ``x`` (at least 1-d) concatenated along dim 0, on
        the CPU, on rank ``dst``; None on the others."""
        send = self._wire(x)
        if self.rank != dst:
            self._p2p([(send, dst)], [])
            return None
        out = torch.empty((self.world, *send.shape), dtype=send.dtype,
                          device=send.device)
        out[dst].copy_(send)
        self._p2p([], [(out[r], r) for r in range(self.world) if r != dst])
        return out.flatten(0, 1).cpu()

    def scatter(self, chunks: Optional[torch.Tensor], like: torch.Tensor,
                src: int = 0) -> torch.Tensor:
        """Rank r's block of ``chunks`` (given on rank ``src`` only: the
        ranks' blocks, each shaped like ``like``, concatenated along dim
        0), on this rank's device."""
        recv = self._wire(torch.empty(like.shape, dtype=like.dtype))
        if self.rank != src:
            self._p2p([], [(recv, src)])
            return recv.to(self.device)
        if chunks.shape[0] != self.world * like.shape[0] or \
                chunks.shape[1:] != like.shape[1:]:
            raise ValueError(f"scatter of {tuple(chunks.shape)}: {self.world} "
                             f"blocks of {tuple(like.shape)} wanted")
        blocks = [self._wire(b) for b in chunks.split(like.shape[0])]
        recv.copy_(blocks[src])
        self._p2p([(b, r) for r, b in enumerate(blocks) if r != src], [])
        return recv.to(self.device)

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        """``obj`` of rank ``src`` on every rank (pickled: only this
        program's own objects)."""
        box = [obj]
        dist.broadcast_object_list(box, src=src, group=self.group)
        return box[0]

    def close(self) -> None:
        """Leave the group (every rank)."""
        dist.destroy_process_group(self.group)


def init_ranks(rank: int, world: int, *, backend: str, init_method: str,
               device=None, timeout: float = 60.0) -> RankGroup:
    """Join the process group of ``world`` ranks as ``rank``.

    ``init_method`` is the rendezvous: a ``file://`` path in a directory
    the caller owns (parallel groups then share no port), or
    ``tcp://localhost:<port>``.  ``device`` is where this rank's state
    lives; default ``cuda:<rank>`` for NCCL and the current CUDA device for
    gloo (no device and no card raises: ``device='cpu'`` runs the plain
    versions).  For NCCL the device is made current before the group is
    made.  ``timeout`` (seconds) bounds every collective, so that a lost
    rank fails its group."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if device is None:
        if backend == "nccl":
            device = torch.device("cuda", rank)
        elif not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available and no device was "
                "given; pass device='cpu' to run the plain versions on the CPU")
        else:
            device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    kw = {}
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"an NCCL rank needs a CUDA device, got {device}")
        torch.cuda.set_device(device)
        kw["device_id"] = device
    elif device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout), **kw)
    return RankGroup(dist.group.WORLD, rank, world, device, backend)
