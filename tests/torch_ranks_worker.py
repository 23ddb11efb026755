"""One rank of the sharded chain's rank group, on the CPU over gloo.

    python tests/torch_ranks_worker.py <rank> <world> <workdir>

``tests/test_torch_sharded_ranks.py`` starts ``world`` of these at once.
Each joins the group by a ``file://`` rendezvous in ``workdir``, reads the
scenario (``spec.json``: the config, the plan of calls) and the global
batches (``inputs.npz``), and runs, in turn:

  * ``layout``: the three collectives, and ``gather`` / ``scatter`` in
    pieces, on small tensors;
  * ``owner``: the plan through the owner calls (``update_``,
    ``maintain_``, ``decay_``) and the reads (``query``, ``topn``) with
    ``ranks``, this rank's slice of every global batch;
  * ``func``: the same plan through the ``make_*_fn`` callables, each
    state call checked to write nothing it is given;
  * ``learner``: an ``EpochStore`` and its ``BackBufferLearner`` writing
    ``update_`` + ``maintain_`` per batch, beside the same two owner calls
    on a plain state (``plain``);
  * ``gathered`` (rank 0): ``convert.gather_sharded`` of the owner state;
    ``counters``: ``counter_stats`` over the group;
  * a snapshot of the owner state to ``workdir/group_snap`` through rank 0,
    and ``restored``: this rank's shard of ``workdir/one_snap`` (the
    one-card stacked chain's snapshot, written before the group starts);
    ``errors``: what a restore from a missing directory and a save rank 0
    cannot write raise on this rank.

It writes every leaf and output it recorded to ``workdir/rank<r>.npz``.
Nothing here imports JAX.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import convert  # noqa: E402
from repro_torch.core import epoch  # noqa: E402
from repro_torch.core import mcprioq as mc  # noqa: E402
from repro_torch.core import sharded as sh  # noqa: E402
from repro_torch.persist import snapshot  # noqa: E402
from repro_torch.sharding import ranks as rank_mod  # noqa: E402
from repro_torch.sharding.ranks import init_ranks  # noqa: E402

QUERY = ("dsts", "probs", "n_needed", "dropped")
TOPN = ("srcs", "dsts", "probs", "dropped")
SNAP_STEP = 7


def config(spec) -> sh.ShardedConfig:
    return sh.ShardedConfig(base=mc.MCConfig(**spec["base"]),
                            num_shards=spec["world"],
                            bucket_factor=spec["factor"])


def leaves(state, prefix: str, rec: dict) -> None:
    rec.update({f"{prefix}/{k}": v
                for k, v in convert.state_to_numpy(state).items()})


def replay(state, calls, reads, inputs, spec, rank, prefix, rec):
    """The plan on ``state`` through ``calls`` (state -> state) and
    ``reads`` (state -> outputs), this rank's slice of every batch."""
    world = spec["world"]

    def mine(x):
        n = x.shape[0] // world
        return x[rank * n:(rank + 1) * n]

    for j, (op, arg) in enumerate(spec["plan"]):
        if op == "update":
            state = calls[op](state, *(mine(inputs[f"{k}{arg}"])
                                       for k in ("src", "dst", "w")))
        elif op in ("maintain", "decay"):
            state = calls[op](state)
        elif op == "query":
            out = reads[op](state, mine(inputs[f"q{arg}"]))
            rec.update({f"{prefix}/{j}/{k}": v.numpy()
                        for k, v in zip(QUERY, out)})
        else:
            out = reads[arg](state)
            rec.update({f"{prefix}/{j}/{k}": v.numpy()
                        for k, v in zip(TOPN, out)})
        if op in ("update", "maintain", "decay"):
            leaves(state, f"{prefix}/{j}", rec)
    return state


def unchanged(fn):
    """``fn`` checked to write nothing it is given."""
    def call(state, *args):
        before = convert.state_to_numpy(state)
        out = fn(state, *args)
        after = convert.state_to_numpy(state)
        for k in before:
            if not np.array_equal(before[k], after[k]):
                raise AssertionError(f"a functional call wrote its input's {k}")
        if out.slabs.cnt.data_ptr() == state.slabs.cnt.data_ptr():
            raise AssertionError("a functional call returned its input's slabs")
        return out
    return call


def main(rank: int, world: int, workdir: Path) -> None:
    torch.set_num_threads(1)
    spec = json.loads((workdir / "spec.json").read_text())
    inputs = dict(np.load(workdir / "inputs.npz"))
    ranks = init_ranks(rank, world, backend="gloo",
                       init_method=f"file://{workdir / 'rendezvous'}",
                       device="cpu", timeout=60.0)
    scfg, th = config(spec), spec["threshold"]
    rec = {}

    x = torch.arange(world * 3, dtype=torch.int32).view(world, 3) + 100 * rank
    rec["layout/all_to_all"] = ranks.all_to_all(x).numpy()
    rec["layout/all_gather"] = ranks.all_gather(
        torch.tensor([rank, -rank], dtype=torch.float32)).numpy()
    rec["layout/psum"] = ranks.psum(torch.tensor([rank + 1, 10])).numpy()
    # gather and scatter in pieces of 40 bytes: 4 pieces of a 37-int row
    piece, rank_mod.P2P_PIECE_BYTES = rank_mod.P2P_PIECE_BYTES, 40
    row = torch.arange(37, dtype=torch.int32).view(1, 37) * (rank + 1)
    got = ranks.gather(row, dst=1)
    if got is not None:
        rec["layout/gather"] = got.numpy()
    blocks = torch.arange(world * 2 * 37, dtype=torch.int32).view(world * 2, 37)
    rec["layout/scatter"] = ranks.scatter(blocks if rank == 2 else None,
                                          torch.empty(2, 37, dtype=torch.int32),
                                          src=2).numpy()
    rank_mod.P2P_PIECE_BYTES = piece

    reads = {"query": sh.make_query_fn(scfg, 0.9, 8, ranks=ranks),
             8: sh.make_topn_fn(scfg, 8, ranks=ranks),
             40: sh.make_topn_fn(scfg, 40, ranks=ranks)}
    owner = {
        "update": lambda st, s, d, w: sh.update_(st, s, d, w, scfg=scfg,
                                                 ranks=ranks),
        "maintain": lambda st: sh.maintain_(st, scfg=scfg, total_threshold=th,
                                            ranks=ranks),
        "decay": lambda st: sh.decay_(st, scfg=scfg, ranks=ranks)}
    state = replay(sh.init_sharded(scfg, ranks=ranks), owner, reads, inputs,
                   spec, rank, "owner", rec)

    func = {"update": unchanged(sh.make_update_fn(scfg, ranks=ranks)),
            "maintain": unchanged(sh.make_maintain_fn(scfg, th, ranks=ranks)),
            "decay": unchanged(sh.make_decay_fn(scfg, ranks=ranks))}
    replay(sh.init_sharded(scfg, ranks=ranks), func, reads, inputs, spec,
           rank, "func", rec)

    def step(st, s, d, w, *, dirty, table_dirty):
        sh.update_(st, s, d, w, scfg=scfg, ranks=ranks, dirty=dirty,
                   table_dirty=table_dirty)
        return sh.maintain_(st, scfg=scfg, total_threshold=th, ranks=ranks,
                            dirty=dirty)

    store = epoch.EpochStore(sh.init_sharded(scfg, ranks=ranks))
    learner = epoch.BackBufferLearner(store)
    plain = sh.init_sharded(scfg, ranks=ranks)
    n = inputs["src0"].shape[0] // world
    for b in range(spec["batches"]):
        batch = [inputs[f"{k}{b}"][rank * n:(rank + 1) * n]
                 for k in ("src", "dst", "w")]
        leaves(learner.write(step, *batch), f"learner/{b}", rec)
        owner["update"](plain, *batch)
        leaves(owner["maintain"](plain), f"plain/{b}", rec)

    gathered = convert.gather_sharded(state, ranks, 0)
    if rank == 0:
        leaves(gathered, "gathered", rec)
    stats = mc.counter_stats(state, ranks)
    rec["counters"] = np.array([stats[k] for k in sorted(stats)])
    snapshot.save_snapshot(state, str(workdir / "group_snap"), SNAP_STEP,
                           spec["meta"], ranks=ranks)
    restored, meta, got_step = snapshot.restore_snapshot(
        sh.init_sharded(scfg, ranks=ranks), str(workdir / "one_snap"),
        ranks=ranks)
    if meta != spec["meta"] or got_step != SNAP_STEP:
        raise AssertionError(f"restored {meta} at step {got_step}")
    leaves(restored, "restored", rec)
    # failures reach every rank: a missing snapshot, a save rank 0 cannot
    # write (its directory is a file)
    try:
        snapshot.restore_snapshot(restored, str(workdir / "missing"),
                                  ranks=ranks)
    except FileNotFoundError as exc:
        rec["errors/restore"] = np.array(str(exc))
    try:
        snapshot.save_snapshot(state, str(workdir / "spec.json"), SNAP_STEP,
                               spec["meta"], ranks=ranks)
    except (OSError, RuntimeError) as exc:
        rec["errors/save"] = np.array(f"{type(exc).__name__}: {exc}")
    ranks.close()
    np.savez(workdir / f"rank{rank}.npz", **rec)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
