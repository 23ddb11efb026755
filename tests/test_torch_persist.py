"""The port's durability layer (``repro_torch.checkpoint``,
``repro_torch.persist``) against the reference's, tolerance 0.

The same states and batches go through both packages: checkpoint key
lists, snapshots restored across packages in both directions (manifests and
sidecars byte-identical), WAL segment files byte-identical and replayed
across packages, the reference's snapshot and WAL tests
(``tests/test_persist.py:55-240``) run against the port, the unsharded
crash recovery through the port's owner calls equal to the reference's
recovered state, ``extract_edges`` / ``plan_batches`` / ``settle_order``
equal on the same inputs, and an async snapshot that an owner call writes
over at once.  The N -> M reshard composition is in
``tests/test_torch_reshard.py``.
"""

import dataclasses
import filecmp
import os
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import ckpt as jck
from repro.core import mcprioq as jmc
from repro.persist import reshard as jrs
from repro.persist import snapshot as jsnap
from repro.persist.wal import WriteAheadLog as JWAL
from repro_torch import convert
from repro_torch import faults
from repro_torch.checkpoint import ckpt
from repro_torch.core import mcprioq as tmc
from repro_torch.core import sharded as tsh
from repro_torch.core import slab as tsl
from repro_torch.persist import reshard as rs
from repro_torch.persist import snapshot as snap_io
from repro_torch.persist.wal import WriteAheadLog

from torch_parity import assert_same, jax_state_leaves

CFG = dict(num_rows=64, capacity=16, sort_passes=4)
SHARDS = 4


def _distinct_count_batch(n_src=12, n_dst=5, seed=0):
    """tests/test_persist.py's batch: edge (s, d) seen d + 1 times."""
    srcs, dsts = [], []
    for s in range(n_src):
        for d in range(n_dst):
            srcs += [s] * (d + 1)
            dsts += [d] * (d + 1)
    src = np.array(srcs, np.int32)
    dst = np.array(dsts, np.int32)
    perm = np.random.default_rng(seed).permutation(src.size)
    return src[perm], dst[perm]


def _jax_chain(seed=0, cfg=CFG):
    """A learned reference chain: a distinct-count batch and a random one."""
    jcfg = jmc.MCConfig(**cfg)
    src, dst = _distinct_count_batch(seed=seed)
    state = jmc.update_batch(jmc.init(jcfg), jnp.asarray(src),
                             jnp.asarray(dst), cfg=jcfg)
    rng = np.random.default_rng(seed + 10)
    return jmc.update_batch(state, jnp.asarray(rng.integers(0, 90, 128),
                                               dtype=jnp.int32),
                            jnp.asarray(rng.integers(0, 30, 128),
                                        dtype=jnp.int32), cfg=jcfg)


def _jax_stacked():
    """A stacked 4-shard reference state built on the host (``np.stack`` of
    four learned chains): no fake devices needed."""
    shards = [jax.tree_util.tree_map(np.asarray, _jax_chain(seed))
              for seed in range(SHARDS)]
    return jax.tree_util.tree_map(lambda *xs: np.stack(xs), *shards)


def _jax_stacked_like():
    """The reference engine's host template of a stacked state."""
    return jax.tree_util.tree_map(
        lambda x: np.broadcast_to(np.asarray(x)[None], (SHARDS,) + x.shape),
        jmc.init(jmc.MCConfig(**CFG)))


def _port(jstate, stacked=False):
    leaves = jax_state_leaves(jstate)
    if stacked:
        scfg = tsh.ShardedConfig(base=tmc.MCConfig(**CFG), num_shards=SHARDS)
        return convert.sharded_state_from_numpy(leaves, scfg, device="cpu")
    return convert.state_from_numpy(leaves, tmc.MCConfig(**CFG), device="cpu")


def _port_like(stacked=False):
    cfg = tmc.MCConfig(**CFG)
    if stacked:
        return tsh.init_sharded(tsh.ShardedConfig(base=cfg, num_shards=SHARDS),
                                device="cpu")
    return tmc.init(cfg, device="cpu")


def _npz(path):
    with np.load(os.path.join(path, "arrays.npz")) as data:
        return {k: data[k] for k in data.files}


# ---------------------------------------------------------------------------
# checkpoint keys
# ---------------------------------------------------------------------------


def test_key_lists_equal_the_references():
    """jax's tree-path strings and leaf order: on a chain (18 keys from
    ``.src_table/.keys`` to ``.dh_tombstones``), a stacked state and a
    nested dict / list / tuple tree with None holes."""
    jchain, tchain = jmc.init(jmc.MCConfig(**CFG)), _port_like()
    jkeys = jck._paths_and_leaves(jchain)[0]
    assert len(jkeys) == 18 and jkeys[0] == ".src_table/.keys"
    assert jkeys[-1] == ".dh_tombstones"
    assert ckpt._paths_and_leaves(tchain)[0] == jkeys
    assert (ckpt._paths_and_leaves(_port_like(stacked=True))[0]
            == jck._paths_and_leaves(_jax_stacked_like())[0])

    def nested(chain, arr):
        return {"z": [arr(3), {"b": None, "a": (arr(1), 7)}], "chain": chain,
                "10": arr(2), "2": [], "m": {"x": [None, arr(4)]}}

    jtree = nested(jchain, lambda n: np.zeros(n, np.int32))
    ttree = nested(tchain, lambda n: torch.zeros(n, dtype=torch.int32))
    jk, jl, _ = jck._paths_and_leaves(jtree)
    tk, tl, rebuild = ckpt._paths_and_leaves(ttree)
    assert tk == jk
    assert [tuple(np.shape(x)) for x in tl] == [tuple(np.shape(x)) for x in jl]
    again = rebuild(tl)
    assert ckpt._paths_and_leaves(again)[0] == tk
    assert again["z"][1]["b"] is None and isinstance(again["z"][1]["a"], tuple)


# ---------------------------------------------------------------------------
# cross-restore, both directions
# ---------------------------------------------------------------------------


def _update_port(state, stacked, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 100, 32).astype(np.int32)
    dst = rng.integers(0, 40, 32).astype(np.int32)
    if stacked:
        scfg = tsh.ShardedConfig(base=tmc.MCConfig(**CFG), num_shards=SHARDS,
                                 bucket_factor=4.0)
        return tsh.update_(state, src, dst, np.ones_like(src), scfg=scfg)
    return tmc.update_batch_(state, src, dst, cfg=tmc.MCConfig(**CFG))


@pytest.mark.parametrize("stacked", [False, True], ids=["chain", "stacked"])
@pytest.mark.parametrize("api", ["ckpt", "snapshot"])
def test_cross_restore_both_ways(tmp_path, api, stacked):
    """The same state saved by each package: identical ``manifest.json``
    (and ``chain.json``), every array equal; each package restores the
    other's files to the same leaves; an owner call on the port's restored
    state equals the same call on the state it came from."""
    jstate = _jax_stacked() if stacked else _jax_chain()
    tstate = _port(jstate, stacked)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    meta = {"wal_seq": 41, "num_shards": SHARDS if stacked else 1,
            "base_cfg": dict(CFG)}
    if api == "ckpt":
        jck.save(jstate, jdir, 5)
        ckpt.save(tstate, tdir, 5)
    else:
        jsnap.save_snapshot(jstate, jdir, 5, meta)
        snap_io.save_snapshot(tstate, tdir, 5, meta)
        assert filecmp.cmp(os.path.join(jdir, "step_00000005", "chain.json"),
                           os.path.join(tdir, "step_00000005", "chain.json"),
                           shallow=False)
    jpath, tpath = (os.path.join(d, "step_00000005") for d in (jdir, tdir))
    assert filecmp.cmp(os.path.join(jpath, "manifest.json"),
                       os.path.join(tpath, "manifest.json"), shallow=False)
    assert_same(_npz(jpath), _npz(tpath), "arrays.npz")

    jlike = _jax_stacked_like() if stacked else jmc.init(jmc.MCConfig(**CFG))
    if api == "ckpt":
        from_ref, _ = ckpt.restore(_port_like(stacked), jdir)
        from_port, _ = jck.restore(jlike, tdir)
    else:
        from_ref, meta_t, _ = snap_io.restore_snapshot(_port_like(stacked), jdir)
        from_port, meta_j, _ = jsnap.restore_snapshot(jlike, tdir)
        assert meta_t == meta_j == meta
    assert_same(jax_state_leaves(jstate), convert.state_to_numpy(from_ref),
                "the port restoring the reference's files")
    assert_same(jax_state_leaves(jstate), jax_state_leaves(from_port),
                "the reference restoring the port's files")
    tmc.scalars_of(from_ref if not stacked else tsh.shard_state(from_ref, 1))
    got = _update_port(from_ref, stacked, 3)
    want = _update_port(_port(jstate, stacked), stacked, 3)
    assert_same(convert.state_to_numpy(want), convert.state_to_numpy(got),
                "an owner call after the restore")
    if not stacked:   # and the reference's update on its own restore
        rng = np.random.default_rng(3)
        src = jnp.asarray(rng.integers(0, 100, 32), jnp.int32)
        dst = jnp.asarray(rng.integers(0, 40, 32), jnp.int32)
        ref = jmc.update_batch(from_port, src, dst, cfg=jmc.MCConfig(**CFG))
        assert_same(jax_state_leaves(ref), convert.state_to_numpy(got),
                    "the reference's update on its restore")


def test_restore_keeps_the_template_and_puts_leaves_on_the_device(tmp_path):
    """``restore`` writes nothing of ``tree_like``; ``device`` overrides the
    template's device; a numpy template leaf comes back as a tensor there; a
    stacked restore keeps the scalars the columns of one ``[S, 10]``
    tensor; a key the checkpoint lacks is a KeyError."""
    tstate = _port(_jax_stacked(), stacked=True)
    ckpt.save({"state": tstate, "extra": np.arange(3)}, str(tmp_path), 2)
    like = _port_like(stacked=True)
    before = convert.state_to_numpy(like)
    out, step = ckpt.restore({"state": like, "extra": np.zeros(3, np.int64)},
                             str(tmp_path), device="cpu")
    assert step == 2 and isinstance(out["extra"], torch.Tensor)
    assert out["extra"].tolist() == [0, 1, 2]
    assert_same(before, convert.state_to_numpy(like), "the template")
    st = out["state"]
    base = st.n_rows.untyped_storage().data_ptr()
    assert all(getattr(st, f).untyped_storage().data_ptr() == base
               and getattr(st, f).stride() == (10,) for f in tmc.SCALAR_FIELDS)
    assert base != like.n_rows.untyped_storage().data_ptr()
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore({"state": like, "more": np.zeros(1)}, str(tmp_path))
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore({"state": like, "extra": np.zeros(4, np.int64)},
                     str(tmp_path))


def test_restore_puts_a_non_tensor_leaf_on_the_gpu_unless_told(tmp_path,
                                                               monkeypatch):
    """A template leaf that is not a tensor (a numpy array, a numpy or
    Python scalar) has no device of its own: ``restore`` puts it on the GPU,
    as the port's constructors do, and raises without one rather than fall
    back to the CPU; ``device='cpu'`` asks for the CPU."""
    tree = {"a": np.arange(3), "b": [np.float32(2.5), 7]}
    ckpt.save(tree, str(tmp_path), 1)
    like = {"a": np.zeros(3, np.int64), "b": [np.float32(0), 0]}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ckpt.restore(like, str(tmp_path))
    out, step = ckpt.restore(like, str(tmp_path), device="cpu")
    assert step == 1
    assert all(x.device.type == "cpu" for x in (out["a"], *out["b"]))
    assert out["a"].tolist() == [0, 1, 2]
    assert out["b"][0].dtype == torch.float32 and float(out["b"][0]) == 2.5
    assert out["b"][1].dtype == torch.int64 and int(out["b"][1]) == 7


# ---------------------------------------------------------------------------
# the WAL, byte for byte
# ---------------------------------------------------------------------------


def _appends(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(7):
        n = int(rng.integers(1, 40))
        src = rng.integers(-2, 1000, n).astype(np.int32)
        dst = rng.integers(0, 1000, n).astype(np.int32)
        w = None if i % 3 == 0 else rng.integers(1, 9, n).astype(np.int32)
        out.append((src, dst, w))
    return out


@pytest.mark.parametrize("fsync", ["always", "rotate", "never"])
def test_wal_segments_byte_identical_and_replayed_across_packages(tmp_path,
                                                                  fsync):
    jdir, tdir = tmp_path / "ref", tmp_path / "port"
    for cls, d in ((JWAL, jdir), (WriteAheadLog, tdir)):
        with cls(str(d), segment_records=3, fsync=fsync) as wal:
            assert [wal.append(*a) for a in _appends()] == list(range(7))
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 3
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    for reader, d in ((WriteAheadLog, jdir), (JWAL, tdir)):
        recs = list(reader(str(d)).replay(after_seq=1))
        assert [r[0] for r in recs] == list(range(2, 7))
        for (_, src, dst, w), (s0, d0, w0) in zip(recs, _appends()[2:]):
            np.testing.assert_array_equal(src, s0)
            np.testing.assert_array_equal(dst, d0)
            np.testing.assert_array_equal(w, np.ones_like(s0) if w0 is None
                                          else w0)


# ---------------------------------------------------------------------------
# tests/test_persist.py:55-240 against the port
# ---------------------------------------------------------------------------


def test_ckpt_roundtrips_integer_counters(tmp_path):
    cfg = tmc.MCConfig(num_rows=8, capacity=4)
    state = tmc.init(cfg, device="cpu")
    for field, v in (("decay_cursor", 3), ("route_dropped", 7),
                     ("deferred_new", 11)):
        getattr(state, field).fill_(v)
    ckpt.save(state, str(tmp_path), 0)
    restored, _ = ckpt.restore(tmc.init(cfg, device="cpu"), str(tmp_path))
    for field in ("decay_cursor", "route_dropped", "deferred_new"):
        leaf = getattr(restored, field)
        assert leaf.dtype == torch.int32, field
        assert int(leaf) == int(getattr(state, field)), field
    assert_same(convert.state_to_numpy(state), convert.state_to_numpy(restored))


def test_ckpt_rejects_kind_changing_cast(tmp_path):
    cfg = tmc.MCConfig(num_rows=8, capacity=4)
    float_state = tmc.map_leaves(lambda x: x.to(torch.float32) + 0.5,
                                 tmc.init(cfg, device="cpu"))
    ckpt.save(float_state, str(tmp_path), 0)
    with pytest.raises(ValueError, match="kind"):
        ckpt.restore(tmc.init(cfg, device="cpu"), str(tmp_path))


def _save_two_steps(tmp_path, cfg):
    state0 = tmc.init(cfg, device="cpu")
    src, dst = _distinct_count_batch()
    state1 = tmc.update_batch(state0, src, dst, cfg=cfg)
    snap_io.save_snapshot(state0, str(tmp_path), 0, {"wal_seq": -1})
    snap_io.save_snapshot(state1, str(tmp_path), 1, {"wal_seq": 0})
    return state0, state1


def _damage(step_dir, how):
    if how == "missing_npz":
        os.unlink(step_dir / "arrays.npz")
    elif how == "truncated_npz":
        data = (step_dir / "arrays.npz").read_bytes()
        (step_dir / "arrays.npz").write_bytes(data[: len(data) // 2])
    elif how == "torn_manifest":
        man = step_dir / "manifest.json"
        man.write_text(man.read_text()[:20])
    else:
        os.unlink(step_dir / "chain.json")


@pytest.mark.parametrize("how", ["missing_npz", "truncated_npz",
                                 "torn_manifest", "missing_sidecar"])
def test_latest_complete_step_skips_a_damaged_snapshot(tmp_path, how):
    cfg = tmc.MCConfig(num_rows=32, capacity=8)
    state0, _ = _save_two_steps(tmp_path, cfg)
    _damage(tmp_path / "step_00000001", how)
    assert snap_io.latest_complete_step(str(tmp_path)) == 0
    assert jsnap.latest_complete_step(str(tmp_path)) == 0
    restored, meta, step = snap_io.restore_snapshot(
        tmc.init(cfg, device="cpu"), str(tmp_path))
    assert step == 0 and meta["wal_seq"] == -1
    assert_same(convert.state_to_numpy(state0),
                convert.state_to_numpy(restored))
    with pytest.raises(FileNotFoundError):
        snap_io.restore_snapshot(tmc.init(cfg, device="cpu"), str(tmp_path),
                                 step=1)


def test_no_complete_snapshot_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        snap_io.restore_snapshot(
            tmc.init(tmc.MCConfig(num_rows=8, capacity=4), device="cpu"),
            str(tmp_path))
    assert snap_io.latest_complete_step(str(tmp_path / "none")) is None


def test_wal_roundtrip_and_rotation(tmp_path):
    wal = WriteAheadLog(str(tmp_path), segment_records=2, fsync="always")
    batches = []
    rng = np.random.default_rng(0)
    for i in range(5):
        src = rng.integers(0, 100, 16).astype(np.int32)
        dst = rng.integers(0, 100, 16).astype(np.int32)
        w = rng.integers(1, 5, 16).astype(np.int32)
        assert wal.append(src, dst, w) == i
        batches.append((src, dst, w))
    wal.close()
    assert len([n for n in os.listdir(tmp_path) if n.endswith(".seg")]) == 3
    wal2 = WriteAheadLog(str(tmp_path))
    assert wal2.next_seq == 5
    records = list(wal2.replay())
    assert [seq for seq, *_ in records] == list(range(5))
    for (seq, src, dst, w), (s0, d0, w0) in zip(records, batches):
        np.testing.assert_array_equal(src, s0)
        np.testing.assert_array_equal(dst, d0)
        np.testing.assert_array_equal(w, w0)
    assert len(list(wal2.replay(after_seq=2))) == 2
    with pytest.raises(ValueError):
        wal2.append([1, 2], [1])
    with pytest.raises(ValueError):
        WriteAheadLog(str(tmp_path), fsync="sometimes")


@pytest.mark.parametrize("damage", ["torn_tail", "corrupt_record"])
def test_wal_damaged_tail_stops_replay(tmp_path, damage):
    wal = WriteAheadLog(str(tmp_path), segment_records=100)
    for i in range(3):
        wal.append(np.full(8, i, np.int32), np.full(8, i, np.int32))
    wal.close()
    seg = os.path.join(str(tmp_path), sorted(os.listdir(tmp_path))[0])
    with open(seg, "r+b") as f:
        if damage == "torn_tail":       # crash mid-append: half a record
            f.truncate(os.path.getsize(seg) - 10)
        else:                           # payload bytes of record 2 flipped
            f.seek(-40, os.SEEK_END)
            f.write(b"\xff\xff\xff\xff")
    records = list(WriteAheadLog(str(tmp_path)).replay())
    assert [seq for seq, *_ in records] == [0, 1]


def test_wal_append_after_torn_tail_keeps_later_records(tmp_path):
    wal = WriteAheadLog(str(tmp_path), segment_records=100, fsync="always")
    for i in range(3):
        wal.append(np.full(8, i, np.int32), np.full(8, i, np.int32))
    wal.close()
    seg = os.path.join(str(tmp_path), sorted(os.listdir(tmp_path))[0])
    with open(seg, "r+b") as f:
        f.truncate(os.path.getsize(seg) - 10)
    wal2 = WriteAheadLog(str(tmp_path))
    assert wal2.next_seq == 2
    wal2.append(np.full(8, 7, np.int32), np.full(8, 7, np.int32))
    wal2.append(np.full(8, 9, np.int32), np.full(8, 9, np.int32))
    wal2.close()
    records = list(WriteAheadLog(str(tmp_path)).replay())
    assert [seq for seq, *_ in records] == [0, 1, 2, 3]
    np.testing.assert_array_equal(records[2][1], np.full(8, 7, np.int32))
    np.testing.assert_array_equal(records[3][1], np.full(8, 9, np.int32))


def test_wal_gap_between_segments_stops_replay(tmp_path):
    wal = WriteAheadLog(str(tmp_path), segment_records=2)
    for i in range(6):
        wal.append(np.full(4, i, np.int32), np.full(4, i, np.int32))
    wal.close()
    os.unlink(os.path.join(str(tmp_path), sorted(os.listdir(tmp_path))[1]))
    records = list(WriteAheadLog(str(tmp_path)).replay())
    assert [seq for seq, *_ in records] == [0, 1]


def test_wal_truncate_through_drops_closed_segments(tmp_path):
    wal = WriteAheadLog(str(tmp_path), segment_records=2)
    for i in range(6):
        wal.append(np.full(4, i, np.int32), np.full(4, i, np.int32))
    wal.close()
    removed = wal.truncate_through(3)
    assert removed == 2
    assert [seq for seq, *_ in WriteAheadLog(str(tmp_path)).replay()] == [4, 5]
    wal3 = WriteAheadLog(str(tmp_path / "empty"))
    wal3.resume_at(9)
    wal3.resume_at(4)                   # never rewinds
    assert wal3.next_seq == 9 and wal3.last_seq == 8


# ---------------------------------------------------------------------------
# crash recovery, unsharded: snapshot + replay through the owner calls
# ---------------------------------------------------------------------------

RECOVERY = dict(num_rows=64, capacity=8, sort_passes=1, max_new_per_batch=16,
                decay_block_rows=16)


def _recovery_batches():
    rng = np.random.default_rng(1)
    return [(rng.integers(0, 80, 64).astype(np.int32),   # overflows rows,
             rng.integers(0, 40, 64).astype(np.int32))   # decays, defers
            for _ in range(10)]


def _jax_recovered(tmp_path):
    """tests/test_persist.py:243-287 on the reference: its recovered state."""
    cfg = jmc.MCConfig(**RECOVERY)
    snap_dir, wal_dir = tmp_path / "jsnap", tmp_path / "jwal"
    wal = JWAL(str(wal_dir), segment_records=3, fsync="always")
    maybe_decay = jax.jit(lambda s: jmc.maybe_decay_impl(
        s, cfg=cfg, total_threshold=4))

    def cycle(state, src, dst):
        return maybe_decay(jmc.update_batch(state, jnp.asarray(src),
                                            jnp.asarray(dst), cfg=cfg))

    state = jmc.init(cfg)
    for seq, (src, dst) in enumerate(_recovery_batches()):
        wal.append(src, dst)
        state = cycle(state, src, dst)
        if seq == 4:
            jsnap.save_snapshot(state, str(snap_dir), seq + 1,
                                {"wal_seq": seq})
    wal.close()
    recovered, meta, _ = jsnap.restore_snapshot(jmc.init(cfg), str(snap_dir))
    for _, src, dst, _w in JWAL(str(wal_dir)).replay(after_seq=meta["wal_seq"]):
        recovered = cycle(recovered, src, dst)
    assert_same(jax_state_leaves(state), jax_state_leaves(recovered),
                "the reference's own recovery")
    return recovered


def test_unsharded_crash_recovery_bit_exact_and_equal_to_the_references(
        tmp_path):
    """Restore (newest complete snapshot) + WAL replay through the port's
    owner calls reproduces the uninterrupted port state — every leaf and
    ``counter_stats`` — and equals the reference's recovered state, all 18
    leaves, with ``deferred_new`` and ``decay_steps`` moving in the replayed
    span."""
    cfg = tmc.MCConfig(**RECOVERY)
    snap_dir, wal_dir = tmp_path / "snap", tmp_path / "wal"
    wal = WriteAheadLog(str(wal_dir), segment_records=3, fsync="always")

    def cycle(state, src, dst, w=None):
        tmc.update_batch_(state, src, dst, w, cfg=cfg)
        return tmc.maybe_decay_(state, cfg=cfg, total_threshold=4)

    state = tmc.init(cfg, device="cpu")
    for seq, (src, dst) in enumerate(_recovery_batches()):
        wal.append(src, dst)
        cycle(state, src, dst)
        if seq == 4:
            snap_io.save_snapshot(state, str(snap_dir), seq + 1,
                                  {"wal_seq": seq})
            at_snapshot = tmc.counter_stats(state)
    wal.close()
    expect = tmc.counter_stats(state)
    assert expect["deferred_new"] > at_snapshot["deferred_new"]
    assert expect["decay_steps"] > at_snapshot["decay_steps"]

    step = snap_io.latest_complete_step(str(snap_dir))
    recovered, meta, _ = snap_io.restore_snapshot(
        tmc.init(cfg, device="cpu"), str(snap_dir), step)
    replayed = 0
    for _, src, dst, w in WriteAheadLog(str(wal_dir)).replay(
            after_seq=meta["wal_seq"]):
        cycle(recovered, src, dst, w)
        replayed += 1
    assert replayed == 5
    assert_same(convert.state_to_numpy(state),
                convert.state_to_numpy(recovered), "uninterrupted vs recovered")
    assert tmc.counter_stats(recovered) == expect
    assert_same(jax_state_leaves(_jax_recovered(tmp_path)),
                convert.state_to_numpy(recovered),
                "the reference's recovered state vs the port's")


def test_async_snapshot_saves_the_state_as_it_was_when_it_returned(tmp_path):
    """``save_snapshot_async`` gathers before it returns: an owner update
    made at once (while the worker, held back by a failpoint, has not yet
    written) leaves the arrays on disk the pre-update state."""
    cfg = tmc.MCConfig(**CFG)
    state = _port(_jax_chain())
    want = convert.state_to_numpy(state)
    done, release = [], threading.Event()
    faults.arm("snapshot.io_thread", lambda ctx: release.wait(60))
    try:
        t = snap_io.save_snapshot_async(state, str(tmp_path), 1, {"wal_seq": 0},
                                        on_complete=lambda: done.append(1))
        src, dst = _distinct_count_batch(seed=5)
        tmc.update_batch_(state, src + 100, dst, cfg=cfg)
        tmc.decay_(state, cfg=cfg)
        assert not done            # the worker is still held back
        release.set()
        t.join(timeout=60)
        assert not t.is_alive()
    finally:
        faults.reset()
    assert done == [1]
    changed = convert.state_to_numpy(state)
    assert not np.array_equal(changed["slabs.cnt"], want["slabs.cnt"])
    restored, _, _ = snap_io.restore_snapshot(tmc.init(cfg, device="cpu"),
                                              str(tmp_path))
    assert_same(want, convert.state_to_numpy(restored), "the async snapshot")


# ---------------------------------------------------------------------------
# extract_edges, plan_batches, settle_order against the reference
# ---------------------------------------------------------------------------


def test_extract_edges_roundtrips_counts():
    cfg = tmc.MCConfig(num_rows=64, capacity=16, sort_passes=4)
    src, dst = _distinct_count_batch()
    state = tmc.update_batch(tmc.init(cfg, device="cpu"), src, dst, cfg=cfg)
    es, ed, ec = rs.extract_edges(state)
    assert es.size == 12 * 5 and es.dtype == np.int32
    got = {(int(s), int(d)): int(c) for s, d, c in zip(es, ed, ec)}
    for s in range(12):
        for d in range(5):
            assert got[(s, d)] == d + 1


@pytest.mark.parametrize("stacked", [False, True], ids=["chain", "stacked"])
def test_extract_edges_and_settle_order_equal_the_references(stacked):
    jstate = _jax_stacked() if stacked else _jax_chain()
    tstate = _port(jstate, stacked)
    for want, got in zip(jrs.extract_edges(jstate), rs.extract_edges(tstate)):
        assert want.dtype == got.dtype and np.array_equal(want, got)
    # a scrambled order, settled: the reference's stable descending sort
    perm = np.random.default_rng(4).permuted(
        np.broadcast_to(np.arange(CFG["capacity"], dtype=np.int32),
                        tstate.slabs.order.shape), axis=-1)
    jstate = jstate._replace(slabs=jstate.slabs._replace(order=perm))
    tstate.slabs.order.copy_(torch.from_numpy(perm))
    before = convert.state_to_numpy(tstate)
    settled = rs.settle_order(tstate)
    assert_same(before, convert.state_to_numpy(tstate), "settle_order's input")
    want = jax_state_leaves(jrs.settle_order(jstate))
    assert_same(want, convert.state_to_numpy(settled), "settle_order")
    order = tstate.slabs.order
    assert rs.settle_order_(tstate) is tstate
    assert tstate.slabs.order is order
    assert_same(want, convert.state_to_numpy(tstate), "settle_order_")


def test_settle_order_blocks_equal_one_sort(monkeypatch):
    """The settle sorts blocks of rows; a block that does not divide the
    rows gives the one-sort answer."""
    tstate = _port(_jax_stacked(), stacked=True)
    want = convert.state_to_numpy(rs.settle_order(tstate))
    monkeypatch.setattr(rs, "SETTLE_BLOCK_ROWS", 7)
    assert_same(want, convert.state_to_numpy(rs.settle_order(tstate)),
                "settle_order in blocks of 7 rows")


def _plan_inputs(n=1000, seed=2, num_shards=4):
    rng = np.random.default_rng(seed)
    src = (np.arange(n) // 40).astype(np.int32)
    dst = (np.arange(n) % 40).astype(np.int32)
    w = rng.integers(1, 9, n).astype(np.int32)
    owner = rng.integers(0, num_shards, n).astype(np.int32)
    owner[:600] = 0                                          # heavy skew
    return src, dst, w, owner


@pytest.mark.parametrize("shape", [(4, 32, 8), (4, 32, 32), (2, 7, 3),
                                   (8, 16, 2), (1, 50, 50)])
def test_plan_batches_yields_the_references_batches(shape):
    """Every yielded batch equal to the reference's, on a skewed owner (and
    an owner value no shard has, which neither plans)."""
    num_shards, slice_len, cap = shape
    src, dst, w, owner = _plan_inputs(num_shards=num_shards)
    owner[-5:] = num_shards
    want = list(jrs.plan_batches(src, dst, w, owner, num_shards, slice_len, cap))
    got = list(rs.plan_batches(src, dst, w, owner, num_shards, slice_len, cap))
    assert len(got) == len(want) > 1
    for i, (a, b) in enumerate(zip(want, got)):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y), i


def test_plan_batches_respects_slice_and_bucket_caps():
    src, dst, w, owner = _plan_inputs()
    num_shards, slice_len, cap = 4, 32, 8
    seen = np.zeros(src.size, bool)
    key = {(int(s), int(d)): i for i, (s, d) in enumerate(zip(src, dst))}
    for bsrc, bdst, bw in rs.plan_batches(src, dst, w, owner, num_shards,
                                          slice_len, cap):
        assert bsrc.size == num_shards * slice_len
        s2, d2 = (bsrc.reshape(num_shards, slice_len),
                  bdst.reshape(num_shards, slice_len))
        for s in range(num_shards):
            live = s2[s] >= 0
            d_of = owner[[key[(int(x), int(y))]
                          for x, y in zip(s2[s][live], d2[s][live])]]
            for dshard in range(num_shards):
                assert np.sum(np.asarray(d_of) == dshard) <= cap
        for x, y, z in zip(bsrc, bdst, bw):
            if x >= 0:
                i = key[(int(x), int(y))]
                assert not seen[i] and z == w[i]
                seen[i] = True
    assert seen.all()


def test_unsharded_reingest_into_one_shard_conserves_counts():
    """extract -> plan -> ingest (the sharded update with the new-edge
    bound lifted) -> settle at S = 1: every edge and count conserved, tot
    unchanged, no inversion left."""
    cfg = tmc.MCConfig(**CFG)
    old = _port(_jax_chain())
    src, dst, cnt = rs.extract_edges(old)
    scfg = tsh.ShardedConfig(base=cfg, num_shards=1)
    ingest = dataclasses.replace(scfg, base=dataclasses.replace(
        cfg, max_new_per_batch=0))
    new = tsh.init_sharded(scfg, device="cpu")
    owner = scfg.resolved_ownership().owner_of(torch.from_numpy(src)).numpy()
    batches = 0
    for b in rs.plan_batches(src, dst, cnt, owner, 1, 16,
                             scfg.bucket_capacity(16)):
        tsh.update_(new, *b, scfg=ingest)
        batches += 1
    assert batches == -(-src.size // 16)
    rs.settle_order_(new)
    stats = tmc.counter_stats(new)
    assert stats["route_dropped"] == stats["deferred_new"] == 0
    assert stats["dropped_probes"] == stats["dropped_rows"] == 0
    assert sorted(zip(*rs.extract_edges(new))) == sorted(zip(src, dst, cnt))
    one = tsh.shard_state(new, 0)
    assert int(tsl.inversions(one.slabs.cnt, one.slabs.order).sum()) == 0
    inv = tmc.check_invariants(one, cfg)
    assert all(v for k, v in inv.items() if k != "sorted_fraction"), inv
