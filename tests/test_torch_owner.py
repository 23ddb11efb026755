"""The write path without functional copies, on the CPU.

The owner calls (``update_batch_``, ``decay_``, ``maybe_decay_``) write into
the state they are given: their stream equals the JAX package's functional
stream leaf by leaf after every call, with no clone and no host read in
them and every leaf kept in its own storage.  Each plain in-place kernel
form leaves every row it does not flag bit-equal.  The back-buffer learner
publishes the functional learner's states while a reader's snapshot never
changes; ``EpochStore.acquire`` cannot pin a retired version; and a
configuration the CUDA kernels refuse is refused when the state is built.
"""

import contextlib
import dataclasses
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import mcprioq as jmc
from repro_torch import convert
from repro_torch.core import mcprioq as tmc
from repro_torch.core import speculative as tspec
from repro_torch.core.epoch import BackBufferLearner, EpochStore
from repro_torch.data.synthetic import token_stream
from repro_torch.kernels import ref

from torch_parity import assert_same, chain_stream, opt

_jax_maybe_decay = jax.jit(jmc.maybe_decay,
                           static_argnames=("cfg", "total_threshold"))
_GUARDED = ("clone", "__bool__", "item", "__int__", "__index__", "tolist")


@contextlib.contextmanager
def no_clone_or_host_read(monkeypatch):
    """While the yielded ``armed`` flag holds, ``Tensor.clone`` and every
    host read of a tensor raise.  The sequential plain new-edge pass reads
    its items on the host by nature (on the card it is a kernel), so it
    runs disarmed."""
    armed = [False]

    def guard(name):
        original = getattr(torch.Tensor, name)

        def guarded(self, *args, **kwargs):
            if armed[0]:
                raise AssertionError(f"Tensor.{name} inside an owner call")
            return original(self, *args, **kwargs)
        return guarded

    def disarmed(fn):
        def call(*args, **kwargs):
            was, armed[0] = armed[0], False
            try:
                return fn(*args, **kwargs)
            finally:
                armed[0] = was
        return call

    with monkeypatch.context() as m:
        for name in _GUARDED:
            m.setattr(torch.Tensor, name, guard(name))
        m.setattr(ref, "slow_path_ref_", disarmed(ref.slow_path_ref_))
        yield armed


def _leaves(state):
    return (*state.src_table, *state.slabs, state.dh_keys, state.dh_vals,
            *(getattr(state, f) for f in tmc.SCALAR_FIELDS))


def test_owner_stream_equals_jax_with_no_clone_and_no_host_read(monkeypatch):
    """30 batches through ``update_batch_``, ``maybe_decay_`` (firing on
    some calls and not on others) and, every fifth batch, ``decay_`` —
    rolling, the block not dividing the table — against the reference's
    ``update_batch``, ``maybe_decay`` and ``decay``; every leaf equal after
    every call, every leaf in the storage it started in."""
    kw = dict(num_rows=48, capacity=5, max_probes=16, max_new_per_batch=16,
              sort_passes=1, decay_block_rows=20, impl="ref")
    jcfg, tcfg = jmc.MCConfig(**kw), tmc.MCConfig(**kw)
    jstate, tstate = jmc.init(jcfg), tmc.init(tcfg, device="cpu")
    ptrs = [x.data_ptr() for x in _leaves(tstate)]
    threshold = 10
    fired = {True: 0, False: 0}
    with no_clone_or_host_read(monkeypatch) as armed:
        for i, (src, dst, weights, mask) in enumerate(
                chain_stream(seed=21, n_batches=30)):
            jstate = jmc.update_batch(
                jstate, jnp.asarray(src), jnp.asarray(dst),
                opt(weights, jnp.asarray), opt(mask, jnp.asarray), cfg=jcfg)
            armed[0] = True
            out = tmc.update_batch_(tstate, src, dst, weights, mask, cfg=tcfg)
            armed[0] = False
            assert out is tstate
            assert_same(jstate, tstate, f"update_batch_ {i}")

            steps = int(jstate.decay_steps)
            jstate = _jax_maybe_decay(jstate, cfg=jcfg, total_threshold=threshold)
            fired[int(jstate.decay_steps) > steps] += 1
            armed[0] = True
            out = tmc.maybe_decay_(tstate, cfg=tcfg, total_threshold=threshold)
            armed[0] = False
            assert out is tstate
            assert_same(jstate, tstate, f"maybe_decay_ {i}")

            if i % 5 == 4:
                jstate = jmc.decay(jstate, cfg=jcfg)
                armed[0] = True
                out = tmc.decay_(tstate, cfg=tcfg)
                armed[0] = False
                assert out is tstate
                assert_same(jstate, tstate, f"decay_ {i}")
            assert [x.data_ptr() for x in _leaves(tstate)] == ptrs, i
    assert fired[True] and fired[False], fired
    stats = tmc.counter_stats(tstate)
    assert stats["evictions"] and stats["deferred_new"] and stats["dropped_rows"], sorted(stats.items())


def test_owner_call_refuses_a_state_whose_counters_are_not_one_tensor():
    cfg = tmc.MCConfig(num_rows=8, capacity=4, impl="ref")
    state = tmc.init(cfg, device="cpu")
    loose = state._replace(n_rows=state.n_rows.clone())
    with pytest.raises(ValueError, match="not consecutive elements"):
        tmc.update_batch_(loose, [1, 2], [3, 4], cfg=cfg)
    # a functional write's result is packed again, so the owner may go on
    tmc.update_batch_(tmc.update_batch(state, [1], [2], cfg=cfg), [1], [3],
                      cfg=cfg)


# ---------------------------------------------------------------------------
# the plain in-place forms: every row they do not flag is left as it was
# ---------------------------------------------------------------------------

N, C = 23, 7


def _slabs(rng):
    cnt = (rng.integers(1, 40, (N, C)) * (rng.random((N, C)) < 0.7)).astype(np.int32)
    dst = np.where(cnt > 0, rng.integers(0, 30, (N, C)), -1).astype(np.int32)
    order = np.stack([rng.permutation(C) for _ in range(N)]).astype(np.int32)
    order[: N // 2] = np.argsort(-cnt[: N // 2], axis=1, kind="stable")
    return {"cnt": torch.from_numpy(cnt), "dst": torch.from_numpy(dst),
            "order": torch.from_numpy(order),
            "tot": torch.from_numpy(cnt.sum(axis=1).astype(np.int32))}


def _table(rng, n_keys):
    from repro_torch.core import hashtable as tht
    table = tht.make(64, device="cpu")
    keys = torch.from_numpy(rng.permutation(200)[:n_keys].astype(np.int32))
    table, _, _ = tht.insert_batch_sequential(
        table, keys, torch.arange(n_keys), torch.ones(n_keys, dtype=torch.bool), 8)
    return table, keys


def _in_place_cases():
    """``(name, case)``: ``case(s, rng, dirty)`` runs an in-place form on the
    slabs ``s`` (and a table of its own) with ``dirty`` and returns
    ``(what the functional form gives, what the in-place form wrote)``."""
    def slab_update(s, rng, dirty):
        rows = torch.from_numpy(rng.integers(-1, N, 40).astype(np.int32))
        pick = rng.integers(0, C, 40)
        dsts = s["dst"][rows.clamp(min=0).long(), pick]
        dsts[::7] = 999
        w = torch.from_numpy(rng.integers(1, 5, 40).astype(np.int32))
        want = ref.slab_update_ref(rows, dsts, w, s["dst"], s["cnt"], s["tot"])[1:3]
        ref.slab_update_ref_(rows, dsts, w, s["dst"], s["cnt"], s["tot"], dirty)
        return want, (s["cnt"], s["tot"])

    def oddeven(passes):
        def run(s, rng, dirty):
            want = ref.oddeven_sort_ref(s["cnt"], s["order"], passes)
            ref.oddeven_sort_ref_(s["cnt"], s["order"], passes, dirty)
            return want, s["order"]
        return run

    def decay(fire):
        def run(s, rng, dirty):
            want = ref.decay_sort_ref(s["cnt"], s["dst"], s["order"])
            if fire is False:
                want = (s["cnt"].clone(), s["dst"].clone(), s["order"].clone(),
                        s["tot"].clone())
            ref.decay_sort_ref_(s["cnt"], s["dst"], s["order"], s["tot"],
                                None if fire is None else torch.tensor(fire),
                                dirty)
            return want, (s["cnt"], s["dst"], s["order"], s["tot"])
        return run

    def rolling(cursor, block_rows, fire):
        def run(s, rng, dirty):
            cur = torch.tensor(cursor, dtype=torch.int32)
            want = ref.decay_sort_rolling_ref(s["cnt"], s["dst"], s["order"],
                                              s["tot"], cur, block_rows)
            if fire is False:
                want = tuple(x.clone() for x in (s["cnt"], s["dst"], s["order"],
                                                 s["tot"], cur))
            ref.decay_sort_rolling_ref_(
                s["cnt"], s["dst"], s["order"], s["tot"], cur, block_rows,
                None if fire is None else torch.tensor(fire), dirty)
            return want, (s["cnt"], s["dst"], s["order"], s["tot"], cur)
        return run

    def slow_path(fn, fn_):
        def run(s, rng, dirty):
            table, keys = _table(rng, 12)
            items = (torch.from_numpy(np.concatenate(
                [keys.numpy()[rng.integers(0, 12, 30)],
                 rng.integers(300, 330, 10)]).astype(np.int32)),
                torch.from_numpy(rng.integers(0, 35, 40).astype(np.int32)),
                torch.from_numpy(rng.integers(1, 4, 40).astype(np.int32)),
                torch.from_numpy(rng.random(40) < 0.8))
            counters = torch.tensor([12, 0, 0, 0], dtype=torch.int32)
            args = (table.keys, table.vals, s["dst"], s["cnt"], s["tot"],
                    s["order"], counters)
            want = fn(*args, *items, 8)
            fn_(*args, *items, 8, dirty)
            return want, args[:5] + (counters,)
        return run

    return [
        ("slab_update", slab_update),
        *((f"oddeven passes={p}", oddeven(p)) for p in (1, 2, C // 2 + 1)),
        *((f"decay_sort fire={f}", decay(f)) for f in (None, True, False)),
        *((f"decay_sort_rolling cursor={c} r={r} fire={f}", rolling(c, r, f))
          for c, r, f in ((0, 10, None), (2, 10, None), (5, 10, True),
                          (-1, 4, None), (1, 10, False), (0, N, None))),
        ("slow_path", slow_path(ref.slow_path_ref, ref.slow_path_ref_)),
        ("slow_path_rows", slow_path(ref.slow_path_rows_ref,
                                     ref.slow_path_rows_ref_)),
    ]


@pytest.mark.parametrize("name,case", _in_place_cases(),
                         ids=[c[0] for c in _in_place_cases()])
def test_in_place_form_leaves_every_unflagged_row_bit_equal(name, case):
    rng = np.random.default_rng(len(name))
    s = _slabs(rng)
    before = {k: v.clone() for k, v in s.items()}
    dirty = torch.zeros(N, dtype=torch.uint8)
    dirty[3] = 1                                   # a flag set before stays
    want, got = case(s, rng, dirty)
    assert_same(want, got, name)
    flagged = dirty.bool()
    changed = (s["tot"] != before["tot"])
    for k in ("cnt", "dst", "order"):
        changed |= (s[k] != before[k]).any(dim=1)
    assert flagged[3]
    assert not (changed & ~flagged).any(), (name, torch.nonzero(changed & ~flagged))
    if "fire=False" in name:
        assert not changed.any() and flagged.sum() == 1


def test_copy_dirty_rows_catches_the_back_up_and_clears_the_flags():
    rng = np.random.default_rng(4)
    front, back = _slabs(rng), _slabs(rng)
    f_table, _ = _table(rng, 10)
    b_table, _ = _table(rng, 5)
    f_sc, b_sc = torch.arange(10, dtype=torch.int32), torch.zeros(10, dtype=torch.int32)
    dirty = torch.from_numpy((rng.random(N) < 0.4).astype(np.uint8))
    flagged = dirty.bool().clone()
    keep = {k: v.clone() for k, v in back.items()}
    kept_table = [x.clone() for x in b_table]
    # the 64-slot tables: two groups of 32 slots, the second flagged
    table_dirty = torch.tensor([0, 1], dtype=torch.uint8)
    order = ("cnt", "dst", "order", "tot")
    ref.copy_dirty_rows_ref(*(front[k] for k in order), *f_table, f_sc,
                            *(back[k] for k in order), *b_table, b_sc, dirty,
                            table_dirty)
    for k in order:
        assert torch.equal(back[k][flagged], front[k][flagged]), k
        assert torch.equal(back[k][~flagged], keep[k][~flagged]), k
    for f, b, k in zip(f_table, b_table, kept_table):
        assert torch.equal(b[32:], f[32:]) and torch.equal(b[:32], k[:32])
    assert torch.equal(b_sc, f_sc) and not dirty.any() and not table_dirty.any()


# ---------------------------------------------------------------------------
# the back-buffer learner
# ---------------------------------------------------------------------------

NCFG = tspec.NGramConfig(order=2, decay_threshold=12, mc=tmc.MCConfig(
    num_rows=32, capacity=4, sort_passes=1, decay_block_rows=7,
    max_new_per_batch=16, max_probes=16))


def _learn(state, tokens, dirty, table_dirty):
    return tspec.maintain_(tspec.observe_(state, tokens, cfg=NCFG, dirty=dirty,
                                          table_dirty=table_dirty),
                           cfg=NCFG, dirty=dirty)


def test_back_buffer_learner_publishes_the_functional_learners_states():
    store = EpochStore(tspec.init(NCFG, device="cpu"))
    learner = BackBufferLearner(store)
    functional = tspec.init(NCFG, device="cpu")
    stream = token_stream(6, 4, 12, seed=3)
    for i in range(16):
        tokens = next(stream)["tokens"]
        functional = tspec.maintain(tspec.observe(functional, tokens, cfg=NCFG),
                                    cfg=NCFG)
        snap = learner.acquire()
        held = convert.state_to_numpy(snap.state.chain)
        published = learner.write(_learn, tokens)
        assert store.version == i + 1
        assert_same(functional.chain, published.chain, f"write {i}")
        now = convert.state_to_numpy(snap.state.chain)
        for name, value in held.items():
            assert np.array_equal(now[name], value), (i, name)
        store.release(snap)
    assert tmc.maintenance_stats(functional.chain)["decay_steps"] > 0
    assert tmc.counter_stats(functional.chain)["evictions"] > 0


def test_acquired_snapshot_stays_bit_equal_while_the_learner_writes_twice_more():
    """The first write goes into the back buffer; the second needs the
    version the reader holds, and waits for its release (RCU's grace
    period) — it neither writes into the snapshot nor publishes before."""
    store = EpochStore(tspec.init(NCFG, device="cpu"))
    learner = BackBufferLearner(store)
    stream = token_stream(6, 4, 12, seed=5)
    for _ in range(3):
        learner.write(_learn, next(stream)["tokens"])
    snap = learner.acquire()
    held = convert.state_to_numpy(snap.state.chain)

    def unchanged():
        now = convert.state_to_numpy(snap.state.chain)
        return all(np.array_equal(now[k], v) for k, v in held.items())

    learner.write(_learn, next(stream)["tokens"])
    assert unchanged() and store.version == snap.version + 1
    second = threading.Thread(target=learner.write, daemon=True,
                              args=(_learn, next(stream)["tokens"]))
    second.start()
    try:
        second.join(timeout=0.5)
        assert second.is_alive() and store.version == snap.version + 1
        assert unchanged()
    finally:
        store.release(snap)
    second.join(timeout=30)
    assert not second.is_alive() and store.version == snap.version + 2


# ---------------------------------------------------------------------------
# EpochStore.acquire and a publish that retires the version being read
# ---------------------------------------------------------------------------


class _HookedLock:
    """A lock that runs ``hook`` once, just before it is first taken: a
    deterministic interleaving point inside ``acquire``."""

    def __init__(self, hook):
        self._lock, self._hook = threading.Lock(), hook

    def __enter__(self):
        hook, self._hook = self._hook, None
        if hook is not None:
            hook()
        return self._lock.__enter__()

    def __exit__(self, *exc):
        return self._lock.__exit__(*exc)


def _acquire_reading_before_the_lock(store):
    """``acquire`` as it was: the snapshot read, then the lock taken."""
    snap = store._snap
    with store._lock:
        store._readers[snap.version] = store._readers.get(snap.version, 0) + 1
    return snap


@pytest.mark.parametrize("fixed", [False, True])
def test_a_publish_between_reading_and_registering_retires_nothing_twice(fixed):
    store = EpochStore("v0")
    hooked = _HookedLock(None)
    store._lock = hooked
    hooked._hook = lambda: store.publish("v1")     # lands inside acquire
    snap = store.acquire() if fixed else _acquire_reading_before_the_lock(store)
    store.release(snap)
    if fixed:
        assert snap.version == 1 and store.retired_versions == [0]
    else:
        # the reader pinned version 0 after the publish had retired it, and
        # its release retires it a second time
        assert snap.version == 0 and store.retired_versions == [0, 0]


# ---------------------------------------------------------------------------
# configurations the CUDA kernels cannot run are refused up front
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("capacity,impl,device,refused", [
    (1200, "auto", "cuda", True), (1025, "cuda", "cuda", True),
    (1024, "auto", "cuda", False), (1200, "ref", "cuda", False),
    (1200, "auto", "cpu", False)])
def test_chain_wider_than_the_decay_kernel_is_refused_on_cuda(capacity, impl,
                                                              device, refused):
    cfg = tmc.MCConfig(num_rows=8, capacity=capacity, impl=impl)
    check = contextlib.nullcontext() if not refused else pytest.raises(
        ValueError, match=r"capacity \d+ is above 1024, .*decay kernel")
    with check:
        tmc.check_cuda_limits(cfg, torch.device(device))
    with check:
        tspec.check_cuda_limits(dataclasses.replace(NCFG, mc=cfg),
                                torch.device(device))


@pytest.mark.parametrize("order,refused", [(16, False), (17, True)])
def test_drafter_context_longer_than_the_walk_is_refused_on_cuda(order, refused):
    cfg = dataclasses.replace(NCFG, order=order)
    check = contextlib.nullcontext() if not refused else pytest.raises(
        ValueError, match="order 17 is above 16, .*draft walk")
    with check:
        tspec.check_cuda_limits(cfg, torch.device("cuda"))
    tspec.check_cuda_limits(cfg, torch.device("cpu"))
    tspec.init(cfg, device="cpu")
