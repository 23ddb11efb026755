"""The port's EpochStore: RCU semantics, and the property the store rests on
in torch — a reader's acquired state stays bit-equal while the learner
builds and publishes the next versions from it."""

import threading

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import mcprioq as tmc
from repro_torch.core import speculative as tspec
from repro_torch.core.epoch import EpochStore
from repro_torch.data.synthetic import token_stream


def test_epoch_store_rcu_semantics():
    store = EpochStore({"v": 0})
    s0 = store.acquire()
    store.publish({"v": 1})
    s1 = store.acquire()
    assert s0.state["v"] == 0 and s1.state["v"] == 1  # old reader unaffected
    store.release(s0)
    store.release(s1)
    store.synchronize()
    assert 0 in store.retired_versions  # grace period elapsed -> reclaimed
    assert store.version == 1


def test_acquired_state_stays_bit_equal_while_the_learner_publishes():
    cfg = tspec.NGramConfig(order=2, decay_threshold=8, mc=tmc.MCConfig(
        num_rows=32, capacity=4, sort_passes=1, decay_block_rows=8,
        max_new_per_batch=16, max_probes=16))
    store = EpochStore(tspec.init(cfg, device="cpu"))
    stream = token_stream(6, 4, 12, seed=2)
    held = []
    for _ in range(12):
        # a reader pins the current version ...
        snap = store.acquire()
        held.append((snap, convert.state_to_numpy(snap.state.chain)))
        # ... and the learner builds the next one from the same tensors
        learner = store.acquire()
        nxt = tspec.observe(learner.state, next(stream)["tokens"], cfg=cfg)
        nxt = tspec.maintain(nxt, cfg=cfg)
        store.publish(nxt)
        store.release(learner)
    assert tmc.maintenance_stats(store.acquire().state.chain)["decay_steps"] > 0
    for snap, leaves in held:
        now = convert.state_to_numpy(snap.state.chain)
        for name, value in leaves.items():
            assert np.array_equal(now[name], value), (snap.version, name)
        store.release(snap)
    assert store.version == 12


def test_concurrent_readers_and_a_publishing_learner():
    store = EpochStore(torch.zeros(4, dtype=torch.int32))
    stop = threading.Event()
    seen = []

    def reader():
        while not stop.is_set():
            snap = store.acquire()
            # a published tensor is never written: it holds its version
            seen.append(bool((snap.state == snap.version).all()))
            store.release(snap)

    threads = [threading.Thread(target=reader) for _ in range(8)]
    for t in threads:
        t.start()
    try:
        for v in range(1, 200):
            store.publish(torch.full((4,), v, dtype=torch.int32))
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    store.synchronize()
    assert seen and all(seen)
    assert store.version == 199
    # a reader that read the reference just before a publish registers after
    # the retirement and retires the version again on release: as a set
    assert set(store.retired_versions) == set(range(199))
