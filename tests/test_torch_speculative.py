"""The drafter slice of the port: repro_torch.core.speculative against
repro.core.speculative on the CPU.  The same numpy token streams go through
both; every int32 leaf of the chain and every draft is equal after every
batch (tolerance zero).  The port's draft runs its plain walk here
(``kernels.ref.draft_walk_ref``); the JAX side runs its oracle
(``impl='ref'``) and its Pallas walk kernel in interpret mode."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import mcprioq as jmc
from repro.core import speculative as jspec
from repro.data.synthetic import token_stream as jax_token_stream
from repro_torch import convert
from repro_torch.core import mcprioq as tmc
from repro_torch.core import speculative as tspec
from repro_torch.data.synthetic import token_stream

from torch_parity import assert_same, jax_state_leaves

# rows and slots run out, the new-edge prefix overflows, and the rolling
# decay fires several times over a 30-batch stream
_MC = dict(num_rows=64, capacity=8, sort_passes=1, decay_block_rows=16,
           max_new_per_batch=24, max_probes=16, impl="ref")


def _configs(order=2, decay_threshold=30, **mc_kw):
    kw = dict(_MC, **mc_kw)
    return (jspec.NGramConfig(order=order, mc=jmc.MCConfig(**kw),
                              decay_threshold=decay_threshold),
            tspec.NGramConfig(order=order, mc=tmc.MCConfig(**kw),
                              decay_threshold=decay_threshold))


def _learned(jcfg, tcfg, batches, vocab=40, seed=1):
    """Both drafters after ``batches`` observe + maintain steps, states held
    equal after every step; returns (jax state, port state, last tokens)."""
    js, ts = jspec.init(jcfg), tspec.init(tcfg, device="cpu")
    stream = token_stream(vocab, 4, 16, seed=seed)
    for i in range(batches):
        toks = next(stream)["tokens"]
        js = jspec.observe(js, jnp.asarray(toks), cfg=jcfg)
        ts = tspec.observe(ts, torch.from_numpy(toks), cfg=tcfg)
        assert_same(js, ts, f"batch {i} observe")
        js = jspec.maintain(js, cfg=jcfg)
        ts = tspec.maintain(ts, cfg=tcfg)
        assert_same(js, ts, f"batch {i} maintain")
    return js, ts, toks


def test_token_stream_is_the_references_stream():
    for a, b, _ in zip(jax_token_stream(50, 3, 9, seed=4),
                       token_stream(50, 3, 9, seed=4), range(3)):
        assert_same(a, b, "token_stream")


@pytest.mark.parametrize("order", [1, 2, 3])
def test_context_ids(order):
    rng = np.random.default_rng(order)
    toks = rng.integers(-2**31, 2**31, (3, 11), dtype=np.int64).astype(np.int32)
    toks[0, :6] = [0, -1, 2**31 - 1, -2**31, 152063, -5]
    assert_same(jspec.context_ids(jnp.asarray(toks), order),
                tspec.context_ids(torch.from_numpy(toks), order),
                f"context_ids order={order}")


def test_observe_maintain_stream_state_equal_after_every_batch():
    jcfg, tcfg = _configs(decay_threshold=12)
    js, ts, _ = _learned(jcfg, tcfg, batches=32, vocab=10)
    stats = tmc.counter_stats(ts.chain)
    assert stats == jmc.counter_stats(js.chain)
    assert stats["decay_steps"] > 0, "the rolling decay never fired"
    assert stats["evictions"] > 0 and stats["dropped_rows"] > 0
    assert stats["deferred_new"] > 0


@pytest.mark.parametrize("k", [1, 4])
def test_draft_equals_jax_ref_and_pallas_and_draft_reference(k):
    jcfg, tcfg = _configs(decay_threshold=1 << 18)
    js, ts, toks = _learned(jcfg, tcfg, batches=6)
    # learned contexts, some followed by a dead end, and unknown contexts
    ctx = np.concatenate([toks[:, 3:7], toks[:, 9:13],
                          np.full((2, 4), 31337, np.int32)]).astype(np.int32)
    got = tspec.draft(ts, torch.from_numpy(ctx), cfg=tcfg, k=k)
    for impl in ("ref", "pallas"):
        jc = dataclasses.replace(jcfg, mc=dataclasses.replace(jcfg.mc, impl=impl))
        assert_same(jspec.draft(js, jnp.asarray(ctx), cfg=jc, k=k), got,
                    f"draft k={k} jax {impl}")
    assert_same(got, tspec.draft_reference(ts, torch.from_numpy(ctx), cfg=tcfg, k=k),
                f"draft_reference k={k}")
    toks_k, ok = got
    assert ok.dtype == torch.bool and ok[:8, 0].any()
    assert not ok[-2:].any() and not toks_k[-2:].any()


def test_draft_dead_lane_emits_zeros_after_failure():
    jcfg, tcfg = _configs()
    seq = np.asarray([[1, 2, 3]], np.int32)
    js = jspec.observe(jspec.init(jcfg), jnp.asarray(seq), cfg=jcfg)
    ts = tspec.observe(tspec.init(tcfg, device="cpu"), torch.from_numpy(seq), cfg=tcfg)
    assert_same(js, ts, "observe")
    ctx = np.asarray([[1, 2]], np.int32)
    want = jspec.draft(js, jnp.asarray(ctx), cfg=jcfg, k=4)
    draft, ok = tspec.draft(ts, torch.from_numpy(ctx), cfg=tcfg, k=4)
    assert_same(want, (draft, ok), "dead lane")
    assert draft[0, 0] == 3 and ok[0, 0]
    assert not ok[0, 1:].any() and not draft[0, 1:].any()


def test_periodic_sequence_drafts_and_candidates():
    jcfg, tcfg = _configs(num_rows=512, capacity=16, sort_passes=2,
                          decay_block_rows=0, max_new_per_batch=0)
    seq = np.tile(np.arange(10), 30)[None].astype(np.int32)
    js = jspec.observe(jspec.init(jcfg), jnp.asarray(seq), cfg=jcfg)
    ts = tspec.observe(tspec.init(tcfg, device="cpu"), torch.from_numpy(seq), cfg=tcfg)
    ctx = np.asarray([[3, 4]], np.int32)
    draft, ok = tspec.draft(ts, torch.from_numpy(ctx), cfg=tcfg, k=4)
    assert_same(jspec.draft(js, jnp.asarray(ctx), cfg=jcfg, k=4), (draft, ok), "draft")
    assert ok.all() and draft[0].tolist() == [5, 6, 7, 8]
    dsts, probs, n = tspec.candidates(ts, torch.from_numpy(ctx), 0.9, cfg=tcfg,
                                      max_items=4)
    assert_same(jspec.candidates(js, jnp.asarray(ctx), 0.9, cfg=jcfg, max_items=4),
                (dsts, probs, n), "candidates")
    assert int(n[0]) == 1 and int(dsts[0, 0]) == 5


def test_chain_learned_in_jax_drafts_the_same_in_the_port():
    jcfg, tcfg = _configs(decay_threshold=1 << 18)
    js = jspec.init(jcfg)
    stream = jax_token_stream(40, 4, 16, seed=9)
    for _ in range(5):
        js = jspec.observe(js, jnp.asarray(next(stream)["tokens"]), cfg=jcfg)
    chain = convert.state_from_numpy(jax_state_leaves(js.chain), tcfg.mc, "cpu")
    ts = tspec.DrafterState(chain=chain)
    ctx = next(stream)["tokens"][:, :5]
    want = jspec.draft(js, jnp.asarray(ctx), cfg=jcfg, k=4)
    assert_same(want, tspec.draft(ts, torch.from_numpy(ctx), cfg=tcfg, k=4), "draft")
    assert_same(jspec.candidates(js, jnp.asarray(ctx), 0.8, cfg=jcfg, max_items=6),
                tspec.candidates(ts, torch.from_numpy(ctx), 0.8, cfg=tcfg, max_items=6),
                "candidates")


@pytest.mark.parametrize("threshold,max_items", [(0.5, 3), (0.9, 8), (1.0, 12)])
def test_candidates_equal(threshold, max_items):
    jcfg, tcfg = _configs(decay_threshold=1 << 18)
    js, ts, toks = _learned(jcfg, tcfg, batches=4, seed=3)
    ctx = np.concatenate([toks[:, :3], np.full((1, 3), 777, np.int32)])
    assert_same(jspec.candidates(js, jnp.asarray(ctx), threshold, cfg=jcfg,
                                 max_items=max_items),
                tspec.candidates(ts, torch.from_numpy(ctx), threshold, cfg=tcfg,
                                 max_items=max_items), "candidates")


@pytest.mark.parametrize("b,k", [(1, 1), (9, 4), (37, 8), (1424, 4), (2058, 3)])
def test_acceptance_rate(b, k):
    # a float32 mean: the port sums in XLA's order (windows of 32, two
    # levels from b = 1,025 on), so the bits are equal, not just close
    rng = np.random.default_rng(b)
    draft = rng.integers(0, 5, (b, k)).astype(np.int32)
    target = rng.integers(0, 5, (b, k)).astype(np.int32)
    ok = rng.random((b, k)) < 0.8
    want = np.asarray(jspec.acceptance_rate(
        jnp.asarray(draft), jnp.asarray(target), jnp.asarray(ok)))
    got = tspec.acceptance_rate(torch.from_numpy(draft),
                                torch.from_numpy(target), torch.from_numpy(ok))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.numpy().tobytes() == want.tobytes()


def test_init_without_a_cuda_device_raises():
    assert not torch.cuda.is_available(), "this test describes a machine without a GPU"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tspec.init(tspec.NGramConfig())
    st = tspec.init(tspec.NGramConfig(mc=tmc.MCConfig(num_rows=8, capacity=4)),
                    device="cpu")
    assert st.chain.slabs.cnt.device.type == "cpu"
