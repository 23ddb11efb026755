"""The port's LM serving engine (``serve.engine.Engine``), its sampling and
its launcher, on the CPU.

  * the port's ``Engine`` against the reference's at
    ``smoke_config("qwen2-7b")``, float32, prompt (2, 12), 16 new tokens,
    ``draft_len`` 4, on the reference's parameters: identical tokens, equal
    ``stats`` and the drafter's 18 int32 leaves bit for bit, over requests
    that take drafts whole, in part (a taught history makes the third
    drafted token wrong, so a round re-extends from its kept caches) and
    not at all; the same for ``deepseek-moe-16b``, ``mamba2-130m`` and
    ``recurrentgemma-9b`` at 8 + 8 tokens;
  * for those three at bfloat16: speculative tokens == plain greedy's over
    whole, partial and no acceptance, recurrentgemma's ring wrapping;
  * the port's counterparts of ``test_system.py::
    test_speculative_serving_is_lossless_greedy``, ``test_maintenance.py::
    test_engine_learn_conserves_transitions_under_threads`` and
    ``test_faults.py::test_engine_learn_failpoint_cuts_before_publish``;
  * a model never writes the caches it is given (the engine's rollback);
  * ``sampling``: ``greedy`` is ``jnp.argmax`` (ties to the first index),
    ``top_p`` keeps the reference's set, the draws come from a generator;
  * the launcher's LM branch with ``--smoke --device cpu``.
"""

import dataclasses
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import smoke_config as r_smoke_config
from repro.models import Model as RModel
from repro.serve import sampling as r_sampling
from repro.serve.engine import Engine as REngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro_torch import convert, faults
from repro_torch.configs import smoke_config
from repro_torch.core import mcprioq as mc
from repro_torch.core import speculative as spec
from repro_torch.models import Model
from repro_torch.serve import sampling
from repro_torch.serve.engine import Engine, ServeConfig

from torch_parity import assert_same, jax_state_leaves

STUB = SimpleNamespace(prefill=lambda *a: None, decode_step=lambda *a: None,
                       extend_step=lambda *a: None)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _chain(engine):
    return engine.drafter_store._snap.state.chain


# ---------------------------------------------------------------------------
# the port's Engine against the reference's
# ---------------------------------------------------------------------------


def engine_against_the_reference(arch, prompt_len, new_tokens):
    """The port's Engine and the reference's at ``smoke_config(arch)``,
    float32, on the reference's parameters: identical tokens, equal
    ``stats`` and the drafter's 18 leaves bit for bit, over three requests
    that take drafts whole, in part and not at all."""
    cfg = dataclasses.replace(r_smoke_config(arch), dtype="float32")
    r_model = RModel(cfg)
    r_params = r_model.init(jax.random.key(1))
    model = Model(dataclasses.replace(smoke_config(arch), dtype="float32"))
    params = convert.model_params_from_numpy(
        model.cfg, jax.tree_util.tree_map(np.asarray, r_params), device="cpu")
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size, (2, prompt_len)).astype(np.int32)
    edited = prompt.copy()
    edited[:, -1] = (edited[:, -1] + 7) % cfg.vocab_size
    serve = dict(max_new_tokens=new_tokens, max_cache_len=64, draft_len=4)

    # the model's own continuation, then a history that teaches the drafter
    # its first three tokens and a wrong fourth: the first round drafts
    # [c1, c2, wrong], accepts two and re-extends
    cont = Engine(model, params, ServeConfig(**dict(serve, draft_len=0)),
                  device="cpu").generate({"tokens": prompt})
    taught = np.concatenate([prompt, cont[:, :3],
                             (cont[:, 3:6] + 1) % cfg.vocab_size], axis=1)

    r_engine = REngine(r_model, r_params, RServeConfig(**serve))
    engine = Engine(model, params, ServeConfig(**serve), device="cpu")
    outs = {}
    for name, eng in (("reference", r_engine), ("port", engine)):
        eng._learn(taught)
        outs[name] = [np.asarray(eng.generate(
            {"tokens": jnp.asarray(p) if name == "reference" else p},
            *((jax.random.key(i),) if name == "reference" else ())))
            for i, p in enumerate((prompt, prompt, edited))]
    for i, (want, got) in enumerate(zip(outs["reference"], outs["port"])):
        np.testing.assert_array_equal(want, got, err_msg=f"request {i}")
    np.testing.assert_array_equal(outs["port"][0], cont)
    st = engine.stats
    assert st == r_engine.stats
    # the three paths ran: a whole acceptance, a partial one, a plain decode
    assert 0 < st["accepted"] < st["drafted"] and st["rounds"] > 0
    assert st["draft_calls"] > st["rounds"]
    assert engine.acceptance_rate == r_engine.acceptance_rate
    assert_same(jax_state_leaves(_chain(r_engine)),
                convert.state_to_numpy(_chain(engine)), "drafter chain")


def test_engine_matches_the_reference_tokens_stats_and_drafter():
    engine_against_the_reference("qwen2-7b", 12, 16)


#: one arch of each family the port added to the dense one; 8 + 8 tokens
#: keep every position inside recurrentgemma's smoke window of 16, where
#: the reference's extension is exact (ROADMAP queue C 30)
NEW_FAMILIES = ("deepseek-moe-16b", "mamba2-130m", "recurrentgemma-9b")


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_families_engine_matches_the_reference(arch):
    engine_against_the_reference(arch, 8, 8)


def test_speculative_serving_is_lossless_greedy():
    """Greedy speculation emits plain greedy decoding's tokens (bfloat16,
    the default), the second request of the same prompt drafting."""
    lossless_greedy("qwen2-7b", 12, 16)


def lossless_greedy(arch, prompt_len, new_tokens):
    """Plain greedy's tokens, then the same requests with speculation: a
    drafter taught the continuation's first three tokens and a wrong
    fourth, then the prompt (drafts whole and in part), the prompt again
    and an edited prompt (no usable draft at first) — tokens equal, and
    each path taken.  Returns the speculative engine."""
    cfg = smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, prompt_len)).astype(np.int32)
    edited = prompt.copy()
    edited[:, -1] = (edited[:, -1] + 7) % cfg.vocab_size
    serve = dict(max_new_tokens=new_tokens, max_cache_len=64)

    def gen(draft_len, teach=None):
        eng = Engine(model, params, ServeConfig(draft_len=draft_len, **serve),
                     device="cpu")
        if teach is not None:
            eng._learn(teach)
        return [eng.generate({"tokens": p})
                for p in (prompt, prompt, edited)], eng

    plain, _ = gen(0)
    taught = np.concatenate([prompt, plain[0][:, :3],
                             (plain[0][:, 3:6] + 1) % cfg.vocab_size], axis=1)
    spec_out, eng = gen(4, taught)
    np.testing.assert_array_equal(np.stack(plain), np.stack(spec_out))
    st = eng.stats
    assert st["rounds"] > 0 and 0 < st["accepted"] < st["drafted"], st
    assert st["draft_calls"] > st["rounds"], st
    assert st["model_calls"] < 3 * (new_tokens - 1), st
    return eng


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_families_speculation_is_lossless_greedy(arch):
    """bfloat16, 12 + 24 tokens: recurrentgemma's ring wraps (a window of
    16) and mamba2's prompt is one SSD chunk of 12."""
    lossless_greedy(arch, 12, 24)


def test_model_never_writes_the_caches_it_is_given():
    """The engine's rollback keeps the pre-extend caches: an extend_step
    and a decode_step leave every leaf of the caches they were given as it
    was."""
    for arch in ("qwen2-7b",) + NEW_FAMILIES:
        cfg = smoke_config(arch)
        model = Model(cfg)
        params = model.init(torch.Generator().manual_seed(3), device="cpu")
        tokens = torch.randint(0, cfg.vocab_size, (2, 12),
                               generator=torch.Generator().manual_seed(3),
                               dtype=torch.int32)
        _, caches = model.prefill(params, {"tokens": tokens}, 40)
        kept = jax.tree_util.tree_map(
            lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
            caches)
        pos = torch.full((2,), 12, dtype=torch.int32)
        _, extended = model.extend_step(params, caches, tokens[:, :4], pos)
        model.decode_step(params, caches, tokens[:, :1], pos)
        changed = 0
        for a, b, c in zip(jax.tree_util.tree_leaves(caches),
                           jax.tree_util.tree_leaves(kept),
                           jax.tree_util.tree_leaves(extended)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), arch
                assert c.data_ptr() != a.data_ptr(), arch
                changed += not torch.equal(a, c)
        assert changed > 0, arch


# ---------------------------------------------------------------------------
# the learner
# ---------------------------------------------------------------------------


def test_engine_learn_conserves_transitions_under_threads():
    """acquire -> observe -> publish is a read-modify-write of the back
    buffer; concurrent requests must not write it at once (lost update).
    The learner path never calls the model, so the Engine gets a stub."""
    ncfg = spec.NGramConfig(
        order=2, mc=mc.MCConfig(num_rows=2048, capacity=16, sort_passes=1))
    rng = np.random.default_rng(6)
    histories = [rng.integers(0, 50, (2, 18)).astype(np.int32)
                 for _ in range(12)]

    def total_mass(engine):
        return int(_chain(engine).slabs.tot.sum())

    eng_seq = Engine(STUB, None, ServeConfig(ngram=ncfg), device="cpu")
    for h in histories:
        eng_seq._learn(h)
    expected = total_mass(eng_seq)
    assert expected > 0

    eng = Engine(STUB, None, ServeConfig(ngram=ncfg), device="cpu")
    errs = []

    def worker(chunk):
        try:
            for h in chunk:
                eng._learn(h)
        except Exception as e:  # pragma: no cover - surfaced via errs
            errs.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(histories[i::4],))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errs, errs
    assert total_mass(eng) == expected
    assert eng.drafter_store.version == len(histories)


def test_engine_learn_failpoint_cuts_before_publish():
    """A fault at engine.learn aborts the whole learner step: the drafter's
    published version, its chain and the stats are untouched, and the lock
    is released."""
    ncfg = spec.NGramConfig(order=2, mc=mc.MCConfig(num_rows=128, capacity=8))
    eng = Engine(STUB, None, ServeConfig(ngram=ncfg), device="cpu")
    history = np.arange(12, dtype=np.int32).reshape(2, 6)
    eng._learn(history)
    version = eng.drafter_store.version
    stats_before = dict(eng.stats)
    leaves = convert.state_to_numpy(_chain(eng))

    faults.arm("engine.learn", RuntimeError("learner fault"))
    try:
        with pytest.raises(RuntimeError, match="learner fault"):
            eng._learn(history)
    finally:
        faults.reset()
    assert eng.drafter_store.version == version    # nothing published
    assert eng.stats == stats_before
    assert_same(leaves, convert.state_to_numpy(_chain(eng)), "published")
    eng._learn(history)                            # lock was released
    assert eng.drafter_store.version == version + 1


def test_lm_engine_hands_its_kernels_what_their_wrappers_take(monkeypatch):
    """Three requests of one prompt (the new-edge bound defers half of the
    first history, so the third drafts, verifies and accepts) with the
    dispatch sent to the stand-ins of the CUDA wrappers on CPU
    tensors: the drafter's walk over the engine's history windows, the
    learner's catch-up, update and rolling decay (firing) get what their
    wrappers take."""
    from test_torch_package import _kernel_stand_ins

    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, "_use_ref", lambda impl, x: impl == "ref")
    probe_calls, decay_calls = [], []
    for module, name, stand_in in _kernel_stand_ins(probe_calls, decay_calls):
        monkeypatch.setattr(module, name, stand_in)
    cfg = smoke_config("qwen2-7b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(6), device="cpu")
    ngram = spec.NGramConfig(order=2, decay_threshold=2, mc=mc.MCConfig(
        num_rows=64, capacity=8, max_new_per_batch=16, decay_block_rows=16))
    eng = Engine(model, params, ServeConfig(
        max_new_tokens=12, max_cache_len=32, draft_len=4, ngram=ngram),
        device="cpu")
    prompt = np.arange(16, dtype=np.int32).reshape(2, 8)
    for _ in range(3):
        eng.generate({"tokens": prompt})
    assert eng.stats["rounds"] > 0 and eng.stats["decay_steps"] > 0
    assert set(probe_calls) == {(True, 0)}, set(probe_calls)
    assert set(decay_calls) == {(64, 16)}, set(decay_calls)


def test_engine_without_a_device_wants_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(STUB, None, ServeConfig())


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def test_greedy_is_argmax_with_ties_to_the_first_index():
    rng = np.random.default_rng(7)
    logits = rng.integers(0, 4, (5, 3, 9)).astype(np.float32)   # many ties
    want = np.asarray(r_sampling.greedy(jnp.asarray(logits)))
    got = sampling.greedy(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(want, got.numpy())


def test_top_p_keeps_the_references_set_and_draws_from_a_generator():
    rng = np.random.default_rng(8)
    logits = (3 * rng.normal(size=(4, 50))).astype(np.float32)
    logits[0, 10] = logits[0, 11] = logits[0].max() + 1     # a tie at the top
    p, temp = 0.6, 0.8
    # the reference's keep set, from its own arithmetic
    probs = jax.nn.softmax(jnp.asarray(logits) / temp, axis=-1)
    sorted_p, sorted_idx = jax.lax.top_k(probs, probs.shape[-1])
    keep = np.asarray((jnp.cumsum(sorted_p, axis=-1) - sorted_p) < p)
    kept = [set(np.asarray(sorted_idx)[r][keep[r]].tolist()) for r in range(4)]
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([sampling.top_p(gen, torch.from_numpy(logits), p, temp)
                         for _ in range(300)])
    assert draws.dtype == torch.int32
    for r in range(4):
        seen = set(draws[:, r].tolist())
        assert seen <= kept[r], (r, seen - kept[r])
        assert len(seen) == len(kept[r])            # each kept item drawn
    again = sampling.top_p(torch.Generator().manual_seed(0),
                           torch.from_numpy(logits), p, temp)
    assert torch.equal(again, draws[0])
    # p small: the first of the tied top items, as lax.top_k orders them
    assert int(sampling.top_p(gen, torch.from_numpy(logits), 1e-6)[0]) == 10


def test_temperature_samples_the_distribution():
    logits = torch.tensor([[0.0, 1.0, 2.0]]).repeat(20000, 1)
    gen = torch.Generator().manual_seed(1)
    draws = sampling.temperature(gen, logits, 1.0)
    freq = np.bincount(draws.numpy(), minlength=3) / 20000
    np.testing.assert_allclose(freq, torch.softmax(logits[0], 0).numpy(),
                               atol=0.015)
    assert torch.equal(sampling.temperature(gen, logits[:3], 1e-9),
                       sampling.greedy(logits[:3]))


def test_engine_samples_with_a_generator_when_not_greedy():
    cfg = smoke_config("qwen2-7b")
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(5), device="cpu")
    prompt = np.zeros((2, 6), np.int32)
    eng = Engine(model, params, ServeConfig(
        max_new_tokens=6, max_cache_len=16, greedy=False, temperature=2.0),
        device="cpu")
    with pytest.raises(ValueError, match="torch.Generator"):
        eng.generate({"tokens": prompt})
    a = eng.generate({"tokens": prompt}, torch.Generator().manual_seed(9))
    b = eng.generate({"tokens": prompt}, torch.Generator().manual_seed(9))
    np.testing.assert_array_equal(a, b)
    assert eng.stats["draft_calls"] == 0          # no speculation sampling


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------


def test_launcher_serves_the_lm_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                "--prompt-len", "8", "--new-tokens", "8"])
    out = capsys.readouterr().out
    assert "2 requests, 32 tokens in" in out
    assert "(plain greedy would use 14)" in out
    assert "maintenance: decay_steps=0" in out
    outs, engine = serve.run("starcoder2-3b", True, 1, 8, 6, 2, device="cpu")
    assert outs[0].shape == (2, 6) and outs[0].dtype == np.int32
    assert engine.drafter_store.version == 1
    for arch in ("whisper-base", "phi-3-vision-4.2b"):
        with pytest.raises(SystemExit, match="encdec"):
            serve.run(arch, True, 1, 8, 6, 2, device="cpu")
    outs, engine = serve.run("deepseek-moe-16b", True, 1, 8, 6, 2,
                             device="cpu")
    assert outs[0].shape == (2, 6) and engine.drafter_store.version == 1
