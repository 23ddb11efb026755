"""The port's configs and dense decoder models against the reference's.

``repro_torch.configs`` is a literal copy of ``repro.configs`` (every field
of the ten archs, ``param_count`` and ``active_param_count`` equal).  The
models run on the CPU with the reference's own parameters
(``model.init(key)`` as numpy, carried over by
``convert.model_params_from_numpy``, bit for bit both ways).  Tolerances:

  * the building blocks (RoPE, both norms, both MLPs, ``attend`` over
    several KV chunks and a local window, ``decode_attend``) at float32:
    atol = rtol = 1e-5 (two libraries' float32 sums in other orders);
  * the four dense archs at ``smoke_config`` with ``dtype="float32"``:
    ``prefill``, ``decode_step`` and ``extend_step`` logits within atol =
    rtol = 1e-4, greedy tokens identical;
  * the bfloat16 default: the largest |logit difference| at most 1.0 and
    the mean at most 0.15, greedy tokens equal wherever the reference's
    top-2 margin exceeds 1.0 and at 3 of 4 positions at least.  Loose on
    purpose: the smoke configs' random attention scores reach +-100, where
    a bfloat16 ulp is 0.5-1, so a one-ulp difference of a score (the
    reference rounds scores to bfloat16, the port keeps float32: ROADMAP
    queue C 21) moves the softmax to another key.

The reference's outputs are computed once per module (``ref_outputs``).
Also here: the port's counterparts of ``test_models_smoke.py``'s
forward-loss and prefill/decode tests, the two archs the launchers
refuse as the reference's do (the encoder and the patch prefix, whose
models run and are held to the reference in
``tests/test_torch_models_encdec.py``), and the port's own claim that an ``extend_step`` of K tokens equals K ``decode_step``
calls bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as R_ARCHS
from repro.configs import get_config as r_get_config
from repro.configs import smoke_config as r_smoke_config
from repro.models import Model as RModel
from repro.models import attention as r_attn
from repro.models import common as r_common
from repro.models import mlp as r_mlp
from repro_torch.configs import ARCHS, get_config, smoke_config
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.models import Model
from repro_torch.models import attention as attn
from repro_torch.models import common
from repro_torch.models import mlp as mlp_mod

DENSE = ("qwen2-7b", "starcoder2-3b", "starcoder2-7b", "granite-34b")
#: the encoder and the patch prefix, which the launchers refuse (the MoE,
#: SSM, hybrid, encdec and vlm models have files of their own:
#: tests/test_torch_models_{moe,recurrent,encdec}.py)
NOT_PORTED = ("phi-3-vision-4.2b", "whisper-base")
B, S, MAX_LEN, K = 2, 12, 40, 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(want, got, tol, what):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(R_ARCHS))
def test_configs_equal_field_for_field(arch):
    assert sorted(ARCHS) == sorted(R_ARCHS)
    for ref, port in ((r_get_config(arch), get_config(arch)),
                      (r_smoke_config(arch), smoke_config(arch))):
        assert dataclasses.asdict(ref) == dataclasses.asdict(port)
        assert ref.param_count() == port.param_count()
        assert ref.active_param_count() == port.active_param_count()
        assert (ref.num_periods(), ref.tail_kinds(), ref.q_per_kv) == \
            (port.num_periods(), port.tail_kinds(), port.q_per_kv)


def test_unknown_arch_is_a_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-5")


@pytest.mark.parametrize("arch", NOT_PORTED)
def test_families_not_ported_are_refused_by_name(arch):
    """``Model`` builds both archs with the reference's tree (keys, shapes
    and dtypes of ``init`` at smoke size) and the same loss on the
    reference's parameters (float32, within 1e-4); the serving and training
    launchers refuse them by name, as the reference's do."""
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    cfg = _f32(smoke_config(arch))
    r_model = RModel(_f32(r_smoke_config(arch)))
    r_params = r_model.init(jax.random.key(5))
    want = jax.tree_util.tree_leaves_with_path(r_params)
    model = Model(cfg)
    got = dict(jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(
        lambda t: t.numpy(), model.init(torch.Generator().manual_seed(5),
                                        device="cpu"))))
    assert len(want) == len(got)
    for path, leaf in want:
        assert got[path].shape == leaf.shape and got[path].dtype == leaf.dtype
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
             for k in ("tokens", "targets")}
    if cfg.encoder_layers:
        batch["frames"] = rng.standard_normal((B, 16, cfg.d_model)).astype(
            np.float32)
    else:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    r_loss, _ = r_model.loss_fn(r_params, {k: jnp.asarray(v)
                                           for k, v in batch.items()})
    loss, _ = model.loss_fn(model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, r_params), device="cpu"),
        batch)
    assert abs(float(loss) - float(r_loss)) <= 1e-4
    with pytest.raises(SystemExit, match="see examples/ for encdec"):
        serve_launch.run(arch, True, 1, 8, 4, 2, device="cpu")
    with pytest.raises(SystemExit, match="use the multimodal examples"):
        train_launch.run(arch, True, 1, 2, 8, None, device="cpu")


# ---------------------------------------------------------------------------
# the reference's outputs, once per module
# ---------------------------------------------------------------------------


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


@pytest.fixture(scope="module")
def ref_outputs():
    """Per dense arch and dtype: the reference's numpy parameters, a prompt,
    a decode token, an extension feed and the logits of prefill ->
    decode_step -> extend_step (the extension on the decode's caches)."""
    out = {}
    rng = np.random.default_rng(0)
    for arch in DENSE:
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(r_smoke_config(arch), dtype=dtype)
            model = RModel(cfg)
            params = model.init(jax.random.key(len(out)))
            prompt = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            feed = rng.integers(0, cfg.vocab_size, (B, K)).astype(np.int32)
            targets = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
            logits, caches = model.prefill(
                params, {"tokens": jnp.asarray(prompt)}, MAX_LEN)
            nxt = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
            pos = np.full((B,), S, np.int32)
            step, caches = model.decode_step(params, caches, jnp.asarray(nxt),
                                             jnp.asarray(pos))
            ext, _ = model.extend_step(params, caches, jnp.asarray(feed),
                                       jnp.asarray(pos + 1))
            loss, metrics = model.loss_fn(params, {
                "tokens": jnp.asarray(prompt), "targets": jnp.asarray(targets)})
            out[arch, dtype] = dict(
                params=jax.tree_util.tree_map(np.asarray, params),
                prompt=prompt, nxt=nxt, pos=pos, feed=feed, targets=targets,
                logits=[np.asarray(x.astype(jnp.float32))
                        for x in (logits, step, ext)],
                ce=float(metrics["ce"]))
    return out


def _port(arch, dtype, ref):
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    return Model(cfg), model_params_from_numpy(cfg, ref["params"],
                                               device="cpu")


def _port_logits(model, params, ref):
    logits, caches = model.prefill(params, {"tokens": ref["prompt"]}, MAX_LEN)
    pos = torch.from_numpy(ref["pos"])
    step, caches = model.decode_step(params, caches,
                                     torch.from_numpy(ref["nxt"]), pos)
    ext, _ = model.extend_step(params, caches, torch.from_numpy(ref["feed"]),
                               pos + 1)
    return [logits, step, ext]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_params_round_trip_bit_for_bit(arch, ref_outputs):
    tree = ref_outputs[arch, "float32"]["params"]
    back = model_params_to_numpy(model_params_from_numpy(
        _f32(smoke_config(arch)), tree, device="cpu"))
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype and np.array_equal(got[path], leaf), \
            jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", DENSE)
def test_init_has_the_references_tree_shapes_and_dtypes(arch):
    cfg = smoke_config(arch)
    want = jax.eval_shape(RModel(cfg).init, jax.random.key(0))
    gen = torch.Generator().manual_seed(0)
    got = Model(cfg).init(gen, device="cpu")
    w = jax.tree_util.tree_leaves_with_path(want)
    g = dict(jax.tree_util.tree_leaves_with_path(
        jax.tree_util.tree_map(lambda t: t.numpy(), got)))
    assert len(w) == len(g)
    for path, leaf in w:
        assert g[path].shape == leaf.shape and g[path].dtype == leaf.dtype, \
            jax.tree_util.keystr(path)
    # the reference's scales: truncated normal at 1/sqrt(fan-in), embeddings
    # at 0.02, biases zero, norm scales one
    w1 = got["stack"]["pos0"]["mlp"]["w1"]
    # (a normal truncated at +-3 has a standard deviation of 0.9866)
    assert abs(float(w1.std()) * np.sqrt(cfg.d_model) - 0.9866) < 0.02
    assert float(w1.abs().max()) <= 3 / np.sqrt(cfg.d_model) + 1e-6
    assert abs(float(got["emb"]["tok"].std()) / 0.02 - 0.9866) < 0.02
    assert bool((got["final_norm"]["scale"] == 1).all())


def test_params_from_numpy_checks_the_tree():
    cfg = _f32(smoke_config("qwen2-7b"))
    tree = model_params_to_numpy(
        Model(cfg).init(torch.Generator().manual_seed(0), device="cpu"))
    bad = dict(tree, emb={"tok": tree["emb"]["tok"]})
    with pytest.raises(ValueError, match="keys"):
        model_params_from_numpy(cfg, bad, device="cpu")
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"][:-1]
    with pytest.raises(ValueError, match="final_norm"):
        model_params_from_numpy(cfg, tree, device="cpu")


# ---------------------------------------------------------------------------
# building blocks at float32
# ---------------------------------------------------------------------------

TOL = 1e-5


def test_rope_matches():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    for theta in (1e4, 1e6):
        _close(r_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
               attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               theta), TOL, f"rope {theta}")


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match(norm):
    cfg = dataclasses.replace(smoke_config("qwen2-7b"), norm=norm)
    rng = np.random.default_rng(2)
    x = (3 * rng.normal(size=(2, 5, cfg.d_model)) + 1).astype(np.float32)
    p = {"scale": rng.normal(size=(cfg.d_model,)).astype(np.float32),
         "bias": rng.normal(size=(cfg.d_model,)).astype(np.float32)}
    if norm == "rmsnorm":
        del p["bias"]
    _close(r_common.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                               jnp.asarray(x), cfg),
           common.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg), TOL, norm)


@pytest.mark.parametrize("arch", ["qwen2-7b", "granite-34b"])
def test_mlps_match(arch):
    """SwiGLU (qwen2) and the plain GELU MLP (granite)."""
    cfg = _f32(smoke_config(arch))
    params = RModel(cfg).init(jax.random.key(3))
    p = jax.tree_util.tree_map(lambda a: np.array(a[0]),
                               params["stack"]["pos0"])
    x = np.random.default_rng(3).normal(size=(2, 7, cfg.d_model)).astype(
        np.float32)
    _close(r_mlp.apply_mlp(jax.tree_util.tree_map(jnp.asarray, p["mlp"]),
                           jnp.asarray(x), cfg),
           mlp_mod.apply_mlp({k: torch.from_numpy(v)
                              for k, v in p["mlp"].items()},
                             torch.from_numpy(x), cfg), TOL, arch)


@pytest.mark.parametrize("window", [0, 40])
def test_attend_over_several_chunks_matches(window):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 256, 4, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 256, 2, 32)).astype(np.float32)
            for _ in range(2))
    _close(r_attn.attend(*(jnp.asarray(a) for a in (q, k, v)), window=window,
                         kv_chunk=64),
           attn.attend(*(torch.from_numpy(a) for a in (q, k, v)),
                       window=window, kv_chunk=64), TOL, f"window {window}")


@pytest.mark.parametrize("ring", [False, True])
def test_cache_insert_and_decode_attend_match(ring):
    """A linear cache of 48 and a ring of 16 with a window of 16, filled by
    three inserts (the ring wraps), then three queries at once."""
    rng = np.random.default_rng(5)
    t, window = (16, 16) if ring else (48, 0)
    r_cache = r_attn.init_cache(2, t, 2, 32, jnp.float32, ring=ring)
    p_cache = attn.init_cache(2, t, 2, 32, torch.float32, ring=ring,
                              device="cpu")
    start = 0
    for n in (5, 9, 7):
        k, v = (rng.normal(size=(2, n, 2, 32)).astype(np.float32)
                for _ in range(2))
        pos = np.broadcast_to(np.arange(start, start + n, dtype=np.int32),
                              (2, n)).copy()
        if ring:   # the reference inserts the last min(W, n) only
            k, v, pos = k[:, -window:], v[:, -window:], pos[:, -window:]
        r_cache = r_attn.cache_insert(r_cache, jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(pos))
        p_cache = attn.cache_insert(p_cache, torch.from_numpy(k),
                                    torch.from_numpy(v), torch.from_numpy(pos))
        start += n
    for a, b in zip(r_cache[:3], p_cache[:3]):
        assert np.array_equal(np.asarray(a), b.numpy())
    q = rng.normal(size=(2, 3, 4, 32)).astype(np.float32)
    qpos = np.broadcast_to(np.arange(start - 3, start, dtype=np.int32),
                           (2, 3)).copy()
    _close(r_attn.decode_attend(jnp.asarray(q), r_cache, window=window,
                                q_positions=jnp.asarray(qpos)),
           attn.decode_attend(torch.from_numpy(q), p_cache, window=window,
                              q_positions=torch.from_numpy(qpos)),
           TOL, f"ring {ring}")


def test_stack_decode_matches():
    """``transformer.stack_decode`` (the reference's per-block decode over
    the periods) on warm caches: the output and every new cache leaf, at
    the whole models' 1e-4."""
    from repro.models import transformer as r_tfm
    from repro_torch.models import transformer as tfm
    cfg = _f32(smoke_config("qwen2-7b"))
    r_model = RModel(cfg)
    r_params = r_model.init(jax.random.key(7))
    params = model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, r_params), device="cpu")
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    _, r_caches = r_model.prefill(r_params, {"tokens": jnp.asarray(prompt)},
                                  24)
    _, caches = Model(cfg).prefill(params, {"tokens": prompt}, 24)
    r_list = [jax.tree_util.tree_map(lambda a: a[i], r_caches["stack"])
              for i in range(cfg.num_periods())]
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    pos = np.full((2, 1), 9, np.int32)
    r_x, r_new = r_tfm.stack_decode(r_params["stack"], jnp.asarray(x), cfg,
                                    positions=jnp.asarray(pos), caches=r_list)
    t_x, t_new = tfm.stack_decode(params["stack"], torch.from_numpy(x), cfg,
                                  positions=torch.from_numpy(pos),
                                  caches=caches["stack"])
    _close(r_x, t_x, 1e-4, "stack_decode")
    for r_c, t_c in zip(r_new, t_new):
        for a, b in zip(r_c["pos0"][:3], t_c["pos0"][:3]):
            _close(a, b, 1e-4, "stack_decode cache")


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_extend_match_at_float32(arch, ref_outputs):
    ref = ref_outputs[arch, "float32"]
    model, params = _port(arch, "float32", ref)
    got = _port_logits(model, params, ref)
    for name, want, g in zip(("prefill", "decode_step", "extend_step"),
                             ref["logits"], got):
        _close(want, g, 1e-4, f"{arch} {name}")
        assert np.array_equal(want.argmax(-1), g.argmax(-1).numpy()), name


PAST_TOL = 1e-3


def test_local_attention_and_tail_match_at_float32():
    """A dense config with the ``local_attn`` kind (a ring for a window of
    8) and a tail block (5 layers over a period of 2).

    Against the reference: a 4-token prompt, a decode and a 2-token
    extension (the positions stay inside the window, where the reference's
    cached calls are exact) within 1e-4, greedy tokens identical.  Past the
    window: a 12-token prompt that overfills the ring, a decode and a
    4-token extension that wraps it, within PAST_TOL of the reference's
    cache-free forward over the whole sequence (``_embed_inputs``,
    ``_body`` without caches, ``lm_logits``), greedy tokens identical, and
    within 1e-5 of the port's own cache-free forward.  The reference's
    cached calls lose keys there (its prefill attends over a ring the
    prompt overfilled, and its extension overwrites keys its first rows
    need; ROADMAP queue C 30), so its cache-free forward is what the
    cached calls must equal.

    PAST_TOL = 1e-3: over 17 tokens of these 5 layers, each library's
    float32 forward lies up to 5e-4 (the reference) and 9e-4 (the port)
    from the port's forward in float64 on the same weights, so two float32
    forwards cannot be held to 1e-4 there (here they differ by up to
    5.8e-4 at position 15); it is half the reference's own 2e-3 between
    two forms of one computation (``tests/test_system.py``)."""
    cfg = dataclasses.replace(_f32(r_smoke_config("qwen2-7b")), num_layers=5,
                              pattern=("attn", "local_attn"), local_window=8)
    model = RModel(cfg)
    r_params = model.init(jax.random.key(9))
    params = model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, r_params), device="cpu")
    port = Model(cfg)
    assert cfg.tail_kinds() == ("attn",)
    rng = np.random.default_rng(9)

    # inside the window: the reference's cached calls
    s, k = 4, 2
    ref = dict(prompt=rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32),
               feed=rng.integers(0, cfg.vocab_size, (B, k)).astype(np.int32),
               pos=np.full((B,), s, np.int32))
    logits, caches = model.prefill(r_params,
                                   {"tokens": jnp.asarray(ref["prompt"])},
                                   MAX_LEN)
    ref["nxt"] = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)[:, None]
    step, caches = model.decode_step(r_params, caches, jnp.asarray(ref["nxt"]),
                                     jnp.asarray(ref["pos"]))
    ext, _ = model.extend_step(r_params, caches, jnp.asarray(ref["feed"]),
                               jnp.asarray(ref["pos"] + 1))
    got = _port_logits(port, params, ref)
    for name, want, g in zip(("prefill", "decode_step", "extend_step"),
                             (logits, step, ext), got):
        _close(want, g, 1e-4, f"local_attn {name}")
        assert np.array_equal(np.asarray(want).argmax(-1),
                              g.argmax(-1).numpy()), name

    # past the window: the port's cached calls against the reference's
    # cache-free forward over the whole sequence (and the port's own)
    ref = dict(prompt=rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
               feed=rng.integers(0, cfg.vocab_size, (B, K)).astype(np.int32),
               pos=np.full((B,), S, np.int32))

    @jax.jit
    def r_forward(tokens):
        x, positions, _ = model._embed_inputs(r_params, {"tokens": tokens})
        x, _, _ = model._body(r_params, x, positions)
        return r_common.lm_logits(r_params["emb"], x, cfg)

    def forward(tokens):
        x, positions, _ = port._embed_inputs(params, {"tokens": tokens})
        x, _, _ = port._body(params, x, positions)
        return common.lm_logits(params["emb"], x, cfg)

    first = np.asarray(r_forward(jnp.asarray(ref["prompt"])))[:, -1]
    ref["nxt"] = first.argmax(-1).astype(np.int32)[:, None]
    tokens = np.concatenate([ref["prompt"], ref["nxt"], ref["feed"]], axis=1)
    whole = np.asarray(r_forward(jnp.asarray(tokens)))
    own = forward(tokens)
    got = _port_logits(port, params, ref)
    for name, want, mine, g in zip(
            ("prefill", "decode_step", "extend_step"),
            (first, whole[:, S], whole[:, S + 1:]),
            (forward(ref["prompt"])[:, -1], own[:, S], own[:, S + 1:]), got):
        _close(want, g, PAST_TOL, f"local_attn past the window {name}")
        assert np.array_equal(want.argmax(-1), g.argmax(-1).numpy()), name
        _close(mine.numpy(), g, TOL, f"local_attn past the window, own {name}")


@pytest.mark.parametrize("arch", DENSE)
def test_bfloat16_default_within_its_tolerance(arch, ref_outputs):
    ref = ref_outputs[arch, "bfloat16"]
    model, params = _port(arch, "bfloat16", ref)
    got = _port_logits(model, params, ref)
    same = []
    for name, want, g in zip(("prefill", "decode_step", "extend_step"),
                             ref["logits"], got):
        assert g.dtype == torch.bfloat16, name
        diff = np.abs(g.float().numpy() - want)
        assert diff.max() <= 1.0 and diff.mean() <= 0.15, \
            (arch, name, diff.max(), diff.mean())
        top2 = -np.sort(-want, axis=-1)[..., :2]
        clear = (top2[..., 0] - top2[..., 1]) > 1.0
        agree = want.argmax(-1) == g.float().argmax(-1).numpy()
        assert agree[clear].all(), (arch, name)
        same.append(agree.ravel())
    assert np.concatenate(same).mean() >= 0.75, arch


@pytest.mark.parametrize("arch", DENSE)
def test_forward_loss_finite(arch, ref_outputs):
    """``test_models_smoke.py::test_forward_loss_finite`` on the port, and
    the same loss as the reference's at float32."""
    for dtype in ("bfloat16", "float32"):
        ref = ref_outputs[arch, dtype]
        model, params = _port(arch, dtype, ref)
        loss, metrics = model.loss_fn(params, {"tokens": ref["prompt"],
                                               "targets": ref["targets"]})
        assert loss.shape == ()
        assert np.isfinite(float(loss))
        assert 3.0 < float(metrics["ce"]) < 12.0, float(metrics["ce"])
        if dtype == "float32":
            assert abs(float(metrics["ce"]) - ref["ce"]) < 1e-4


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(arch):
    """``test_models_smoke.py::test_prefill_decode_consistency`` on the
    port: prefill then one greedy decode step, shapes and finite logits."""
    cfg = smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32))
    logits_p, caches = model.prefill(params, {"tokens": tokens}, 64)
    assert logits_p.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits_p.float()).all())
    nxt = logits_p.argmax(-1).to(torch.int32)[:, None]
    pos = torch.full((2,), 16, dtype=torch.int32)
    logits_d, caches = model.decode_step(params, caches, nxt, pos)
    assert logits_d.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits_d.float()).all())


@pytest.mark.parametrize("arch", DENSE)
def test_extend_step_equals_sequential_decode_bit_for_bit(arch):
    """K tokens through one ``extend_step`` == K ``decode_step`` calls, the
    logits and every cache leaf equal: both run at ``STEP_ROWS`` rows, so
    greedy speculation cannot change a token (bfloat16, the default)."""
    cfg = smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(4), device="cpu")
    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 10)).astype(
        np.int32))
    _, caches = model.prefill(params, {"tokens": tokens}, 32)
    feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, K)).astype(
        np.int32))
    pos = torch.full((2,), 10, dtype=torch.int32)
    ext, ext_caches = model.extend_step(params, caches, feed, pos)
    steps, c = [], caches
    for j in range(K):
        logits, c = model.decode_step(params, c, feed[:, j:j + 1], pos + j)
        steps.append(logits)
    assert torch.equal(ext, torch.stack(steps, dim=1))
    for a, b in zip(jax.tree_util.tree_leaves(ext_caches),
                    jax.tree_util.tree_leaves(c)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b


def test_init_without_a_device_wants_the_gpu(monkeypatch):
    """No silent CPU fallback: ``init`` without a device wants the GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(smoke_config("qwen2-7b")).init(torch.Generator())
