"""Shared parity checks of the port's LM families against the reference's
(a helper, not collected): the reference's outputs at ``smoke_config``
computed once (jitted) and the checks that hold the port to them.  Used by
``tests/test_torch_models_moe.py``,
``tests/test_torch_models_recurrent.py`` and
``tests/test_torch_models_encdec.py``; the tolerances are stated in those
files' docstrings and in each check's.  An ``encdec`` arch's batches carry
``frames`` [B, ENC_LEN, D] and a ``vlm``'s ``prefix_embeds`` [B, P, D]
(``extra_inputs``); its decodes continue at ``P + s``.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as r_get_config
from repro.configs import smoke_config as r_smoke_config
from repro.models import Model as RModel
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.models import Model
from repro_torch.models.model import STEP_ROWS

B, MAX_LEN, K = 2, 40, 4
ENC_LEN = 24    # stub encoder frames of an encdec arch's batches


def extra_inputs(cfg, rng):
    """The stub frontend's inputs a batch of ``cfg`` carries besides its
    tokens (normal draws from ``rng``): ``frames`` or ``prefix_embeds``."""
    if cfg.encoder_layers:
        return {"frames": rng.standard_normal(
            (B, ENC_LEN, cfg.d_model)).astype(np.float32)}
    if cfg.frontend == "patch":
        return {"prefix_embeds": rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)}
    return {}


def n_prefix(cfg):
    return cfg.frontend_len if cfg.frontend == "patch" else 0


def close(want, got, tol, what):
    want = np.asarray(want, np.float32)
    got = got.detach().to(torch.float32).numpy()
    assert want.shape == got.shape, (what, want.shape, got.shape)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# the reference's outputs, once per module
# ---------------------------------------------------------------------------


def reference_outputs(cases, seed0=0):
    """Per arch and dtype: the reference's numpy parameters, a prompt, an
    extension feed, targets, and the logits of the prefill, of K sequential
    decode steps; at float32 also the caches after those decodes, the
    logits of one K-token extend_step from the prefill's caches and the
    loss metrics."""
    out = {}
    rng = np.random.default_rng(seed0)
    for arch, s, dtypes in cases:
        for dtype in dtypes:
            cfg = dataclasses.replace(r_smoke_config(arch), dtype=dtype)
            model = RModel(cfg)
            params = model.init(jax.random.key(seed0 + len(out)))
            prompt = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
            feed = rng.integers(0, cfg.vocab_size, (B, K)).astype(np.int32)
            targets = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
            extra = extra_inputs(cfg, rng)
            jextra = {k: jnp.asarray(v) for k, v in extra.items()}
            logits, caches = jax.jit(
                lambda p, t, e: model.prefill(p, {"tokens": t, **e},
                                              MAX_LEN))(
                    params, jnp.asarray(prompt), jextra)
            pos = np.full((B,), s + n_prefix(cfg), np.int32)
            decode = jax.jit(model.decode_step)
            seq, c = [], caches
            for j in range(K):
                lg, c = decode(params, c, jnp.asarray(feed[:, j:j + 1]),
                               jnp.asarray(pos + j))
                seq.append(np.asarray(lg.astype(jnp.float32)))
            rec = dict(
                params=jax.tree_util.tree_map(np.asarray, params),
                prompt=prompt, feed=feed, pos=pos, targets=targets,
                extra=extra,
                prefill=np.asarray(logits.astype(jnp.float32)),
                seq=np.stack(seq, axis=1))
            if dtype == "float32":
                ext, _ = jax.jit(model.extend_step)(
                    params, caches, jnp.asarray(feed), jnp.asarray(pos))
                _, metrics = jax.jit(model.loss_fn)(params, {
                    "tokens": jnp.asarray(prompt),
                    "targets": jnp.asarray(targets), **jextra})
                rec.update(ext=np.asarray(ext), caches=c,
                           metrics={k: float(v) for k, v in metrics.items()})
            out[arch, dtype, s] = rec
    return out


def port_outputs(arch, dtype, ref):
    """The port's prefill logits and its K-token extension's logits from
    the prefill's caches, on the reference's parameters."""
    cfg = dataclasses.replace(smoke_config(arch), dtype=dtype)
    model = Model(cfg)
    params = model_params_from_numpy(cfg, ref["params"], device="cpu")
    logits, caches = model.prefill(
        params, {"tokens": ref["prompt"], **ref["extra"]}, MAX_LEN)
    ext, _ = model.extend_step(params, caches, torch.from_numpy(ref["feed"]),
                               torch.from_numpy(ref["pos"]))
    return model, params, logits, ext


def check_float32(arch, ref, seq_tol=1e-4):
    _, _, logits, ext = port_outputs(arch, "float32", ref)
    close(ref["prefill"], logits, 1e-4, f"{arch} prefill")
    close(ref["seq"], ext, seq_tol,
          f"{arch} extension vs sequential decodes")
    close(ref["ext"], ext, 2e-3, f"{arch} extension vs extend_step")
    for want, got in ((ref["prefill"], logits), (ref["seq"], ext)):
        assert np.array_equal(want.argmax(-1), got.argmax(-1).numpy())


def check_bfloat16(arch, ref):
    """Against the reference's bfloat16 logits, with ``theirs`` = how far
    bfloat16 rounding moves the reference's logits (against float32 logits
    of the same parameters: the port's float32, within 1e-4 of the
    reference's) and ``ours`` = the same for the port: the largest and the
    mean |port - reference| at most 1.0 and 0.15 (the dense archs' bound,
    ``tests/test_torch_models.py``) or twice ``theirs`` where that is
    larger; ``ours`` at most 4x ``theirs``; greedy tokens equal wherever
    the reference's top-2 margin exceeds the largest-difference bound.
    The smoke configs' logits spread by ~0.23 (recurrent) to ~1 (MoE) with
    small top-2 margins, so a greedy token is often a coin toss at
    bfloat16, and a router's near tie moves an MoE logit by up to 2.3."""
    _, _, logits, ext = port_outputs(arch, "bfloat16", ref)
    _, _, logits32, ext32 = port_outputs(arch, "float32", ref)
    for name, want, got, exact in (("prefill", ref["prefill"], logits,
                                    logits32),
                                   ("extension", ref["seq"], ext, ext32)):
        assert got.dtype == torch.bfloat16, name
        got = got.float().numpy()
        diff = np.abs(got - want)
        ours, theirs = np.abs(got - exact.numpy()), np.abs(want - exact.numpy())
        bound_max = max(1.0, 2 * float(theirs.max()))
        bound_mean = max(0.15, 2 * float(theirs.mean()))
        assert diff.max() <= bound_max and diff.mean() <= bound_mean, \
            (arch, name, diff.max(), bound_max, diff.mean(), bound_mean)
        assert ours.max() <= 4 * theirs.max() and \
            ours.mean() <= 4 * theirs.mean(), \
            (arch, name, ours.max(), theirs.max(), ours.mean(), theirs.mean())
        top2 = -np.sort(-want, axis=-1)[..., :2]
        clear = (top2[..., 0] - top2[..., 1]) > bound_max
        agree = want.argmax(-1) == got.argmax(-1)
        assert agree[clear].all(), (arch, name)


def check_loss(arch, ref):
    model, params, _, _ = port_outputs(arch, "float32", ref)
    loss, metrics = model.loss_fn(params, {"tokens": ref["prompt"],
                                           "targets": ref["targets"],
                                           **ref["extra"]})
    assert loss.shape == () and np.isfinite(float(loss))
    assert sorted(metrics) == sorted(ref["metrics"])
    for k, v in ref["metrics"].items():
        assert abs(float(metrics[k]) - v) <= 1e-4 * max(1.0, abs(v)), k


def check_tree(arch, ref):
    """The tree's keys, shapes and dtypes (at smoke and full width, the
    full one as meta tensors against ``jax.eval_shape``) and a bit-for-bit
    round trip of the reference's parameters."""
    for cfg, r_cfg in ((smoke_config(arch), r_smoke_config(arch)),
                       (get_config(arch), r_get_config(arch))):
        want = jax.eval_shape(RModel(r_cfg).init, jax.random.key(0))
        got = Model(cfg).abstract_params()
        w = jax.tree_util.tree_leaves_with_path(want)
        g = dict(jax.tree_util.tree_leaves_with_path(got))
        assert len(w) == len(g)
        for path, leaf in w:
            t = g[path]
            assert tuple(t.shape) == leaf.shape, jax.tree_util.keystr(path)
            assert torch.empty((), dtype=t.dtype).numpy().dtype == \
                leaf.dtype, jax.tree_util.keystr(path)
    gen = torch.Generator().manual_seed(0)
    drawn = model_params_to_numpy(Model(smoke_config(arch)).init(
        gen, device="cpu"))
    assert all(np.isfinite(a).all() for a in jax.tree_util.tree_leaves(drawn))
    tree = ref["params"]
    back = model_params_to_numpy(model_params_from_numpy(
        smoke_config(arch), tree, device="cpu"))
    want = jax.tree_util.tree_leaves_with_path(tree)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(want) == len(got)
    for path, leaf in want:
        assert got[path].dtype == leaf.dtype and \
            np.array_equal(got[path], leaf), jax.tree_util.keystr(path)


def check_extend_bit_for_bit(arch, seed):
    """K tokens through one extend_step == K decode_steps, logits and every
    cache leaf (bfloat16, the default), for K with pad rows and K =
    STEP_ROWS; the caches given are left as they were."""
    cfg = smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32))
    _, caches = model.prefill(params, {"tokens": tokens,
                                       **extra_inputs(cfg, rng)}, 40)
    kept = jax.tree_util.tree_map(
        lambda t: t.clone() if isinstance(t, torch.Tensor) else t, caches)
    pos = torch.full((2,), 16 + n_prefix(cfg), dtype=torch.int32)
    for k in (3, STEP_ROWS):
        feed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, k)).astype(
            np.int32))
        ext, ext_caches = model.extend_step(params, caches, feed, pos)
        steps, c = [], caches
        for j in range(k):
            logits, c = model.decode_step(params, c, feed[:, j:j + 1], pos + j)
            steps.append(logits)
        assert torch.equal(ext, torch.stack(steps, dim=1)), (arch, k)
        lx, lc = (jax.tree_util.tree_leaves(t) for t in (ext_caches, c))
        assert len(lx) == len(lc)
        for a, b in zip(lx, lc):
            assert (torch.equal(a, b) if isinstance(a, torch.Tensor)
                    else a == b), (arch, k)
    for a, b in zip(jax.tree_util.tree_leaves(caches),
                    jax.tree_util.tree_leaves(kept)):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
