"""The port's training pieces against the reference's, on the CPU:
``optim/schedule.py``, ``optim/adamw.py``, ``train/compression.py`` and
``train/train_step.py``, and the train state's checkpoint.

Tolerances and what they rest on:

  * ``warmup_cosine``: equal, but where ``torch.cos`` and XLA's ``cos``
    differ by an ulp (the test finds and counts those): there the
    multiplier within 0.45 of that ulp plus 2 ulps of its own (``1 + cos``
    cancels near cos = -1);
  * ``adamw.update`` on the same numpy grads, params and state, gradients
    below the clip norm (the clip's scale is then exactly 1): ``mu`` and
    ``nu`` bit for bit; the params bit for bit wherever the port's bias
    corrections ``1 - b ** step`` equal the reference's, within 1 ulp
    (``nextafter``) where XLA's ``pow`` differs.  Above the clip norm the
    global norm's float32 sum runs in another order than XLA's, so the
    scale may differ by an ulp: ``mu``, ``nu`` and the params within 4e-7
    relative there;
  * ``compress``: int8 codes, dequantised gradients and the carried
    residual bit for bit (an all-zero block, lengths that are not a
    multiple of 256, exact .5 ties rounded to even);
  * ``make_train_step``, 3 steps of whisper-base's smoke config at float32,
    ``microbatches=2``, ``compress_grads=True``, ``warmup_steps=1``: the
    first loss within 1e-5 relative (the same parameters), later losses
    within 1e-3; the params within a derived bound.  An AdamW step moves a
    parameter by ``lr_t * (d + wd * p)`` with |d| = |mhat / (sqrt(nhat) +
    eps)| <= sqrt((1 - b1)^2 (1 - b2^t) / ((1 - b1^t)^2 (1 - b2))
    * sum_i (b1^2 / b2)^i) (Cauchy-Schwarz; 1.0 at t = 1, 1.00095 at
    t = 3): where |g| is near ``eps`` or an int8 code flips, a last-ulp
    difference of a gradient can turn d from +1 to -1.  So after step t
    the two runs' params differ by at most sum_t lr_t (2 |d|_max + wd
    delta_{t-1}), delta_{t-1} the bound before the step;
  * remat on and off give equal losses and gradients (``torch.equal``).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import ckpt as r_ckpt
from repro.configs import ARCHS
from repro.configs import get_config as r_get_config
from repro.configs import smoke_config as r_smoke_config
from repro.models import Model as RModel
from repro.optim import adamw as r_adamw
from repro.optim import schedule as r_schedule
from repro.train import compression as r_compression
from repro.train import train_step as r_train_step
from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.data.synthetic import token_stream
from repro_torch.models import Model
from repro_torch.optim import adamw, schedule
from repro_torch.train import compression
from repro_torch.train.train_step import (TrainConfig, TrainState,
                                          abstract_state, grads_of,
                                          init_state, make_train_step)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t_tree(tree):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                  tree)


def _leaves(tree):
    return [np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()
            for x in jax.tree_util.tree_leaves(tree)]


# ---------------------------------------------------------------------------
# schedule and AdamW
# ---------------------------------------------------------------------------


def test_warmup_cosine_matches_the_reference():
    ulps = 0
    for warm, total in ((100, 10_000), (1, 10), (0, 5), (7, 7)):
        for s in list(range(0, 3 * max(warm, 4))) + [total - 1, total,
                                                      2 * total]:
            want = np.float32(r_schedule.warmup_cosine(
                s, warmup_steps=warm, total_steps=total))
            got = schedule.warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                         warmup_steps=warm, total_steps=total)
            assert got.dtype == torch.float32
            got = np.float32(got)
            prog = np.float32(min(max((s - warm) / max(1.0, total - warm),
                                      0.0), 1.0))
            arg = np.float32(np.float32(math.pi) * prog)
            c_port = np.float32(torch.cos(torch.tensor(arg)))
            c_ref = np.float32(jnp.cos(jnp.float32(arg)))
            if s < warm or c_port == c_ref:
                assert got == want, (warm, total, s)
            else:   # cos one ulp apart, times 0.45 after 1 + cos
                assert c_port == np.nextafter(c_ref, c_port)
                assert abs(got - want) <= 0.45 * abs(c_port - c_ref) + 2 * (
                    np.spacing(want)), (warm, total, s)
                ulps += 1
    assert 0 < ulps < 20   # XLA's cos and torch's differ at 13 of 73


def _random_tree(rng, scale):
    return {"blk": {"scale": rng.standard_normal(7).astype(np.float32),
                    "w": rng.standard_normal((5, 9)).astype(np.float32)},
            "pre": [{"bias": rng.standard_normal(3).astype(np.float32),
                     "k": (rng.standard_normal((4, 4, 3)) * scale).astype(
                         np.float32)}],
            "ssm": {"A_log": rng.standard_normal(4).astype(np.float32),
                    "in_proj": rng.standard_normal((6, 2)).astype(
                        np.float32)}}


def _bias_corrections_equal(cfg, step):
    for b in (cfg.b1, cfg.b2):
        want = np.float32(1.0 - b ** jnp.asarray(step, jnp.float32))
        got = np.float32(1.0 - b ** torch.tensor(float(step)))
        if want != got:
            return False
    return True


@pytest.mark.parametrize("grad_scale", [0.01, 1.0])
def test_adamw_update_matches_the_reference(grad_scale):
    rng = np.random.default_rng(3)
    params = _random_tree(rng, 1.0)
    r_cfg, cfg = r_adamw.AdamWConfig(), adamw.AdamWConfig()
    r_params, r_state = params, r_adamw.init(params)
    p_params, p_state = _t_tree(params), adamw.init(_t_tree(params))
    exact_steps = 0
    for t in range(6):
        grads = jax.tree_util.tree_map(
            lambda x: (rng.standard_normal(x.shape) * grad_scale).astype(
                np.float32), params)
        lr_scale = np.float32(0.5 + 0.1 * t)
        r_params, r_state, r_m = r_adamw.update(
            jax.tree_util.tree_map(jnp.asarray, grads), r_state,
            jax.tree_util.tree_map(jnp.asarray, r_params), r_cfg, lr_scale)
        p_params, p_state, p_m = adamw.update(
            _t_tree(grads), p_state, p_params, cfg, torch.tensor(lr_scale))
        assert int(p_state.step) == int(r_state.step) == t + 1
        assert float(p_m["lr"]) == float(r_m["lr"])
        clipped = float(r_m["grad_norm"]) > cfg.clip_norm
        exact = _bias_corrections_equal(cfg, t + 1)
        exact_steps += exact
        for name, want, got in (("mu", r_state.mu, p_state.mu),
                                ("nu", r_state.nu, p_state.nu),
                                ("params", r_params, p_params)):
            for w, g in zip(_leaves(want), _leaves(got)):
                assert g.dtype == w.dtype == np.float32
                if clipped:
                    np.testing.assert_allclose(g, w, rtol=4e-7, atol=0)
                elif name != "params" or exact:
                    assert np.array_equal(g, w), (name, t)
                else:
                    assert np.all(np.abs(g - w) <= np.abs(
                        np.nextafter(w, np.inf) - w)), (name, t)
    assert exact_steps >= 2


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_decayed_leaves_are_the_references(arch):
    """The set of leaves that take weight decay, at full width (the
    reference's tree from ``jax.eval_shape``, the port's as meta
    tensors)."""
    tree = jax.eval_shape(RModel(r_get_config(arch)).init, jax.random.key(0))
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    keys = r_ckpt._paths_and_leaves(tree)[0]
    want = {k for k, (path, _) in zip(keys, flat)
            if r_adamw._decay_mask(path)}
    got_keys = ckpt._paths_and_leaves(Model(get_config(arch)).abstract_params(
    ))[0]
    assert got_keys == keys
    assert {k for k in got_keys if adamw.decays(k)} == want
    assert want and want != set(keys)


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_compress_codes_and_residual_bit_for_bit():
    rng = np.random.default_rng(4)
    leaves = {
        "zeros_then_normal": np.concatenate([
            np.zeros(256, np.float32),
            rng.standard_normal(300).astype(np.float32)]),
        "short": rng.standard_normal((3, 5)).astype(np.float32),
        "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 63.5,
                          -126.5, 3.0], np.float32),
        "wide": (rng.standard_normal((7, 111)) * 1e-3).astype(np.float32),
    }
    residual = {k: (rng.standard_normal(v.shape) * 1e-4).astype(np.float32)
                for k, v in leaves.items()}
    residual["ties"][:] = 0
    r_out, r_ef, r_m = r_compression.compress(
        jax.tree_util.tree_map(jnp.asarray, leaves),
        r_compression.EFState(jax.tree_util.tree_map(jnp.asarray, residual)))
    out, ef, m = compression.compress(_t_tree(leaves), compression.EFState(
        _t_tree(residual)))
    for k in leaves:
        assert out[k].dtype == torch.float32
        assert np.array_equal(out[k].numpy(), np.asarray(r_out[k])), k
        assert np.array_equal(ef.residual[k].numpy(),
                              np.asarray(r_ef.residual[k])), k
        q, scale = compression.quantize_int8(torch.from_numpy(
            leaves[k] + residual[k]))
        assert q.dtype == torch.int8 and q.shape[1] == compression.BLOCK
        dq = (q.to(torch.float32) * scale).reshape(-1)[:leaves[k].size]
        assert np.array_equal(dq.numpy(), np.asarray(r_out[k]).reshape(-1))
    assert float(m["ef_residual_sq"]) == pytest.approx(
        float(r_m["ef_residual_sq"]), rel=1e-6)
    q, scale = compression.quantize_int8(torch.from_numpy(leaves["ties"]))
    assert float(scale[0, 0]) == 1.0      # amax 127: the codes are the values
    assert q[0, :10].tolist() == [127, 0, 2, 2, 0, -2, -2, 64, -126, 3]
    q, scale = compression.quantize_int8(torch.zeros(300))
    assert scale.flatten().tolist() == [1.0, 1.0] and not q.any()


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _adam_step_bound(cfg, t):
    """The largest |mhat / (sqrt(nhat) + eps)| at step t (Cauchy-Schwarz
    over the t gradients)."""
    r = cfg.b1 ** 2 / cfg.b2
    s = (1 - cfg.b1) ** 2 * (1 - cfg.b2 ** t) / ((1 - cfg.b1 ** t) ** 2
                                                 * (1 - cfg.b2))
    return math.sqrt(s * sum(r ** i for i in range(t)))


def test_train_steps_with_microbatches_and_compression_match_the_reference():
    arch = "whisper-base"
    r_cfg = dataclasses.replace(r_smoke_config(arch), dtype="float32")
    cfg = dataclasses.replace(smoke_config(arch), dtype="float32")
    kw = dict(warmup_steps=1, total_steps=10, microbatches=2,
              compress_grads=True)
    r_tcfg, tcfg = r_train_step.TrainConfig(**kw), TrainConfig(**kw)
    r_model = RModel(r_cfg)
    r_state = r_train_step.init_state(r_model, jax.random.key(2), r_tcfg)
    r_step = jax.jit(r_train_step.make_train_step(r_model, r_tcfg))
    params = model_params_from_numpy(cfg, _np_tree(r_state.params),
                                     device="cpu")
    state = TrainState(params, adamw.init(params), compression.init(params))
    step = make_train_step(Model(cfg), tcfg)
    rng = np.random.default_rng(2)
    bound, opt = 0.0, tcfg.optimizer
    for t in range(3):
        batch = {k: rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
                 for k in ("tokens", "targets")}
        batch["frames"] = rng.standard_normal((4, 24, cfg.d_model)).astype(
            np.float32)
        lr_t = opt.lr * float(r_train_step.warmup_cosine(
            t, warmup_steps=1, total_steps=10))
        r_state, r_m = r_step(r_state, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        state, m = step(state, batch)
        loss, r_loss = float(m["loss"]), float(r_m["loss"])
        assert abs(loss - r_loss) <= (1e-5 * abs(r_loss) if t == 0 else 1e-3)
        assert sorted(m) == sorted(r_m)
        bound += lr_t * (2 * _adam_step_bound(opt, t + 1)
                         + opt.weight_decay * bound)
        worst = max(float(np.abs(g - w).max()) for w, g in zip(
            _leaves(r_state.params), _leaves(state.params)))
        assert worst <= bound * (1 + 1e-5), (t, worst, bound)
    assert int(state.opt.step) == 3 and 0 < bound < 2e-3


def test_remat_on_and_off_give_equal_values():
    base = dataclasses.replace(smoke_config("recurrentgemma-9b"),
                               dtype="float32")
    rng = np.random.default_rng(6)
    batch = {k: rng.integers(0, base.vocab_size, (2, 16)).astype(np.int32)
             for k in ("tokens", "targets")}
    out = {}
    for remat in ("none", "full", "dots"):
        model = Model(dataclasses.replace(base, remat=remat))
        params = model.init(torch.Generator().manual_seed(6), device="cpu")
        out[remat] = grads_of(model, params, batch)
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][1], out["none"][1])
        for a, b in zip(ckpt._paths_and_leaves(out[remat][0])[1],
                        ckpt._paths_and_leaves(out["none"][0])[1]):
            assert torch.equal(a, b), remat


def test_train_checkpoint_restore_bitexact(tmp_path):
    """``tests/test_system.py::test_train_checkpoint_restore_bitexact`` on
    the port: 2 steps, a checkpoint, 2 more; the restored state's 2 more
    steps give the same state, leaf for leaf, bit for bit."""
    cfg = smoke_config("mamba2-130m")
    model = Model(cfg)
    tcfg = TrainConfig(total_steps=10)
    state = init_state(model, torch.Generator().manual_seed(0), tcfg,
                       device="cpu")
    step = make_train_step(model, tcfg)
    stream = token_stream(cfg.vocab_size, 4, 32, seed=3)
    bt = [next(stream) for _ in range(4)]
    for b in bt[:2]:
        state, _ = step(state, b)
    ckpt.save(state, str(tmp_path), 2)
    cont = state
    for b in bt[2:]:
        cont, _ = step(cont, b)
    like = ckpt.tree_map(lambda x: torch.empty_like(x), state)
    restored, s0 = ckpt.restore(like, str(tmp_path))
    assert s0 == 2
    for b in bt[2:]:
        restored, _ = step(restored, b)
    a, b = (ckpt._paths_and_leaves(t)[1] for t in (cont, restored))
    assert len(a) == len(b) > 0
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("compress", [False, True])
def test_train_checkpoint_keys_are_the_references(compress):
    arch = "mamba2-130m"
    want = r_ckpt._paths_and_leaves(r_train_step.abstract_state(
        RModel(r_smoke_config(arch)),
        r_train_step.TrainConfig(compress_grads=compress)))[0]
    state = abstract_state(Model(smoke_config(arch)),
                           TrainConfig(compress_grads=compress))
    assert all(x.device.type == "meta"
               for x in ckpt._paths_and_leaves(state)[1])
    assert ckpt._paths_and_leaves(state)[0] == want
    assert ".opt/.step" in want and (".ef/.residual/emb/tok" in want) == \
        compress
