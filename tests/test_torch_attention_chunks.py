"""Attention over a KV length that is no multiple of its chunk.

A ``local_attn`` ring holds ``local_window + STEP_ROWS`` positions in the
port (ROADMAP queue C 30): 2,056 for ``recurrentgemma-9b``, which chunks of
1,024 do not divide, so every decode and extension past 2,055 cached
positions raised (found by ``launch/dryrun.py``'s ``decode_32k`` cell).
``attention._flash_stats`` now gives the last chunk the rest.

* ``attend`` over 20 positions in chunks of 8 (8 + 12) against the
  reference's ``attend`` over one chunk of 20 (its chunks must divide T),
  float32, within 1e-5 (the online softmax adds the chunks in another
  order), and against the port's own single chunk within 1e-6; where the
  chunks divide T nothing changed (32 in chunks of 8 == the reference's,
  same chunking, within 1e-6).
* ``recurrentgemma-9b``'s smoke model with its window widened to 2,048: a
  ring of 2,056 positions; a prefill, then a 4-token extension == 4 decode
  steps bit for bit, finite, and its logits equal the same decodes of a
  model whose cache is no longer than a chunk (max_len 1,024) within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import attention as r_attn
from repro_torch.configs import smoke_config
from repro_torch.models import Model
from repro_torch.models import attention as t_attn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(t, sq=4, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, t, 2, 16)).astype(np.float32)
    qp = np.broadcast_to(np.arange(t - sq, t, dtype=np.int32), (2, sq))
    kp = np.broadcast_to(np.arange(t, dtype=np.int32), (2, t)).copy()
    kp[1, :3] = -1                                  # empty slots
    return q, k, v, np.ascontiguousarray(qp), kp


def _port(args, chunk, window):
    q, k, v, qp, kp = (torch.from_numpy(a) for a in args)
    return t_attn.attend(q, k, v, window=window, q_positions=qp,
                         kv_positions=kp, kv_chunk=chunk).numpy()


def _ref(args, chunk, window):
    q, k, v, qp, kp = (jnp.asarray(a) for a in args)
    return np.asarray(r_attn.attend(q, k, v, window=window, q_positions=qp,
                                    kv_positions=kp, kv_chunk=chunk))


@pytest.mark.parametrize("window", [0, 6])
def test_a_ragged_last_chunk(window):
    args = _inputs(20)
    got = _port(args, 8, window)
    np.testing.assert_allclose(got, _ref(args, 20, window), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(got, _port(args, 20, window), atol=1e-6,
                               rtol=0)
    even = _inputs(32, seed=1)
    np.testing.assert_allclose(_port(even, 8, window), _ref(even, 8, window),
                               atol=1e-6, rtol=0)


def _decodes(model, params, prompt, feed, max_len):
    _, caches = model.prefill(params, {"tokens": prompt}, max_len)
    pos = torch.full((prompt.shape[0],), prompt.shape[1], dtype=torch.int32)
    ext, _ = model.extend_step(params, caches, feed, pos)
    steps, c = [], caches
    for j in range(feed.shape[1]):
        step, c = model.decode_step(params, c, feed[:, j:j + 1], pos + j)
        steps.append(step)
    return ext, torch.stack(steps, dim=1), caches


def test_a_ring_of_window_plus_step_rows_past_a_chunk():
    cfg = dataclasses.replace(smoke_config("recurrentgemma-9b"),
                              dtype="float32", local_window=2048)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(2)
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 12)),
                             dtype=torch.int32)
    feed = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 4)),
                           dtype=torch.int32)
    ext, steps, caches = _decodes(model, params, prompt, feed, 4096)
    rings = [c["pos2"].k.shape[1] for c in caches["stack"]]
    assert rings == [2056] * cfg.num_periods()
    assert torch.isfinite(ext).all()
    assert torch.equal(ext, steps)
    short, _, _ = _decodes(model, params, prompt, feed, 1024)
    np.testing.assert_allclose(ext.numpy(), short.numpy(), atol=1e-5,
                               rtol=0)
