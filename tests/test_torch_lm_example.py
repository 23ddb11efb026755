"""``examples/torch_lm_speculative_serve.py`` (the train-then-serve LM
example) against ``examples/lm_speculative_serve.py``, on the CPU.

* The train half on ``starcoder2-3b``'s smoke config at the example's batch
  8 x 128, started from the reference's parameters (the launcher's
  ``init_state`` patched to convert them, as in
  ``tests/test_torch_launch_train.py``): at float32 compute every loss
  within that file's 2e-3 of the reference launcher's (measured 2e-6); at
  the config's bfloat16, where XLA and torch round the activations
  differently, within the larger of 2e-3 and twice what bfloat16 rounding
  moves the reference's own losses (its bfloat16 against its float32 run:
  6e-3 at the first step), the rule ``chip_smoke.py`` holds the card to.
  3 steps: the example asserts
  that the loss fell, and from the reference's parameters it has after 3
  steps (in the 100-step warm-up the rate is still small and a loss can
  rise for a step).
* The serve half on the reference launcher's trained parameters
  (``convert.model_params_from_numpy``) at float32 compute: every token,
  ``model_calls``, the acceptance and the drafter's version equal to the
  reference ``Engine``'s, serving as the reference example serves.
* The example as a user runs it, ``--device cpu --steps 8``, twice at once
  in one working directory (each trains into a fresh checkpoint directory
  of its own): both exit 0, and each prints the lines of the reference
  example's ``print`` calls (their format strings read from
  ``examples/lm_speculative_serve.py``, numbers masked) with the
  launcher's step lines between them.  8 steps: the port's own
  parameters' loss has fallen by then (not yet at 4).
* A ``--ckpt-dir`` that holds a checkpoint is refused by name, and without
  ``--device`` the example wants the GPU this machine does not have.
"""

import ast
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import ckpt as r_ckpt
from repro.configs import smoke_config as r_smoke_config
from repro.core import mcprioq as r_mcq
from repro.core import speculative as r_spec
from repro.launch import train as r_train
from repro.models import Model as RModel
from repro.serve.engine import Engine as REngine
from repro.serve.engine import ServeConfig as RServeConfig
from repro.train.train_step import TrainConfig as RTrainConfig
from repro.train.train_step import abstract_state as r_abstract_state
from repro_torch.convert import model_params_from_numpy
from repro_torch.configs import smoke_config
from repro_torch.launch import train as t_train
from repro_torch.models import Model
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "examples"))
import torch_lm_speculative_serve as example  # noqa: E402

ARCH = "starcoder2-3b"
STEPS = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def reference_run(tmp_path_factory):
    """The reference launcher's losses and trained parameters (numpy)."""
    d = str(tmp_path_factory.mktemp("ref_ckpt"))
    losses = r_train.run(ARCH, smoke=True, steps=STEPS, batch=8, seq=128,
                         ckpt_dir=d, ckpt_every=100)
    shapes = r_abstract_state(RModel(r_smoke_config(ARCH)), RTrainConfig())
    state, _ = r_ckpt.restore(shapes, d)
    return losses, jax.tree_util.tree_map(np.asarray, state.params)


def _from_the_reference_parameters(monkeypatch):
    def reference_params(model, generator, tcfg, device=None):
        tree = RModel(model.cfg).init(jax.random.key(0))
        params = model_params_from_numpy(
            model.cfg, jax.tree_util.tree_map(np.asarray, tree),
            device=device)
        return TrainState(params, adamw.init(params), None)

    monkeypatch.setattr(t_train, "init_state", reference_params)


def test_the_train_half_follows_the_reference_launcher(reference_run,
                                                        monkeypatch, tmp_path,
                                                        capsys):
    want, _ = reference_run
    _from_the_reference_parameters(monkeypatch)
    got = example.train(ARCH, STEPS, str(tmp_path / "bf16"), device="cpu")
    assert capsys.readouterr().out.splitlines() == [
        f"== training {ARCH} (reduced config) for {STEPS} steps",
        f"loss: {got[0]:.3f} -> {got[-1]:.3f}"]
    with pytest.raises(SystemExit, match="already holds a checkpoint"):
        example.train(ARCH, STEPS, str(tmp_path / "bf16"), device="cpu")

    # float32 compute in both launchers: no rounding in the way
    monkeypatch.setattr(r_train, "smoke_config", lambda a: dataclasses.replace(
        r_smoke_config(a), dtype="float32"))
    monkeypatch.setattr(t_train, "smoke_config", lambda a: dataclasses.replace(
        smoke_config(a), dtype="float32"))
    want32 = r_train.run(ARCH, smoke=True, steps=STEPS, batch=8, seq=128,
                         ckpt_dir=None)
    got32 = example.train(ARCH, STEPS, str(tmp_path / "f32"), device="cpu")
    assert len(got) == len(got32) == len(want) == len(want32) == STEPS
    np.testing.assert_allclose(got32, want32, atol=2e-3, rtol=0)  # 2e-6 seen
    # bfloat16, the example's compute: within twice what bfloat16 rounding
    # moves the reference's own losses (measured: 3.7e-3 against 1.2e-2)
    spread = np.abs(np.array(want) - np.array(want32)).max()
    np.testing.assert_allclose(got, want, atol=max(2e-3, 2 * spread),
                               rtol=0)


def _reference_serve(cfg, params):
    """The reference example's serve loop, greedy, on ``params``."""
    engine = REngine(RModel(cfg), params, RServeConfig(
        max_new_tokens=48, max_cache_len=256, draft_len=4,
        ngram=r_spec.NGramConfig(order=2, mc=r_mcq.MCConfig(
            num_rows=8192, capacity=32, sort_passes=1))))
    rng = np.random.default_rng(0)
    outs = []
    for req in range(6):
        prompt = jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 16)),
                             jnp.int32)
        outs.append(np.asarray(engine.generate({"tokens": prompt},
                                               jax.random.key(req))))
    return engine, outs


def test_the_serve_half_is_the_reference_engines(reference_run, capsys):
    _, tree = reference_run
    rcfg = dataclasses.replace(r_smoke_config(ARCH), dtype="float32")
    cfg = dataclasses.replace(smoke_config(ARCH), dtype="float32")
    r_engine, want = _reference_serve(rcfg, jax.tree_util.tree_map(
        jnp.asarray, tree))
    engine, got = example.serve(
        Model(cfg), model_params_from_numpy(cfg, tree, device="cpu"),
        device="cpu")
    assert len(got) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert engine.stats["model_calls"] == r_engine.stats["model_calls"]
    assert engine.stats["model_calls"] <= 6 * 47
    assert engine.acceptance_rate == r_engine.acceptance_rate
    assert engine.drafter_store.version == r_engine.drafter_store.version
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        f"{6 * 4 * 48} tokens in ")


def _reference_print_patterns():
    """One regex per ``print`` call of the reference example: its format
    string with every replacement field as a number-free wildcard."""
    tree = ast.parse(open(os.path.join(ROOT, "examples",
                                       "lm_speculative_serve.py")).read())
    patterns = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "id", None) == "print"):
            continue
        pieces = []
        for arg in node.args:
            parts = arg.values if isinstance(arg, ast.JoinedStr) else [arg]
            for part in parts:
                if isinstance(part, ast.Constant):
                    pieces.append(re.escape(part.value))
                else:
                    pieces.append(r"[-+0-9.e%x]+?" if not isinstance(
                        part.value, ast.Attribute) or part.value.attr != "arch"
                        else r"[\w.-]+")
        patterns.append("".join(pieces))
    return patterns


def test_the_example_prints_the_references_lines_and_reruns(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", TMPDIR=str(tmp_path))
    cmd = [sys.executable, os.path.join(ROOT, "examples",
                                        "torch_lm_speculative_serve.py"),
           "--device", "cpu", "--steps", "8"]
    procs = [subprocess.Popen(cmd, cwd=tmp_path, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    assert os.listdir(tmp_path) == []   # each removed its own directory
    patterns = _reference_print_patterns()
    assert len(patterns) == 4
    for out, _ in outs:
        lines = [line for line in out.splitlines()
                 if not re.fullmatch(r"step +\d+ loss .*", line)]
        assert re.fullmatch("\n".join(patterns), "\n".join(lines)), lines
        assert lines[0] == f"== training {ARCH} (reduced config) for 8 steps"
        assert lines[-1].startswith(f"{6 * 4 * 48} tokens in ")


def test_without_a_device_the_example_wants_the_gpu(monkeypatch):
    assert not torch.cuda.is_available()
    monkeypatch.setattr(sys, "argv", ["torch_lm_speculative_serve.py"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.main()


def test_the_launcher_logs_every_step_it_is_asked_to(monkeypatch, capsys):
    """``--log-every 1``: one loss line a step (``chip_smoke.py`` times the
    launcher's steps by these lines)."""
    monkeypatch.setattr(sys, "argv", [
        "train", "--arch", "starcoder2-3b", "--smoke", "--steps", "3",
        "--batch", "2", "--seq", "16", "--log-every", "1",
        "--device", "cpu"])
    t_train.main()
    out = capsys.readouterr().out
    assert [int(m) for m in re.findall(r"^step\s+(\d+) loss", out,
                                       re.M)] == [1, 2, 3]
    assert "first loss" in out
