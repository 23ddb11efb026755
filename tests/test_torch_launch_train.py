"""The port's training launcher (``python -m repro_torch.launch.train``)
and its data pipeline, on the CPU.

``run("mamba2-130m", smoke=True, steps=4, batch=2, seq=32,
device="cpu")`` against the reference's ``run`` with the same arguments:
the port starts from the reference's parameters (its ``init_state`` is
patched to convert them; the launcher draws its own otherwise) and reads
the same token stream.  Bound: each loss within 2e-3 of the reference's
(measured: 4.2e-4), at the smoke config's bfloat16 compute, where XLA and
torch round the activations differently (one bfloat16 ulp at 6.2 is
0.03; the losses are means of float32 log-sums over 64 tokens).
Also: the launcher wants a GPU unless ``device="cpu"`` (it raises here),
refuses the encoder and vision archs as the reference's does and a model
axis other than 1 by name, and a run stopped at a checkpoint and resumed
ends in the state of a run that never stopped, bit for bit.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.launch import train as r_train
from repro.models import Model as RModel
from repro_torch.checkpoint import ckpt
from repro_torch.convert import model_params_from_numpy
from repro_torch.data.pipeline import DeviceIterator, device_batch
from repro_torch.launch import train
from repro_torch.optim import adamw
from repro_torch.train.train_step import TrainState

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_losses_match_the_reference_launcher(monkeypatch):
    kw = dict(smoke=True, steps=4, batch=2, seq=32, ckpt_dir=None)
    want = r_train.run("mamba2-130m", **kw)

    def reference_params(model, generator, tcfg, device=None):
        tree = RModel(model.cfg).init(jax.random.key(0))
        params = model_params_from_numpy(
            model.cfg, jax.tree_util.tree_map(np.asarray, tree),
            device=device)
        return TrainState(params, adamw.init(params), None)

    monkeypatch.setattr(train, "init_state", reference_params)
    got = train.run("mamba2-130m", device="cpu", **kw)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)


def test_the_launcher_wants_a_gpu_unless_asked_for_the_cpu():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.run("mamba2-130m", True, 1, 2, 8, None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--steps", "1"], cwd=ROOT, capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        timeout=300)
    assert out.returncode != 0 and "no CUDA device" in out.stderr


@pytest.mark.parametrize("arch", ["whisper-base", "phi-3-vision-4.2b"])
def test_the_encoder_and_vision_archs_are_refused(arch):
    with pytest.raises(SystemExit, match="use the multimodal examples"):
        train.run(arch, True, 1, 2, 8, None, device="cpu")


def test_a_model_axis_is_refused_by_name():
    with pytest.raises(SystemExit, match="--model-axis 2: .* no mesh"):
        train.run("mamba2-130m", True, 1, 2, 8, None, model_axis=2,
                  device="cpu")


def test_a_resumed_run_ends_where_an_uninterrupted_one_does(tmp_path):
    kw = dict(smoke=True, batch=2, seq=16, device="cpu")
    whole = train.run("mamba2-130m", steps=4, ckpt_dir=str(tmp_path / "a"),
                      **kw)
    first = train.run("mamba2-130m", steps=2, ckpt_dir=str(tmp_path / "b"),
                      **kw)
    rest = train.run("mamba2-130m", steps=4, ckpt_dir=str(tmp_path / "b"),
                     **kw)
    assert whole == first + rest
    a, b = (np.load(tmp_path / d / "step_00000004" / "arrays.npz")
            for d in ("a", "b"))
    assert sorted(a.files) == sorted(b.files) and len(a.files) > 10
    assert all(np.array_equal(a[k], b[k]) for k in a.files)


def test_device_batches():
    batch = {"tokens": np.arange(12, dtype=np.int32).reshape(3, 4),
             "frames": np.ones((3, 2, 5), np.float32)[:, :, ::2]}
    out = device_batch(batch, "cpu")
    for k, v in batch.items():
        assert out[k].device.type == "cpu" and np.array_equal(
            out[k].numpy(), v)
    it = DeviceIterator(iter([batch, batch]), "cpu")
    assert len(list(it)) == 2
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_batch(batch)
    assert ckpt.latest_step(os.path.join(ROOT, "no-such-dir")) is None
