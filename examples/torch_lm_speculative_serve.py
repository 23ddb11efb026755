"""End-to-end example on the PyTorch/CUDA port: train a small LM for a few
hundred steps, then serve it with the MCPrioQ speculative drafter —
``examples/lm_speculative_serve.py`` on ``repro_torch``, with its flags,
defaults and printed lines.

Training uses the port's launcher (``launch/train.py``: the device data
pipeline, the train step, AdamW, checkpointing); serving uses the engine
with online n-gram drafting — the paper's structure learning from the
model's own output stream.  The trained parameters come back from the
checkpoint into a template made from ``abstract_state`` (meta tensors).

    PYTHONPATH=src python examples/torch_lm_speculative_serve.py \
        --steps 300 --arch starcoder2-3b [--device cpu]

Runs on the GPU unless ``--device cpu``.  One difference from the original:
``--ckpt-dir`` defaults to a fresh temporary directory, removed at the end,
where the original's fixed default makes a second run resume at its last
step, train nothing and fail on an empty loss list.  A ``--ckpt-dir`` that
already holds a checkpoint is refused for the same reason.
"""

import argparse
import shutil
import tempfile
import time

import numpy as np
import torch

from repro_torch.checkpoint import ckpt as ckpt_mod
from repro_torch.checkpoint.ckpt import tree_map
from repro_torch.configs import smoke_config
from repro_torch.core import mcprioq as mcq
from repro_torch.core import speculative as spec
from repro_torch.core.device import resolve_device
from repro_torch.launch.train import run as train_run
from repro_torch.models.model import Model
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.train.train_step import TrainConfig, abstract_state

REQUESTS = 6
NEW_TOKENS = 48


def train(arch, steps, ckpt_dir, device=None):
    """The train half: ``steps`` launcher steps of the reduced config at
    batch 8 x 128 into ``ckpt_dir``; returns the losses."""
    if ckpt_mod.latest_step(ckpt_dir) is not None:
        raise SystemExit(f"--ckpt-dir {ckpt_dir} already holds a checkpoint: "
                         f"the launcher would resume there and train "
                         f"nothing; give an empty directory (the default is "
                         f"a fresh one)")
    print(f"== training {arch} (reduced config) for {steps} steps")
    losses = train_run(arch=arch, smoke=True, steps=steps,
                       batch=8, seq=128, ckpt_dir=ckpt_dir,
                       ckpt_every=100, device=device)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f}")
    assert losses[-1] < losses[0], "training must reduce loss"
    return losses


def trained_params(arch, ckpt_dir, device=None):
    """The newest checkpoint's parameters, restored into empty tensors on
    the device shaped by ``abstract_state``."""
    model = Model(smoke_config(arch))
    dev = resolve_device(device)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=dev),
                    abstract_state(model, TrainConfig()))
    state, _ = ckpt_mod.restore(like, ckpt_dir)
    return model, state.params


def serve(model, params, device=None):
    """The serve half: 6 requests of 4 x 16 prompt tokens, greedy, through
    the engine with the drafter; returns the engine and each request's
    tokens."""
    print("\n== serving with online n-gram speculative drafting")
    cfg = model.cfg
    engine = Engine(model, params, ServeConfig(
        max_new_tokens=NEW_TOKENS, max_cache_len=256, draft_len=4,
        ngram=spec.NGramConfig(order=2, mc=mcq.MCConfig(
            num_rows=8192, capacity=32, sort_passes=1))), device=device)

    rng = np.random.default_rng(0)
    t0 = time.time()
    total, outs = 0, []
    for _ in range(REQUESTS):
        prompt = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
        outs.append(engine.generate({"tokens": prompt}))
        total += outs[-1].size
    dt = time.time() - t0
    plain_calls = REQUESTS * (NEW_TOKENS - 1)  # model calls plain greedy needs
    print(f"{total} tokens in {dt:.1f}s ({total/dt:.1f} tok/s), "
          f"model calls {engine.stats['model_calls']} vs {plain_calls} plain "
          f"({plain_calls / max(engine.stats['model_calls'], 1):.2f}x), "
          f"draft acceptance {engine.acceptance_rate:.1%} "
          f"(drafter version {engine.drafter_store.version})")
    return engine, outs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temporary "
                         "one, removed at the end)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the model and the drafter run (default: the "
                         "GPU)")
    args = ap.parse_args()
    device = None if args.device == "cuda" else "cpu"
    resolve_device(device)   # no GPU: fail before training anything
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="mcprioq_lm_ckpt_")
    try:
        train(args.arch, args.steps, ckpt_dir, device)
        model, params = trained_params(args.arch, ckpt_dir, device)
        serve(model, params, device)
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
