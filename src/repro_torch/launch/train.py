"""End-to-end training launcher of the port.

Runs real steps on the GPU (``--device cpu`` for the CPU): the device data
pipeline, the train step, checkpoint/restart, the straggler watchdog.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \
      --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt

trains ``mamba2-130m`` at full width on the GPU; ``--smoke --device cpu``
trains its reduced config on the CPU.  Counterpart of
``repro.launch.train``, with its flags and defaults, and these
differences: there is no mesh, so ``--model-axis`` other than 1 is refused;
``--log-every`` sets ``run``'s ``log_every`` from the command line;
the checkpoint (``checkpoint.ckpt``, the reference's files and key strings)
restores onto the device; and a resumed run continues the data stream
where the checkpoint left it (the reference's restarts it at its first
batch).  So a run stopped and resumed ends in the state of a run that never
stopped where the schedule is the same in both: when the resumed run has
the stopped one's ``--steps`` (the cosine's horizon), or when every step
of the stopped run lies in the warm-up (ROADMAP queue C).  The encoder and vision archs
(``whisper-base``, ``phi-3-vision-4.2b``) are refused as the reference
refuses them; ``train.train_step.make_train_step`` trains them.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.checkpoint.ckpt import tree_map
from repro_torch.configs import get_config, smoke_config
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DeviceIterator
from repro_torch.data.synthetic import token_stream
from repro_torch.models.model import Model
from repro_torch.runtime.fault_tolerance import StepWatchdog, WatchdogConfig
from repro_torch.train.train_step import (TrainConfig, abstract_state,
                                          init_state, make_train_step)


def run(arch: str, smoke: bool, steps: int, batch: int, seq: int,
        ckpt_dir: str | None, ckpt_every: int = 50, microbatches: int = 1,
        compress: bool = False, model_axis: int = 1, log_every: int = 10,
        device=None):
    """Train ``steps`` steps on ``device`` (default: the GPU; an error
    without one), the parameters random from seed 0, drawn on the CPU so
    that every device starts from the same ones.  Returns the losses of
    the steps this call ran."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    if cfg.encoder_layers or cfg.frontend == "patch":
        raise SystemExit(f"{arch}: the token stream feeds no frames or patch "
                         f"embeddings; use the multimodal examples for "
                         f"this arch")
    if model_axis != 1:
        raise SystemExit(f"--model-axis {model_axis}: the port trains on one "
                         f"device and has no mesh to shard the model over")
    dev = resolve_device(device)
    model = Model(cfg)
    tcfg = TrainConfig(microbatches=microbatches, compress_grads=compress,
                       total_steps=max(steps, 2))
    step_fn = make_train_step(model, tcfg)

    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                              device=dev),
                        abstract_state(model, tcfg))
        state, start = ckpt.restore(like, ckpt_dir)
        print(f"restored checkpoint at step {start}")
    else:
        # drawn on the CPU and moved: the same parameters on any device,
        # as the reference's jax.random.key(0) gives
        state = init_state(model, torch.Generator().manual_seed(0), tcfg,
                           device=dev)

    stream = token_stream(cfg.vocab_size, batch, seq, seed=1)
    for _ in range(start):   # the batches the checkpoint has seen
        next(stream)
    data = DeviceIterator(stream, dev)
    watchdog = StepWatchdog(WatchdogConfig(deadline_s=300.0))
    pending_save = None
    losses = []
    t0 = time.time()
    for i, b in zip(range(start, steps), data):
        ts = time.time()
        state, metrics = step_fn(state, b)
        loss = float(metrics["loss"])
        losses.append(loss)
        watchdog.observe(time.time() - ts)
        if (i + 1) % log_every == 0:
            print(f"step {i+1:5d} loss {loss:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({(time.time()-t0)/(i-start+1):.2f}s/step)",
                  flush=True)
        if ckpt_dir and (i + 1) % ckpt_every == 0:
            if pending_save is not None:
                pending_save.join()
            pending_save = ckpt.save_async(state, ckpt_dir, i + 1)
    if pending_save is not None:
        pending_save.join()
    if ckpt_dir:
        ckpt.save(state, ckpt_dir, steps)
    return losses


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-130m")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--log-every", type=int, default=10,
                    help="print a step's loss every this many steps")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' for the CPU)")
    args = ap.parse_args()
    losses = run(args.arch, args.smoke, args.steps, args.batch, args.seq,
                 args.ckpt_dir, args.ckpt_every, args.microbatches,
                 args.compress_grads, args.model_axis, args.log_every,
                 device=args.device)
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
