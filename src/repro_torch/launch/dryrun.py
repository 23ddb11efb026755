"""One-card dry run: build every (arch x shape) cell on the meta device and
count what one call of it needs.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each cell
over 512 forced host devices with GSPMD shardings.  The port has one card
and no mesh: it builds each cell's parameters, optimizer state (train), batch
(``launch/cells.py``) and caches (decode) as tensors on the ``meta`` device,
which hold shapes and dtypes and no memory, and runs one call of the cell
(a train step's forward, backward and AdamW update; ``Model.prefill``;
``Model.decode_step``) under ``torch.utils.flop_counter.FlopCounterMode``
and a count of the bytes every eager op reads and writes.  Per cell it
records

  * the bytes of each part and ``fits_one_card``: whether their sum is at
    most 80 GiB.  The sum is a lower bound: activations, the backward's
    saved tensors and the allocator's workspace are left out;
  * the counted FLOPs beside ``roofline.model_flops`` (a decode step runs
    ``STEP_ROWS`` rows a sequence, ROADMAP queue C 25, so it counts about
    8x the model's 2·N FLOPs a token);
  * the roofline terms (``launch/roofline.py``, H100 constants), with the
    eager ops' bytes as the memory term.

A cell that cannot run on meta (a read of a tensor's value on the host, such
as whisper's check of a decode's position against its self-cache) keeps its
bytes and is recorded ``not_counted`` with the reason.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape decode_32k
  python -m repro_torch.launch.dryrun --all --out DIR
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.checkpoint.ckpt import _paths_and_leaves
from repro_torch.configs import get_config
from repro_torch.launch import cells as cells_mod
from repro_torch.launch import roofline as rl
from repro_torch.models.model import STEP_ROWS, Model
from repro_torch.train.train_step import (TrainConfig, abstract_state,
                                          make_train_step)

CARD_BYTES = 80 * 2 ** 30   # one H100 SXM 80 GB


def tree_bytes(tree) -> int:
    """Bytes of every tensor leaf of a tree."""
    _, leaves, _ = _paths_and_leaves(tree)
    return sum(x.numel() * x.element_size() for x in leaves
               if isinstance(x, torch.Tensor))


class EagerBytes(TorchDispatchMode):
    """Sums the bytes every aten op reads (its tensor arguments) and writes
    (its tensor results), views excepted: eager PyTorch runs each op as its
    own kernel, so this is the call's device-memory traffic when no read
    hits a cache."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            ins, _ = tree_flatten((args, kwargs))
            outs, _ = tree_flatten(out)
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs
                              if isinstance(t, torch.Tensor))
        return out


def _run(model, cell, cfg):
    """The cell's parts (meta tensors) and a function that makes its call."""
    if cell.kind == "train":
        state = abstract_state(model, TrainConfig())
        batch = cells_mod.batch_specs(cfg, cell)
        step = make_train_step(model, TrainConfig())
        parts = {"params": state.params, "optimizer": state.opt,
                 "batch": batch}
        return parts, lambda: step(state, batch)
    params = model.abstract_params()
    if cell.kind == "prefill":
        batch = cells_mod.batch_specs(cfg, cell)
        return ({"params": params, "batch": batch},
                lambda: model.prefill(params, batch, cell.seq))
    caches, tokens, pos = cells_mod.decode_specs(cfg, cell)
    return ({"params": params, "caches": caches, "batch": [tokens, pos]},
            lambda: model.decode_step(params, caches, tokens, pos))


def count_cell(arch: str, shape: str) -> dict:
    cfg = get_config(arch)
    cell = cells_mod.cell_of(arch, shape)
    if cell is None:
        return {"arch": arch, "shape": shape, "status": "skipped",
                "reason": "full-attention arch: 500k dense KV cache "
                          "(sub-quadratic attention required; DESIGN.md §5)"}
    t0 = time.time()
    model = Model(cfg)
    parts, call = _run(model, cell, cfg)
    part_bytes = {k: tree_bytes(v) for k, v in parts.items()}
    total = sum(part_bytes.values())
    out = {
        "arch": arch, "shape": shape, "status": "ok", "kind": cell.kind,
        "batch": cell.batch, "seq": cell.seq, "device": "meta",
        "bytes": {**part_bytes, "total": total},
        "card_bytes": CARD_BYTES,
        "fits_one_card": total <= CARD_BYTES,
        "fits_note": "a lower bound: parameters (float32, as the port "
                     "stores them), optimizer state, batch and caches; "
                     "activations and workspace are left out",
        "model_flops": rl.model_flops(cfg, cell),
        "memory_floor_bytes": rl.memory_floor_bytes(cfg, cell),
    }
    if cell.kind == "decode":
        out["rows_per_sequence"] = STEP_ROWS
    flops, eager = FlopCounterMode(display=False), EagerBytes()
    try:
        with flops, eager:
            call()
    except RuntimeError as exc:
        if "meta" not in str(exc):
            raise
        out.update(status="not_counted",
                   reason=f"the call reads a tensor's value on the host, "
                          f"which a meta tensor does not hold: {exc}")
        out["count_s"] = round(time.time() - t0, 2)
        return out
    roof = rl.analyse(flops.get_total_flops(), eager.bytes, cfg, cell)
    out.update(counted_flops=flops.get_total_flops(),
               counted_vs_model_flops=(flops.get_total_flops()
                                       / max(out["model_flops"], 1.0)),
               eager_bytes=eager.bytes, roofline=roof.to_dict(),
               count_s=round(time.time() - t0, 2))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true",
                    help="refused: the port runs on one card, with no mesh")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None,
                    help="directory for one JSON per cell (default: none)")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise SystemExit("--multi-pod: the port runs on one card and has no "
                         "mesh to lower a cell over (ROADMAP queue C)")
    if args.all:
        todo = [(arch, shape) for arch, shape, _ in cells_mod.all_cells()]
    elif args.arch and args.shape:
        todo = [(args.arch, args.shape)]
    else:
        ap.error("give --arch and --shape, or --all")

    results = []
    for arch, shape in todo:
        try:
            res = count_cell(arch, shape)
        except Exception as e:  # a failing cell is a bug — surface it loudly
            res = {"arch": arch, "shape": shape, "status": "FAILED",
                   "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        results.append(res)
        print(json.dumps({k: v for k, v in res.items() if k != "trace"}),
              flush=True)
        if args.out:
            os.makedirs(args.out, exist_ok=True)
            fname = f"{arch}__{shape}__onecard.json".replace("/", "_")
            with open(os.path.join(args.out, fname), "w") as f:
                json.dump(res, f, indent=1)

    n_fail = sum(r["status"] == "FAILED" for r in results)
    print(f"\n{len(results)} cells, {n_fail} failed")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
