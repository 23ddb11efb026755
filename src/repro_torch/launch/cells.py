"""The assigned (architecture x input-shape) grid: 10 archs x 4 shapes.

Counterpart of ``repro.launch.cells``.  Shape semantics (brief):
  * train_4k   : seq 4096,   global_batch 256  -> one train step
  * prefill_32k: seq 32768,  global_batch 32   -> prefill
  * decode_32k : KV len 32768, global_batch 128 -> decode_step (1 token)
  * long_500k  : KV len 524288, global_batch 1  -> decode_step; SSM/hybrid only

Enc-dec (whisper): seq applies to the encoder frame stream; the decoder uses
its native max (448 prefill 256 prompt / decode cache).  VLM: 256 stub patch
embeddings are part of the sequence budget.

The reference describes a cell's inputs as ``jax.ShapeDtypeStruct``s; the
port describes them as tensors on the ``meta`` device, which carry a shape
and a dtype and no memory.  A decode cell's caches are
``Model.init_caches(..., device="meta")``: per-period lists where the
reference stacks the periods, and a ``local_attn`` ring of ``local_window +
STEP_ROWS`` positions (ROADMAP queue C 26, C 30).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.configs import ARCHS
from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import Model

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")

# archs whose attention is sub-quadratic (long_500k runs only for these)
SUBQUADRATIC = ("mamba2-130m", "recurrentgemma-9b")


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    kind: str            # "train" | "prefill" | "decode"
    batch: int
    seq: int

    @property
    def name(self) -> str:
        return f"{self.arch}/{self.shape}"


def cell_of(arch: str, shape: str) -> Optional[Cell]:
    """None == skipped cell (with the reason recorded by the caller)."""
    if shape == "train_4k":
        return Cell(arch, shape, "train", 256, 4096)
    if shape == "prefill_32k":
        return Cell(arch, shape, "prefill", 32, 32768)
    if shape == "decode_32k":
        return Cell(arch, shape, "decode", 128, 32768)
    if shape == "long_500k":
        if arch not in SUBQUADRATIC:
            return None  # full attention: 500k dense KV cache is the blocker
        return Cell(arch, shape, "decode", 1, 524288)
    raise ValueError(shape)


def all_cells():
    for arch in sorted(ARCHS):
        for shape in SHAPES:
            yield arch, shape, cell_of(arch, shape)


# ---------------------------------------------------------------------------
# meta-tensor inputs per cell (no allocation — the dry-run contract)
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, cell: Cell) -> Dict[str, torch.Tensor]:
    """Training / prefill batch, as meta tensors."""
    b, s = cell.batch, cell.seq
    i32, f32 = torch.int32, torch.float32
    if cfg.encoder_layers:                       # whisper: frames + dec tokens
        s_dec = 256 if cell.kind == "prefill" else min(cfg.decoder_max_len, 448)
        out = {"frames": _meta((b, s, cfg.d_model), f32),
               "tokens": _meta((b, s_dec), i32)}
        if cell.kind == "train":
            out["targets"] = _meta((b, s_dec), i32)
        return out
    if cfg.frontend == "patch":                  # vlm: patches are in-budget
        npatch = cfg.frontend_len
        out = {"prefix_embeds": _meta((b, npatch, cfg.d_model), f32),
               "tokens": _meta((b, s - npatch), i32)}
        if cell.kind == "train":
            out["targets"] = _meta((b, s - npatch), i32)
        return out
    out = {"tokens": _meta((b, s), i32)}
    if cell.kind == "train":
        out["targets"] = _meta((b, s), i32)
    return out


def decode_specs(cfg: ModelConfig, cell: Cell):
    """(caches, tokens, pos) for decode cells, as meta tensors."""
    model = Model(cfg)
    b, s = cell.batch, cell.seq
    if cfg.encoder_layers:
        caches = model.init_caches(b, cfg.decoder_max_len, enc_len=s,
                                   device="meta")
    else:
        caches = model.init_caches(b, s, device="meta")
    tokens = _meta((b, 1), torch.int32)
    pos = _meta((b,), torch.int32)
    return caches, tokens, pos
