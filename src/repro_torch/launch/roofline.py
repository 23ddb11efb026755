"""Roofline terms of one cell on one NVIDIA H100 SXM 80 GB.

Counterpart of ``repro.launch.roofline``, which reads XLA's compiled HLO
with TPU v5e constants.  The port has no compiled artifact: the FLOPs are
counted by ``torch.utils.flop_counter.FlopCounterMode`` over one call of the
cell (2·M·N·K per matmul, elementwise work free: the reference's
convention), the bytes are the caller's figure, and a measured time, when
given, turns the bound into a measured share.

  compute term    = FLOPs / peak bfloat16 FLOP/s
  memory term     = bytes / HBM rate
  collective term = collective bytes / NVLink rate (0 on one card)

``memory_floor_bytes`` and ``model_flops`` are the reference's, line for
line.  The reference's ``collective_bytes`` (and ``hlo_cost``) parse XLA's
HLO text and have no counterpart: one card moves no collective bytes
(ROADMAP queue C).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

# NVIDIA H100 SXM5 80 GB data sheet, per card
PEAK_FLOPS_BF16 = 989e12   # dense bfloat16 tensor-core FLOP/s (no sparsity)
HBM_BW = 3.35e12           # HBM3 bytes/s
NVLINK_BW = 450e9          # NVLink 4 bytes/s each way (900 GB/s both ways)


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    model_flops_per_device: float
    memory_floor: float = 0.0
    coll_bytes: float = 0.0
    coll_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    measured_s: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / NVLINK_BW

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops_per_device / max(self.flops, 1.0)

    @property
    def roofline_fraction(self) -> float:
        """How close the dominant-term step time is to the ideal step time
        (ideal = useful model FLOPs at peak): MODEL_FLOPS / peak /
        max(term)."""
        ideal = self.model_flops_per_device / PEAK_FLOPS_BF16
        return ideal / max(self.t_bound, 1e-30)

    @property
    def measured_share(self) -> Optional[float]:
        """The bound's time over the measured time (1.0 = at the bound)."""
        if self.measured_s is None:
            return None
        return self.t_bound / max(self.measured_s, 1e-30)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops,
            "hbm_bytes_per_device": self.hbm_bytes,
            "collective_bytes_per_device": self.coll_bytes,
            "collective_by_class": self.coll_by_class,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_per_device": self.model_flops_per_device,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "memory_floor_s": self.memory_floor / HBM_BW,
            "memory_vs_floor": (self.hbm_bytes
                                / max(self.memory_floor, 1.0)),
            "measured_s": self.measured_s,
            "measured_share": self.measured_share,
        }


def memory_floor_bytes(cfg, cell, n_devices: int = 1) -> float:
    """Rough intrinsic lower bound on HBM traffic per device per step —
    what an ideal implementation could not avoid reading/writing:

      train  : 28 B/param (fp32 p read+write, grad write, adam m/v r+w)
               + ~6 half-precision residual-stream passes per layer
      prefill: params once (bf16) + KV cache write + 4 stream passes
      decode : params once (bf16) + full KV/state cache read
    """
    params = cfg.param_count()
    d, L = cfg.d_model, cfg.num_layers
    tokens = cell.batch * (cell.seq if cell.kind != "decode" else 1)
    if cell.kind == "train":
        traffic = 28.0 * params + 6.0 * L * tokens * d * 2.0
    elif cell.kind == "prefill":
        kv_bytes = (2 * cell.seq * cell.batch * cfg.num_kv_heads
                    * cfg.head_dim * 2.0 * L)
        traffic = 2.0 * params + kv_bytes + 4.0 * L * tokens * d * 2.0
    else:
        if cfg.pattern == ("ssm",):
            cache = (cell.batch * cfg.ssm_heads * cfg.ssm_headdim
                     * cfg.ssm_state * 4.0 * L)
        else:
            eff_len = min(cell.seq, cfg.local_window or cell.seq)
            n_attn = sum(1 for k in cfg._all_kinds()
                         if k in ("attn", "local_attn", "dense_mlp", "cross"))
            cache = (2 * eff_len * cell.batch * cfg.num_kv_heads
                     * cfg.head_dim * 2.0 * n_attn)
        traffic = 2.0 * params + cache
    return traffic / n_devices


def model_flops(cfg, cell, n_devices: int = 1) -> float:
    """MODEL_FLOPS convention: 6*N*D train, 2*N*D inference; N = active
    params (MoE counts routed-in experts only)."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.batch * cell.seq
        total = 6.0 * n_active * tokens
    elif cell.kind == "prefill":
        tokens = cell.batch * cell.seq
        total = 2.0 * n_active * tokens
    else:  # decode: one token per sequence
        total = 2.0 * n_active * cell.batch
    return total / n_devices


def analyse(flops: float, hbm_bytes: float, cfg, cell,
            measured_s: Optional[float] = None) -> Roofline:
    """The roofline of one cell on one card from its counted ``flops``
    (``FlopCounterMode.get_total_flops()`` over one call), a bytes figure
    and, when given, the call's measured seconds."""
    return Roofline(
        flops=float(flops), hbm_bytes=float(hbm_bytes),
        model_flops_per_device=model_flops(cfg, cell),
        memory_floor=memory_floor_bytes(cfg, cell),
        measured_s=measured_s)
