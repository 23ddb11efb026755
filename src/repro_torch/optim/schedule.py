"""LR schedules (warmup + cosine decay), as functions of the step.

Counterpart of ``repro.optim.schedule``, in float32 on the step's device.
Its divisions take tensor divisors: PyTorch's CUDA kernels multiply by the
reciprocal of a Python-number divisor, which can differ from a division by
an ulp, so the card computes what the CPU computes.
"""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Multiplier in [min_ratio, 1] (a float32 0-dim tensor)."""
    step = torch.as_tensor(step).to(torch.float32)

    def over(x, d):
        return x / torch.full_like(x, d)

    warm = over(step, max(1.0, warmup_steps))
    prog = over(step - warmup_steps, max(1.0, total_steps - warmup_steps))
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)
