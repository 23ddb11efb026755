"""Gradient compression with error feedback: int8 block quantisation.

Counterpart of ``repro.train.compression``: each leaf (plus the residual
carried from the last step) is quantised in blocks of ``BLOCK`` values to
int8 codes with one float32 scale a block (``amax / 127``), dequantised,
and what the codes lose is carried to the next step.  ``torch.round`` and
``jnp.round`` both round half to even, and the two divisions are IEEE
divisions (the scale's divisor is a tensor: PyTorch's CUDA kernels would
multiply by the reciprocal of a Python number), so the codes and the
residual equal the reference's bit for bit on the same float32 input, on
the CPU and on the card.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.checkpoint.ckpt import _paths_and_leaves, tree_map

PyTree = Any
BLOCK = 256


class EFState(NamedTuple):
    residual: PyTree  # same structure as grads, float32


def init(grads_like: PyTree) -> EFState:
    return EFState(residual=tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 codes of float32 ``g``, flattened and padded
    with zeros to whole blocks: (codes int8 [nb, BLOCK], scales float32
    [nb, 1]); an all-zero block has scale 1."""
    flat = g.reshape(-1)
    fp = F.pad(flat, (0, (-flat.numel()) % BLOCK)).reshape(-1, BLOCK)
    amax = fp.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / amax.new_tensor(127.0), 1.0)
    q = torch.clamp(torch.round(fp / scale), -127, 127).to(torch.int8)
    return q, scale


def _quant_dequant_int8(g: torch.Tensor) -> torch.Tensor:
    """Blockwise symmetric int8 quantise-dequantise."""
    q, scale = quantize_int8(g)
    dq = q.to(torch.float32) * scale
    return dq.reshape(-1)[:g.numel()].reshape(g.shape)


def compress(grads: PyTree, state: EFState) -> Tuple[PyTree, EFState, dict]:
    """grads -> (compressed grads, new EF state, metrics)."""
    _, gs, rebuild = _paths_and_leaves(grads)
    _, rs, _ = _paths_and_leaves(state.residual)
    out, res = [], []
    for g, r in zip(gs, rs):
        gf = g.to(torch.float32) + r
        cq = _quant_dequant_int8(gf)
        out.append(cq.to(g.dtype))
        res.append(gf - cq)
    err = sum(torch.sum(torch.square(r)) for r in res)
    return rebuild(out), EFState(rebuild(res)), {"ef_residual_sq": err}
