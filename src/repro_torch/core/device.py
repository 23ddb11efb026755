"""Where the port's entry points put their tensors.

A leaf module (imports torch only), so that the constructors of every layer
(``hashtable.make``, ``slab.make``, ``mcprioq.init``, ``speculative.init``)
follow one rule: no device given means the current CUDA device, and no CUDA
device means an error, never a silent fallback to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``None`` means the GPU, and only the GPU: no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch: no CUDA device is available and no device was "
                "given; pass device='cpu' to run the plain versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
