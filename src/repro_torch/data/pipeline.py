"""Device data pipeline: host batch dicts -> device tensors.

Counterpart of ``repro.data.pipeline``.  One process feeds one device: a
batch's numpy arrays are copied into pinned host memory and sent to the
GPU with ``non_blocking`` copies on the current stream, so the copy of the
next batch overlaps the step in flight.  The reference's multi-host path
(``jax.make_array_from_process_local_data`` over a mesh's batch axes) has
no counterpart: there is no mesh (ROADMAP queue C).
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.core.device import resolve_device


def device_batch(batch: Dict[str, np.ndarray], device=None
                 ) -> Dict[str, torch.Tensor]:
    """Host batch dict -> tensors on ``device`` (default: the GPU; an error
    without one)."""
    dev = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[k] = t
    return out


class DeviceIterator:
    """Wrap a host iterator; yields batches on ``device``."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], device=None):
        self.it = it
        self.device = resolve_device(device)

    def __iter__(self):
        return self

    def __next__(self):
        return device_batch(next(self.it), self.device)
