"""Chunking rule of the cumulative-probability walk (paper §II.B).

Counterpart of ``repro/kernels/cdf_query.py``.  This slice holds the part of
it that the fused query path uses: :func:`auto_chunks`, which resolves and
validates ``MCConfig.query_chunks``.  The walk itself is the device function
in ``csrc/cdf_walk.cuh``, written so that the kernel over pre-ordered rows
(``fused_query=False``, a later slice) can share it.

On the GPU a warp walks 32 priority positions at a time whatever ``chunks``
says: by the integer-walk contract every chunking gives the same bits, so the
value only has to be valid.
"""

from __future__ import annotations

LANE_WIDTH = 128  # the reference's chunk unit: one chunk per 128 positions


def auto_chunks(capacity: int, chunks: int) -> int:
    """Resolve ``chunks=0`` (auto) from C and the lane width: one chunk per
    128-position tile when C is a multiple of it, else a single chunk.
    Explicit chunk counts are validated here — once, for every backend — so
    a bad ``MCConfig.query_chunks`` fails identically on every path."""
    if chunks:
        if capacity % chunks:
            raise ValueError(
                f"chunks={chunks} must divide capacity={capacity} "
                f"(MCConfig.query_chunks)")
        return chunks
    if capacity % LANE_WIDTH == 0 and capacity > LANE_WIDTH:
        return capacity // LANE_WIDTH
    return 1
