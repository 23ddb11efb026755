"""MCPrioQ on PyTorch and CUDA: the port of :mod:`repro` (JAX, Pallas/TPU).

Same sub-package layout and public names as the reference package, so the
counterpart of ``repro.x`` is ``repro_torch.x``:

  * :mod:`repro_torch.core`    — the online sparse Markov chain
    (``init / update_batch / query_threshold / query_topk / decay``), the
    n-gram drafter built on it (``core.speculative``) and the snapshot
    store readers and the learner share (``core.epoch``)
  * :mod:`repro_torch.kernels` — hand-written CUDA C++ kernels (``csrc/``),
    their ctypes wrappers and their plain PyTorch versions
  * :mod:`repro_torch.data`    — synthetic Zipf graph sampler and token
    stream (numpy)
  * :mod:`repro_torch.analysis` — the ``requires_lock`` contract annotation
  * :mod:`repro_torch.convert` — state <-> dict of numpy leaves
  * :mod:`repro_torch.sharding` — the two-level ownership map
  * :mod:`repro_torch.checkpoint`, :mod:`repro_torch.persist` — checkpoints,
    chain snapshots, the write-ahead log and the N -> M reshard, in the
    reference's file formats
  * :mod:`repro_torch.faults`, :mod:`repro_torch.obs`,
    :mod:`repro_torch.runtime` — failpoints, telemetry and the retry
    ladder (host-only)

The package imports ``torch`` and never ``jax`` or ``repro``.  State lives on
the GPU unless the caller asks for the CPU (``init(cfg, device="cpu")``),
where every kernel wrapper runs its plain version instead.
"""
