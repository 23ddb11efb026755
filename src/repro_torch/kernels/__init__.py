"""CUDA kernels for the paper's compute hot spots, with their plain versions.

  * :mod:`repro_torch.kernels.probe`       — shared open-addressing probe:
                                             flat src table (§II.1) + per-row
                                             dst hash (§II.2)
  * :mod:`repro_torch.kernels.slab_update` — fused batched edge increment (§II.A)
  * :mod:`repro_torch.kernels.oddeven`     — lock-free bubble sort (§II.2)
  * :mod:`repro_torch.kernels.decay_sort`  — decay in one pass: halve, evict,
                                             re-sum, full re-sort (§II.C)
  * :mod:`repro_torch.kernels.cdf_gather`  — fused row-gather + CDF walk (§II.B)
  * :mod:`repro_torch.kernels.cdf_query`   — CDF walk over pre-ordered rows
                                             (the unfused read) + chunking rule
  * :mod:`repro_torch.kernels.slow_path`   — sequential new-edge pass (§II.A)
  * :mod:`repro_torch.kernels.walk`        — k-step greedy draft walk
                                             (speculative decoding)
  * :mod:`repro_torch.kernels.dh_rebuild`  — rebuild of every row's dst
                                             hash, decided on the device
                                             (§II.2)
  * :mod:`repro_torch.kernels.copy_rows`   — the back-buffer learner's
                                             catch-up by flagged rows
  * :mod:`repro_torch.kernels.topn_merge`  — the sharded chain's global
                                             top-n: k-way merge of top
                                             lists, the winners' labels
  * :mod:`repro_torch.kernels.topn_windows` — the global top-n's one pass
                                             over the stacked slabs: each
                                             block's best window entries

Public API lives in :mod:`repro_torch.kernels.ops` (backend dispatch);
``ref.py`` holds the plain PyTorch version each kernel is held against;
``csrc/`` the CUDA C++ sources, built at first use by ``_build.py``.
"""

from repro_torch.kernels import ops  # noqa: F401
