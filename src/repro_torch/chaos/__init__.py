"""Chaos tooling for the port: the kill-and-recover soak
(:mod:`repro_torch.chaos.soak`, ``python -m repro_torch.chaos.soak``)."""
