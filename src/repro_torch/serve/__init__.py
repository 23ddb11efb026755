"""Serving: the sharded chain's engine (:mod:`repro_torch.serve.engine`)."""
