"""Serving: the LM engine with the MCPrioQ drafter and the sharded chain's
engine (:mod:`repro_torch.serve.engine`), and sampling."""
