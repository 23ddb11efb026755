"""Model zoo of the port: the dense decoder family on shared substrates."""

from repro_torch.models.model import Model  # noqa: F401
