"""Model zoo of the port: every family of the ten archs on shared
substrates."""

from repro_torch.models.model import Model  # noqa: F401
