"""Model definition of the port (training and serving)."""
from repro_torch.models.model import Model

__all__ = ["Model"]
