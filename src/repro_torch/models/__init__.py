"""Model definition of the port's serving path."""
from repro_torch.models.model import Model

__all__ = ["Model"]
