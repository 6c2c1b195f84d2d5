"""Model configs of the port."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_config

__all__ = ["ModelConfig", "get_config"]
