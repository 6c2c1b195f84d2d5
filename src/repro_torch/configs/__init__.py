"""Model configs of the port."""
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      input_specs, variant_config)
from repro_torch.configs.registry import ASSIGNED, get_config

__all__ = ["ASSIGNED", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "get_config", "input_specs", "variant_config"]
