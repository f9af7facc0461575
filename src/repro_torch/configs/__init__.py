"""Configurations of the port (counterpart of ``repro.configs``)."""
from repro_torch.configs.base import (ModelConfig, MoEConfig, SSMConfig,
                                      ShapeConfig, SubLayer, SHAPES,
                                      cell_is_runnable, get_config,
                                      list_archs, register, smoke_config)

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "ShapeConfig", "SubLayer",
    "SHAPES", "cell_is_runnable", "get_config", "list_archs", "register",
    "smoke_config",
]
