from repro_torch.configs.base import (SHAPE_BY_NAME, SHAPE_CELLS, ModelConfig,
                                      ShapeCell)
from repro_torch.configs.registry import ARCHS, get_config

__all__ = ["ModelConfig", "ShapeCell", "SHAPE_CELLS", "SHAPE_BY_NAME",
           "ARCHS", "get_config"]
