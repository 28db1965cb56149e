from .base import (ModelConfig, ShapeConfig, SHAPES, ARCH_IDS,  # noqa: F401
                   get_config, list_archs)
