"""Architecture configs: the 10 assigned architectures and the 4 input
shapes."""
from .base import ModelConfig, smoke_variant  # noqa: F401
from .registry import ARCHS, get_config, get_smoke_config, list_archs  # noqa: F401
from .shapes import (  # noqa: F401
    LONG_CONTEXT_WINDOW,
    SHAPES,
    InputShape,
    config_for_shape,
    get_shape,
    input_specs,
)
