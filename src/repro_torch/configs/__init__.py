"""Architecture configs: the 10 assigned architectures (the reference's
input-shape table is not part of the port yet)."""
from .base import ModelConfig, smoke_variant  # noqa: F401
from .registry import ARCHS, get_config, get_smoke_config, list_archs  # noqa: F401
