"""Architecture and shape configs of the model zoo (the port's copy of
``repro.configs``)."""
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, cell_is_runnable
from repro_torch.configs.registry import ARCHS, get_arch

__all__ = ["ARCHS", "ArchConfig", "SHAPES", "ShapeConfig", "cell_is_runnable",
           "get_arch"]
