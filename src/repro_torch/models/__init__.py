"""The model zoo's dense decoder (port of ``repro.models``)."""
from repro_torch.models.lm import build_model, model_from_numpy

__all__ = ["build_model", "model_from_numpy"]
