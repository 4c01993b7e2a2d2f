"""The model zoo (port of ``repro.models``): every family of the registry."""
from repro_torch.models.lm import build_model, make_batch, model_from_numpy

__all__ = ["build_model", "make_batch", "model_from_numpy"]
