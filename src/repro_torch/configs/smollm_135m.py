"""Assigned architecture config: smollm-135m (see registry.py for provenance)."""
from repro_torch.configs.registry import get_arch

CONFIG = get_arch("smollm-135m")
