"""Assigned architecture config: zamba2-2.7b (see registry.py for provenance)."""
from repro_torch.configs.registry import get_arch

CONFIG = get_arch("zamba2-2.7b")
