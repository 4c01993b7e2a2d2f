"""Assigned architecture config: yi-34b (see registry.py for provenance)."""
from repro_torch.configs.registry import get_arch

CONFIG = get_arch("yi-34b")
