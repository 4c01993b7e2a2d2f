"""Assigned architecture config: stablelm-1.6b (see registry.py for provenance)."""
from repro_torch.configs.registry import get_arch

CONFIG = get_arch("stablelm-1.6b")
