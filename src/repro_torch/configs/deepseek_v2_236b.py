"""Assigned architecture config: deepseek-v2-236b (see registry.py for provenance)."""
from repro_torch.configs.registry import get_arch

CONFIG = get_arch("deepseek-v2-236b")
