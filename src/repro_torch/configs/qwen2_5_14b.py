"""Assigned architecture config: qwen2.5-14b (see registry.py for provenance)."""
from repro_torch.configs.registry import get_arch

CONFIG = get_arch("qwen2.5-14b")
