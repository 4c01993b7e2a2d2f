"""Assigned architecture config: xlstm-1.3b (see registry.py for provenance)."""
from repro_torch.configs.registry import get_arch

CONFIG = get_arch("xlstm-1.3b")
