"""Assigned architecture config: llama4-maverick-400b-a17b (see registry.py for provenance)."""
from repro_torch.configs.registry import get_arch

CONFIG = get_arch("llama4-maverick-400b-a17b")
