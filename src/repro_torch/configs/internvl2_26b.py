"""Assigned architecture config: internvl2-26b (see registry.py for provenance)."""
from repro_torch.configs.registry import get_arch

CONFIG = get_arch("internvl2-26b")
