"""Assigned architecture config: whisper-base (see registry.py for provenance)."""
from repro_torch.configs.registry import get_arch

CONFIG = get_arch("whisper-base")
