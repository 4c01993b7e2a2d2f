from repro_torch.kernels.canonical_check.ops import (
    canonical_check,
    expand_canonical,
)

__all__ = [
    "canonical_check",
    "expand_canonical",
]
