"""Oracle: the plain version beside the kernel."""
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: F401
    flash_attention_ref,
)
