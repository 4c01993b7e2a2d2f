"""Oracle: the plain version beside the kernel."""
from repro_torch.kernels.rmsnorm.rmsnorm import rmsnorm_ref  # noqa: F401
