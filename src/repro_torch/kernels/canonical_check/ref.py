"""Oracle: the engine's plain Algorithm-2 check (port of
``repro.kernels.canonical_check.ref``)."""
from repro_torch.core import canonical
from repro_torch.core.graph import DeviceGraph


def canonical_check_ref(g: DeviceGraph, members, n_valid, cand):
    return canonical.vertex_check(g, members, n_valid, cand)
