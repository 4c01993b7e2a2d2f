from repro_torch.core.apps.cliques import CliquesApp
from repro_torch.core.apps.motifs import MotifsApp

__all__ = ["CliquesApp", "MotifsApp"]
