from repro_torch.core.apps.cliques import CliquesApp
from repro_torch.core.apps.fsm import FSMApp
from repro_torch.core.apps.motifs import MotifsApp

__all__ = ["CliquesApp", "FSMApp", "MotifsApp"]
