from . import free_energy_profile, imaging, organize
from .joint_hist import joint_hist
from .joint_pipeline import joint_state_sweep
from .pore_hist import pore_hist
from .pore_pipeline import pore_state_sweep

__all__ = ["joint_hist", "joint_state_sweep", "pore_hist", "pore_state_sweep", "free_energy_profile", "imaging", "organize"]
