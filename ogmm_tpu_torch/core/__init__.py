from ogmm_tpu_torch.core import se3
from ogmm_tpu_torch.core.procrustes import horn_rotation, rigid_transform

__all__ = ["se3", "horn_rotation", "rigid_transform"]
