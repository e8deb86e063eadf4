from ogmm_tpu_torch.core import se3
from ogmm_tpu_torch.core.procrustes import (horn_rotation, rigid_transform,
                                            rigid_transform_3x4)

__all__ = ["se3", "horn_rotation", "rigid_transform", "rigid_transform_3x4"]
