"""The ModelNet data pipeline of the port (host-side numpy, no torch)."""
from ogmm_tpu_torch.data.loader import PrefetchLoader, data_loader
from ogmm_tpu_torch.data.modelnet import (ModelNetHdf, SyntheticPointClouds,
                                          get_transforms, synthetic_clouds)

__all__ = ["PrefetchLoader", "data_loader", "ModelNetHdf",
           "SyntheticPointClouds", "get_transforms", "synthetic_clouds"]
