"""The data pipeline of the port (host-side numpy, no torch): ModelNet40 and
its synthetic stand-in, and the indoor datasets 7-Scenes and ICL-NUIM."""
from ogmm_tpu_torch.data.loader import PrefetchLoader, data_loader
from ogmm_tpu_torch.data.modelnet import (ModelNetHdf, SyntheticPointClouds,
                                          get_transforms, synthetic_clouds)
from ogmm_tpu_torch.data.realdata import IclNuim, Scene7

__all__ = ["PrefetchLoader", "data_loader", "ModelNetHdf",
           "SyntheticPointClouds", "get_transforms", "synthetic_clouds",
           "Scene7", "IclNuim"]
