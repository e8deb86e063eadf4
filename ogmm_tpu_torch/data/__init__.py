"""The data pipeline of the port (host-side numpy, no torch): ModelNet40,
its synthetic stand-in and its variants, and the indoor datasets 7-Scenes
and ICL-NUIM."""
from ogmm_tpu_torch.data.loader import ListAsDict, PrefetchLoader, data_loader
from ogmm_tpu_torch.data.modelnet import (ModelNetCP, ModelNetDV, ModelNetGMR,
                                          ModelNetHdf, SyntheticPointClouds,
                                          get_transforms, synthetic_clouds)
from ogmm_tpu_torch.data.realdata import IclNuim, Scene7

__all__ = ["ListAsDict", "PrefetchLoader", "data_loader", "ModelNetCP",
           "ModelNetDV", "ModelNetGMR", "ModelNetHdf", "SyntheticPointClouds",
           "get_transforms", "synthetic_clouds", "Scene7", "IclNuim"]
