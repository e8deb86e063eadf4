"""Typed configuration of the port: the ModelNet, serving and indoor presets.

The field names and defaults of the model section are those of the JAX
package's config, so a config saved beside exported weights translates one
to one, both ways (`config_from_dict`, `config_to_dict`). An unknown model
option is rejected when a config is built from a saved dictionary, not
silently dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters of the serving forward."""
    emb_dims: int = 512
    n_clusters: int = 128       # GMM components for the registration solve
    km_clusters: int = 128      # FPS anchors conditioning attention
    num_heads: int = 4
    gnn_k: int = 20             # DGCNN edge-conv neighbourhood
    pos_k: int = 5              # position-encoding neighbourhood
    em_iters: int = 10          # EM trips of the clustering
    sinkhorn_iters: int = 10    # Sinkhorn trips inside each EM trip
    tau: float = 1.0            # clustering temperature
    softmax_temp: float = 0.05  # GMM matching softmax temperature
    is_sk: bool = False         # Sinkhorn instead of softmax matching
    overlap_radius: float = 0.035  # ICP gate is twice this
    icp_iters: int = 30         # fixed-trip ICP refinement
    # FPS anchors recomputed for each of the three attention stages (the
    # original's behaviour) instead of one FPS reused by all three; the
    # clustering then starts from its own centre FPS (nn/gmmreg.py:_fps)
    recompute_anchors: bool = False
    dtype: str = "float32"      # compute type of the network body
    # src and tgt through the per-cloud stages as one (2B, N, .) batch: in
    # eval (default on) and in training (default off: stacked, every
    # BatchNorm takes the statistics of both clouds at once, a divergence
    # from the original's one update per cloud)
    stack_eval: bool = True
    stack_train: bool = False
    # DGCNN training route: None (or True) the fused kernels where their
    # shape rule allows, False the unfused route (nn/dgcnn.py:fused_route)
    dgcnn_fused_train: bool | None = None
    # eval DGCNN over a given graph through the dgcnn_edges kernel (above
    # N = 1024, where GMMReg shares one graph): None/False off, True on; it
    # needs eval mode and a graph, and raises otherwise (nn/dgcnn.py:edges_route)
    dgcnn_fused_edges: bool | None = None
    # above N = 4096 the shared graph lives in Morton-sorted row space
    # (ops/stream.py:knn_self_vspace): None/True on, False the original-order
    # control
    dgcnn_vspace: bool | None = None
    # overlap head: stream the (N, M) similarity softmax through the wproject
    # kernel. None streams above B N M = 64 Mi elements, True always, False
    # never (nn/gmmreg.py:overlap_route), in eval and in training
    overlap_stream: bool | None = None
    # recompute the attention blocks' and conv heads' activations in the
    # backward instead of storing them (torch.utils.checkpoint; each
    # running statistic still moves once a forward: nn/gmmreg.py:_remat)
    remat: bool = False


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """The dataset and augmentation options of the data pipeline."""
    root: str = "/data"         # the dataset's files, or 'synthetic[:S]'
    dataset: str = "modelnet"   # modelnet | synthetic | 7scene | icl_nuim
    n_points: int = 717
    trans_mag: float = 0.5
    rot_mag: float = 45.0       # degrees
    unseen: bool = True         # test on the categories >= 20
    partial: Tuple[float, float] = (0.70, 0.70)   # crop keep proportions
    noise_type: str = "crop"    # clean | jitter | crop
    num_workers: int = 6        # loader threads
    # the true target overlap labels instead of the original's
    # tgt_overlap = src_overlap (device_overlap and the indoor datasets)
    fix_tgt_overlap: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, schedule, loss weights and loop."""
    batch_size: int = 24
    test_batch_size: int = 24
    epochs: int = 450
    lr: float = 1e-4
    weight_decay: float = 1e-4  # L2, added to the gradient before Adam
    lr_milestones: Tuple[int, ...] = (75, 150, 200)   # epochs
    lr_gamma: float = 0.1
    seed: int = 1234            # weights and the anchor FPS generator
    w_dcp: float = 10.0         # composite loss weights
    w_clu: float = 1.0
    w_overlap: float = 1.0
    w_welsch: float = 0.01
    mu: float = 10.0            # Welsch alpha
    n_keypoints: int = 512      # Welsch top-k
    save_every: int = 50        # periodic checkpoint, epochs
    metrics_every: int = 1      # full metric suite every k-th train step
    eval_every: int = 1         # test-split eval every k-th epoch
    device_overlap: bool = False  # ground-truth overlap labels in the step
    overlap_thresh: float = 0.05  # their radius
    model_path: str = "checkpoints"  # root of the run's checkpoints


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    model_name: str = "GMMReg"  # GMMReg | DeepGMR

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# the models a config may name (`model_name`): the JAX package's two
MODELS = ("GMMReg", "DeepGMR")

def _known(cls, section: dict) -> dict:
    """The entries of a saved section that are fields of `cls`, lists back
    to tuples (JSON keeps no tuples)."""
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in section.items() if k in names}


def config_from_dict(d: dict) -> Config:
    """Build a Config from the dictionary the JAX package saves beside its
    weights. An unknown model option raises; options of the training and
    dataset sections that this package does not read (the TPU mesh, the
    indoor datasets' options) are left out."""
    model_name = d.get("model_name", "GMMReg")
    if model_name not in MODELS:
        raise ValueError(f"unknown model {model_name!r}")
    known = {f.name for f in dataclasses.fields(ModelConfig)}
    model = d.get("model", {})
    for key in model:
        if key not in known:
            raise ValueError(f"unknown model option {key!r}")
    return Config(model=ModelConfig(**model),
                  data=DataConfig(**_known(DataConfig, d.get("data", {}))),
                  train=TrainConfig(**_known(TrainConfig, d.get("train", {}))),
                  model_name=model_name)


def config_to_dict(cfg: Config) -> dict:
    """The JSON-ready dictionary of a Config, in the layout the JAX
    package's `config_from_dict` reads (fields it has and this package
    lacks take its defaults there)."""
    return dataclasses.asdict(cfg)


def mnet(**overrides) -> Config:
    """ModelNet-family preset."""
    cfg = Config()
    return cfg.replace(**overrides) if overrides else cfg


def serve(**overrides) -> Config:
    """Serving preset, the JAX package's `serve`: `mnet` with 6 EM trips
    instead of 10 and a bf16 body; the ICP keeps its 30 trips. For serving
    only: training and evaluation keep `mnet`'s 10 trips."""
    cfg = Config(model=ModelConfig(em_iters=6, dtype="bfloat16"))
    return cfg.replace(**overrides) if overrides else cfg


def indoor(**overrides) -> Config:
    """7-Scenes / ICL-NUIM preset, the JAX package's `indoor`: K = 16
    clusters and anchors, a 0.0375 ICP voxel; fragments of 50,000 points
    cropped to 35,000 (`data/realdata.py`), one pair a request, 8 pairs a
    training batch. Above B N N = 64 Mi elements its overlap head streams,
    in training too (the chunked recompute of `ops/stream.py:wproject`)."""
    cfg = Config(
        model=ModelConfig(n_clusters=16, km_clusters=16, overlap_radius=0.0375),
        data=DataConfig(dataset="7scene", n_points=50000, unseen=False),
        train=TrainConfig(batch_size=8, test_batch_size=1, epochs=250, lr=1e-3,
                          n_keypoints=256),
    )
    return cfg.replace(**overrides) if overrides else cfg


def torch_dtype(name: str | None):
    import torch
    if name in (None, "float32"):
        return torch.float32
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported compute dtype {name!r}")
