"""Distribution of the port over `torch.distributed`.

`sp` is point-sharded (sequence-parallel) serving: one large registration
pair computed by the processes of a group, each owning a block of the
points (`Registrar.sharded`). `comm` holds the collectives over a group,
`launch.run_ranks` starts W processes joined by a group. Data-parallel
training lives in `train/distributed.py` and `train/trainer.py`.
"""
from ogmm_tpu_torch.parallel.sp import make_sp_eval, sp_eval, sp_mesh

__all__ = ["make_sp_eval", "sp_eval", "sp_mesh"]
