from ogmm_tpu_torch.train.checkpoint import (CheckpointManager, export_weights,
                                             restore_checkpoint,
                                             save_checkpoint)
from ogmm_tpu_torch.train.state import (TrainState, create_train_state,
                                        make_optimizer)
from ogmm_tpu_torch.train.trainer import (BATCH_KEYS, Trainer, make_eval_step,
                                          make_train_step, train_loss)

__all__ = ["CheckpointManager", "export_weights", "restore_checkpoint",
           "save_checkpoint", "TrainState", "create_train_state",
           "make_optimizer", "BATCH_KEYS", "Trainer", "make_eval_step",
           "make_train_step", "train_loss"]
