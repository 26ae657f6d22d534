"""Training of the port: the teacher-forced loss, the AdamW step and the
train-state snapshots (`fish_speech_tpu/train`), on one device or under a
(dp, tp) mesh of ranks (`init_train_state(mesh=)`, `step.shard_batch`,
`make_train_step(mesh=)`; snapshots re-shard across meshes)."""

from fish_speech_tpu_torch.train.loss import dual_ar_loss, fast_forward_teacher, slow_forward_full
from fish_speech_tpu_torch.train.step import TrainConfig, init_train_state, make_train_step

__all__ = [
    "dual_ar_loss",
    "fast_forward_teacher",
    "slow_forward_full",
    "TrainConfig",
    "init_train_state",
    "make_train_step",
]
