"""Training layer (L4): curriculum, optimizer/schedules, train state,
jit/shard_map train step, checkpointing, trainer loop."""

from rangeclip.training.curriculum import get_curriculum_schedule
from rangeclip.training.optim import (
    make_optimizer,
    MultiStepSchedule,
    CosineAnnealingSchedule,
    ReduceOnPlateauSchedule,
    make_lr_schedule,
)
from rangeclip.training.state import TrainState, create_train_state
from rangeclip.training.train_step import make_train_step

__all__ = [
    "get_curriculum_schedule",
    "make_optimizer",
    "MultiStepSchedule",
    "CosineAnnealingSchedule",
    "ReduceOnPlateauSchedule",
    "make_lr_schedule",
    "TrainState",
    "create_train_state",
    "make_train_step",
]
