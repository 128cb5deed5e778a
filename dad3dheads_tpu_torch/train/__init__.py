from .optimizers import Optimizer, get_optimizer
from .schedulers import EarlyStopping, ReduceLROnPlateau, flat_cosine_schedule, get_schedule, warmup_factor
from .state import TrainState, init_train_state
from .step import build_eval_step, build_train_step

__all__ = [
    "Optimizer",
    "get_optimizer",
    "get_schedule",
    "flat_cosine_schedule",
    "warmup_factor",
    "ReduceLROnPlateau",
    "EarlyStopping",
    "TrainState",
    "init_train_state",
    "build_train_step",
    "build_eval_step",
]
