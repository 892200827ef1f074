from .steps import make_eval_step, make_multi_eval_step, make_multi_train_step, make_train_step
from .train_state import TrainState

__all__ = ["TrainState", "make_eval_step", "make_multi_eval_step", "make_multi_train_step",
           "make_train_step"]
