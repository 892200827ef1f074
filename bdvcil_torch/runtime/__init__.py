from .steps import make_multi_train_step, make_train_step
from .train_state import TrainState

__all__ = ["TrainState", "make_multi_train_step", "make_train_step"]
