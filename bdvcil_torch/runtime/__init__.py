from .steps import make_train_step
from .train_state import TrainState

__all__ = ["TrainState", "make_train_step"]
