from .elastic import ElasticTrainer
from .state import TrainState, make_train_state
from .step import make_train_step

__all__ = ["TrainState", "make_train_state", "make_train_step",
           "ElasticTrainer"]
