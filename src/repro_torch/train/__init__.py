from .elastic import ElasticTrainer
from .state import (TrainState, abstract_train_state, make_train_state,
                    train_state_specs)
from .step import make_train_step

__all__ = ["TrainState", "make_train_state", "make_train_step",
           "ElasticTrainer", "abstract_train_state", "train_state_specs"]
