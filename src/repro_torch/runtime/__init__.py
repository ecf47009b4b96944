"""Serving and training steps of the port (``repro.runtime`` minus its mesh and sharding code)."""
from . import serve, train
from .train import TrainState, init_state, make_train_step

__all__ = ["serve", "train", "TrainState", "init_state", "make_train_step"]
