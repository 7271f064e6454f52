"""Training on one device: AdamW, the step-seeded data, the train step,
checkpoints and fault tolerance (the counterpart of ``repro.training``)."""
from repro_torch.training import checkpoint, data, fault_tolerance, optimizer
from repro_torch.training.train_step import (TrainConfig, TrainState,
                                             init_state, make_train_step,
                                             train_step)

__all__ = ["checkpoint", "data", "fault_tolerance", "optimizer",
           "TrainConfig", "TrainState", "init_state", "make_train_step",
           "train_step"]
