"""Training on the port: the train step, AdamW and Adafactor, synthetic
data, checkpoints through the persistent log and the fault-tolerant loop
(port of the JAX package's ``training/``)."""
from .checkpoint import CheckpointManager
from .data import DataConfig, ShardedBatcher, synthetic_batch
from .ft import FaultTolerantLoop, StepMonitor, elastic_reshard
from .optimizer import (Optimizer, OptState, adafactor, adamw,
                        clip_by_global_norm, get_optimizer)
from .train import (TrainState, clone_state, cross_entropy,
                    init_train_state, make_loss_fn, make_train_step,
                    train_state_from_numpy, value_and_grad)

__all__ = ["CheckpointManager", "DataConfig", "FaultTolerantLoop",
           "OptState", "Optimizer", "ShardedBatcher", "StepMonitor",
           "TrainState", "adafactor", "adamw", "clip_by_global_norm",
           "clone_state", "cross_entropy", "elastic_reshard",
           "get_optimizer", "init_train_state", "make_loss_fn",
           "make_train_step", "synthetic_batch", "train_state_from_numpy",
           "value_and_grad"]
