"""Training substrate of the port: AdamW, the deterministic data pipeline,
atomic checkpoints, gradient compression and the fault-tolerant training
loop, as the JAX package's ``repro.train``.  Entry points take ``device=``
and default to ``"cuda"``."""
from . import checkpoint, data, optimizer, trainer
from .optimizer import OptConfig, OptState
from .trainer import NodeFailure, TrainConfig, make_train_step, train

__all__ = ["checkpoint", "data", "optimizer", "trainer", "OptConfig",
           "OptState", "NodeFailure", "TrainConfig", "make_train_step",
           "train"]
