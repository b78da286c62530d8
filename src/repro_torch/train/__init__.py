"""Training substrate: the fault-tolerant trainer (port of
``repro.train``)."""

from repro_torch.train.trainer import TrainConfig, Trainer, TrainState
from repro_torch.train.metrics import MetricLogger

__all__ = ["TrainConfig", "Trainer", "TrainState", "MetricLogger"]
