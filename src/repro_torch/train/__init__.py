"""Training substrate: data pipeline, optimizer, train step, checkpointing
(the JAX package's ``train/``).  Everything works on the reference's
parameter leaves (``models.convert.reference_leaves``), on the model's own
device."""
from .data import SyntheticTask, make_data
from .optimizer import AdamWConfig, adamw_init, adamw_update, cosine_schedule
from .loop import make_train_step, TrainMetrics
from . import checkpoint

__all__ = ["SyntheticTask", "make_data", "AdamWConfig", "adamw_init",
           "adamw_update", "cosine_schedule", "make_train_step",
           "TrainMetrics", "checkpoint"]
