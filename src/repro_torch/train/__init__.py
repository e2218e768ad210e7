"""Training substrate (port of ``repro/train``): the optimizer and the
synthetic data pipeline.  The checkpoint manager and the fault-tolerant
loop come with a later slice."""
from . import data, optim
from .data import DataConfig, SyntheticLM, make_batch
from .optim import OptConfig, adamw_update, init_state

__all__ = ["data", "optim", "OptConfig", "init_state", "adamw_update",
           "DataConfig", "SyntheticLM", "make_batch"]
