"""Training substrate (port of ``repro/train``): the optimizer, the
synthetic data pipeline, the checkpoint manager and the fault-tolerant
loop.  The int8 gradient compression comes with the LM-sharding slice."""
from . import checkpoint, data, loop, optim
from .checkpoint import CheckpointManager
from .data import DataConfig, SyntheticLM, make_batch
from .optim import OptConfig, adamw_update, init_state

__all__ = ["checkpoint", "data", "loop", "optim", "OptConfig",
           "init_state", "adamw_update", "CheckpointManager", "DataConfig",
           "SyntheticLM", "make_batch"]
