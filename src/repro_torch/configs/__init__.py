"""Ported architecture configs (one module per arch, as in
``repro.configs``).  Importing this package populates the registry; use
``repro_torch.models.get_config(name)`` or the ``--arch`` flag of
``repro_torch.launch.serve``."""
from . import mamba2_1_3b, qwen2_1_5b  # noqa: F401
