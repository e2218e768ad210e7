"""Ported architecture configs (one module per arch, as in
``repro.configs``).  Importing this package populates the registry; use
``repro_torch.models.get_config(name)`` or the ``--arch`` flag of
``repro_torch.launch.serve`` / ``repro_torch.launch.train``."""
from . import (dbrx_132b, internlm2_20b, llava_next_34b,  # noqa: F401
               mamba2_1_3b, qwen1_5_4b, qwen1_5_110b, qwen2_1_5b,
               qwen3_moe_30b, whisper_base, zamba2_7b)
