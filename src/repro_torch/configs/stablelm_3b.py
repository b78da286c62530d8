"""stablelm-3b [dense, MHA] — assigned architecture config (see archs.py for the registry).

Exact config per the assignment spec; ``reduced()`` in archs.py derives
the same-family smoke-test config.
"""

from repro_torch.configs.base import ArchConfig, MLACfg, MambaCfg, MoECfg, register

STABLELM_3B = register(ArchConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=6912, vocab=50304, head_dim=80,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", sp=True, n_micro=2,
    notes="[hf:stabilityai/stablelm-2-1_6b; unverified] MHA (kv=32)",
))

CONFIG = STABLELM_3B
