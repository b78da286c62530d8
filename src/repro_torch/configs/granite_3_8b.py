"""granite-3-8b [dense, GQA] — assigned architecture config (see archs.py for the registry).

Exact config per the assignment spec; ``reduced()`` in archs.py derives
the same-family smoke-test config.
"""

from repro_torch.configs.base import ArchConfig, MLACfg, MambaCfg, MoECfg, register

GRANITE_3_8B = register(ArchConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12800, vocab=49155, head_dim=128,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", sp=True, n_micro=2,
    notes="[hf:ibm-granite/granite-3.0-2b-base; hf] GQA",
))

CONFIG = GRANITE_3_8B
