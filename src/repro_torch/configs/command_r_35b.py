"""command-r-35b [dense, GQA no-bias] — assigned architecture config (see archs.py for the registry).

Exact config per the assignment spec; ``reduced()`` in archs.py derives
the same-family smoke-test config.
"""

from repro_torch.configs.base import ArchConfig, MLACfg, MambaCfg, MoECfg, register

COMMAND_R_35B = register(ArchConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22528, vocab=256000, head_dim=128,
    qkv_bias=False,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", fsdp=True, sp=True, n_micro=4,
    notes="[hf:CohereForAI/c4ai-command-r-v01; unverified] GQA, no-bias",
))

CONFIG = COMMAND_R_35B
