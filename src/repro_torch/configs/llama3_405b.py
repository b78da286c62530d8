"""llama3-405b [dense, flagship FSDP scale] — assigned architecture config (see archs.py for the registry).

Exact config per the assignment spec; ``reduced()`` in archs.py derives
the same-family smoke-test config.
"""

from repro_torch.configs.base import ArchConfig, MLACfg, MambaCfg, MoECfg, register

LLAMA3_405B = register(ArchConfig(
    name="llama3-405b", family="dense",
    num_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
    d_ff=53248, vocab=128256, head_dim=128,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", fsdp=True, loss_chunk=2048, sp=True, n_micro=4,
    opt_moment_dtype="bfloat16",
    notes="[arXiv:2407.21783; unverified] GQA, 128k vocab; flagship FSDP "
          "scale — see EXPERIMENTS.md for the per-chip memory budget",
))

CONFIG = LLAMA3_405B
