"""mamba2-370m [ssm, SSD] — assigned architecture config (see archs.py for the registry).

Exact config per the assignment spec; ``reduced()`` in archs.py derives
the same-family smoke-test config.
"""

from repro_torch.configs.base import ArchConfig, MLACfg, MambaCfg, MoECfg, register

MAMBA2_370M = register(ArchConfig(
    name="mamba2-370m", family="ssm",
    num_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    mamba=MambaCfg(d_state=128, headdim=64, expand=2, d_conv=4, chunk=128),
    param_dtype="float32", compute_dtype="float32",
    notes="[arXiv:2405.21060; unverified] SSD (state-space duality)",
))

CONFIG = MAMBA2_370M
