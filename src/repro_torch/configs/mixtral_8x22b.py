"""mixtral-8x22b [moe] — assigned architecture config (see archs.py for the registry).

Exact config per the assignment spec; ``reduced()`` in archs.py derives
the same-family smoke-test config.
"""

from repro_torch.configs.base import ArchConfig, MLACfg, MambaCfg, MoECfg, register

MIXTRAL_8X22B = register(ArchConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=32768, head_dim=128,
    window=4096,                      # SWA per assignment spec
    moe=MoECfg(num_experts=8, top_k=2),
    expert_axis="ff",                 # 8 experts < model=16 → TP inside
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", fsdp=True, sp=True, n_micro=2,
    notes="[arXiv:2401.04088; hf] 8 experts top-2, SWA",
))

CONFIG = MIXTRAL_8X22B
