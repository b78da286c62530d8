"""jamba-v0.1-52b [hybrid mamba+attn+MoE] — assigned architecture config (see archs.py for the registry).

Exact config per the assignment spec; ``reduced()`` in archs.py derives
the same-family smoke-test config.
"""

from repro_torch.configs.base import ArchConfig, MLACfg, MambaCfg, MoECfg, register

JAMBA_V01_52B = register(ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    num_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    mamba=MambaCfg(d_state=16, headdim=64, expand=2, d_conv=4, chunk=128,
                   attn_every=8),    # 1 attention per 8 layers (1:7)
    moe=MoECfg(num_experts=16, top_k=2, every=2),
    expert_axis="experts",
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", fsdp=True, sp=True, n_micro=4,
    notes="[arXiv:2403.19887; hf] Mamba+attn 1:7 interleave, 16e top-2 "
          "MoE every 2 layers",
))

CONFIG = JAMBA_V01_52B
