"""deepseek-v2-lite-16b [moe, MLA] — assigned architecture config (see archs.py for the registry).

Exact config per the assignment spec; ``reduced()`` in archs.py derives
the same-family smoke-test config.
"""

from repro_torch.configs.base import ArchConfig, MLACfg, MambaCfg, MoECfg, register

DEEPSEEK_V2_LITE = register(ArchConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400, head_dim=128,
    attn_kind="mla",
    mla=MLACfg(kv_lora=512, nope_dim=128, rope_dim=64, v_dim=128),
    moe=MoECfg(num_experts=64, top_k=6, num_shared=2, first_dense=1),
    expert_axis="experts",            # 64 experts % 16 == 0 → EP
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", n_micro=4,
    notes="[arXiv:2405.04434; hf] MLA kv_lora=512, 2 shared + 64 routed "
          "top-6 (v2-lite published config; the spec line's '160 routed' "
          "is the full V2 — we follow the lite numbers it also gives)",
))

CONFIG = DEEPSEEK_V2_LITE
