"""llama-3.2-vision-90b [vlm, cross-attn] — assigned architecture config (see archs.py for the registry).

Exact config per the assignment spec; ``reduced()`` in archs.py derives
the same-family smoke-test config.
"""

from repro_torch.configs.base import ArchConfig, MLACfg, MambaCfg, MoECfg, register

LLAMA32_VISION_90B = register(ArchConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    cross_every=5, cross_kv_len=4096,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", fsdp=True, sp=True, n_micro=4,
    notes="[hf:meta-llama/Llama-3.2-11B-Vision; unverified] cross-attn "
          "image layers every 5th; patch embeddings stubbed",
))

CONFIG = LLAMA32_VISION_90B
