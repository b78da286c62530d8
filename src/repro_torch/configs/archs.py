"""The 10 assigned architectures — aggregator over the per-arch modules
(port of ``repro.configs.archs``).

Each architecture lives in its own ``configs/<id>.py``; this module
re-exports them, defines the ``ASSIGNED`` order, and provides
``reduced()`` — the same-family tiny config the CPU tests use.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig

from repro_torch.configs.mixtral_8x22b import MIXTRAL_8X22B
from repro_torch.configs.deepseek_v2_lite_16b import DEEPSEEK_V2_LITE
from repro_torch.configs.mamba2_370m import MAMBA2_370M
from repro_torch.configs.seamless_m4t_large_v2 import SEAMLESS_M4T_LARGE_V2
from repro_torch.configs.granite_3_8b import GRANITE_3_8B
from repro_torch.configs.command_r_35b import COMMAND_R_35B
from repro_torch.configs.stablelm_3b import STABLELM_3B
from repro_torch.configs.llama3_405b import LLAMA3_405B
from repro_torch.configs.jamba_v01_52b import JAMBA_V01_52B
from repro_torch.configs.llama32_vision_90b import LLAMA32_VISION_90B

ASSIGNED = [
    "mixtral-8x22b", "deepseek-v2-lite-16b", "mamba2-370m",
    "seamless-m4t-large-v2", "granite-3-8b", "command-r-35b",
    "stablelm-3b", "llama3-405b", "jamba-v0.1-52b", "llama-3.2-vision-90b",
]

def reduced(cfg: ArchConfig) -> ArchConfig:
    """Same-family tiny config for CPU smoke tests: few layers, narrow
    width, few experts, tiny vocab.  Preserves every structural feature
    (mixer kinds, MoE periodicity, cross-attn, enc-dec)."""
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4),
        d_model=128,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=(min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0),
        d_ff=(256 if cfg.d_ff else 0),
        vocab=512,
        head_dim=32 if cfg.n_heads else None,
        window=min(cfg.window, 16) if cfg.window else None,
        param_dtype="float32", compute_dtype="float32",
        remat="none", fsdp=False, loss_chunk=None,
        cross_kv_len=16 if cfg.cross_kv_len else 0,
        cross_every=min(cfg.cross_every, 2) if cfg.cross_every else 0,
        enc_layers=min(cfg.enc_layers, 2) if cfg.enc_layers else 0,
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            num_shared=min(cfg.moe.num_shared, 1),
            first_dense=min(cfg.moe.first_dense, 1))
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(
            cfg.mamba, d_state=16, headdim=16, chunk=8,
            attn_every=min(cfg.mamba.attn_every, 2)
            if cfg.mamba.attn_every else 0)
    if cfg.mamba is not None and cfg.mamba.attn_every:
        kw["num_layers"] = 4    # keep one attn + mamba mix
    return dataclasses.replace(cfg, **kw)
