"""seamless-m4t-large-v2 [audio, enc-dec] — assigned architecture config (see archs.py for the registry).

Exact config per the assignment spec; ``reduced()`` in archs.py derives
the same-family smoke-test config.
"""

from repro_torch.configs.base import ArchConfig, MLACfg, MambaCfg, MoECfg, register

SEAMLESS_M4T_LARGE_V2 = register(ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    num_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    enc_dec=True, enc_layers=24, cross_every=1,
    param_dtype="bfloat16", compute_dtype="bfloat16",
    remat="full", n_micro=2,
    notes="[arXiv:2308.11596; hf] enc-dec, multimodal; audio frontend is "
          "a stub (precomputed frame embeddings)",
))

CONFIG = SEAMLESS_M4T_LARGE_V2
