"""PyTorch/CUDA port of the Cavs reproduction (``repro``), for one
NVIDIA H100.

The layout mirrors ``src/repro/`` module for module.  The port imports
``torch`` and NumPy, never ``jax`` and nothing of ``repro``; carry
weights across with :func:`repro_torch.interop.params_from_jax`.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

Precision: importing the package turns TF32 off for matmuls and cuDNN
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``), so every float32 product
stays full fp32 — the bar the JAX reference is held to (fused against
unfused within 1e-4).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
