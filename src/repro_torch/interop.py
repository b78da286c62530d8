"""Carrying weights across from the JAX package, and the packed
recurrent weight the Tree-LSTM kernel takes.

Parameters cross as NumPy arrays, so nothing here needs JAX:
``np_params = jax.tree.map(np.asarray, jax_params)`` one way,
:func:`params_to_numpy` the other.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

#: The Tree-LSTM recurrent weights in the kernel's packed column order.
RECURRENT_KEYS = ("ui", "uf", "uo", "uu")


def pack_recurrent(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Return ``params`` with ``ui``/``uf``/``uo``/``uu`` replaced by
    column views of ONE contiguous ``[H, 4H]`` tensor (``ui|uf|uo|uu``).

    The values are unchanged (the plain path reads the views as before);
    the fused kernel reads the packed tensor behind them without a copy
    per launch (``kernels/level_megastep.packed_recurrent``).  Dicts
    without all four keys are returned as they are.
    """
    if not all(k in params for k in RECURRENT_KEYS):
        return dict(params)
    H = params["ui"].shape[0]
    packed = torch.cat([params[k] for k in RECURRENT_KEYS], dim=1) \
        .contiguous()
    out = dict(params)
    for g, k in enumerate(RECURRENT_KEYS):
        out[k] = packed[:, g * H:(g + 1) * H]
    return out


def params_from_jax(np_params: Dict[str, Any], device="cuda"
                    ) -> Dict[str, Any]:
    """Torch tensors on ``device`` from a JAX params dict converted to
    NumPy, keys unchanged; nested dicts (``{"cell": {...}, "head": ...}``)
    are carried level by level, and every dict with the Tree-LSTM
    recurrent weights comes packed (:func:`pack_recurrent`)."""
    out = {k: params_from_jax(v, device) if isinstance(v, dict)
           else torch.from_numpy(np.array(v, copy=True)).to(device)
           for k, v in np_params.items()}
    return pack_recurrent(out)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The same nested dict with every tensor copied to a NumPy array
    (the way back, for comparing with the JAX package)."""
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy().copy() for k, v in params.items()}
