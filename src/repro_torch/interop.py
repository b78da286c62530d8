"""Carrying weights across from the JAX package, and the packed
recurrent weight the Tree-LSTM kernel takes.

Parameters cross as NumPy arrays, so nothing here needs JAX:
``np_params = jax.tree.map(np.asarray, jax_params)`` one way,
:func:`params_to_numpy` the other.  :func:`lm_params_from_numpy` carries
a ``TransformerLM``'s, whose repeats the reference stacks.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import layer_plan

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
           else _tensor(v, device) for k, v in np_params.items()}
    return pack_recurrent(out)


def _tensor(a: Any, device) -> torch.Tensor:
    """A NumPy array (a bf16 one too, as ``ml_dtypes`` gives it) as a
    torch tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_to_numpy(params: Dict[str, Any]) -> Dict[str, Any]:
    """The same nested dict with every tensor copied to a NumPy array
    (the way back, for comparing with the JAX package)."""
    return {k: params_to_numpy(v) if isinstance(v, dict)
            else v.detach().cpu().numpy().copy() for k, v in params.items()}


def lm_params_from_numpy(np_params: Dict[str, Any], cfg,
                         device="cuda") -> Dict[str, Any]:
    """The port's ``TransformerLM`` params from the reference's, converted
    to NumPy (``jax.tree.map(np.asarray, TransformerLM(cfg).init(key))``).

    The reference keeps ``prologue`` (a list of block dicts) and
    ``pattern`` (one dict a pattern position, every leaf stacked
    ``[repeats, ...]`` for its ``lax.scan``); the port keeps ``layers``,
    one block dict a layer in execution order: the prologue, then repeat
    0's pattern positions, repeat 1's, ...  Embedding, head and final
    norm carry across as they are."""
    _prologue, pattern, repeats = layer_plan(cfg)

    def take(tree, r):
        return {k: take(v, r) if isinstance(v, dict) else np.asarray(v)[r]
                for k, v in tree.items()}

    layers: List[Dict[str, Any]] = [
        params_from_jax(p, device) for p in np_params.get("prologue", [])]
    layers += [params_from_jax(take(np_params["pattern"][pos], r), device)
               for r in range(repeats) for pos in range(len(pattern))]
    out = params_from_jax({k: v for k, v in np_params.items()
                           if k not in ("prologue", "pattern")}, device)
    out["layers"] = layers
    return out
